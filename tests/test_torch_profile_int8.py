"""The int8 profilers (pose6d_tpu_torch/ops/profile_int8.py, the
counterparts of scripts/profile_int8_stages.py and probe_int8_variants.py)
on the CPU at a small size: a ResNet50 tower at 32x32, batch 2, random flax
variables with every BatchNorm randomised (torch_port_utils.
random_flax_variables), crops uniform(-2, 2) in bf16 as the scripts draw
them, and JAX's int8 tree of the tower (quantize_resnet_from_variables on
the crops in f32) carried to the port (convert.quantized_from_jax).

Variants B, C and E are held against a JAX transcription of the script's
closures, built here from pose6d_tpu.ops.quant's _resnet_structure and
nn_max_pool and run op by op (no jit, so that XLA fuses no bf16 rounding
away): B (f32 epilogues) within rel-L2 1e-6 and E (bf16 epilogues) within
rel-L2 1e-3 (0 measured for both: the int32 products are exact and every
cast and rounding is where JAX's is); C (float-resident, bf16 epilogues,
bf16 features) within rel-L2 1e-2 (0 measured; its features are the bf16
cast of an f32 mean whose sum order differs). D's last prefix equals
int8_resnet50_forward and the bf16 tower cut after stage 4 equals
folded_resnet50_forward, bit for bit. Each flag runs with --device cpu and
prints its JSON fields; without a card and without --device cpu it exits
2."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pose6d_tpu.models.resnet import ResNet50 as JResNet50
from pose6d_tpu.ops import quant as jquant
from pose6d_tpu_torch.convert import posenet_from_jax, quantized_from_jax
from pose6d_tpu_torch.models.resnet import ResNet50
from pose6d_tpu_torch.ops import profile_int8 as pi
from pose6d_tpu_torch.ops import quant

from torch_port_utils import few_torch_threads, random_flax_variables  # noqa: F401

B, S = 2, 32
RTOL = {"B": 1e-6, "C": 1e-2, "E": 1e-3}
ARGS = ["--device", "cpu", "--frame-hw", "64", "96", "--img-size", str(S), "--window", "1",
        "--reps", "1"]


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def trees():
    """(JAX's int8 tree, the port's copy of it, the crops: JAX bf16 and
    torch bf16, equal)."""
    variables = random_flax_variables(JResNet50(), jnp.zeros((1, S, S, 3)), seed=0)
    x32 = np.random.default_rng(0).uniform(-2, 2, (B, S, S, 3)).astype(np.float32)
    jx = jnp.asarray(x32, jnp.bfloat16)
    jq = jquant.quantize_resnet_from_variables(variables, [np.asarray(jx, np.float32)])
    tq = quantized_from_jax({k: {f: np.asarray(v) for f, v in e.items()} for k, e in jq.items()})
    tx = torch.from_numpy(x32).to(torch.bfloat16)
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx, np.float32))
    return jq, tq, jx, tx, variables


# ------------------------------------------- the script's closures in JAX

def _conv_s32(xq, e, stride=1, padding=None):
    return lax.conv_general_dilated(xq, e["w"], (stride, stride),
                                    padding if padding is not None else "SAME",
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                    preferred_element_type=jnp.int32)


def _quant_in(x, a, dt=jnp.float32):
    return jnp.clip(jnp.round(x.astype(dt) * (1.0 / a).astype(dt)), -127, 127).astype(jnp.int8)


def jax_b(q, x):
    """probe_int8_variants.py's fwd_resident (B)."""
    e1 = q["conv1"]
    y = jax.nn.relu(_conv_s32(_quant_in(x, e1["a"]), e1, 2, [(3, 3), (3, 3)]).astype(jnp.float32)
                    * (e1["a"] * e1["s"]) + e1["b"])
    xf = jquant.nn_max_pool(y)
    xq, a_in = _quant_in(xf, q["layer1_0/conv1"]["a"]), q["layer1_0/conv1"]["a"]
    flat = list(jquant._resnet_structure())
    for idx, (i, j, stride) in enumerate(flat):
        blk = f"layer{i + 1}_{j}"
        e1, e2, e3 = q[f"{blk}/conv1"], q[f"{blk}/conv2"], q[f"{blk}/conv3"]
        y = jax.nn.relu(_conv_s32(xq, e1).astype(jnp.float32) * (a_in * e1["s"]) + e1["b"])
        yq = _quant_in(y, e2["a"])
        y = jax.nn.relu(_conv_s32(yq, e2, stride, [(1, 1), (1, 1)]).astype(jnp.float32)
                        * (e2["a"] * e2["s"]) + e2["b"])
        yq = _quant_in(y, e3["a"])
        y = _conv_s32(yq, e3).astype(jnp.float32) * (e3["a"] * e3["s"]) + e3["b"]
        if f"{blk}/downsample" in q:
            ed = q[f"{blk}/downsample"]
            r = _conv_s32(xq, ed, stride).astype(jnp.float32) * (a_in * ed["s"]) + ed["b"]
        else:
            r = xq.astype(jnp.float32) * a_in
        xf = jax.nn.relu(y + r)
        if idx + 1 < len(flat):
            ni, nj, _ = flat[idx + 1]
            nxt = q[f"layer{ni + 1}_{nj}/conv1"]["a"]
            xq, a_in = _quant_in(xf, nxt), nxt
    return jnp.mean(xf, axis=(1, 2))


def jax_c(q, x):
    """probe_int8_variants.py's fwd_bf16epi (C)."""
    def conv(name, x, stride=1, padding=None):
        e = q[name]
        y = _conv_s32(_quant_in(x, e["a"], jnp.bfloat16), e, stride, padding)
        return (y.astype(jnp.bfloat16) * (e["a"] * e["s"]).astype(jnp.bfloat16)
                + e["b"].astype(jnp.bfloat16))

    x = jax.nn.relu(conv("conv1", x, 2, [(3, 3), (3, 3)]))
    x = jquant.nn_max_pool(x)
    for i, j, stride in jquant._resnet_structure():
        blk = f"layer{i + 1}_{j}"
        r = x
        y = jax.nn.relu(conv(f"{blk}/conv1", x))
        y = jax.nn.relu(conv(f"{blk}/conv2", y, stride, [(1, 1), (1, 1)]))
        y = conv(f"{blk}/conv3", y)
        if f"{blk}/downsample" in q:
            r = conv(f"{blk}/downsample", r, stride)
        x = jax.nn.relu(y + r)
    return jnp.mean(x, axis=(1, 2))


def jax_e(q, x):
    """probe_int8_variants.py's variant_e's fwd_e (E)."""
    bf = jnp.bfloat16

    def quant(x, a):
        return jnp.clip(jnp.round(x.astype(bf) * (1.0 / a).astype(bf)), -127, 127).astype(jnp.int8)

    def deq(y, e, a_in):
        return y.astype(bf) * (a_in * e["s"]).astype(bf) + e["b"].astype(bf)

    e1 = q["conv1"]
    y = jax.nn.relu(deq(_conv_s32(quant(x, e1["a"]), e1, 2, [(3, 3), (3, 3)]), e1, e1["a"]))
    xf = jquant.nn_max_pool(y)
    flat = list(jquant._resnet_structure())
    a_in = q["layer1_0/conv1"]["a"]
    xq = quant(xf, a_in)
    for idx, (i, j, stride) in enumerate(flat):
        blk = f"layer{i + 1}_{j}"
        e1b, e2, e3 = q[f"{blk}/conv1"], q[f"{blk}/conv2"], q[f"{blk}/conv3"]
        y = jax.nn.relu(deq(_conv_s32(xq, e1b), e1b, a_in))
        yq = quant(y, e2["a"])
        y = jax.nn.relu(deq(_conv_s32(yq, e2, stride, [(1, 1), (1, 1)]), e2, e2["a"]))
        yq = quant(y, e3["a"])
        y = deq(_conv_s32(yq, e3), e3, e3["a"])
        if f"{blk}/downsample" in q:
            ed = q[f"{blk}/downsample"]
            r = deq(_conv_s32(xq, ed, stride), ed, a_in)
        else:
            r = xq.astype(bf) * a_in.astype(bf)
        xf = jax.nn.relu(y + r)
        if idx + 1 < len(flat):
            ni, nj, _ = flat[idx + 1]
            a_in = q[f"layer{ni + 1}_{nj}/conv1"]["a"]
            xq = quant(xf, a_in)
    return jnp.mean(xf.astype(jnp.float32), axis=(1, 2))


@pytest.mark.parametrize("variant", ["B", "C", "E"])
def test_variant_matches_jax_transcription(trees, variant):
    jq, tq, jx, tx, _ = trees
    want = np.asarray({"B": jax_b, "C": jax_c, "E": jax_e}[variant](jq, jx), np.float32)
    got = {"B": lambda: pi.int8_resident(tq, tx, torch.float32),
           "C": lambda: pi.int8_float_resident(tq, tx, torch.bfloat16),
           "E": lambda: pi.int8_resident(tq, tx, torch.bfloat16)}[variant]()
    assert got.dtype == (torch.bfloat16 if variant == "C" else torch.float32)
    assert tuple(got.shape) == want.shape == (B, 2048)
    rel = _rel(got.float().numpy(), want)
    print(f"{variant}: rel-L2 {rel:.3g} against JAX")
    assert rel <= RTOL[variant], rel


def test_d_last_prefix_is_the_serving_tower(trees):
    """D cut after stage 4 equals int8_resnet50_forward in bf16 bit for
    bit, B equals it in f32; the earlier cuts have their stages' widths."""
    _, tq, _, tx, _ = trees
    want = quant.int8_resnet50_forward(tq, tx, torch.bfloat16)
    got = pi.int8_resident(tq, tx, torch.bfloat16, upto=4).to(torch.bfloat16)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(pi.int8_resident(tq, tx, torch.float32),
                       quant.int8_resnet50_forward(tq, tx, torch.float32))
    for k, width in zip((1, 2, 3), (256, 512, 1024)):
        assert tuple(pi.int8_resident(tq, tx, torch.bfloat16, upto=k).shape) == (B, width)


def test_bf16_prefix_is_the_folded_tower(trees):
    """The bf16 tower cut after stage 4 equals folded_resnet50_forward bit
    for bit (without the kernels, which need 224)."""
    *_, tx, variables = trees
    model = ResNet50()
    model.load_state_dict(posenet_from_jax(variables), strict=True)
    entry = pi.folded_entry(model.eval(), torch.bfloat16, kernels=False)
    with torch.no_grad():
        want = quant.folded_resnet50_forward(entry["tree"], tx, torch.bfloat16)
        assert torch.equal(pi.folded_prefix(entry, tx, 4, torch.bfloat16), want)
        assert torch.equal(pi.bf16_tower(entry, tx), want)


SPLIT_KEYS = {"tower_bf16_ms", "tower_int8_ms", "act_quantize_ms", "yolo_bf16_ms", "yolo_int8_ms"}
VARIANT_KEYS = ({"bf16_ms", "A_int8_f32epi_ms", "C_int8_bf16epi_ms", "B_int8_resident_ms",
                 "B_vs_A_rel_drift", "E_int8_resident_bf16epi_ms"}
                | {f"D_int8_prefix_stage{k}_ms" for k in range(1, 5)}
                | {f"D_int8_stage{k}_delta_ms" for k in range(1, 5)})


@pytest.mark.parametrize("flag", ["--int8-split", "--int8-variants"])
def test_flag_prints_its_fields(flag):
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pp.main(ARGS + [flag, str(B)]) == 0
    (line,) = [json.loads(x) for x in out.getvalue().splitlines()]
    keys = SPLIT_KEYS if flag == "--int8-split" else VARIANT_KEYS
    assert keys <= set(line) and line["tool"] == flag[2:].replace("-", "_")
    assert (line["batch"], line["device"], line["clock"]) == (B, "cpu", "host")
    assert line["tower_bf16"] == "folded_bf16" and line["tower_bf16_vs_cudnn_rel_l2"] is None
    names = {k[:-3] for k in keys if k.endswith("_ms") and "delta" not in k}
    assert names <= set(line["readings"]) and set(line["readings"]) == set(line["kernel_launches"])
    for name, r in line["readings"].items():
        assert r["ms"] > 0 and r["host_enqueue_ms"] > 0, name
        assert r["card_ms"] is None and r["idle_share"] is None, name
    assert all(v == {} for v in line["kernel_launches"].values())  # the plain versions
    if flag == "--int8-variants":
        assert line["B_vs_A_rel_drift"] == 0.0 and line["D_last_prefix_equals_A"] is True


@pytest.mark.parametrize("flag", ["--int8-split", "--int8-variants"])
def test_flag_refuses_without_a_card(flag, capsys):
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs on it")
    assert pp.main([flag, "2"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err
