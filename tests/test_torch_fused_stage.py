"""pose6d_tpu_torch.ops.fused_block's parametric stage (fused_stage,
reference_stage, pack_stage_weights) and the folded tower with
pallas_stages, against the JAX package.

On the CPU the port's wrapper runs its plain version. The same random
BN-folded trees (HWIO in JAX, OIHW in the port) and inputs made from a
numpy seed go through both packages. f32: rtol/atol 1e-5 against JAX's
reference_stage for stages 1-4 and against its Pallas kernel in interpret
mode for stages 1-2 (as tests/test_pallas_block.py holds the kernel); the
folded tower at 224: rtol 1e-4 / atol 1e-5. bf16: within the bf16 envelope
of the f32 oracle (mean error < 0.02 std, max < 0.3 std). The CUDA kernel
itself is held against the plain version on the card by chip_smoke.py and
tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops import pallas_block as jpb
from pose6d_tpu.ops.quant import folded_resnet50_forward as j_folded_forward
from pose6d_tpu_torch.ops import fused_block as tfb
from pose6d_tpu_torch.ops import quant as tq

from torch_port_utils import random_folded_stage


def _input(rng, stage, batch=1):
    _, _, _, cin, _, _, h, w = tfb.STAGE_CFGS[stage]
    return rng.standard_normal((batch, h, w, cin)).astype(np.float32)


def test_stage_cfgs_match_jax():
    assert tfb.STAGE_CFGS == jpb.STAGE_CFGS


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_pack_stage_weights_matches_jax(rng, stage):
    jtree, ttree = random_folded_stage(rng, stage)
    got = tfb.pack_stage_weights(ttree, stage, torch.float32)
    want = jpb.pack_stage_weights(jtree, stage, jnp.float32)
    assert len(got) == len(want) == {1: 20, 2: 26, 3: 38, 4: 20}[stage]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().reshape(np.shape(b)), np.asarray(b))
    if stage == 1:
        for a, b in zip(got, tfb.pack_layer1_weights(ttree, torch.float32)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_stage_matches_jax_reference(rng, stage):
    jtree, ttree = random_folded_stage(rng, stage)
    x = _input(rng, stage)
    got = tfb.fused_stage(torch.from_numpy(x), tfb.pack_stage_weights(ttree, stage, torch.float32),
                          stage)
    _, _, stride, _, _, cout, h, w = tfb.STAGE_CFGS[stage]
    assert got.shape == (1, h // stride, w // stride, cout) and got.dtype == torch.float32
    want = np.asarray(jpb.reference_stage(jnp.asarray(x), jtree, stage, jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage", [1, 2])
def test_stage_matches_jax_pallas_interpret(rng, stage):
    jtree, ttree = random_folded_stage(rng, stage)
    x = _input(rng, stage)
    got = tfb.fused_stage(torch.from_numpy(x), tfb.pack_stage_weights(ttree, stage, torch.float32),
                          stage)
    pallas = jpb.fused_stage(jnp.asarray(x), jpb.pack_stage_weights(jtree, stage, jnp.float32),
                             stage=stage, dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


def test_stride2_block0_pads_like_torch_at_the_odd_edge(rng):
    """Stage 2's block 0 reads input pixel (2*oy+ky-1, 2*ox+kx-1) in its
    3x3/s2 conv (padding 1 on every side, as torch and the JAX package's
    folded forward pad it; flax 'SAME' would pad (0, 1) and shift the grid)
    and pixel (2*oy, 2*ox) in its 1x1/s2 shortcut. A ramp input makes every
    input pixel distinct; the output's first and last rows and columns
    (input rows -1..1 and 53..55) must match JAX."""
    jtree, ttree = random_folded_stage(rng, 2)
    ramp = np.linspace(-1.0, 1.0, 56, dtype=np.float32)
    x = (ramp[None, :, None, None] * ramp[None, None, :, None]
         + 0.1 * rng.standard_normal((1, 56, 56, 256))).astype(np.float32)
    got = tfb.fused_stage(torch.from_numpy(x), tfb.pack_stage_weights(ttree, 2, torch.float32),
                          2).numpy()
    want = np.asarray(jpb.reference_stage(jnp.asarray(x), jtree, 2, jnp.float32))
    for edge in (np.s_[0, [0, -1], :, :], np.s_[0, :, [0, -1], :]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_stage_bf16_close_to_f32_oracle(rng, stage):
    jtree, ttree = random_folded_stage(rng, stage)
    x = torch.from_numpy(_input(rng, stage)).bfloat16()
    got = tfb.fused_stage(x, tfb.pack_stage_weights(ttree, stage, torch.bfloat16), stage)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jpb.reference_stage(jnp.asarray(x.float().numpy()), jtree, stage,
                                          jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert err.mean() < 0.02 * want.std() and err.max() < 0.3 * want.std()


@pytest.mark.parametrize("case", ["stage", "dtype", "shape", "weight_dtype", "weight_count"])
def test_fused_stage_refuses_what_the_kernel_does_not_take(rng, case):
    _, ttree = random_folded_stage(rng, 2)
    w = tfb.pack_stage_weights(ttree, 2, torch.float32)
    x = torch.zeros(1, 56, 56, 256)
    call, err = {
        "stage": (lambda: tfb.fused_stage(x, w, 5), ValueError),
        "dtype": (lambda: tfb.fused_stage(x.half(), w, 2), TypeError),
        "shape": (lambda: tfb.fused_stage(torch.zeros(1, 28, 28, 256), w, 2), ValueError),
        "weight_dtype": (lambda: tfb.fused_stage(
            x, tfb.pack_stage_weights(ttree, 2, torch.bfloat16), 2), TypeError),
        "weight_count": (lambda: tfb.fused_stage(x, w[:-1], 2), ValueError),
    }[case]
    with pytest.raises(err):
        call()
    with pytest.raises(ValueError):  # stage 3's weights for stage 2's input
        tfb.fused_stage(x, w, 3)


@pytest.fixture(scope="module")
def tower():
    """A random folded ResNet50 tree (JAX and port layouts) and a 224 input."""
    rng = np.random.default_rng(7)
    jtree, ttree = {}, {}
    for stage in (1, 2, 3, 4):
        j, t = random_folded_stage(rng, stage)
        jtree.update(j)
        ttree.update(t)
    w = (rng.standard_normal((7, 7, 3, 64)) / np.sqrt(147)).astype(np.float32)
    b = (rng.standard_normal((64,)) * 0.05).astype(np.float32)
    jtree["conv1"] = {"w": w, "b": b}
    ttree["conv1"] = {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      "b": torch.from_numpy(b)}
    x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    return jtree, ttree, x


def test_folded_tower_with_stem_and_stages_matches_plain_and_jax(tower):
    """stem + stages 1-2 through the hooks: the graph the rgbd_geometric
    folded serving runs, at f32."""
    jtree, ttree, x = tower
    xt = torch.from_numpy(x)
    plain = tq.folded_resnet50_forward(ttree, xt)
    got = tq.folded_resnet50_forward(
        ttree, xt, pallas_stem=tfb.pack_stem_weights(ttree, torch.float32),
        pallas_stages={s: tfb.pack_stage_weights(ttree, s, torch.float32) for s in (1, 2)})
    want = np.asarray(j_folded_forward(jtree, jnp.asarray(x)))
    assert got.shape == plain.shape == (1, 2048)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_pallas_stages_take_precedence_over_pallas_l1(tower, monkeypatch):
    """As in the JAX package: a stage named in pallas_stages runs
    fused_stage; pallas_l1 runs fused_layer1 only when 1 is not named."""
    _, ttree, x = tower
    xt = torch.from_numpy(x)
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, args[2] if name == "stage" else 1))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tq, "fused_layer1", spy("layer1", tfb.fused_layer1))
    monkeypatch.setattr(tq, "fused_stage", spy("stage", tfb.fused_stage))
    l1 = tfb.pack_layer1_weights(ttree, torch.float32)
    stages = {s: tfb.pack_stage_weights(ttree, s, torch.float32) for s in (1, 2)}
    a = tq.folded_resnet50_forward(ttree, xt, pallas_l1=l1, pallas_stages=stages)
    assert calls == [("stage", 1), ("stage", 2)]
    calls.clear()
    b = tq.folded_resnet50_forward(ttree, xt, pallas_l1=l1, pallas_stages={2: stages[2]})
    assert calls == [("layer1", 1), ("stage", 2)]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
