"""The int8 half of pose6d_tpu_torch/ops/quant.py against pose6d_tpu's.

Small size: a ResNet50 tower at 32x32, batch 2, random flax variables
with every BatchNorm randomised (torch_port_utils.random_flax_variables),
converted to the port (convert.posenet_from_jax's table). Tolerances:
- weight codes and scales equal on the same folded tree (the same f32
  arithmetic, round half to even);
- activation scales within rtol 1e-5 (the two folded forwards sum their
  convolutions in different orders, rel 1.6e-6 measured);
- the port's int8 forward on JAX's own int8 tree, in f32: rel-L2 <= 1e-3
  and cosine >= 0.99999 against JAX's (the int32 products are exact, and
  every epilogue rounds where JAX's does; 0 measured);
- int8 against the float folded forward: cosine > 0.99, rel-L2 < 0.15,
  the bounds of tests/test_quant.py.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pose6d_tpu.models.resnet import ResNet50 as JResNet50
from pose6d_tpu.ops import quant as jquant
from pose6d_tpu_torch.convert import posenet_from_jax, quantized_from_jax
from pose6d_tpu_torch.models.resnet import ResNet50
from pose6d_tpu_torch.ops import quant

from torch_port_utils import random_flax_variables

B, S = 2, 32


def _np_tree(q):
    return {k: {f: np.asarray(v) for f, v in e.items()} for k, e in q.items()}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cos(a, b):
    return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def tower():
    """(JAX variables, JAX folded tree, the port's eval tower, input x)."""
    variables = random_flax_variables(JResNet50(), jnp.zeros((1, S, S, 3)), seed=0)
    jfold = jquant.fold_bn_resnet(variables["params"], variables["batch_stats"])
    model = ResNet50()
    model.load_state_dict(posenet_from_jax(variables), strict=True)
    x = np.random.default_rng(1).normal(size=(B, S, S, 3)).astype(np.float32)
    return variables, jfold, model.eval(), x


@pytest.fixture(scope="module")
def jax_int8(tower):
    """JAX's int8 tree of the tower (its own calibration)."""
    _, jfold, _, x = tower
    return jquant.quantize_folded(jfold, jquant.calibrate_act_scales(jfold, [x]))


def test_weight_codes_and_scales_match_jax(tower):
    """Per-channel int8 of the same folded kernels: the port's codes (OHWI)
    and scales equal JAX's (HWIO) exactly, for every conv."""
    _, jfold, _, _ = tower
    for name, e in jfold.items():
        jcodes, jscale = jquant.quantize_weights_per_channel(e["w"])
        codes, scale = quant.quantize_weights_per_channel(
            torch.from_numpy(e["w"].transpose(3, 2, 0, 1).copy()))
        assert codes.dtype == torch.int8 and codes.shape[1:3] == jcodes.shape[:2]
        np.testing.assert_array_equal(codes.numpy(), jcodes.transpose(3, 0, 1, 2), err_msg=name)
        np.testing.assert_array_equal(scale.numpy(), jscale, err_msg=name)


def test_act_scales_match_jax(tower):
    """calibrate_act_scales (abs max) on the port's own fold of the tower
    against JAX's on its fold, within rtol 1e-5."""
    _, jfold, model, x = tower
    want = jquant.calibrate_act_scales(jfold, [x])
    got = quant.calibrate_act_scales(quant.fold_bn_resnet(model), [x])
    assert set(got) == set(want) and len(got) == 53
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=0, err_msg=name)


def test_int8_forward_matches_jax(tower, jax_int8):
    """The port's int8 forward in f32 on JAX's int8 tree (carried across by
    convert.quantized_from_jax) against JAX's, with the activation
    codes that reach each conv in the two counted where they differ
    (recorded by spying on each package's int8 convolution); and the
    port's own tree (its own fold and calibration) against JAX's codes:
    at most 1 apart, counted. The own tree's forward is not held to JAX's:
    at these random weights a scale 1.6e-6 off flips a few codes, which
    the 16 blocks amplify to a few % (tested against float below)."""
    _, _, model, x = tower
    jq = jax_int8
    jcodes, tcodes = [], []
    conv = lax.conv_general_dilated

    def jspy(lhs, *args, **kwargs):
        jcodes.append(np.asarray(lhs))
        return conv(lhs, *args, **kwargs)

    def tspy(xq, *args):
        tcodes.append(xq.numpy())
        return conv_s8s32(xq, *args)

    conv_s8s32 = quant.conv_s8s32
    with mock.patch.object(jquant.lax, "conv_general_dilated", jspy):
        want = np.asarray(jquant.int8_resnet50_forward(jq, jnp.asarray(x)))
    with mock.patch.object(quant, "conv_s8s32", tspy):
        got = quant.int8_resnet50_forward(quantized_from_jax(_np_tree(jq)),
                                          torch.from_numpy(x)).numpy()
    assert len(jcodes) == len(tcodes) == 53
    flipped = sum(int((j != t).sum()) for j, t in zip(jcodes, tcodes))
    print(f"activation codes that differ from JAX's: {flipped} of "
          f"{sum(j.size for j in jcodes)}; rel-L2 {_rel(got, want):.3g}")
    assert got.dtype == np.float32 and got.shape == (B, 2048)
    assert _rel(got, want) <= 1e-3 and _cos(got, want) >= 0.99999, (_rel(got, want),
                                                                   _cos(got, want))
    own = quant.quantize_resnet_from_variables(model, [torch.from_numpy(x)])
    diffs = [own[k]["w"].numpy().astype(np.int32)
             - np.asarray(jq[k]["w"]).transpose(3, 0, 1, 2) for k in jq]
    print(f"the port's own weight codes that differ from JAX's: "
          f"{sum(int((d != 0).sum()) for d in diffs)}")
    assert max(int(np.abs(d).max()) for d in diffs) <= 1


def test_int8_forward_tracks_float(tower):
    """The port's PTQ tower against its float folded forward, with the
    bounds of tests/test_quant.py."""
    _, _, model, x = tower
    xt = torch.from_numpy(x)
    q = quant.quantize_resnet_from_variables(model, [xt])
    f = quant.folded_resnet50_forward(quant.fold_bn_resnet(model), xt).numpy()
    g = quant.int8_resnet50_forward(q, xt).numpy()
    assert _cos(f, g) > 0.99 and _rel(g, f) < 0.15, (_cos(f, g), _rel(g, f))


def test_bf16_int8_forward_dtype_and_shape(tower):
    """compute_dtype bf16: the features come out bf16 [B, 2048], finite,
    as JAX's do; the tree's codes are int8, its scales and biases [co]."""
    _, _, model, x = tower
    q = quant.quantize_resnet_from_variables(model, [torch.from_numpy(x)])
    assert q["conv1"]["w"].dtype == torch.int8
    assert q["conv1"]["s"].ndim == 1 and q["conv1"]["b"].ndim == 1 and q["conv1"]["a"].ndim == 0
    out = quant.int8_resnet50_forward(q, torch.from_numpy(x), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, 2048)
    assert bool(torch.isfinite(out.float()).all())


def test_int32_to_bf16_matches_jax():
    """The dequantize casts the int32 products to compute_dtype before its
    multiply; |y| reaches 74M (K 4608 x 127^2), past 2^24. torch's int32 ->
    bf16 cast equals JAX's there, on random values and on each bf16
    midpoint between 2^17 and 2^27 and its neighbours."""
    rng = np.random.default_rng(0)
    extra = []
    for e in range(17, 27):
        ulp = (1 << e) >> 7
        for k in range(1, 64):
            m = (1 << e) + k * ulp + ulp // 2
            extra += [m + d for d in range(-3, 4)]
    v = np.concatenate([rng.integers(-80_000_000, 80_000_000, 200_000),
                        extra, -np.asarray(extra)]).astype(np.int32)
    want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    got = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,stride,pad,ci,co", [
    (7, 2, 3, 3, 64),    # ResNet50 conv1: K 147 -> 152
    (7, 2, 3, 1, 64),    # the depth tower's conv1: K 49 -> 56
    (3, 2, 1, 3, 16),    # YOLOv8 stem: K 27 -> 32
    (3, 1, 1, 16, 24),   # a 3x3 stride-1 conv
    (3, 2, 1, 16, 32),   # a stride-2 3x3
    (1, 1, 0, 32, 16),   # a 1x1: the input codes as they are
    (1, 2, 0, 32, 64),   # the stride-2 downsample
])
def test_conv_s8s32_matches_lax(k, stride, pad, ci, co):
    """conv_s8s32 against lax.conv_general_dilated with int32 results, bit
    for bit, on the geometries of the towers and the detector (odd sides
    too)."""
    rng = np.random.default_rng(k * 100 + ci)
    for h, w in ((17, 20), (16, 16)):
        x = rng.integers(-127, 128, (2, h, w, ci), dtype=np.int8)
        wt = rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8)
        want = np.asarray(lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(wt), (stride, stride), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
        got = quant.conv_s8s32(torch.from_numpy(x),
                               torch.from_numpy(wt.transpose(3, 0, 1, 2).copy()), stride, pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
