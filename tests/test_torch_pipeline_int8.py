"""The int8 serving mode as a whole: pose6d_tpu_torch's
PosePipeline.quantize_backbones and its int8 serving against the JAX
PosePipeline's, for the four variants in f32; and the missing depth map
(C4), which both pipelines serve as an all-zero map.

Small size: pipelines at PIPE_IMG on 64x64 frames, batch 2, a narrow
YOLOv8 (width 0.125, nc 2), conf_thresh 0 (make_pipeline_pair). The JAX
pipeline runs op by op (jax.disable_jit), as in test_torch_pipeline.py.
Each variant calibrates on the same request in both packages, with and
without the detector. Tolerances: the trees' weight codes at most 1 apart
(0 differ, measured), their weight scales within rtol 1e-5 (the two BN
folds differ in the last bit, 8e-8 measured) and their activation scales
too (the two float crop stages and folded forwards round differently,
rel 1.6e-6 measured); then the port serving JAX's own int8 trees (convert.
quantized_from_jax) within
assert_pipeline_parity of JAX.
"""

import jax
import numpy as np
import pytest
import torch

from pose6d_tpu_torch.convert import quantized_from_jax

from torch_port_utils import (PIPE_IMG as S, assert_pipeline_parity, make_pipeline_pair,
                              pipeline_request)

VARIANTS = ["rgbd", "rgbd_geometric", "rgb", "rgb_geometric"]


def _request():
    return pipeline_request(0, (S, S), 2)


def _args(variant, frames, K, depth):
    return (frames, K, depth) if variant.startswith("rgbd") else (frames, K)


def _port_trees(jax_quantized):
    """JAX's int8 trees {tower: tree, "__yolo__": tree} in the port's layout."""
    def one(name, tree):
        np_tree = {k: {f: (v if f == "float" else np.asarray(v)) for f, v in e.items()}
                   for k, e in tree.items()}
        return quantized_from_jax(np_tree)
    return {name: one(name, tree) for name, tree in jax_quantized.items()}


def _assert_trees_close(got, want):
    """The port's trees against JAX's (converted): the same trees and convs,
    codes at most 1 apart, scales within rtol 1e-5; returns the count of
    codes that differ."""
    assert set(got) == set(want)
    flipped = 0
    for name, tree in want.items():
        assert set(got[name]) == set(tree), name
        for conv, e in tree.items():
            g = got[name][conv]
            if e.get("float"):
                np.testing.assert_allclose(g["w"].numpy(), e["w"].numpy(), rtol=0, atol=1e-6)
                continue
            d = g["w"].numpy().astype(np.int32) - e["w"].numpy()
            assert int(np.abs(d).max()) <= 1, (name, conv)
            flipped += int((d != 0).sum())
            np.testing.assert_allclose(g["s"].numpy(), e["s"].numpy(), rtol=1e-5, err_msg=conv)
            np.testing.assert_allclose(float(g["a"]), float(e["a"]), rtol=1e-5, err_msg=conv)
    return flipped


@pytest.fixture(scope="module", params=VARIANTS)
def quantized(request):
    """Per variant: the pipelines, the request, and both packages'
    quantize_backbones(include_detector=True) on it: (variant, jax_pipe,
    port_pipe, request, JAX's trees, the port's)."""
    variant = request.param
    jpipe, tpipe = make_pipeline_pair(variant)
    frames, K, depth = _request()
    with jax.disable_jit():
        jpipe.quantize_backbones(frames, K, depth, include_detector=True)
    tpipe.quantize_backbones(frames, K, depth, include_detector=True)
    return variant, jpipe, tpipe, (frames, K, depth), jpipe._quantized, tpipe._quantized


def test_quantize_backbones_matches_jax(quantized):
    """Both packages' trees of every tower and the detector: codes and
    scales as _assert_trees_close holds them; without the detector the
    port's tower trees are the same bits and hold no detector tree."""
    variant, _, tpipe, (frames, K, depth), jtrees, ttrees = quantized
    print(f"{variant}: weight codes that differ from JAX's: "
          f"{_assert_trees_close(ttrees, _port_trees(jtrees))}")
    towers = tpipe.quantize_backbones(frames, K, depth)._quantized
    assert set(towers) == set(ttrees) - {"__yolo__"}
    for name, tree in towers.items():
        for conv, e in tree.items():
            for k, v in e.items():
                assert torch.equal(v, ttrees[name][conv][k]), (name, conv, k)


@pytest.mark.parametrize("include_detector", [True, False])
def test_int8_serving_matches_jax(quantized, include_detector):
    """The port serving JAX's own int8 trees, from JAX's quantize_backbones
    with the detector (the fixture's) or without it, against the JAX
    pipeline serving them."""
    variant, jpipe, tpipe, (frames, K, depth), jtrees, _ = quantized
    with jax.disable_jit():
        if include_detector:
            jpipe._quantized = jtrees
        else:
            jpipe.quantize_backbones(frames, K, depth)
            assert "__yolo__" not in jpipe._quantized
        tpipe.load_quantized(_port_trees(jpipe._quantized))
        assert (tpipe._yolo_int8 is not None) == include_detector
        want = jpipe(*_args(variant, frames, K, depth))
    got = tpipe(*_args(variant, frames, K, depth))
    assert got["rotation"].shape == (2, 4) and got["translation"].shape == (2, 3)
    assert_pipeline_parity(got, want)


@pytest.mark.parametrize("variant", ["rgbd", "rgbd_geometric"])
def test_missing_depth_serves_zero_depth(variant):
    """C4: called with no depth map, the depth variants serve an all-zero
    f32 map of the frames' [B, H, W], as the JAX pipeline does (rgbd's
    depth tower sees 0; rgbd_geometric falls back to depth_fallback), the
    same as an explicit zero map; the map is made once per shape."""
    jpipe, tpipe = make_pipeline_pair(variant)
    frames, K, _ = _request()
    with jax.disable_jit():
        want = jpipe(frames, K)
    got = tpipe(frames, K)
    assert_pipeline_parity(got, want)
    zero = tpipe._zero_depth
    assert zero.dtype == torch.float32 and tuple(zero.shape) == frames.shape[:3]
    assert not bool(zero.any())
    explicit = tpipe(frames, K, np.zeros(frames.shape[:3], np.float32))
    for k in ("rotation", "translation", "bbox_xywh"):
        assert torch.equal(got[k], explicit[k]), k
    tpipe(frames, K)
    assert tpipe._zero_depth is zero


def test_quantize_backbones_without_depth_matches_jax():
    """quantize_backbones(calib_depth=None), as the JAX benchmark calls it
    for rgbd: both calibrate the depth tower on the normalized all-zero
    map (0 everywhere), with the same trees."""
    jpipe, tpipe = make_pipeline_pair("rgbd")
    frames, K, _ = _request()
    with jax.disable_jit():
        jpipe.quantize_backbones(frames, K)
    tpipe.quantize_backbones(frames, K)
    _assert_trees_close(tpipe._quantized, _port_trees(jpipe._quantized))


def test_rgb_geometric_bf16_int8_raises_in_both():
    """rgb_geometric serving bf16 crops with int8 towers: the JAX serving
    forward runs its f32 ZBackbone on the bf16 crops and lax refuses the
    mixed dtypes; the port raises TypeError too (the fault the folded mode
    mirrors, tests/test_torch_posenet_variants.py)."""
    jpipe, tpipe = make_pipeline_pair("rgb_geometric", compute_dtype=torch.bfloat16)
    frames, K, _ = _request()
    with jax.disable_jit():
        jpipe.quantize_backbones(frames, K)
        with pytest.raises(TypeError):
            jpipe(frames, K)
    tpipe.quantize_backbones(frames, K)
    with pytest.raises(TypeError, match="ZBackbone"):
        tpipe(frames, K)
