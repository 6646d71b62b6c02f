"""pose6d_tpu_torch.ops.fused_block (stem and layer1) against the JAX
package's plain versions and its Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain versions; the same random
BN-folded trees (HWIO in JAX, OIHW in the port) go through both packers.
f32: rtol/atol 1e-5. bf16: the port's bf16 path stays within the bf16
envelope of the f32 oracle (mean error < 0.02 std, max < 0.25 std), as
tests/test_pallas_block.py holds the Pallas kernels. The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.ops import pallas_block as jpb
from pose6d_tpu_torch.ops import fused_block as tfb


def _tree(rng, specs, scale=0.05):
    """{name: {"w": HWIO, "b"}} numpy (JAX layout) and the port's OIHW twin."""
    jtree, ttree = {}, {}
    for name, (k, ci, co) in specs.items():
        w = rng.standard_normal((k, k, ci, co)).astype(np.float32) * scale
        b = rng.standard_normal((co,)).astype(np.float32) * scale
        jtree[name] = {"w": w, "b": b}
        ttree[name] = {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                       "b": torch.from_numpy(b)}
    return jtree, ttree


def _stem_trees(rng, C):
    return _tree(rng, {"conv1": (7, C, 64)})


def _layer1_trees(rng):
    specs = {}
    for j in range(3):
        specs[f"layer1_{j}/conv1"] = (1, 64 if j == 0 else 256, 64)
        specs[f"layer1_{j}/conv2"] = (3, 64, 64)
        specs[f"layer1_{j}/conv3"] = (1, 64, 256)
    specs["layer1_0/downsample"] = (1, 64, 256)
    return _tree(rng, specs)


@pytest.mark.parametrize("batch,C", [(1, 3), (2, 3), (1, 1), (2, 1)])
def test_stem_matches_jax_reference_and_pallas(rng, batch, C):
    jtree, ttree = _stem_trees(rng, C)
    x = rng.standard_normal((batch, 224, 224, C)).astype(np.float32)
    got = tfb.fused_stem(torch.from_numpy(x), tfb.pack_stem_weights(ttree, torch.float32))
    assert got.shape == (batch, 56, 56, 64) and got.dtype == torch.float32
    want = np.asarray(jpb.reference_stem(jnp.asarray(x), jtree, jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jpb.fused_stem(jnp.asarray(x), jpb.pack_stem_weights(jtree, jnp.float32),
                                       dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [3, 1])
def test_stem_edges_zero_padded(rng, C):
    """A constant image exposes any mismatch in conv1's pad-3 border or the
    pool's pad-1 border."""
    jtree, ttree = _stem_trees(rng, C)
    x = np.ones((1, 224, 224, C), np.float32)
    got = tfb.fused_stem(torch.from_numpy(x), tfb.pack_stem_weights(ttree, torch.float32)).numpy()
    want = np.asarray(jpb.fused_stem(jnp.asarray(x), jpb.pack_stem_weights(jtree, jnp.float32),
                                     dtype=jnp.float32, interpret=True))
    for edge in (np.s_[0, [0, -1], :, :], np.s_[0, :, [0, -1], :]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=1e-5, atol=1e-5)


def test_stem_bf16_close_to_f32_oracle(rng):
    jtree, ttree = _stem_trees(rng, 3)
    x = torch.from_numpy(rng.standard_normal((1, 224, 224, 3)).astype(np.float32)).bfloat16()
    got = tfb.fused_stem(x, tfb.pack_stem_weights(ttree, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jpb.reference_stem(jnp.asarray(x.float().numpy()), jtree, jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert err.mean() < 0.02 * want.std() and err.max() < 0.25 * want.std()


@pytest.mark.parametrize("batch", [1, 2])
def test_layer1_matches_jax_reference_and_pallas(rng, batch):
    jtree, ttree = _layer1_trees(rng)
    x = rng.standard_normal((batch, 56, 56, 64)).astype(np.float32)
    packed = tfb.pack_layer1_weights(ttree, torch.float32)
    # the port packs exactly the JAX layout
    for a, b in zip(packed, jpb.pack_layer1_weights(jtree, jnp.float32)):
        np.testing.assert_array_equal(a.numpy().reshape(np.shape(b)), np.asarray(b))
    got = tfb.fused_layer1(torch.from_numpy(x), packed)
    assert got.shape == (batch, 56, 56, 256)
    want = np.asarray(jpb.reference_layer1(jnp.asarray(x), jtree, jnp.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jpb.fused_layer1(jnp.asarray(x), jpb.pack_layer1_weights(jtree, jnp.float32),
                                         dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)


def test_layer1_edge_pixels_zero_padded(rng):
    jtree, ttree = _layer1_trees(rng)
    x = np.ones((1, 56, 56, 64), np.float32)
    got = tfb.fused_layer1(torch.from_numpy(x), tfb.pack_layer1_weights(ttree, torch.float32)).numpy()
    want = np.asarray(jpb.reference_layer1(jnp.asarray(x), jtree, jnp.float32))
    for edge in (np.s_[0, [0, -1], :, :], np.s_[0, :, [0, -1], :]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=1e-5, atol=1e-5)


def test_layer1_bf16_close_to_f32_oracle(rng):
    jtree, ttree = _layer1_trees(rng)
    x = torch.from_numpy(rng.standard_normal((2, 56, 56, 64)).astype(np.float32)).bfloat16()
    got = tfb.fused_layer1(x, tfb.pack_layer1_weights(ttree, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jpb.reference_layer1(jnp.asarray(x.float().numpy()), jtree, jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert err.mean() < 0.02 * want.std() and err.max() < 0.25 * want.std()


@pytest.mark.parametrize("case", ["dtype", "shape", "weight_dtype", "weight_shape"])
def test_wrappers_refuse_what_the_kernels_do_not_take(rng, case):
    _, stree = _stem_trees(rng, 3)
    _, ltree = _layer1_trees(rng)
    x = torch.zeros(1, 224, 224, 3)
    sw = tfb.pack_stem_weights(stree, torch.float32)
    h = torch.zeros(1, 56, 56, 64)
    lw = tfb.pack_layer1_weights(ltree, torch.float32)
    if case == "dtype":
        calls = [lambda: tfb.fused_stem(x.half(), sw), lambda: tfb.fused_layer1(h.double(), lw)]
        err = TypeError
    elif case == "shape":
        calls = [lambda: tfb.fused_stem(torch.zeros(1, 112, 112, 3), sw),
                 lambda: tfb.fused_layer1(torch.zeros(1, 28, 28, 64), lw)]
        err = ValueError
    elif case == "weight_dtype":
        calls = [lambda: tfb.fused_stem(x, tfb.pack_stem_weights(stree, torch.bfloat16)),
                 lambda: tfb.fused_layer1(h, tfb.pack_layer1_weights(ltree, torch.bfloat16))]
        err = TypeError
    else:
        calls = [lambda: tfb.fused_stem(torch.zeros(1, 224, 224, 1), sw),
                 lambda: tfb.fused_layer1(h, lw[:-1])]
        err = ValueError
    for call in calls:
        with pytest.raises(err):
            call()
