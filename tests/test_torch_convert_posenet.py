"""pose6d_tpu_torch.models.convert_posenet (the reference's PoseNet*
checkpoints <-> the port's PoseNet) against the JAX package, all four
variants.

The reference's own checkout is not in this repository, so the JAX
package's posenet_flax_to_torch, applied to a seeded flax tree (every
BatchNorm randomised), is the oracle for the reference's key layout. For
each variant: posenet_from_reference is bit-equal to
convert.posenet_from_jax(posenet_torch_to_flax(...)); posenet_to_reference
gives posenet_flax_to_torch's key set with bit-equal values; port ->
reference -> port is the identity; and the port's PoseNet on the converted
weights matches the JAX PoseNet on the tree at 64 px within atol 1e-4 (the
bound of tests/test_torch_posenet_variants.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.convert_posenet import posenet_flax_to_torch, posenet_torch_to_flax
from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu_torch.convert import posenet_from_jax
from pose6d_tpu_torch.models.convert_posenet import posenet_from_reference, posenet_to_reference
from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig

from torch_port_utils import few_torch_threads, random_flax_variables  # noqa: F401

S, B = 64, 2
ATOL = 1e-4
VARIANTS = ("rgb", "rgb_geometric", "rgbd", "rgbd_geometric")


def _inputs(variant, seed=0):
    rng = np.random.default_rng(seed)
    inputs = {"rgb": rng.standard_normal((B, S, S, 3)).astype(np.float32)}
    if variant == "rgbd":
        inputs["depth"] = rng.uniform(0, 1, (B, S, S, 1)).astype(np.float32)
    if variant.endswith("geometric"):
        inputs["bbox_center"] = rng.uniform(4, S - 4, (B, 2)).astype(np.float32)
        K = np.array([[150.0, 0, S / 2], [0, 160.0, S / 2], [0, 0, 1]], np.float32)
        inputs["camera_matrix"] = np.repeat(K[None], B, 0)
    if variant == "rgbd_geometric":
        inputs["depth_raw"] = rng.uniform(0.3, 1.5, (B, S, S)).astype(np.float32)
    return inputs


def _equal(a: dict, b: dict):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:8]
    for k in a:
        x = a[k] if isinstance(a[k], torch.Tensor) else torch.from_numpy(np.asarray(a[k]))
        y = b[k] if isinstance(b[k], torch.Tensor) else torch.from_numpy(np.asarray(b[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        assert torch.equal(x, y), k


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_interop_matches_jax(variant):
    jmodel = JPoseNet(JPoseNetConfig(variant=variant, img_size=S))
    inputs = _inputs(variant)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    variables = random_flax_variables(jmodel, seed=3, **jin)
    ref_sd = posenet_flax_to_torch(variant, variables)

    state = posenet_from_reference(variant, ref_sd)
    _equal(state, posenet_from_jax(posenet_torch_to_flax(variant, ref_sd)))
    _equal(posenet_to_reference(variant, state), ref_sd)
    _equal(posenet_from_reference(variant, posenet_to_reference(variant, state)), state)
    # torch tensors in, as a .pth holds them
    _equal(posenet_from_reference(variant, {k: torch.from_numpy(np.asarray(v))
                                            for k, v in ref_sd.items()}), state)

    model = PoseNet(PoseNetConfig(variant=variant, img_size=S)).eval()
    model.load_state_dict(state, strict=True)
    want = jmodel.apply(variables, **jin)
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_missing_reference_key_raises():
    jmodel = JPoseNet(JPoseNetConfig(variant="rgbd_geometric", img_size=S))
    jin = {k: jnp.asarray(v) for k, v in _inputs("rgbd_geometric").items()}
    ref_sd = posenet_flax_to_torch("rgbd_geometric", random_flax_variables(jmodel, **jin))
    del ref_sd["rot_head.4.weight"]
    with pytest.raises(KeyError):
        posenet_from_reference("rgbd_geometric", ref_sd)
