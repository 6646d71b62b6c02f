"""One train step of the single-tower variants (rgb, rgb_geometric) of
pose6d_tpu_torch against pose6d_tpu's make_train_step, from shared flax
weights with dropout and augmentation off: loss, gradient global norm,
every gradient leaf and the updated BN statistics (tolerances and why the
reference runs in float64: torch_port_utils.one_train_step_both and
assert_train_step_parity); the eval step's metrics against make_eval_step
(rgb_geometric, whose deployed metric is its own); and the rgb step on a
(2, 2) mesh of four gloo processes against the same JAX step (here, so
that the JAX float64 step compiles once for both)."""

import types

import pytest
import torch

import torch_parallel_utils as U
from torch_port_utils import (assert_eval_parity, assert_train_step_parity, eval_step_both,
                              one_train_step_both)

_JAX_RGB = {}  # the rgb JAX step, its variables and batch, for the mesh test


@pytest.mark.parametrize("variant", ["rgb", "rgb_geometric"])
def test_one_step_matches_jax(variant):
    jax_out, runs, variables, batch = one_train_step_both(variant)
    assert_train_step_parity(jax_out, runs)
    if variant == "rgb":
        _JAX_RGB["rgb"] = (jax_out, variables, batch)
    if variant == "rgb_geometric":
        assert_eval_parity(*eval_step_both(variant, variables, batch))


def test_mesh_step_matches_jax_float64_step(tmp_path):
    """The port's rgb step on (2, 2) (torch_parallel_utils.jax_step_rank,
    f32 and float64, dropout and augmentation off as the one-process
    harness runs them) held by assert_train_step_parity to the JAX float64
    step, with the one-process step's bounds."""
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig

    if "rgb" not in _JAX_RGB:  # run alone
        jax_out, _, variables, batch = one_train_step_both("rgb")
        _JAX_RGB["rgb"] = (jax_out, variables, batch)
    jax_out, variables, batch = _JAX_RGB.pop("rgb")
    runs = U.run_world(U.jax_step_rank, 4, tmp_path, "rgb", posenet_from_jax(variables), batch,
                       (2, 2))[0]
    mesh_runs = {}
    for dtype, r in runs.items():
        model = PoseNet(PoseNetConfig(variant="rgb", img_size=U.S)).to(dtype)
        model.load_state_dict(r["state"], strict=True)
        for n, p in model.named_parameters():
            p.grad = r["grads"][n]
        mesh_runs[dtype] = (types.SimpleNamespace(model=model),
                            {"loss": r["loss"], "grad_norm": r["grad_norm"]})
    assert_train_step_parity(jax_out, mesh_runs)
    assert set(mesh_runs) == {torch.float32, torch.float64}
