"""The rgbd train step on a mesh equals the one-process step (LayerNorm /
GELU heads and fusion, the LayerNorm after each column-parallel layer
reduced over the model group, the attention dropout): see
torch_parallel_steps.check_mesh_step."""

import pytest

from torch_parallel_steps import MESHES, check_mesh_step, reference_steps  # noqa: F401


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_mesh_step_equals_one_process_step(reference_steps, tmp_path, mesh_shape):
    check_mesh_step(reference_steps, tmp_path, "rgbd", mesh_shape)
