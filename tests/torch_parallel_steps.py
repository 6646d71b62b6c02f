"""The comparison behind tests/test_torch_parallel_step_{rgb,rgbd}.py.

One device-preprocess train step (torch_parallel_utils.train_step_run:
the flax init from a seed, global batch BATCH at 64 px, dropout and
augmentation on, the gather and the crop of the resident split, clipping
and AdamW) runs on a mesh of 2 or 4 gloo processes and in one process, in
float64 and in f32, from the same seed, batch and generator.

float64: the loss, the gradient norm, every gradient leaf (after the
clipping, as the optimizer saw it) and every parameter and BatchNorm
statistic after the step agree to 1e-10 relative per leaf; f32, on the
(2, 2) mesh (both axes at once): the gradient leaves to 1e-4 relative, the
loss to 1e-5 (torch_parallel_utils.compare_step, which rank 0 runs against
the reference in shared memory; it also says how the zero-gradient leaves
are held). In both, the ranks that hold the same parameters (one data
group) end the step with equal bits (a digest of their parameters and
buffers), and so do every rank's replicated tensors."""

from __future__ import annotations

import pytest
import torch

import torch_parallel_utils as U

MESHES = [(2, 1), (1, 2), (4, 1), (2, 2)]
BATCH = 8
DTYPES = (torch.float64, torch.float32)


@pytest.fixture(scope="module")
def reference_steps(request):
    """The one-process steps of the module's variant, their tensors in
    shared memory for the mesh runs' rank 0 to read."""
    variant = request.module.__name__.rpartition("_")[2]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    init = U.initial_state(variant)
    refs = {}
    for dtype in DTYPES:
        ref = U.train_step_run(variant, BATCH, dtype, init)
        if dtype == torch.float32:
            del ref["state"]  # f32 holds the gradients only
        for kind in ("grads", "state"):
            for t in ref.get(kind, {}).values():
                t.share_memory_()
        refs[dtype] = ref
    torch.set_num_threads(before)
    return variant, init, refs


def check_mesh_step(reference_steps, tmp_path, variant, mesh_shape):
    ref_variant, init, refs = reference_steps
    assert ref_variant == variant
    world = mesh_shape[0] * mesh_shape[1]
    refs = refs if mesh_shape == (2, 2) else {torch.float64: refs[torch.float64]}
    runs = U.run_world(U.train_step_rank, world, tmp_path, variant, BATCH, init, refs,
                       mesh_shape)
    for dtype in refs:
        res = runs[0][dtype]
        assert not res["errors"], (dtype, res["errors"][:10], res["worst"])
        digests = {}
        for r in runs:
            digests.setdefault(r[dtype]["model_index"], set()).add(r[dtype]["digest"])
        assert len(digests) == mesh_shape[1] and all(len(v) == 1 for v in digests.values()), \
            f"{dtype}: the replicas of a data group differ"
        assert len({r[dtype]["replicated"] for r in runs}) == 1, \
            f"{dtype}: the replicated tensors differ between ranks"
