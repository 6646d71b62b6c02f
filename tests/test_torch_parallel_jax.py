"""The port's sharded serving against the JAX package's: the rgbd
PosePipeline.shard on (2, 2) against JAX's PosePipeline.shard on a (2, 2)
mesh of the virtual CPU devices (assert_pipeline_parity), float and folded;
then the int8 calibration under a mesh: quantize_backbones before or after
shard gives every rank the one-process scales. (The (2, 2) train step
against JAX's float64 step is in test_torch_train_step_rgb.py, which
compiles that JAX step once for both.)"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_utils as U
from torch_port_utils import (assert_pipeline_parity, make_pipeline_pair, pipeline_request,
                              pipeline_weights)

B = 4


@pytest.fixture(scope="module")
def shard_request(tmp_path_factory):
    """The pipelines' weights on disk for the ranks, and a request of B
    frames at 64 x 64 (B divides the data axis)."""
    _, _, ystate, pstate = pipeline_weights("rgbd")
    path = str(tmp_path_factory.mktemp("weights") / "rgbd.pt")
    torch.save((ystate, pstate), path)
    return path, pipeline_request(3, (U.S, U.S), B)


@pytest.mark.parametrize("mode", ["float", "folded"])
def test_sharded_pipeline_matches_jax_shard(shard_request, tmp_path, mode):
    from pose6d_tpu.parallel import make_mesh as jax_make_mesh

    path, (frames, K, depth) = shard_request
    jpipe, _ = make_pipeline_pair("rgbd")
    jpipe.shard(jax_make_mesh((2, 2), devices=jax.devices()[:4]))
    if mode == "folded":
        jpipe.fold_backbones()
    want = jpipe(frames, K, depth)  # jitted: sharded, op by op takes several times longer
    runs = U.run_world(U.pipeline_rank, 4, tmp_path, path, (2, 2), frames, K, depth, mode)
    assert len({r["digest"] for r in runs}) == 1, "the ranks return different outputs"
    got = {k: torch.from_numpy(v) for k, v in runs[0]["out"].items()}
    assert got["rotation"].shape == (B, 4)
    assert_pipeline_parity(got, want)


def test_sharded_int8_calibration_is_the_one_process_one(shard_request, tmp_path):
    """quantize_backbones on (2, 1), after shard (each rank calibrates on
    its rows, the abs maxes reduced with MAX) and before it: every rank's
    activation scales and int8 outputs equal the one-process pipeline's
    bit for bit, the reference run on one thread as the ranks run (with
    more threads oneDNN rounds the detector's f32 convolutions otherwise,
    the boxes move by 5e-5 px and the int8 codes of the crops with them)."""
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    path, (frames, K, depth) = shard_request
    ystate, pstate = torch.load(path, weights_only=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipe = PosePipeline(PipelineConfig(variant="rgbd", img_size=U.S, conf_thresh=0.0,
                                           compute_dtype=torch.float32),
                            YoloConfig(num_classes=2, width=0.125), ystate, pstate,
                            PoseNetConfig(variant="rgbd", img_size=U.S), device="cpu")
        pipe.quantize_backbones(frames, K, depth)
        want = pipe(frames, K, depth)
    finally:
        torch.set_num_threads(threads)
    scales = {name: {conv: float(e["a"]) for conv, e in tree.items()}
              for name, tree in pipe._quantized.items()}
    for mode in ("int8-after", "int8-before"):
        runs = U.run_world(U.pipeline_rank, 2, tmp_path, path, (2, 1), frames, K, depth, mode)
        for r in runs:
            assert r["scales"] == scales, mode
            for k, v in r["out"].items():
                np.testing.assert_array_equal(v, want[k].numpy(), err_msg=f"{mode} {k}")
