"""The port's sharded serving against the JAX package's: the rgbd
PosePipeline.shard on (2, 2) against JAX's PosePipeline.shard on a (2, 2)
mesh of the virtual CPU devices (assert_pipeline_parity), float and folded;
the float pipeline at compute bf16 built without pose_cfg (its towers bf16,
the JAX pipeline's default), served in the float case's world, against
JAX's sharded one and the port's one-process one within MULT times JAX's
own bf16 spread plus FLOOR (test_torch_bf16_serving.py's MULT and FLOOR);
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
MULT, FLOOR = 2.0, 1e-5  # test_torch_bf16_serving.py's


@pytest.fixture(scope="module")
def shard_request(tmp_path_factory):
    """The pipelines' weights on disk for the ranks, and a request of B
    frames at 64 x 64 (B divides the data axis)."""
    _, _, ystate, pstate = pipeline_weights("rgbd")
    path = str(tmp_path_factory.mktemp("weights") / "rgbd.pt")
    torch.save((ystate, pstate), path)
    return path, pipeline_request(3, (U.S, U.S), B)


@pytest.fixture(scope="module")
def float_world(shard_request, tmp_path_factory):
    """One (2, 2) world serving the "float" and "float-bf16" modes of
    pipeline_rank: each rank's {mode: its return}."""
    path, (frames, K, depth) = shard_request
    return U.run_world(U.pipeline_rank, 4, tmp_path_factory.mktemp("float_world"), path, (2, 2),
                       frames, K, depth, ("float", "float-bf16"))


@pytest.mark.parametrize("mode", ["float", "folded"])
def test_sharded_pipeline_matches_jax_shard(shard_request, tmp_path, mode, request):
    from pose6d_tpu.parallel import make_mesh as jax_make_mesh

    path, (frames, K, depth) = shard_request
    jpipe, _ = make_pipeline_pair("rgbd")
    jpipe.shard(jax_make_mesh((2, 2), devices=jax.devices()[:4]))
    if mode == "folded":
        jpipe.fold_backbones()
    want = jpipe(frames, K, depth)  # jitted: sharded, op by op takes several times longer
    if mode == "float":
        runs = [r[mode] for r in request.getfixturevalue("float_world")]
    else:
        runs = U.run_world(U.pipeline_rank, 4, tmp_path, path, (2, 2), frames, K, depth, mode)
    assert len({r["digest"] for r in runs}) == 1, "the ranks return different outputs"
    got = {k: torch.from_numpy(v) for k, v in runs[0]["out"].items()}
    assert got["rotation"].shape == (B, 4)
    assert_pipeline_parity(got, want)


def _dist(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_sharded_bf16_towers_match_jax_shard(shard_request, float_world):
    """The float pipeline at compute bf16 without pose_cfg on (2, 2): the
    towers' conv outputs bf16 in every rank, the ranks' outputs equal, and
    rotation and translation within MULT times JAX's own bf16 spread plus
    FLOOR of JAX's sharded pipeline, built the same way, and of the port's
    one-process one; boxes, scores, classes and validity at
    assert_pipeline_parity's tolerances. JAX's spread is the largest
    distance between its own jitted builds at compute bf16: f32 towers,
    bf16 towers, and bf16 towers sharded. Its bf16-from-f32 distance alone
    is no yardstick here: at this request JAX's sharded and unsharded bf16
    pipelines lie 1.24x that distance apart, and its unsharded one lies
    2.42e-2 from the same pipeline run op by op, 2.4x the op-by-op run's
    own bf16-from-f32 distance."""
    from pose6d_tpu.infer import PosePipeline as JPosePipeline
    from pose6d_tpu.parallel import make_mesh as jax_make_mesh
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    path, (frames, K, depth) = shard_request
    runs = [r["float-bf16"] for r in float_world]
    for r in runs:
        assert r["tower_dtypes"] == [torch.bfloat16] * 2
    assert len({r["digest"] for r in runs}) == 1, "the ranks return different outputs"
    got = runs[0]["out"]

    jf32, _ = make_pipeline_pair("rgbd", compute_dtype=torch.bfloat16)  # f32 towers
    jargs = (jf32.cfg, jf32.yolo_cfg, jf32.yolo_variables, jf32.pose_variables)
    jbf16 = JPosePipeline(*jargs)
    assert jbf16.pose_cfg.dtype == jax.numpy.bfloat16
    want = JPosePipeline(*jargs).shard(jax_make_mesh((2, 2), devices=jax.devices()[:4]))(
        frames, K, depth)
    builds = [jf32(frames, K, depth), jbf16(frames, K, depth), want]
    yard = {k: max(_dist(a[k], b[k]) for i, a in enumerate(builds) for b in builds[i + 1:])
            for k in ("rotation", "translation")}

    ystate, pstate = torch.load(path, weights_only=True)
    one = PosePipeline(PipelineConfig(variant="rgbd", img_size=U.S, conf_thresh=0.0,
                                      compute_dtype=torch.bfloat16),
                       YoloConfig(num_classes=2, width=0.125), ystate, pstate, device="cpu")
    assert one.pose_cfg.dtype == torch.bfloat16
    local = {k: v.float() if v.is_floating_point() else v
             for k, v in one(frames, K, depth).items() if k != "detections"}
    for ref, what in ((want, "JAX's sharded pipeline"), (local, "the one-process pipeline")):
        ref = {k: np.asarray(v) for k, v in ref.items() if k != "detections"}
        for k, atol in (("bbox_xywh", 1e-3), ("det_score", 1e-5)):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=f"{k}, {what}")
        for k in ("class_id", "det_valid"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{k}, {what}")
        for k, y in yard.items():
            d = _dist(got[k], ref[k])
            assert d <= MULT * y + FLOOR, f"{k}: {d:.3g} from {what}, JAX's bf16 spread {y:.3g}"


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
