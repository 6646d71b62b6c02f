"""Repairs to the port's serving slices: a bf16 detector (YoloConfig.dtype,
the detector computing in bf16 as flax does and _detect_best feeding it
frames in its dtype), and every kernel wrapper launching under a device
guard on the input's device with that device's stream; and to the
detector's train mode: its BatchNorm updates the running statistics as
flax's (momentum 0.97 flax-side, the biased batch variance)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
from pose6d_tpu_torch import _build
from pose6d_tpu_torch.convert import (_flax_to_state_dict, init_posenet_weights,
                                     init_yolo_weights, yolo_from_jax)
from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
from pose6d_tpu_torch.models.posenet import PoseNetConfig
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8
from pose6d_tpu_torch.ops import addmin, fused_block as fb, gather_frames as gf

from torch_port_utils import random_flax_variables

# bf16 against bf16: mean error < 0.02 std, max error < 0.25 std of the
# flax map (chip_smoke.py's BF16_MEAN_REL / BF16_MAX_REL)
BF16_MEAN_REL, BF16_MAX_REL = 0.02, 0.25


def test_bf16_yolov8n_matches_flax_bf16():
    """YOLOv8n (width 0.25, depth 1/3, nc 13) in bf16 on the same weights
    and frames: flax casts parameters and inputs to bf16 at use and
    computes BatchNorm in f32; so does the port. Every raw head map agrees
    within the bf16 envelope and comes out in bf16."""
    S = 96
    jcfg = JYoloConfig(dtype=jnp.bfloat16)
    jmodel = JYoloV8(jcfg)
    variables = random_flax_variables(jmodel, jnp.zeros((1, S, S, 3)), seed=5)
    x = np.random.default_rng(0).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x, jnp.bfloat16))
    model = YoloV8(YoloConfig(dtype=torch.bfloat16))
    model.load_state_dict(yolo_from_jax(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for (tb, tc), (jb, jc) in zip(got, want):
        for t, j in ((tb, jb), (tc, jc)):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
            ref = np.asarray(j, np.float32)
            err = np.abs(t.float().numpy() - ref)
            std = ref.std()
            assert err.mean() < BF16_MEAN_REL * std and err.max() < BF16_MAX_REL * std, \
                (err.mean() / std, err.max() / std)


def test_yolo_train_mode_batch_stats_match_flax():
    """One train-mode forward of YOLOv8n (width 0.25, depth 1/3) from the
    same variables in float64 on both sides: every running mean and
    variance the port leaves equals flax's apply(train=True,
    mutable=["batch_stats"]) within 1e-6 relative (per leaf, of its largest
    magnitude). torch's own BatchNorm2d (momentum 0.1 torch-side, the
    unbiased variance) misses by orders of magnitude more."""
    S = 64
    variables = random_flax_variables(JYoloV8(JYoloConfig(num_classes=2)), jnp.zeros((1, S, S, 3)),
                                      seed=2)
    x = np.random.default_rng(1).uniform(0, 1, (3, S, S, 3))
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        jmodel = JYoloV8(JYoloConfig(num_classes=2, dtype=jnp.float64))
        _, upd = jax.jit(lambda v, im: jmodel.apply(v, im, train=True, mutable=["batch_stats"]))(
            f64(variables), jnp.asarray(x))
    want = _flax_to_state_dict({"params": {}, "batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])}, dtype=np.float64)
    stats = {k: v.numpy() for k, v in want.items() if "running_" in k}
    model = YoloV8(YoloConfig(num_classes=2, dtype=torch.float64))
    model.load_state_dict(yolo_from_jax(variables), strict=True)
    model = model.double().train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    got = model.state_dict()
    assert len(stats) == sum(1 for k in got if "running_" in k) == 2 * 57
    for k, w in stats.items():
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= 1e-6 * float(np.abs(w).max()), f"{k}: max err {err:.3g}"


def test_pipeline_feeds_the_detector_its_dtype():
    """_detect_best casts the frames to the detector's dtype: bf16 frames
    to an f32 detector, f32 frames to a bf16 one. The configs' variant
    defaults are the JAX package's ("rgb")."""
    assert PipelineConfig().variant == PoseNetConfig().variant == "rgb"
    seen = []
    for yolo_dtype, compute in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        ycfg = YoloConfig(num_classes=2, width=0.125, dtype=yolo_dtype)
        pcfg = PoseNetConfig(variant="rgb", img_size=32)
        pipe = PosePipeline(PipelineConfig(variant="rgb", img_size=32, conf_thresh=0.0,
                                           compute_dtype=compute),
                            ycfg, init_yolo_weights(ycfg, 1), init_posenet_weights(pcfg, 2),
                            pcfg, device="cpu")
        pipe.yolo.register_forward_hook(lambda m, a, out: seen.append((a[0].dtype, out[0][0].dtype)))
        frames = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        out = pipe(frames, np.eye(3, dtype=np.float32))
        assert torch.isfinite(out["rotation"]).all()
    assert seen == [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)]


class _Guard:
    """Stands in for torch.cuda.device: records the devices made current."""

    active: list = []

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _Guard.active.append(self.device)

    def __exit__(self, *exc):
        _Guard.active.pop()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _stage_weights_meta(stage):
    return tuple(_meta(*s) for s in fb._stage_shapes(stage))


WRAPPERS = {
    "fused_stem": ("_launch_stem", lambda: fb.fused_stem(
        _meta(2, 224, 224, 3), (_meta(7, 7, 3, 64), _meta(64))), "fused_stem_c3"),
    "fused_layer1": ("_launch_stage", lambda: fb.fused_layer1(
        _meta(2, 56, 56, 64), _stage_weights_meta(1)), "fused_layer1"),
    "fused_stage": ("_launch_stage", lambda: fb.fused_stage(
        _meta(2, 14, 14, 1024), _stage_weights_meta(4), 4), "fused_stage_s4"),
    "pairwise_min_dist_kernel": ("_launch_addmin", lambda: addmin.pairwise_min_dist_kernel(
        _meta(2, 50, 3), _meta(2, 50, 3)), "pairwise_min_dist"),
    "gather_rows_u32": ("_launch_gather", lambda: gf.gather_rows_u32(
        _meta(8, 256, dtype=torch.int32), _meta(4, dtype=torch.int64)), "gather_rows_u32"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_launches_under_the_device_guard(monkeypatch, name):
    """Each wrapper makes its input's device current around the launch and
    passes that device's stream (tensors on the meta device stand in for a
    card's; the card check, the guard, the stream and the launch are
    patched)."""
    launch, call, key = WRAPPERS[name]
    module = {"_launch_stem": fb, "_launch_stage": fb, "_launch_addmin": addmin,
              "_launch_gather": gf}[launch]
    calls = []
    monkeypatch.setattr(_build, "check_on_card", lambda x, tensors=(): None)
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=(device, 1234)))
    monkeypatch.setattr(module, launch, lambda *args: calls.append((list(_Guard.active), args[-1])))
    before = _build.launch_counts[key]
    call()
    assert calls == [([torch.device("meta")], (torch.device("meta"), 1234))]
    assert _build.launch_counts[key] == before + 1
