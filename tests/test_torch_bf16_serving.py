"""The float pipeline's towers in the compute dtype, and the last public
options of the JAX package, against pose6d_tpu.

bf16 towers: PoseNetConfig(dtype=torch.bfloat16) runs the ResNet50 towers
under autocast as flax's PoseNet(dtype=jnp.bfloat16) runs them, the
parameters, BN statistics and heads f32. The yardstick is JAX's own
rounding: on the same weights and inputs, the port's bf16 output may lie
at most MULT times as far from JAX's bf16 output as JAX's bf16 output lies
from JAX's f32 one, plus FLOOR. MULT is 2, the triangle inequality's bound
for two bf16 computations each as close to f32 as JAX's is. Held so: the
four variants' PoseNet and a stem_s2d rgb one (rotation, translation and
each tower's features), at PIPE_IMG, batch 2, on flax weights with every
BatchNorm randomised; the rgb and rgbd pipelines at compute bf16 (narrow
YOLOv8, f32 detector, 64x64 frames, the JAX pipeline op by op under
jax.disable_jit) in rotation and translation, their boxes, scores, classes
and validity within assert_pipeline_parity's tolerances. A pipeline built
without pose_cfg serves its towers in compute_dtype; an explicit
PoseNetConfig keeps its own dtype.

The options: percentile calibration (abs_percentile on JAX's activations
within 1e-6 relative of numpy's float64 percentile, also above 2**24
elements; the tower's scales within the abs-max test's 1e-5 of that rule
on JAX's activations and of JAX's scales; a (2, 1) mesh calibrating
to the one-process scales), nms_top1_fast=False (slot 0 equal
to the fast path's, the general decode's detections against JAX's),
src_scale (1/255 on uint8-valued frames, full and windowed, f32 and bf16),
quantize_yolo_folded / yolo_int8_forward (codes equal to JAX's on the same
fold, the forward equal to yolo_int8_model and within the int8 test's
rel-L2 of JAX's), and the single-image color_jitter, random_grayscale and
random_erasing (their batch forms on a batch of one; JAX's grayscale and
erasing at the settings where no draw decides).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_utils as U
from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
from pose6d_tpu_torch.convert import (init_posenet_weights, init_yolo_weights, posenet_from_jax,
                                      quantized_from_jax, yolo_from_jax)
from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8

from torch_port_utils import (PIPE_IMG, few_torch_threads,  # noqa: F401
                              make_pipeline_pair, pipeline_request, pipeline_weights,
                              random_flax_variables)

S, B = PIPE_IMG, 2
MULT = 2.0
FLOOR = 1e-5
PERCENTILE = 99.9


def _dist(a, b) -> float:
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
    b = b.float().numpy() if torch.is_tensor(b) else np.asarray(b, np.float32)
    assert a.shape == b.shape
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def _within_jax_rounding(got, want, want_f32, what: str) -> None:
    """|got - want| <= MULT |want - want_f32| + FLOOR, in max abs."""
    d, yard = _dist(got, want), _dist(want, want_f32)
    assert d <= MULT * yard + FLOOR, f"{what}: port bf16 {d:.3g} from JAX bf16, JAX bf16 " \
                                     f"{yard:.3g} from JAX f32"


# ------------------------------------------------------------ bf16 pipelines

@functools.lru_cache(maxsize=None)
def bf16_run(variant: str):
    """(the request's args, the port's bf16 pipeline, its outputs, JAX's
    bf16 outputs, JAX's outputs with f32 towers): compute bf16 in every
    run, so that only the towers' dtype parts the two JAX runs."""
    from pose6d_tpu.infer import PosePipeline as JPosePipeline

    frames, K, depth = pipeline_request(0, (S, S), B)
    args = (frames, K, depth) if variant == "rgbd" else (frames, K)
    jpipe, tpipe = make_pipeline_pair(variant, compute_dtype=torch.bfloat16,
                                      pose_dtype=torch.bfloat16)
    jpipe_f32 = JPosePipeline(jpipe.cfg, jpipe.yolo_cfg, jpipe.yolo_variables,
                              jpipe.pose_variables,
                              dataclasses.replace(jpipe.pose_cfg, dtype=jnp.float32))
    with jax.disable_jit():
        want, want_f32 = jpipe(*args), jpipe_f32(*args)
    return args, tpipe, tpipe(*args), want, want_f32


@pytest.mark.parametrize("variant", ["rgbd", "rgb"])
def test_bf16_pipeline_matches_jax(variant):
    """The rgb and rgbd pipelines with bf16 towers against JAX's: the
    detector's outputs at assert_pipeline_parity's tolerances, rotation and
    translation within JAX's own bf16 rounding, the towers bf16."""
    args, tpipe, got, want, want_f32 = bf16_run(variant)
    assert tpipe.pose_cfg.dtype == torch.bfloat16
    for k in ("bbox_xywh", "det_score"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-3 if k == "bbox_xywh" else 1e-5, err_msg=k)
    for k in ("class_id", "det_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    _within_jax_rounding(got["rotation"], want["rotation"], want_f32["rotation"], "rotation")
    _within_jax_rounding(got["translation"], want["translation"], want_f32["translation"],
                         "translation")
    seen = []
    hooks = [getattr(tpipe.posenet, name).layer4_2.conv3.register_forward_hook(
        lambda m, a, out: seen.append(out.dtype)) for name in tpipe.posenet.towers]
    again = tpipe(*args)
    for h in hooks:
        h.remove()
    assert seen == [torch.bfloat16] * len(tpipe.posenet.towers)
    assert torch.equal(again["rotation"], got["rotation"])


def test_nms_top1_fast_false_keeps_slot_0():
    """nms_top1_fast=False decodes max_objects=1 through the general NMS
    with max_det max(8, M): its detections against JAX's with the same
    flag, and every per-object output of the rgb pipeline equal to the
    fast path's (slot 0 of the general NMS is the global best)."""
    args, _, fast, _, _ = bf16_run("rgb")
    jpipe, tpipe = make_pipeline_pair("rgb", compute_dtype=torch.bfloat16,
                                      pose_dtype=torch.bfloat16, nms_top1_fast=False)
    with jax.disable_jit():
        want = jpipe(*args)
    got = tpipe(*args)
    assert fast["detections"]["boxes"].shape == (B, 1, 4)
    assert got["detections"]["boxes"].shape == (B, 8, 4)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got["detections"][k].numpy(),
                                   np.asarray(want["detections"][k]), rtol=0,
                                   atol=1e-3 if k == "boxes" else 1e-5, err_msg=k)
    for k in ("classes", "valid"):
        np.testing.assert_array_equal(got["detections"][k].numpy(),
                                      np.asarray(want["detections"][k]), err_msg=k)
    for k, v in fast.items():
        if k != "detections":
            assert torch.equal(got[k], v), k
    for k, v in fast["detections"].items():
        assert torch.equal(got["detections"][k][:, :1], v), k


# ------------------------------------------------------- PoseNet, bf16 towers

def _posenet_inputs(variant: str, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    inputs = {"rgb": rng.standard_normal((B, S, S, 3)).astype(np.float32)}
    if variant == "rgbd":
        inputs["depth"] = rng.uniform(0, 1, (B, S, S, 1)).astype(np.float32)
    if variant in ("rgb_geometric", "rgbd_geometric"):
        inputs["bbox_center"] = rng.uniform(4, S - 4, (B, 2)).astype(np.float32)
        K = np.array([[150.0, 0, S / 2], [0, 160.0, S / 2 - 2], [0, 0, 1]], np.float32)
        inputs["camera_matrix"] = np.repeat(K[None], B, 0)
    if variant == "rgbd_geometric":
        inputs["depth_raw"] = rng.uniform(0.3, 1.5, (B, S, S)).astype(np.float32)
    return inputs


@pytest.mark.parametrize("variant,s2d", [("rgb", False), ("rgb_geometric", False),
                                         ("rgbd", False), ("rgbd_geometric", False),
                                         ("rgb", True)],
                         ids=["rgb", "rgb_geometric", "rgbd", "rgbd_geometric", "rgb_s2d"])
def test_bf16_posenet_matches_flax(variant, s2d):
    """PoseNet(PoseNetConfig(dtype=bfloat16)) against flax's PoseNet(dtype=
    jnp.bfloat16) on the same weights: rotation, translation and each
    tower's features within JAX's own bf16 rounding; the port's features
    are bf16 values, its parameters and BN statistics stay f32."""
    jcfg = JPoseNetConfig(variant=variant, img_size=S, stem_s2d=s2d)
    if s2d:
        variables = random_flax_variables(JPoseNet(jcfg), jnp.zeros((1, S, S, 3)), seed=3)
        state = posenet_from_jax(variables)
    else:
        _, variables, _, state = pipeline_weights(variant)
    inputs = _posenet_inputs(variant)
    # the image inputs in bf16, as the bf16 pipeline's crops come
    jin = {k: jnp.asarray(v, jnp.bfloat16 if k in ("rgb", "depth") else jnp.float32)
           for k, v in inputs.items()}
    towers = ("rgb_backbone", "depth_backbone") if variant == "rgbd" else ("backbone",)
    jax_out = {}
    for dt in (jnp.bfloat16, jnp.float32):
        with jax.disable_jit():  # op by op, sharing the pipelines' compiled ops
            (rot, trans), seen = JPoseNet(dataclasses.replace(jcfg, dtype=dt)).apply(
                variables, **jin, mutable=["intermediates"],
                capture_intermediates=lambda m, fn: fn == "__call__" and m.name in towers)
        feats = {name: seen["intermediates"][name]["__call__"][0] for name in towers}
        jax_out[dt] = (rot, trans, feats)

    with torch.device("meta"):
        model = PoseNet(PoseNetConfig(variant=variant, img_size=S, stem_s2d=s2d,
                                      dtype=torch.bfloat16))
    model.load_state_dict(state, strict=True, assign=True)
    model.eval()
    tin = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k in ("rgb", "depth") else torch.float32) for k, v in jin.items()}
    with torch.no_grad():
        rot, trans = model(**tin)
        feats = model.tower_features(model.tower_inputs(tin["rgb"], tin.get("depth")))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers() if "running" in n)
    assert rot.dtype == trans.dtype == torch.float32
    (jrot, jtrans, jfeats), (frot, ftrans, ffeats) = jax_out[jnp.bfloat16], jax_out[jnp.float32]
    _within_jax_rounding(rot, jrot, frot, "rotation")
    _within_jax_rounding(trans, jtrans, ftrans, "translation")
    for name, f in feats.items():
        assert f.dtype == torch.float32 and torch.equal(f, f.bfloat16().float()), name
        assert _dist(jfeats[name], ffeats[name]) > 0, f"{name}: JAX's bf16 equals its f32"
        _within_jax_rounding(f, jfeats[name], ffeats[name], name)


def test_pipeline_towers_follow_pose_cfg_dtype():
    """Without pose_cfg the pipeline's PoseNet is PoseNetConfig(variant,
    img_size, dtype=compute_dtype), as pose6d_tpu/infer/pipeline.py builds
    it: a hook on the tower's first conv sees bf16 under PipelineConfig's
    default compute dtype, f32 at compute f32; an explicit f32 PoseNetConfig
    serves f32 towers at compute bf16."""
    assert PipelineConfig().compute_dtype == torch.bfloat16
    assert PoseNetConfig().dtype == torch.float32
    ycfg = YoloConfig(num_classes=2, width=0.125)
    ystate, img = init_yolo_weights(ycfg, 1), 32
    pstate = init_posenet_weights(PoseNetConfig(variant="rgb", img_size=img), 2)
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    for compute, pose_cfg, want in (
            (torch.bfloat16, None, torch.bfloat16),
            (torch.bfloat16, PoseNetConfig(variant="rgb", img_size=img), torch.float32),
            (torch.float32, None, torch.float32)):
        pipe = PosePipeline(dataclasses.replace(PipelineConfig(), img_size=img, conf_thresh=0.0,
                                                compute_dtype=compute),
                            ycfg, ystate, pstate, pose_cfg, device="cpu")
        seen = []
        pipe.posenet.backbone.conv1.register_forward_hook(
            lambda m, a, out: seen.append(out.dtype))
        out = pipe(frames, np.eye(3, dtype=np.float32))
        assert pipe.pose_cfg.dtype == want and seen == [want], (compute, pose_cfg, seen)
        assert torch.isfinite(out["rotation"]).all()


# -------------------------------------------------------- percentile scales

@pytest.fixture(scope="module")
def rgb_tower():
    """(JAX's folded rgb tower of pipeline_weights("rgb"), the port's eval
    tower of the same weights, crops x [B, S, S, 3], and every conv input
    of JAX's folded forward of x, where JAX's calibrate_act_scales takes
    its statistics)."""
    from pose6d_tpu.ops import quant as jquant

    _, variables, _, state = pipeline_weights("rgb")
    jfold = jquant.fold_bn_resnet(variables["params"]["backbone"],
                                  variables["batch_stats"]["backbone"])
    with torch.device("meta"):
        model = PoseNet(PoseNetConfig(variant="rgb", img_size=S))
    model.load_state_dict(state, strict=True, assign=True)
    x = np.random.default_rng(2).normal(size=(B, S, S, 3)).astype(np.float32)
    seen = {}
    with jax.disable_jit():
        jquant.folded_resnet50_forward(jfold, jnp.asarray(x),
                                       observer=lambda n, h: seen.setdefault(n, np.array(h)))
    assert len(seen) == 53
    return jfold, model.eval().backbone, x, seen


def _rule(h: np.ndarray, q: float) -> float:
    """numpy's default linear percentile of |h| at a float64 position."""
    return float(np.percentile(np.abs(h).astype(np.float64), q))


def test_abs_percentile_is_numpy_percentile(rgb_tower):
    """abs_percentile against np.percentile(|x|) in float64, the linear
    rule that jnp.percentile follows with its position in f32: on every
    conv input of JAX's folded tower and on a flat tensor of 2**24 + 3
    elements, past torch.quantile's limit; within 1e-6 relative."""
    from pose6d_tpu_torch.ops.quant import abs_percentile

    _, _, _, seen = rgb_tower
    flat = torch.randn(2**24 + 3, generator=torch.Generator().manual_seed(0))
    cases = [(name, torch.from_numpy(h), (PERCENTILE,)) for name, h in seen.items()]
    cases.append(("flat", flat, (PERCENTILE, 50.0, 0.0, 100.0)))
    for name, h, qs in cases:
        for q in qs:
            got = float(abs_percentile(h, q))
            assert got == pytest.approx(_rule(h.numpy(), q), rel=1e-6, abs=0), (name, q)


def test_percentile_scales_match_jax(rgb_tower):
    """calibrate_act_scales(percentile=) on the port's own fold against
    JAX's calibrate_act_scales(percentile=) on its fold: within the
    abs-max test's 1e-5 (test_torch_quant_int8.py) of the rule on JAX's
    activations, and of JAX's scales once JAX's own distance from the rule
    (its f32 position) is added; quantize_resnet_from_variables(percentile=)
    carries them, and they are below the abs-max scales."""
    from pose6d_tpu.ops import quant as jquant
    from pose6d_tpu_torch.ops import quant

    jfold, tower, x, seen = rgb_tower
    with jax.disable_jit():
        want = jquant.calibrate_act_scales(jfold, [x], percentile=PERCENTILE)
    folded = quant.fold_bn_resnet(tower)
    got = quant.calibrate_act_scales(folded, [x], PERCENTILE)
    assert set(got) == set(want) == set(seen)
    for name, w in want.items():
        rule = _rule(seen[name], PERCENTILE) / 127.0
        assert got[name] == pytest.approx(rule, rel=1e-5, abs=0), name
        assert abs(got[name] - w) <= 1e-5 * w + abs(w - rule), name
    q = quant.quantize_resnet_from_variables(tower, [torch.from_numpy(x)], PERCENTILE)
    assert {n: float(e["a"]) for n, e in q.items()} == pytest.approx(got, rel=1e-7)
    absmax = quant.calibrate_act_scales(folded, [x])
    assert all(got[n] < absmax[n] for n in got)


def test_mesh_percentile_calibration_is_the_one_process_one(tmp_path):
    """quantize_backbones(percentile=) after shard on (2, 1): each rank
    gathers the conv inputs of the data group, so every rank's scales are
    the one-process pipeline's on the whole batch, within 1e-5 relative
    (a rank's convolutions at batch 1 round apart from the one process's
    at batch 2 by a few f32 ulps), where the MAX of the two ranks' own
    percentiles misses some scale by more than 1e-3."""
    _, _, ystate, pstate = pipeline_weights("rgbd")
    path = str(tmp_path / "rgbd.pt")
    torch.save((ystate, pstate), path)
    frames, K, depth = pipeline_request(3, (U.S, U.S), 2)

    pipe = PosePipeline(PipelineConfig(variant="rgbd", img_size=U.S, conf_thresh=0.0,
                                       compute_dtype=torch.float32),
                        YoloConfig(num_classes=2, width=0.125), ystate, pstate,
                        PoseNetConfig(variant="rgbd", img_size=U.S), device="cpu")

    def scales(rows):
        pipe.quantize_backbones(frames[rows], K, depth[rows], PERCENTILE)
        return {(name, conv): float(e["a"]) for name, tree in pipe._quantized.items()
                for conv, e in tree.items()}

    whole = scales(slice(0, 2))
    halves = [scales(slice(r, r + 1)) for r in range(2)]
    per_rank_max = {k: max(h[k] for h in halves) for k in whole}
    assert max(abs(per_rank_max[k] / whole[k] - 1) for k in whole) > 1e-3
    for r in U.run_world(U.pipeline_rank, 2, tmp_path, path, (2, 1), frames, K, depth,
                         "int8-after", PERCENTILE):
        got = {(name, conv): a for name, tree in r["scales"].items() for conv, a in tree.items()}
        assert set(got) == set(whole)
        for k, v in whole.items():
            assert got[k] == pytest.approx(v, rel=1e-5, abs=0), k


# --------------------------------------------------------------- src_scale

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_src_scale_matches_jax(dtype):
    """crop_resize_matmul(_windowed)(src_scale=1/255) on uint8-valued
    frames against JAX's, at the crop tests' tolerances (1e-5 in f32, 2e-2
    in bf16), and in f32 within 1e-6 of cropping frames / 255."""
    from pose6d_tpu.ops import crop_resize as jcr
    from pose6d_tpu_torch.ops import crop_resize as tcr

    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 48, 64, 3)).astype(np.float32)
    x1, y1 = np.array([-3.0, 20.0], np.float32), np.array([5.0, -2.0], np.float32)
    size = np.array([30.0, 24.0], np.float32)
    jdt = getattr(jnp, str(dtype).removeprefix("torch."))
    atol = 1e-5 if dtype == torch.float32 else 2e-2
    t = [torch.from_numpy(a) for a in (x1, y1, size)]
    j = [jnp.asarray(a) for a in (x1, y1, size)]
    for window in (None, 40):
        if window is None:
            got = tcr.crop_resize_matmul(torch.from_numpy(img).to(dtype), *t, 24,
                                         compute_dtype=dtype, src_scale=1 / 255)
            want = jcr.crop_resize_matmul(jnp.asarray(img, jdt), *j, 24, compute_dtype=jdt,
                                          src_scale=1 / 255)
            plain = tcr.crop_resize_matmul(torch.from_numpy(img / 255), *t, 24)
        else:
            got = tcr.crop_resize_matmul_windowed(torch.from_numpy(img).to(dtype), *t, 24,
                                                  window, compute_dtype=dtype,
                                                  src_scale=1 / 255)
            want = jcr.crop_resize_matmul_windowed(jnp.asarray(img, jdt), *j, 24, window,
                                                   compute_dtype=jdt, src_scale=1 / 255)
            plain = tcr.crop_resize_matmul_windowed(torch.from_numpy(img / 255), *t, 24, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-6)


# ------------------------------------------------------------ int8 detector

def test_quantize_yolo_folded_and_yolo_int8_forward():
    """quantize_yolo_folded on JAX's fold (carried across as is) equals
    JAX's quantize_yolo_folded: codes, weight scales, biases and input
    scales, the head output convs float; yolo_int8_forward(q, cfg, x, cd)
    equals yolo_int8_model(q, cfg, cd)(x) bit for bit in f32 and bf16
    (test_torch_yolo_quant.py holds yolo_int8_model against JAX's
    yolo_int8_forward)."""
    from pose6d_tpu.models.yolo import quant as jyquant
    from pose6d_tpu_torch.models.yolo import quant as yquant

    yvars = pipeline_weights("rgb")[0]
    cfg = YoloConfig(num_classes=2, width=0.125)
    jfold = jyquant.fold_yolo(yvars["params"], yvars["batch_stats"])
    model = YoloV8(cfg)
    model.load_state_dict(yolo_from_jax(yvars), strict=True)
    xt = torch.from_numpy(np.random.default_rng(6).uniform(size=(B, S, S, 3)).astype(np.float32))
    scales = yquant.calibrate_yolo(yquant.fold_yolo(model.eval()), cfg, [xt])
    fold = {n: {**({"float": True} if e.get("float") else {}),
                "w": torch.from_numpy(e["w"].transpose(3, 2, 0, 1).copy()),
                "b": torch.from_numpy(e["b"])} for n, e in jfold.items()}
    jq = jyquant.quantize_yolo_folded(jfold, scales)
    q = yquant.quantize_yolo_folded(fold, scales)
    carried = quantized_from_jax({k: {f: (v if f == "float" else np.asarray(v))
                                      for f, v in e.items()} for k, e in jq.items()})
    assert set(q) == set(carried) and len(q) == 63
    for name, e in carried.items():
        assert set(q[name]) == set(e), name
        for f, v in e.items():
            assert f == "float" or torch.equal(q[name][f], v), (name, f)
    for dt in (torch.float32, torch.bfloat16):
        got = yquant.yolo_int8_forward(q, cfg, xt, dt)
        same = yquant.yolo_int8_model(q, cfg, dt)(xt)
        assert all(torch.equal(a, b) for pa, pb in zip(got, same) for a, b in zip(pa, pb)), dt


# ------------------------------------------------------- single-image augments

def test_single_image_augments():
    """color_jitter, random_grayscale and random_erasing on one image are
    their batch forms on a batch of one, drawn from the same generator
    state (JAX's color_jitter is its batch form on a batch of one too;
    test_torch_train_augment.py holds the batch forms); against JAX's
    single-image random_grayscale and random_erasing, whose draws differ
    from their batch forms', where no draw decides the result: grayscale at
    p 1, erasing at p 0."""
    from pose6d_tpu.ops import augment as jaug
    from pose6d_tpu_torch.ops import augment as aug

    img = torch.rand(24, 32, 3, generator=torch.Generator().manual_seed(7))
    cfg = aug.AugmentConfig(erase_p=1.0, erase_scale=(0.1, 0.3))
    for single, batch, arg in ((aug.color_jitter, aug.color_jitter_batch, cfg),
                               (aug.random_grayscale, aug.random_grayscale_batch, 0.5),
                               (aug.random_erasing, aug.random_erasing_batch, cfg)):
        got = single(torch.Generator().manual_seed(8), img, arg)
        want = batch(torch.Generator().manual_seed(8), img[None], arg)[0]
        assert got.shape == img.shape and torch.equal(got, want), single.__name__
    assert not torch.equal(aug.random_erasing(torch.Generator().manual_seed(8), img, cfg), img)
    g, key, jimg = torch.Generator().manual_seed(9), jax.random.key(0), jnp.asarray(img.numpy())
    with jax.disable_jit():
        pairs = ((aug.random_grayscale(g, img, 1.0), jaug.random_grayscale(key, jimg, 1.0)),
                 (aug.random_erasing(g, img, aug.AugmentConfig(erase_p=0.0)),
                  jaug.random_erasing(key, jimg, jaug.AugmentConfig(erase_p=0.0))))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
