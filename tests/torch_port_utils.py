"""Shared helper for the tests that hold pose6d_tpu_torch against the JAX
package: flax variables with every BatchNorm randomised, as numpy trees."""

from __future__ import annotations

import functools

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch intra-op threads for a module of many small CPU ops
    (import it into the test module): with one thread per core in each of
    a test run's worker processes, every parallel region waits on
    descheduled threads, and a 5 s Trainer fit took over 2 minutes."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def random_flax_variables(model, *args, seed: int = 0, trainable: bool = False, **kwargs):
    """Random variables for a flax module without running its init: the
    tree's shapes come from jax.eval_shape (tracing only), the values from
    numpy. Conv/dense kernels are He-scaled, every BatchNorm's scale, bias,
    mean and var and every bias are random (no zero-init residuals).

    trainable: weights whose train-mode gradients are well conditioned in
    f32, for the one-step tests: LeCun-scaled kernels (flax's lecun_normal
    scale) and each bottleneck's last BN scale in [0.1, 0.3] (where flax's
    init puts 0), so that 16 residual blocks stay near their identity."""
    import jax

    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), *args, **kwargs))
    rng = np.random.default_rng(seed)

    def fill(tree, stats, scope=""):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v, stats, k)
                continue
            shape = v.shape
            if stats:
                a = rng.normal(0, 0.1, shape) if k == "mean" else rng.uniform(0.5, 1.5, shape)
            elif k == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                gain = 2.0 if len(shape) == 4 and not trainable else 1.0
                a = rng.normal(0, np.sqrt(gain / fan_in), shape)
            elif k == "scale" and trainable and scope == "bn3":
                a = rng.uniform(0.1, 0.3, shape)
            elif k == "scale":
                a = rng.uniform(0.5, 1.2, shape)
            else:
                a = rng.normal(0, 0.05, shape)
            out[k] = a.astype(np.float32)
        return out

    return {"params": fill(shapes["params"], False),
            "batch_stats": fill(shapes.get("batch_stats", {}), True)}


def random_folded_stage(rng, stage: int):
    """A random BN-folded tree of one ResNet50 stage: ({name: {"w" HWIO,
    "b"}} numpy in the JAX layout, the same as {name: {"w" OIHW, "b"}}
    torch tensors). Weights are N(0, 1/fan_in), biases N(0, 0.05), so
    activations stay of order one through every stage."""
    import torch

    from pose6d_tpu_torch.ops.fused_block import STAGE_CFGS

    name, n_blocks, _, cin, cmid, cout, _, _ = STAGE_CFGS[stage]
    specs = {f"{name}_0/downsample": (1, cin, cout)}
    for j in range(n_blocks):
        specs.update({f"{name}_{j}/conv1": (1, cin if j == 0 else cout, cmid),
                      f"{name}_{j}/conv2": (3, cmid, cmid),
                      f"{name}_{j}/conv3": (1, cmid, cout)})
    jtree, ttree = {}, {}
    for n, (k, ci, co) in specs.items():
        w = (rng.standard_normal((k, k, ci, co)) / np.sqrt(k * k * ci)).astype(np.float32)
        b = (rng.standard_normal((co,)) * 0.05).astype(np.float32)
        jtree[n] = {"w": w, "b": b}
        ttree[n] = {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                    "b": torch.from_numpy(b)}
    return jtree, ttree


# ---------------------------------------------------------------- serving

PIPE_IMG = 64
PIPE_K = np.array([[150.0, 0, 32], [0, 150.0, 30], [0, 0, 1]], np.float32)


@functools.lru_cache(maxsize=None)
def pipeline_weights(variant: str, nc: int = 2):
    """Random flax variables (random_flax_variables) of a narrow YOLOv8
    (width 0.125, nc classes, seed 1) and of a PoseNet of `variant` at
    PIPE_IMG (seed 3), with the port's state_dicts of both (convert.py):
    (yolo_vars, pose_vars, yolo_state, pose_state). Cached per variant."""
    import jax.numpy as jnp

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
    from pose6d_tpu_torch.convert import posenet_from_jax, yolo_from_jax

    S = PIPE_IMG
    yvars = random_flax_variables(JYoloV8(JYoloConfig(num_classes=nc, width=0.125)),
                                  jnp.zeros((1, S, S, 3)), seed=1)
    extra = {"depth": jnp.zeros((1, S, S, 1))} if variant == "rgbd" else {}
    pvars = random_flax_variables(
        JPoseNet(JPoseNetConfig(variant=variant, img_size=S, dtype=jnp.float32)),
        jnp.zeros((1, S, S, 3)), seed=3, **extra)
    return yvars, pvars, yolo_from_jax(yvars), posenet_from_jax(pvars)


def make_pipeline_pair(variant: str, nc: int = 2, **cfg):
    """The JAX PosePipeline and the port's on pipeline_weights(variant, nc),
    both at PIPE_IMG with conf_thresh 0 and compute f32 unless `cfg` (more
    PipelineConfig fields, set on both; compute_dtype as a torch dtype)
    says otherwise; the port's on the CPU. Returns (jax_pipe, port_pipe)."""
    import jax.numpy as jnp
    import torch

    from pose6d_tpu.infer import PipelineConfig as JPipelineConfig, PosePipeline as JPosePipeline
    from pose6d_tpu.models.posenet import PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.models.posenet import PoseNetConfig
    from pose6d_tpu_torch.models.yolo.model import YoloConfig

    yvars, pvars, ystate, pstate = pipeline_weights(variant, nc)
    S = PIPE_IMG
    cfg = {"conf_thresh": 0.0, "compute_dtype": torch.float32, **cfg}
    jcd = getattr(jnp, str(cfg["compute_dtype"]).removeprefix("torch."))
    jpipe = JPosePipeline(
        JPipelineConfig(variant=variant, img_size=S, **{**cfg, "compute_dtype": jcd}),
        JYoloConfig(num_classes=nc, width=0.125), yvars, pvars,
        JPoseNetConfig(variant=variant, img_size=S, dtype=jnp.float32))
    tpipe = PosePipeline(
        PipelineConfig(variant=variant, img_size=S, **cfg),
        YoloConfig(num_classes=nc, width=0.125), ystate, pstate,
        PoseNetConfig(variant=variant, img_size=S), device="cpu")
    return jpipe, tpipe


def pipeline_request(seed: int, hw, batch: int = 2):
    """Seeded uint8 frames [batch, *hw, 3], metric depth [batch, *hw] in
    0.2-1.5 m with its first 8 rows invalid (0), and PIPE_K, as numpy."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8)
    depth = rng.uniform(0.2, 1.5, (batch, *hw)).astype(np.float32)
    depth[:, :8] = 0.0
    return frames, PIPE_K, depth


def assert_pipeline_parity(got, want):
    """The port's PosePipeline output against the JAX one's: boxes within
    1e-3 px, detection scores within 1e-5, classes and validity equal,
    rotations within 1e-4, translations within 1e-4 m."""
    def close(k, atol):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)

    assert got["rotation"].shape == np.asarray(want["rotation"]).shape
    close("bbox_xywh", 1e-3)
    close("det_score", 1e-5)
    for k in ("class_id", "det_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    close("rotation", 1e-4)
    close("translation", 1e-4)


# ---------------------------------------------------------------- training

TRAIN_S, TRAIN_B, TRAIN_N, TRAIN_HW = 64, 4, 12, (64, 64)


def train_split(seed: int = 0):
    """A seeded split of TRAIN_N frames at TRAIN_HW: uint8 RGB, uint16 depth
    (mm, some invalid), boxes, rotations, translations (mm), object ids
    and intrinsics, as numpy."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    n, (h, w) = TRAIN_N, TRAIN_HW
    rgb = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    depth = rng.integers(400, 1400, (n, h, w)).astype(np.uint16)
    depth[rng.random(depth.shape) < 0.05] = 0
    bw, bh = rng.uniform(14, 30, n), rng.uniform(14, 30, n)
    bbox = np.stack([rng.uniform(0, w - bw), rng.uniform(0, h - bh), bw, bh], -1)
    rot = Rotation.from_quat(rng.normal(size=(n, 4))).as_matrix()
    trans_mm = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                         rng.uniform(600, 1000, n)], -1)
    K = np.tile(np.array([[572.4114, 0, w / 2], [0, 573.57043, h / 2], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    return rgb, depth, bbox, rot, trans_mm, rng.integers(0, 3, n), K


def disable_dropout(model):
    """Every port Dropout to identity (rate 0)."""
    from pose6d_tpu_torch.models.posenet import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def no_dropout_interceptor(next_fun, args, kwargs, context):
    """flax.linen.intercept_methods interceptor: every nn.Dropout call
    returns its input."""
    import flax.linen as nn

    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def grad_capture_tx():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradients it is given as its state: the JAX train step then
    returns its gradients in opt_state["g"]."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def one_train_step_both(variant: str, seed: int = 0, **flags):
    """One train step of `variant` at TRAIN_S / TRAIN_B in both packages,
    through make_train_step, from the same flax variables
    (random_flax_variables, trainable) and the same batch, with dropout
    off (interceptor / rate 0) and augmentation off (train_augment
    patched to the eval path's normalization on both sides, so that both
    networks see the same bits). The batch is the port's device batch of
    a seeded split (expand_device_batch, held against JAX in
    test_torch_device_pipeline.py), as numpy.

    The JAX step is the reference and runs in float64 (jax.enable_x64,
    PoseNetConfig dtype float64; the loss stays f32 as the package computes
    it): in f32 its train-mode gradients are off by up to 1e-2 relative
    per leaf at this depth (flax's E[x^2] - E[x]^2 batch variance, XLA's
    sequential f32 sums). The port's step runs twice, with its f32 module
    and with the same module converted to float64: a 50-layer train-mode
    BN network has gradient leaves that are small remainders of cancelling
    sums, off by up to 2e-2 relative in f32 for the port too (against its
    float64 run), so the 1e-3 per-leaf statement is the float64 run's and
    the f32 run's leaves are held at the looser LEAF_BOUNDS. The f32 run has
    oneDNN off: its f32 convolution backward on the CPU moves the gradient
    norm by up to 1.8e-4, torch's native convolutions by under 6e-5 (the
    card runs cuDNN with TF32 off). The JAX step runs
    with grad_capture_tx, the port's with clipping out of reach (grad_clip
    1e9): p.grad after its step is the raw gradient. Returns (jax: {"loss",
    "grad_norm", "grads" and "batch_stats" in the port's state_dict
    layout}, {torch.float32: (TrainState, metrics), torch.float64:
    (TrainState, metrics)}, variables, batch)."""
    from unittest import mock

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import torch

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.ops.augment import eval_preprocess as j_eval_preprocess
    from pose6d_tpu.train import loop as jloop
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.train import loop as tloop

    S, B = TRAIN_S, TRAIN_B
    dummy = {"rgb": jnp.zeros((1, S, S, 3)), "depth": jnp.zeros((1, S, S, 1)),
             "depth_raw": jnp.zeros((1, S, S)), "center_orig": jnp.zeros((1, 2)),
             "center_crop": jnp.zeros((1, 2)), "cam_K": jnp.eye(3)[None],
             "cam_K_crop": jnp.eye(3)[None]}
    variables = random_flax_variables(
        JPoseNet(JPoseNetConfig(variant=variant, img_size=S, **flags)),
        **jloop.model_inputs(variant, dummy, dummy["rgb"]), seed=seed, trainable=True)

    store = DeviceFrameStore(*train_split(seed), img_size=S, device="cpu",
                             flavor="rgbd" if variant.startswith("rgbd") else "rgb")
    meta = store.meta_batch(np.array([5, 0, 11, 2]), np.random.default_rng(seed + 1))
    batch = tloop.expand_device_batch(
        store.rgb_frames, store.depth_frames,
        {k: torch.from_numpy(v) for k, v in meta.items()}, S, TRAIN_HW)
    batch = {k: v.numpy() for k, v in batch.items()}

    to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    with jax.enable_x64(True), nn.intercept_methods(no_dropout_interceptor), \
            mock.patch.object(jloop, "train_augment",
                              lambda key, rgb, cfg: j_eval_preprocess(rgb)):
        jmodel = JPoseNet(JPoseNetConfig(variant=variant, img_size=S, dtype=jnp.float64,
                                         **flags))
        jcfg = jloop.TrainConfig(variant=variant, img_size=S, batch_size=B, **flags)
        tx = grad_capture_tx()
        params = f64(variables["params"])
        jstate = jloop.TrainState(params=params, batch_stats=f64(variables["batch_stats"]),
                                  opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        jstep = jloop.make_train_step(jmodel, tx, jcfg)
        new_jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                     jax.random.key(seed))
        jax_out = {
            "loss": float(jmetrics["loss"]), "grad_norm": float(jmetrics["grad_norm"]),
            "grads": {k: v.double() for k, v in posenet_from_jax(
                {"params": to_np(new_jstate.opt_state["g"])}).items()},
            "batch_stats": {k: v.double() for k, v in posenet_from_jax(
                {"params": {}, "batch_stats": to_np(new_jstate.batch_stats)}).items()},
        }

    tcfg = tloop.TrainConfig(variant=variant, img_size=S, batch_size=B, grad_clip=1e9, **flags)
    runs = {}
    with mock.patch.object(tloop, "train_augment", lambda g, rgb, cfg: eval_preprocess(rgb)):
        step = tloop.make_train_step(tcfg)
        for dtype in (torch.float32, torch.float64):
            model = PoseNet(PoseNetConfig(variant=variant, img_size=S, **flags))
            model.load_state_dict(posenet_from_jax(variables), strict=True)
            state = tloop.create_train_state(tcfg, model=disable_dropout(model).to(dtype),
                                             device="cpu")
            with torch.backends.mkldnn.flags(enabled=False):
                runs[dtype] = step(state, batch, torch.Generator().manual_seed(seed))
    return jax_out, runs, variables, batch


# Per-leaf gradient bounds against the float64 JAX step, by the port's
# dtype: (relative L2 of a leaf, |g| / global norm of a leaf whose
# reference is zero). float64 holds the 1e-3 statement. f32 leaves that
# are remainders of cancelling sums (BN biases and scales deep in a tower)
# read up to 2.1e-2 (rgbd, rgb_backbone.layer2_3.bn3.bias; rgb 5.7e-3,
# rgb_geometric 1.4e-2, rgbd_geometric 7.6e-5) and zero leaves up to 2.1e-9;
# a wrong leaf reads far above: BN epsilon 1e-4 for 1e-5 gives 0.17.
LEAF_BOUNDS = {"float64": (1e-3, 1e-9), "float32": (5e-2, 1e-7)}


def assert_train_step_parity(jax_out, runs):
    """The one-step tolerances, for the port's f32 and float64 runs: loss
    within 1e-5 max(1, |loss|); gradient global norm within 1e-4 relative;
    each BN running mean and variance within 1e-4 of its largest
    magnitude; and each gradient leaf within LEAF_BOUNDS of its dtype
    (one_train_step_both says why f32 cannot hold 1e-3). A leaf whose
    reference gradient is zero (below 1e-9 of the global norm: the bias of
    a dense layer that train-mode BN follows, whose shift the batch mean
    removes) must stay near zero too. Returns the worst relative leaf
    error of each run, by dtype (the readings LEAF_BOUNDS cites)."""
    import torch

    want_gn = jax_out["grad_norm"]
    worst = {}
    for dtype, (state, metrics) in runs.items():
        loss = float(metrics["loss"])
        assert abs(loss - jax_out["loss"]) <= 1e-5 * max(1.0, abs(jax_out["loss"])), \
            (dtype, loss, jax_out["loss"])
        gn = float(metrics["grad_norm"])
        assert abs(gn - want_gn) <= 1e-4 * want_gn, (dtype, gn, want_gn)
        buffers = dict(state.model.named_buffers())
        stats = {k: v for k, v in jax_out["batch_stats"].items() if "running_" in k}
        assert stats
        for k, want in stats.items():
            err = float((buffers[k].double() - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), f"{dtype} {k}: max err {err:.3g}"
        params = dict(state.model.named_parameters())
        assert set(params) == set(jax_out["grads"])
        rel_bound, zero_bound = LEAF_BOUNDS[str(dtype).removeprefix("torch.")]
        worst[dtype] = 0.0
        for k, want in jax_out["grads"].items():
            got = params[k].grad.detach().double()
            ref, err = float(want.norm()), float((got - want).norm())
            if ref < 1e-9 * want_gn:
                assert float(got.norm()) <= zero_bound * want_gn, \
                    f"{dtype} {k}: |g| {float(got.norm()):.3g}, 0 expected"
                continue
            worst[dtype] = max(worst[dtype], err / ref)
            assert err <= rel_bound * ref, \
                f"{dtype} {k}: gradient rel L2 err {err / ref:.3g} (|g| {ref:.3g})"
    return worst


def eval_step_both(variant: str, variables, batch):
    """make_eval_step of both packages, f32, on the same variables and
    batch (one_train_step_both's), over 3 seeded objects of 50 points with
    the last row of the batch padding (valid False). Returns (jax metrics,
    port metrics) as numpy."""
    import types

    import jax.numpy as jnp
    import torch

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.train import loop as jloop
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.losses.add import ObjectModels
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.train import loop as tloop

    rng = np.random.default_rng(7)
    n_obj, P = 3, 50
    models = {"points": rng.normal(0, 0.04, (n_obj, P, 3)).astype(np.float32),
              "diameters": np.array([0.1, 0.12, 0.09], np.float32),
              "symmetric": np.array([False, True, False]),
              "present": np.ones(n_obj, bool),
              "num_valid": np.array([P, 40, P], np.int32)}
    batch = dict(batch, valid=np.array([True] * (len(batch["idx"]) - 1) + [False]))
    S = batch["rgb"].shape[1]
    jstep = jloop.make_eval_step(JPoseNet(JPoseNetConfig(variant=variant, img_size=S)),
                                 jloop.TrainConfig(variant=variant, img_size=S),
                                 types.SimpleNamespace(**{k: jnp.asarray(v)
                                                          for k, v in models.items()}))
    jstate = jloop.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                              opt_state=(), step=jnp.zeros((), jnp.int32))
    want = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    model = PoseNet(PoseNetConfig(variant=variant, img_size=S))
    model.load_state_dict(posenet_from_jax(variables), strict=True)
    cfg = tloop.TrainConfig(variant=variant, img_size=S)
    state = tloop.create_train_state(cfg, model=model, device="cpu")
    tstep = tloop.make_eval_step(cfg, ObjectModels(*(torch.from_numpy(models[k]) for k in (
        "points", "diameters", "symmetric", "present", "num_valid"))))
    got = tstep(state, batch)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_eval_parity(want, got):
    """Predictions within 1e-4 (eval-mode f32 forward, as the serving
    tests hold it), ADD means within 1e-2 mm, the 0.1d accuracies and the
    valid count equal, the loss within 1e-5 max(1, |loss|)."""
    assert set(got) == set(want)
    for k in ("pred_rot", "pred_trans"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    for k in ("add_mean", "add_s_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-2, err_msg=k)
    for k in ("add_01d_acc", "add_01d_acc_deploy", "count"):
        assert float(got[k]) == float(want[k]), k
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * max(1.0, abs(float(want["loss"])))


# ------------------------------------------------------------------ addmin

def fma_f32(a, b, c):
    """a * b + c rounded once to float32, as the card's fmaf: a * b is exact
    in float64, TwoSum gives the float64 sum's error, and a sum that lands
    on a float32 midpoint rounds by that error's sign."""
    ab = a.astype(np.float64) * b.astype(np.float64)
    c = np.asarray(c, np.float64)
    s = ab + c
    bb = s - ab
    e = (ab - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    mid = (s != r) & (s - r.astype(np.float64) == other.astype(np.float64) - s) & (e != 0)
    up = np.maximum(r, other)
    down = np.minimum(r, other)
    return np.where(mid, np.where(e > 0, up, down), r).astype(np.float32)


def kernel_d2(pred, gt):
    """csrc/addmin.cu's pair_d2 for every pair, bit for bit:
    [..., Pp, 3] x [..., Pg, 3] float32 -> [..., Pp, Pg] float32."""
    d = pred[..., :, None, :].astype(np.float32) - gt[..., None, :, :].astype(np.float32)
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))


def kernel_recompute(p, q) -> np.float32:
    """The kernel's final distance of one pair: float64 differences,
    dx*dx and two fmas each rounded to float64, sqrt, one float32 rounding."""
    from fractions import Fraction

    dx, dy, dz = (float(a) - float(b) for a, b in zip(p, q))
    t = dx * dx
    t = float(Fraction(dy) * Fraction(dy) + Fraction(t))
    t = float(Fraction(dz) * Fraction(dz) + Fraction(t))
    return np.float32(np.sqrt(t))


def addmin_expected(pred, gt):
    """What the kernel returns, bit for bit: for each predicted point, the
    first GT point at the smallest kernel_d2, and its distance as
    kernel_recompute gives it. [B, P, 3] x [B, P, 3] -> [B, P] float32."""
    arg = kernel_d2(pred, gt).argmin(-1)
    return np.array([[kernel_recompute(pred[b, i], gt[b, arg[b, i]])
                      for i in range(pred.shape[1])] for b in range(pred.shape[0])], np.float32)


def padded_cloud(rng, P: int, n_real: int, scale: float = 0.05):
    """A model cloud as load_object_models pads it: n_real points, then
    P - n_real repeats of them drawn with replacement. [P, 3] float32."""
    pts = rng.normal(0, scale, (n_real, 3))
    return np.concatenate([pts, pts[rng.choice(n_real, P - n_real, replace=True)]]).astype(np.float32)


def plant_ties(rng, p, gt, j_first: int, j_second: int, radius: float = 0.002) -> bool:
    """Put two GT points near p at j_first < j_second with equal kernel_d2
    but distances that round to different float32 values, the one at
    j_first the farther; True if such a pair was found."""
    u = rng.normal(size=(512, 3))
    cand = (p + radius * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    d2 = kernel_d2(p[None].astype(np.float32), cand)[0]
    dist = np.array([kernel_recompute(p, q) for q in cand])
    for v in np.unique(d2):
        idx = np.flatnonzero(d2 == v)
        if len(idx) > 1 and dist[idx].min() != dist[idx].max():
            far, near = idx[dist[idx].argmax()], idx[dist[idx].argmin()]
            gt[j_first], gt[j_second] = cand[far], cand[near]
            return True
    return False


# ------------------------------------------------------------ bf16 training

# The bf16 step's bounds against the JAX step in float64, relative: the
# loss, the gradient global norm, the whole gradient as one vector in L2,
# and the BN running statistics' largest error over their largest
# magnitude. JAX's own bf16 step (PoseNetConfig dtype bfloat16, params f32)
# meets them, and test_torch_bf16_step_* assert that it does. Its readings
# at batch 8 on one_train_step_both's weights and split: loss 0.002-0.013,
# grad norm 0.002-0.020, gradient L2 0.39-0.68 (bf16 rounding dominates the
# remainders of cancelling sums that the f32 tests see at 2e-2), BN stats
# 0.004-0.006 (rgb seeds 0-2, rgbd seed 0); the port's 0.003-0.035,
# 0.005-0.010, 0.42-0.62, 0.005-0.006. At batch_size 4 the heads'
# train-mode BatchNorm over 4 samples amplifies the towers' bf16 rounding
# into the grad norm (JAX 0.03-0.09, the port 0.10-0.63 over seeds 0-3),
# so the step runs at 8.
BF16_BOUNDS = {"loss": 5e-2, "grad_norm": 5e-2, "grad_l2": 0.8, "bn_stats": 2e-2}
BF16_BATCH = 8


def bf16_step_errors(variant: str, seed: int = 0, batch_size: int = BF16_BATCH):
    """One compute_dtype="bfloat16" train step of `variant` at TRAIN_S in
    both packages, from one_train_step_both's variables and split (a batch
    of batch_size <= 8 of its frames; dropout and augmentation off), against
    the JAX step run in float64: {"jax": errors of JAX's bf16 step, "port": errors of the
    port's}, each {"loss", "grad_norm", "grad_l2", "bn_stats"} as
    BF16_BOUNDS defines them."""
    from unittest import mock

    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import torch

    from pose6d_tpu.models.posenet import PoseNet as JPoseNet, PoseNetConfig as JPoseNetConfig
    from pose6d_tpu.ops.augment import eval_preprocess as j_eval_preprocess
    from pose6d_tpu.train import loop as jloop
    from pose6d_tpu_torch.convert import posenet_from_jax
    from pose6d_tpu_torch.data.device_pipeline import DeviceFrameStore
    from pose6d_tpu_torch.models.posenet import PoseNet, PoseNetConfig
    from pose6d_tpu_torch.ops.augment import eval_preprocess
    from pose6d_tpu_torch.train import loop as tloop

    S, B = TRAIN_S, batch_size
    dummy = {"rgb": jnp.zeros((1, S, S, 3)), "depth": jnp.zeros((1, S, S, 1)),
             "depth_raw": jnp.zeros((1, S, S)), "center_orig": jnp.zeros((1, 2)),
             "center_crop": jnp.zeros((1, 2)), "cam_K": jnp.eye(3)[None],
             "cam_K_crop": jnp.eye(3)[None]}
    variables = random_flax_variables(
        JPoseNet(JPoseNetConfig(variant=variant, img_size=S)),
        **jloop.model_inputs(variant, dummy, dummy["rgb"]), seed=seed, trainable=True)
    store = DeviceFrameStore(*train_split(seed), img_size=S, device="cpu",
                             flavor="rgbd" if variant.startswith("rgbd") else "rgb")
    meta = store.meta_batch(np.array([5, 0, 11, 2, 7, 9, 1, 4])[:B],
                            np.random.default_rng(seed + 1))
    batch = tloop.expand_device_batch(
        store.rgb_frames, store.depth_frames,
        {k: torch.from_numpy(v) for k, v in meta.items()}, S, TRAIN_HW)
    batch = {k: v.numpy() for k, v in batch.items()}

    def flat(tree):
        return {k: v.double() for k, v in posenet_from_jax(tree).items()}

    to_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    runs = {}
    with nn.intercept_methods(no_dropout_interceptor), \
            mock.patch.object(jloop, "train_augment",
                              lambda key, rgb, cfg: j_eval_preprocess(rgb)):
        for name, dtype, x64 in (("f64", jnp.float64, True), ("jax", jnp.bfloat16, False)):
            with jax.enable_x64(x64):
                cast = (lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)) \
                    if x64 else (lambda t: jax.tree.map(jnp.asarray, t))
                jmodel = JPoseNet(JPoseNetConfig(variant=variant, img_size=S, dtype=dtype))
                jcfg = jloop.TrainConfig(variant=variant, img_size=S, batch_size=B)
                tx = grad_capture_tx()
                params = cast(variables["params"])
                jstate = jloop.TrainState(params=params, batch_stats=cast(variables["batch_stats"]),
                                          opt_state=tx.init(params),
                                          step=jnp.zeros((), jnp.int32))
                new, m = jloop.make_train_step(jmodel, tx, jcfg)(
                    jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(seed))
                runs[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                              "grads": flat({"params": to_np(new.opt_state["g"])}),
                              "stats": flat({"params": {}, "batch_stats": to_np(new.batch_stats)})}

    tcfg = tloop.TrainConfig(variant=variant, img_size=S, batch_size=B, grad_clip=1e9,
                             compute_dtype="bfloat16")
    model = PoseNet(PoseNetConfig(variant=variant, img_size=S))
    model.load_state_dict(posenet_from_jax(variables), strict=True)
    state = tloop.create_train_state(tcfg, model=disable_dropout(model), device="cpu")
    with mock.patch.object(tloop, "train_augment", lambda g, rgb, cfg: eval_preprocess(rgb)):
        state, m = tloop.make_train_step(tcfg)(state, batch, torch.Generator().manual_seed(seed))
    runs["port"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "grads": {k: p.grad.detach().double() for k, p in
                              state.model.named_parameters()},
                    "stats": {k: v.double() for k, v in state.model.state_dict().items()}}
    assert all(p.dtype == torch.float32 for p in state.model.parameters())

    ref = runs["f64"]
    keys = sorted(ref["grads"])
    ref_g = torch.cat([ref["grads"][k].flatten() for k in keys])
    stat_keys = [k for k in ref["stats"] if "running_" in k]
    out = {}
    for name in ("jax", "port"):
        r = runs[name]
        g = torch.cat([r["grads"][k].flatten() for k in keys])
        out[name] = {
            "loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm": abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            "grad_l2": float((g - ref_g).norm() / ref_g.norm()),
            "bn_stats": max(float((r["stats"][k] - ref["stats"][k]).abs().max()
                                  / ref["stats"][k].abs().max()) for k in stat_keys),
        }
    return out


# ------------------------------------------------------- detector training

def jax_draws(key, batch: int, cfg) -> dict:
    """The draws of JAX's make_det_train_step for `key`, in the port's
    layout: the per-image keys split as the step splits them, each uniform
    drawn as hsv_augment / flip_augment / affine_augment draw it."""
    import jax
    import torch

    k_hsv, k_flip, k_aff = jax.random.split(key, 3)
    u = jax.random.uniform
    hsv, flip, aff = [], [], []
    for k in jax.random.split(k_hsv, batch):
        kh, ks, kv = jax.random.split(k, 3)
        hsv.append([u(kh, (), minval=-cfg.hsv_h, maxval=cfg.hsv_h),
                    1.0 + u(ks, (), minval=-cfg.hsv_s, maxval=cfg.hsv_s),
                    1.0 + u(kv, (), minval=-cfg.hsv_v, maxval=cfg.hsv_v)])
    for k in jax.random.split(k_flip, batch):
        flip.append(u(k, ()) < cfg.flip_p)
    t = cfg.affine_translate
    for k in jax.random.split(k_aff, batch):
        ks, ktx, kty = jax.random.split(k, 3)
        aff.append([u(ks, (), minval=1.0 - cfg.affine_scale, maxval=1.0 + cfg.affine_scale),
                    u(ktx, (), minval=0.5 - t, maxval=0.5 + t),
                    u(kty, (), minval=0.5 - t, maxval=0.5 + t)])
    as_t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    return {"hsv": as_t(hsv), "flip": as_t(flip), "affine": as_t(aff)}
