"""The train profilers (pose6d_tpu_torch/ops/profile_train.py, the
counterparts of scripts/profile_nomodel.py, profile_train_stages.py and
profile_train_step.py) on the CPU at a small size: 8 resident frames of
48x64 (uint8 RGB, uint16 depth millimetres), crops of 32, batch 2.

The no-model prefixes: the full one ("augment") equals expand_device_batch
then train_augment bit for bit, from generators in the same state; the
gather, convert, crop_rgb and crop_depth prefixes equal the expressions
profile_nomodel.py times on the same seeded numpy inputs: JAX's
gather_frames (its Pallas gather in interpret mode on the CPU, as the JAX
package's tests run it) and the f32 conversions bit for bit, the crops
(JAX's crop_resize_matmul, the depth normalised with pose6d_tpu.data.
crop's constants) within 1e-5 absolute (values in [0, 1] and metres: the
two packages' einsums sum in different orders). fwd_bwd_adamw's loss
equals one make_train_step call's on the same state and batch, bit for
bit. Each flag runs with --device cpu and prints its JSON fields; without
a card and without --device cpu it exits 2."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.data.crop import DEPTH_INVALID_M, DEPTH_MAX_M, DEPTH_MIN_M
from pose6d_tpu.ops import gather_frames as jgf
from pose6d_tpu.ops.crop_resize import crop_resize_matmul as jcrop
from pose6d_tpu_torch.ops import profile_train as pt

from torch_port_utils import few_torch_threads  # noqa: F401

HW, N_FRAMES, B, S = (48, 64), 8, 2, 32
CROP_ATOL = 1e-5
ARGS = ["--device", "cpu", "--frame-hw", "48", "64", "--img-size", str(S), "--window", "2",
        "--reps", "1", "--train-frames", str(N_FRAMES)]


@pytest.fixture(scope="module")
def inputs():
    """(frames, depth as the port holds them, their numpy arrays, a
    metadata batch as tensors and as numpy)."""
    rng = np.random.default_rng(0)
    frames, depth = pt.resident_frames(N_FRAMES, HW, rng, "cpu")
    meta = pt.nomodel_meta(rng, B, N_FRAMES, HW, "cpu")
    np_meta = {k: v.numpy() for k, v in meta.items()}
    return frames, depth, frames.numpy(), depth.numpy().view(np.uint16), meta, np_meta


def test_full_prefix_equals_expand_augment(inputs):
    from pose6d_tpu_torch.ops.augment import AugmentConfig, train_augment
    from pose6d_tpu_torch.train.loop import expand_device_batch

    frames, depth, _, _, meta, _ = inputs
    got = pt.nomodel_prefix("augment", frames, depth, meta, S, torch.Generator().manual_seed(3))
    want = expand_device_batch(frames, depth, meta, S)
    rgb = train_augment(torch.Generator().manual_seed(3), want["rgb"], AugmentConfig())
    for g, w in zip(got, (rgb, want["depth_raw"], want["depth"])):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)


def _jax_prefix(stage, frames, depth, m):
    """profile_nomodel.py's body_out for `stage`, as numpy outputs."""
    idx = jnp.asarray(m["idx"])
    src8 = jgf.gather_frames(jnp.asarray(frames), idx)
    src16 = jgf.gather_frames(jnp.asarray(depth), idx)
    if stage == "gather":
        return [src8, src16]
    src, raw_full = src8.astype(jnp.float32), src16.astype(jnp.float32)
    if stage == "convert":
        return [src / 255.0, raw_full / 1000.0]
    x1, y1, size = (jnp.asarray(m[k]) for k in ("x1", "y1", "size"))
    rgb = jcrop(src, x1, y1, size, S) / 255.0
    if stage == "crop_rgb":
        return [rgb]
    raw = jcrop(raw_full[..., None], x1, y1, size, S)[..., 0] / 1000.0
    d = jnp.clip((raw - DEPTH_MIN_M) / (DEPTH_MAX_M - DEPTH_MIN_M), 0.0, 1.0)
    return [rgb, jnp.where(raw < DEPTH_INVALID_M, 0.0, d)]


@pytest.mark.parametrize("stage", ["gather", "convert", "crop_rgb", "crop_depth"])
def test_prefix_matches_jax_script(inputs, stage):
    frames, depth, np_frames, np_depth, meta, np_meta = inputs
    want = [np.asarray(w) for w in _jax_prefix(stage, np_frames, np_depth, np_meta)]
    got = pt.nomodel_prefix(stage, frames, depth, meta, S, None)
    if stage == "crop_depth":
        got = [got[0], got[2][..., 0]]  # rgb and the normalised depth, as JAX's outputs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        if stage == "gather" and g.dtype == np.int16:
            g = g.view(np.uint16)  # the port holds depth millimetres as int16
        assert g.shape == w.shape and g.dtype == w.dtype
        if stage in ("gather", "convert"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=CROP_ATOL)


def test_gather_take_is_the_gather(inputs):
    frames, depth, _, _, meta, _ = inputs
    for a, b in zip(pt.nomodel_prefix("gather_take", frames, depth, meta, S, None),
                    pt.nomodel_prefix("gather", frames, depth, meta, S, None)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["rgbd"])
def test_fwd_bwd_adamw_equals_make_train_step(variant):
    """The core on ready crops gives the loss one make_train_step call
    gives on the same state and batch (two states from one seed)."""
    from pose6d_tpu_torch.train.loop import make_train_step

    batch = pt.ready_batch(variant, B, S, np.random.default_rng(1), "cpu")
    cfg, state_a, core = pt.fwd_bwd_adamw(variant, B, S, "cpu")
    _, state_b, _ = pt.fwd_bwd_adamw(variant, B, S, "cpu")
    _, got = core(state_a, batch, torch.Generator().manual_seed(5))
    _, want = make_train_step(cfg)(state_b, batch, torch.Generator().manual_seed(5))
    assert torch.equal(got["loss"], want["loss"]) and torch.isfinite(got["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])


def test_epoch_meta_synth():
    """The JAX script's metadata at 480x640: boxes inside the frame, unit
    quaternions, crop intrinsics from the crop parameters."""
    m = pt.epoch_meta_synth(3, 4, 256, (480, 640), 224)
    assert all(v.shape[:2] == (3, 4) for v in m.values())
    assert m["idx"].min() >= 0 and m["idx"].max() < 256
    np.testing.assert_allclose(np.linalg.norm(m["quat"], axis=-1), 1.0, rtol=1e-6)
    s = 224 / m["size"]
    np.testing.assert_allclose(m["cam_K_crop"][..., 0, 0], m["cam_K"][..., 0, 0] * s, rtol=1e-6)


@pytest.mark.parametrize("spans,want", [
    ([], 0), ([(0, 5)], 5), ([(0, 5), (5, 9)], 9), ([(0, 5), (2, 3)], 5),
    ([(0, 5), (3, 8), (10, 12)], 10), ([(1, 2), (1, 4), (6, 7)], 4)])
def test_union_ns(spans, want):
    """Clock.busy_ms's card time: overlapping device operations (a copy
    beside a kernel) count once, gaps not at all."""
    from pose6d_tpu_torch.ops.profile_pipeline import union_ns

    assert union_ns(spans) == want


LINE_KEYS = {
    "--nomodel": {"gather", "gather_take", "convert", "crop_rgb", "crop_depth", "augment",
                  "_batch", "_n_frames", "full_prefix_equals_expand_augment"},
    "--train-split": {"gather_u8", "gather_u16", "gather_crop_rgb", "augment", "fwd_bwd_adamw",
                      "_batch", "_variant"},
    "--train-step": {"nomodel", "float32", "bfloat16", "speedup", "variant"},
}
COMMON = {"readings", "kernel_launches", "device", "clock", "card_clock", "frame_hw",
          "img_size", "window", "n_frames"}


@pytest.fixture(scope="module")
def lines():
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert pp.main(ARGS + ["--nomodel", str(B), "--train-split", f"rgb@{B}",
                               "--train-step", f"rgbd@{B}"]) == 0
    return [json.loads(x) for x in out.getvalue().splitlines()]


@pytest.mark.parametrize("i,flag", enumerate(LINE_KEYS))
def test_flag_prints_its_fields(lines, i, flag):
    assert len(lines) == len(LINE_KEYS)
    line = lines[i]
    assert line["tool"] == flag[2:].replace("-", "_")
    assert LINE_KEYS[flag] | COMMON <= set(line)
    assert (line["device"], line["clock"], line["card_clock"]) == ("cpu", "host", None)
    for name, r in line["readings"].items():
        assert r["ms"] > 0 and r["host_enqueue_ms"] > 0, name
        assert r["card_ms"] is None and r["idle_share"] is None, name
    assert all(v == {} for v in line["kernel_launches"].values())  # the plain versions
    if flag == "--nomodel":
        assert line["full_prefix_equals_expand_augment"] is True and line["_batch"] == B
        assert all(line[k] == line["readings"][k]["ms"] for k in pt.NOMODEL_STAGES)
    elif flag == "--train-split":
        assert set(line["readings"]) == set(pt.TRAIN_STAGES) and line["_variant"] == "rgb"
    else:
        for dt in pt.DTYPES:
            d = line[dt]
            assert d["losses_finite"] and d["ms_per_step"] > 0
            assert d["imgs_per_sec"] == pytest.approx(B / (d["ms_per_step"] / 1e3))
        assert line["speedup"] == pytest.approx(line["float32"]["ms_per_step"]
                                                / line["bfloat16"]["ms_per_step"])
        assert line["nomodel"]["ms_per_step"] > 0 and line["window"] == 2


@pytest.mark.parametrize("argv", [["--nomodel", "2"], ["--train-split", "rgbd@2"],
                                  ["--train-step", "rgbd@2"]])
def test_flag_refuses_without_a_card(argv, capsys):
    from pose6d_tpu_torch.ops import profile_pipeline as pp

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool runs on it")
    assert pp.main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "--device cpu" in out.err
