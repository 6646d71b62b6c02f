"""pose6d_tpu_torch.models.yolo against the flax YOLOv8 and its decode.

A narrow YOLOv8 (width 0.125, nc 2) on a 64x64 input: flax weights with
every BatchNorm randomised go through convert.yolo_from_jax; the raw
per-level maps agree within f32 atol 1e-4, and decode_topk_nms max_det=1
gives the same box, score and class (atol 1e-4) on inputs whose top-1
candidate leads the runner-up by more than ten times the largest logit
difference between the frameworks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.yolo import decode as jdec
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
from pose6d_tpu_torch.convert import init_yolo_weights, yolo_from_jax
from pose6d_tpu_torch.models.yolo import decode as tdec
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8

from torch_port_utils import random_flax_variables

WIDTH, NC, S = 0.125, 2, 64


@pytest.fixture(scope="module")
def models():
    jcfg = JYoloConfig(num_classes=NC, width=WIDTH)
    jmodel = JYoloV8(jcfg)
    variables = random_flax_variables(jmodel, jnp.zeros((1, S, S, 3)), seed=3)
    tcfg = YoloConfig(num_classes=NC, width=WIDTH)
    tmodel = YoloV8(tcfg)
    tmodel.load_state_dict(yolo_from_jax(variables), strict=True)
    return jcfg, jmodel, variables, tcfg, tmodel.eval()


def test_forward_matches_flax(models):
    jcfg, jmodel, variables, tcfg, tmodel = models
    x = np.random.default_rng(0).uniform(0, 1, (2, S, S, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for (tb, tc), (jb, jc) in zip(got, want):
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)


def test_top1_decode_matches_jax(models):
    jcfg, jmodel, variables, tcfg, tmodel = models
    x = np.random.default_rng(1).uniform(0, 1, (3, S, S, 3)).astype(np.float32)
    jout = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(x))
    # the comparison needs a best candidate per image that no difference
    # between the two frameworks' logits can reorder
    cls = [np.concatenate([np.asarray(c).reshape(3, -1, NC) for _, c in out], 1)
           for out in (jout, [(b, c.numpy()) for b, c in tout])]
    noise = np.abs(cls[0] - cls[1]).max()
    top2 = np.sort(cls[0].max(-1), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 10 * noise).all()
    want = jdec.decode_topk_nms(jout, jcfg, (S, S), max_det=1, conf_thresh=0.0)
    got = tdec.decode_topk_nms(tout, tcfg, (S, S), max_det=1, conf_thresh=0.0)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-4)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))


def test_anchors_and_dfl_match_jax(rng):
    ta, ts = tdec.make_anchors((64, 96), (8, 16, 32))
    ja, js = jdec.make_anchors((64, 96), (8, 16, 32))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    logits = rng.normal(size=(5, 64)).astype(np.float32)
    np.testing.assert_allclose(tdec.dfl_expectation(torch.from_numpy(logits), 16).numpy(),
                               np.asarray(jdec.dfl_expectation(jnp.asarray(logits), 16)),
                               atol=1e-5)


def test_conf_thresh_marks_invalid(models):
    _, _, _, tcfg, tmodel = models
    x = torch.zeros(1, S, S, 3)
    with torch.no_grad():
        d = tdec.decode_topk_nms(tmodel(x), tcfg, (S, S), max_det=1, conf_thresh=1.1)
    assert not d["valid"].any() and (d["classes"] == -1).all() and (d["scores"] == 0).all()
    # and the general NMS path: no candidate survives the threshold
    with torch.no_grad():
        d = tdec.decode_topk_nms(tmodel(x), tcfg, (S, S), max_det=8, conf_thresh=1.1)
    assert d["valid"].shape == (1, 8)
    assert not d["valid"].any() and (d["classes"] == -1).all() and (d["scores"] == 0).all()


def test_seeded_weights_load_at_full_width():
    """init_yolo_weights covers every entry of the YOLOv8n state_dict."""
    cfg = YoloConfig()
    YoloV8(cfg).load_state_dict(init_yolo_weights(cfg, 0), strict=True)
