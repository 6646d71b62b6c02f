"""pose6d_tpu_torch/models/yolo/quant.py against pose6d_tpu's: the
detector's BN folding, its folded f32 forward and its int8 forward.

Small size: the narrow YOLOv8 (width 0.125, nc 2) on 64x64 frames, batch
2, random flax variables with every BatchNorm randomised, converted to
the port. Tolerances: folded weights within 1e-6 (the same f32 fold);
the folded forward within 1e-4 of JAX's (different conv summation
orders); the port's int8 forward on JAX's int8 tree within rel-L2 1e-3 of
JAX's (exact int32 products, the same epilogue roundings; 9e-8
measured); int8 against the float detector: cosine > 0.98 per map, the
bound of tests/test_yolo_quant.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose6d_tpu.models.yolo import quant as jyquant
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig, YoloV8 as JYoloV8
from pose6d_tpu_torch.convert import quantized_from_jax, yolo_from_jax
from pose6d_tpu_torch.models.yolo import quant as yquant
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8

from torch_port_utils import random_flax_variables

B, S, NC, WIDTH = 2, 64, 2, 0.125


def _flat(outputs):
    return np.concatenate([np.asarray(t, np.float32).ravel() for pair in outputs for t in pair])


@pytest.fixture(scope="module")
def detector():
    """(JAX config, JAX variables, the port's config and eval model, x)."""
    jcfg = JYoloConfig(num_classes=NC, width=WIDTH)
    variables = random_flax_variables(JYoloV8(jcfg), jnp.zeros((1, S, S, 3)), seed=1)
    cfg = YoloConfig(num_classes=NC, width=WIDTH)
    model = YoloV8(cfg)
    model.load_state_dict(yolo_from_jax(variables), strict=True)
    x = np.random.default_rng(1).uniform(size=(B, S, S, 3)).astype(np.float32)
    return jcfg, variables, cfg, model.eval(), x


@pytest.fixture(scope="module")
def jax_int8(detector):
    jcfg, variables, _, _, x = detector
    return jyquant.quantize_yolo_from_variables(variables, jcfg, [x])


def test_fold_yolo_matches_jax(detector):
    """The same paths ("backbone/c2f_1/m0/cv1", ..., "head/cls2_out"),
    folded kernels (OIHW here, HWIO there) and biases within 1e-6, the
    head output convs marked float and unfolded."""
    _, variables, _, model, _ = detector
    want = jyquant.fold_yolo(variables["params"], variables["batch_stats"])
    got = yquant.fold_yolo(model)
    assert set(got) == set(want) and len(got) == 63
    for name, e in want.items():
        assert bool(got[name].get("float")) == bool(e.get("float")), name
        np.testing.assert_allclose(got[name]["w"].numpy(), e["w"].transpose(3, 2, 0, 1),
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got[name]["b"].numpy(), e["b"], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_folded_forward_matches_jax(detector):
    """yolo_folded_forward (the detector's own wiring with each ConvBN
    swapped for its folded conv) against JAX's and against the float
    detector, within 1e-4."""
    jcfg, variables, cfg, model, x = detector
    jfold = jyquant.fold_yolo(variables["params"], variables["batch_stats"])
    want = jyquant.yolo_folded_forward(jfold, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got = yquant.yolo_folded_forward(yquant.fold_yolo(model), cfg, torch.from_numpy(x))
        ref = model(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for (gb, gc), (wb, wc), (rb, rc) in zip(got, want, ref):
        for g, w, r in ((gb, wb, rb), (gc, wc, rc)):
            assert tuple(g.shape) == np.asarray(w).shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-4)


def test_int8_forward_matches_jax(detector, jax_int8):
    """The port's int8 forward on JAX's int8 tree (convert.
    quantized_from_jax) against JAX's, in f32: rel-L2 <= 1e-3 and
    cosine >= 0.99999 over all six maps, each map's shape as JAX's; the
    logits stay f32 under a bf16 compute dtype."""
    jcfg, _, cfg, _, x = detector
    q = quantized_from_jax({k: {f: (v if f == "float" else np.asarray(v))
                                for f, v in e.items()} for k, e in jax_int8.items()})
    want = jyquant.yolo_int8_forward(jax_int8, jcfg, jnp.asarray(x))
    got = yquant.yolo_int8_model(q, cfg)(torch.from_numpy(x))
    for (gb, gc), (wb, wc) in zip(got, want):
        assert tuple(gb.shape) == wb.shape and tuple(gc.shape) == wc.shape
    g, w = _flat([(b.numpy(), c.numpy()) for b, c in got]), _flat(want)
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    assert rel <= 1e-3 and cos >= 0.99999, (rel, cos)
    bf16 = yquant.yolo_int8_model(q, cfg, torch.bfloat16)(torch.from_numpy(x).bfloat16())
    assert all(b.dtype == c.dtype == torch.float32 for b, c in bf16)


def test_head_outputs_stay_float(detector, jax_int8):
    """The port's own PTQ tree: every ConvBN int8 with a scalar input scale,
    the six head output convs float as in JAX's tree, and the codes of the
    same conv at most 1 apart from JAX's."""
    _, _, _, model, x = detector
    q = yquant.quantize_yolo_from_variables(model, [torch.from_numpy(x)])
    assert set(q) == set(jax_int8)
    floats = sorted(k for k, e in q.items() if e.get("float"))
    assert floats == sorted(k for k, e in jax_int8.items() if e.get("float"))
    assert floats == [f"head/{k}{i}_out" for k in ("box", "cls") for i in range(3)]
    assert q["backbone/stem"]["w"].dtype == torch.int8 and q["backbone/stem"]["a"].ndim == 0
    for name, e in q.items():
        if not e.get("float"):
            want = np.asarray(jax_int8[name]["w"]).transpose(3, 0, 1, 2)
            d = e["w"].numpy().astype(np.int32) - want
            assert int(np.abs(d).max()) <= 1, name


def test_int8_forward_tracks_float(detector):
    """The port's PTQ detector against the float one: cosine > 0.98 on each
    of the six maps."""
    _, _, cfg, model, x = detector
    xt = torch.from_numpy(x)
    with torch.no_grad():
        q = yquant.quantize_yolo_from_variables(model, [xt])
        got, ref = yquant.yolo_int8_model(q, cfg)(xt), model(xt)
    for pair_g, pair_r in zip(got, ref):
        for g, r in zip(pair_g, pair_r):
            g, r = g.numpy().ravel(), r.numpy().ravel()
            cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r))
            assert cos > 0.98, cos
