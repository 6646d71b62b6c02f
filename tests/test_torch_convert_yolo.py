"""pose6d_tpu_torch.models.yolo.convert (ultralytics YOLOv8 <-> the port's
YoloV8) against the JAX package.

The ultralytics-keyed state_dict comes from the pure-torch YOLOv8n of
tests/test_yolo_torch_golden.py (its 'model.{idx}.' layout), every weight
and BatchNorm statistic randomised from a seed, with keys prefixed
('model.model.', 'model.') and bare. yolo_from_ultralytics is bit-equal to
convert.yolo_from_jax(ultralytics_yolov8_to_flax(...)); yolo_to_ultralytics
is bit-equal to flax_to_ultralytics_keys; and the port's per-level forward
on the converted weights matches the torch re-declaration within 1e-4 at
160 px."""

import numpy as np
import pytest
import torch

from pose6d_tpu.models.yolo.convert import flax_to_ultralytics_keys, ultralytics_yolov8_to_flax
from pose6d_tpu.models.yolo.model import YoloConfig as JYoloConfig
from pose6d_tpu_torch.convert import yolo_from_jax
from pose6d_tpu_torch.models.yolo.convert import yolo_from_ultralytics, yolo_to_ultralytics
from pose6d_tpu_torch.models.yolo.model import YoloConfig, YoloV8

from test_yolo_torch_golden import NC, _TorchYoloV8n
from torch_port_utils import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    model = _TorchYoloV8n().eval()
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=g) * 0.2)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=g) + 0.5)
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g) * 0.1)
    return model


def _equal(a: dict, b: dict):
    assert set(a) == set(b), sorted(set(a) ^ set(b))[:8]
    for k in a:
        x = a[k] if isinstance(a[k], torch.Tensor) else torch.from_numpy(np.asarray(a[k]))
        y = b[k] if isinstance(b[k], torch.Tensor) else torch.from_numpy(np.asarray(b[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


@pytest.mark.parametrize("prefix", ["model.model.", "model.", ""], ids=["model2", "model", "bare"])
def test_import_bit_equal_to_jax_chain(reference, prefix):
    bare = {k[len("model."):]: v for k, v in reference.state_dict().items()}
    sd = {prefix + k: v for k, v in bare.items()}
    # a DFL conv, as ultralytics checkpoints hold it: not loaded
    sd[prefix + "22.dfl.conv.weight"] = torch.arange(16.0).reshape(1, 16, 1, 1)
    state = yolo_from_ultralytics(sd, YoloConfig(num_classes=NC))
    p, s = ultralytics_yolov8_to_flax(sd, JYoloConfig(num_classes=NC))
    _equal(state, yolo_from_jax({"params": p, "batch_stats": s}))
    YoloV8(YoloConfig(num_classes=NC)).load_state_dict(state, strict=True)


def test_export_bit_equal_to_flax_keys(reference):
    p, s = ultralytics_yolov8_to_flax(reference.state_dict(), JYoloConfig(num_classes=NC))
    state = yolo_from_jax({"params": p, "batch_stats": s})
    got = yolo_to_ultralytics(state, YoloConfig(num_classes=NC))
    want = flax_to_ultralytics_keys(p, s, JYoloConfig(num_classes=NC))
    _equal(got, {k: np.ascontiguousarray(v) for k, v in want.items()})
    # and back to the same state
    _equal(yolo_from_ultralytics(got, YoloConfig(num_classes=NC)), state)


def test_forward_matches_torch_redeclaration(reference):
    cfg = YoloConfig(num_classes=NC)
    model = YoloV8(cfg).eval()
    model.load_state_dict(yolo_from_ultralytics(reference.state_dict(), cfg), strict=True)
    x = np.random.default_rng(12).uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)
    with torch.no_grad():
        theirs = reference(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        ours = model(torch.from_numpy(x))
    assert len(ours) == 3
    for lvl, ((obox, ocls), (tbox, tcls)) in enumerate(zip(ours, theirs)):
        np.testing.assert_allclose(obox.numpy(), tbox.permute(0, 2, 3, 1).numpy(), atol=1e-4,
                                   err_msg=f"box level {lvl}")
        np.testing.assert_allclose(ocls.numpy(), tcls.permute(0, 2, 3, 1).numpy(), atol=1e-4,
                                   err_msg=f"cls level {lvl}")
