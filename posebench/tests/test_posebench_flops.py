"""posebench/flops.py against published figures, then at the cells' shapes."""

import json
import os

import pytest

from posebench import flops, serve

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shapes(num_classes=13):
    cfg = json.load(open(os.path.join(HERE, "configs", "rgbd_folded.json")))
    cfg["detector"]["num_classes"] = num_classes
    traffic = json.load(open(os.path.join(HERE, "traffic", "b128x1.json")))
    return serve.state_shapes(cfg, traffic)


def test_resnet50_macs_match_torchvision():
    # torchvision's resnet50: 4.09 GMACs at 224 (its "GFLOPS" are multiply-adds),
    # fc included; the tower ends at the pool, so the fc's 2048 x 1000 are added.
    # 0.5 %: the published figure has three digits (+-0.12 %), and nothing else
    # may differ: the convolutions are torchvision's.
    _, pose = _shapes()
    macs = flops.tower_flops(pose, "rgb_backbone", 224) / 2 + 2048 * 1000
    assert macs == pytest.approx(4.09e9, rel=5e-3)


def test_yolov8n_flops_match_ultralytics():
    # Ultralytics: YOLOv8n, 8.7 GFLOPs at 640x640 with 80 classes. 1 %: the
    # figure has two digits (+-0.6 %), and Ultralytics counts the DFL's 1x1
    # convolution too (~1 MFLOP), which the reference computes as a softmax.
    det, _ = _shapes(num_classes=80)
    assert flops.detector_flops(det, (640, 640)) == pytest.approx(8.7e9, rel=1e-2)


def test_counts_at_the_cells_shapes():
    # 480 x 640 has 3/4 of 640 x 640's pixels; 13 classes shrink the class
    # head from 80 to 64 channels (max(64, nc)) and its outputs to 13
    det13, pose = _shapes()
    det80, _ = _shapes(80)
    d = flops.detector_flops(det13, (480, 640))
    assert d < 0.75 * flops.detector_flops(det80, (640, 640))
    assert d == pytest.approx(6.07e9, rel=1e-2)
    # two towers (the depth one's stem takes 1 channel) and the heads
    per_crop = flops.posenet_flops("rgbd", pose, 224)
    assert 2 * flops.tower_flops(pose, "depth_backbone", 224) < per_crop
    assert per_crop < 2 * flops.tower_flops(pose, "rgb_backbone", 224) * 1.01


def test_bound_is_the_larger_of_work_and_traffic():
    assert flops.bound_ms(989e12, 0) == pytest.approx(1e3)
    assert flops.bound_ms(0, 3.35e12) == pytest.approx(1e3)
    assert flops.bound_ms(989e9, 3.35e12) == pytest.approx(1e3)
