"""An ultralytics YOLOv8 state_dict <-> the port's YoloV8 state_dict
(counterpart of pose6d_tpu/models/yolo/convert.py).

The reference starts detector training from the pretrained yolov8n.pt
(scripts/training/train_yolo.py:41). ultralytics keys look like
"model.model.0.conv.weight", "model.0.conv.weight" or "0.conv.weight";
both sides keep torch's layouts, so the mapping renames keys:

  backbone: 0 stem, 1 down1, 2 c2f_1, 3 down2, 4 c2f_2, 5 down3, 6 c2f_3,
            7 down4, 8 c2f_4, 9 sppf
  neck:     12 td_p4, 15 td_p3, 16 bu_down3, 18 bu_p4, 19 bu_down4, 21 bu_p5
            (10/13 upsample, 11/14/17/20 concat hold no weights)
  head:     22 Detect: cv2[i] the box branch (Conv, Conv, Conv2d) ->
            box{i}_0, box{i}_1, box{i}_out; cv3[i] the class branch ->
            cls{i}_*. The DFL conv is a fixed arange and is not loaded.

A C2f's bottlenecks m.{i} are the port's m{i}. Values become float32;
num_batches_tracked is 0, as convert.yolo_from_jax writes it.
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple

import torch

from ..convert import _f32

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_BACKBONE = (("stem", "0", None), ("down1", "1", None), ("c2f_1", "2", 3), ("down2", "3", None),
             ("c2f_2", "4", 6), ("down3", "5", None), ("c2f_3", "6", 6), ("down4", "7", None),
             ("c2f_4", "8", 3))
_NECK = (("td_p4", "12", 3), ("td_p3", "15", 3), ("bu_down3", "16", None), ("bu_p4", "18", 3),
         ("bu_down4", "19", None), ("bu_p5", "21", 3))


def _prefix(state_dict: Mapping) -> str:
    if any(k.startswith("model.model.") for k in state_dict):
        return "model.model."
    return "model." if any(k.startswith("model.") for k in state_dict) else ""


def _convbn_pairs(ours: str, theirs: str) -> Iterator[Tuple[str, str]]:
    yield f"{ours}.conv.weight", f"{theirs}.conv.weight"
    for leaf in _BN_LEAVES:
        yield f"{ours}.bn.{leaf}", f"{theirs}.bn.{leaf}"


def key_pairs(cfg) -> Iterator[Tuple[str, str]]:
    """(port key, unprefixed ultralytics key) for every loaded tensor of a
    YoloV8(cfg), BatchNorm counts aside."""
    def c2f(ours, theirs, n):
        for cv in ("cv1", "cv2"):
            yield from _convbn_pairs(f"{ours}.{cv}", f"{theirs}.{cv}")
        for i in range(n):
            for cv in ("cv1", "cv2"):
                yield from _convbn_pairs(f"{ours}.m{i}.{cv}", f"{theirs}.m.{i}.{cv}")

    for part, table in (("backbone", _BACKBONE), ("neck", _NECK)):
        for ours, idx, n in table:
            if n is None:
                yield from _convbn_pairs(f"{part}.{ours}", idx)
            else:
                yield from c2f(f"{part}.{ours}", idx, cfg.depth_n(n))
        if part == "backbone":
            for cv in ("cv1", "cv2"):
                yield from _convbn_pairs(f"backbone.sppf.{cv}", f"9.{cv}")
    for i in range(3):
        for branch, ours in (("cv2", "box"), ("cv3", "cls")):
            for j in (0, 1):
                yield from _convbn_pairs(f"head.{ours}{i}_{j}", f"22.{branch}.{i}.{j}")
            for leaf in ("weight", "bias"):
                yield f"head.{ours}{i}_out.{leaf}", f"22.{branch}.{i}.2.{leaf}"


def _count_key(port_key: str):
    return port_key[:-len("running_var")] + "num_batches_tracked" \
        if port_key.endswith(".bn.running_var") else None


def yolo_from_ultralytics(state_dict: Mapping, cfg) -> dict:
    """An ultralytics YOLOv8 state_dict (keys with or without "model." /
    "model.model.") -> the port's YoloV8(cfg) state_dict."""
    pre = _prefix(state_dict)
    out = {}
    for ours, theirs in key_pairs(cfg):
        out[ours] = _f32(state_dict[pre + theirs])
        count = _count_key(ours)
        if count:
            out[count] = torch.zeros((), dtype=torch.int64)
    return out


def yolo_to_ultralytics(state: Mapping, cfg) -> dict:
    """The port's YoloV8 state_dict -> unprefixed ultralytics keys (float32;
    no BatchNorm counts and no DFL conv, as the JAX package's
    flax_to_ultralytics_keys writes them)."""
    return {theirs: _f32(state[ours]) for ours, theirs in key_pairs(cfg)}
