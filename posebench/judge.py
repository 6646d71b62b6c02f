"""The check that decides `correct`: the program's outputs, as the timed
window produced them, held against the plain reference (reference/).

Every batch the window handed over is waited for and judged; batches whose
outputs are bit for bit those of another batch of the same ring entry are
judged once. Each answer the program gave is judged three ways:

  det_gap      the detection, as a served token's logit is judged: the gap
               between the class logit of each detection slot (recovered
               from its score) and the best logit the reference finds among
               the candidates left to that slot (both taken as
               LOGIT_CEILING where above it): every anchor for the top-1
               decode; with max_objects > 1 the reference's nms_pre_topk
               best anchors, less those that the program's earlier slots
               suppress (same class, IoU >= iou_thresh with the slot's
               box). A slot the program marks invalid while the reference
               still has a candidate, or the reverse, reads infinity.
  box_err      the detection's box: the L-infinity distance from the
               program's box to the nearest box the reference decodes at
               any anchor, in units of that anchor's stride.
  pose_add_mm  the pose: for each box the program returned, the reference
               crops, normalises and runs the towers, the heads and the
               translation itself; the ADD distance between the program's
               pose and the reference's (the mean over the 8 corners of a
               10 cm cube of the distance between the two poses' images of
               each corner), in millimetres.

The reference is float32 with TF32 off. The same three are read for the
reference run in the configuration's own precision, bf16, on the same
answers: the detector under bf16 autocast, the towers BatchNorm-folded in
bf16 (the larger of two memory layouts, whose cuDNN kernels sum in other
orders). The numbers compared (NUMBERS), each with a limit of its own
(limits/<cell>.json):

  det_gap_x, box_err_x, pose_add_x
               for each of the three, the 99th percentile of the program's
               readings over the 99th percentile of the bf16 reference's:
               how many times bf16's own error the program's is. A bare
               reading moves from seed to seed with how sensitive the
               seed's network is (the program's widest pose gap read
               2.1-5.6 mm over 12 seeds, the int8 control's narrowest 11.0
               on an H100); the ratio does not. A fault in fewer than one
               answer in a hundred does not move it.
  box_err_worst_x, pose_add_worst_x
               the largest, over every answer, of the program's reading
               over the bf16 reference's reading of the same answer, the
               latter floored at its median over the run: one answer in
               the run that is wrong by many times bf16's error (a frame
               slot, a tile or a row of a batch mishandled) moves it.
               det_gap has no such number: with NMS a slot's candidates
               change where a box's IoU crosses iou_thresh, and a sound
               run's worst answer then read 23 times bf16's, as the int8
               control's did.

The reference runs once the window has closed and the program's state is
freed, in blocks of frames.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .reference import pipeline as ref

CUBE_M = 0.05
CORNERS = torch.tensor([[x, y, z] for x in (-CUBE_M, CUBE_M) for y in (-CUBE_M, CUBE_M)
                        for z in (-CUBE_M, CUBE_M)])
READINGS = ("det_gap", "box_err", "pose_add_mm")
QUANTILE_NUMBERS = {"det_gap": "det_gap_x", "box_err": "box_err_x", "pose_add_mm": "pose_add_x"}
WORST_NUMBERS = {"box_err": "box_err_worst_x", "pose_add_mm": "pose_add_worst_x"}
NUMBERS = tuple(QUANTILE_NUMBERS.values()) + tuple(WORST_NUMBERS.values())
QUANTILE = 0.99
# a float32 score recovers its logit to 0.01 at 12 and not at all past ~16.6
# (the score rounds to 1): logits above are compared as 12
LOGIT_CEILING = 12.0


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit xyzw quaternions [N, 4] -> rotation matrices [N, 3, 3]."""
    x, y, z, w = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                       -1).reshape(-1, 3, 3)


def add_mm(rot_a, trans_a, rot_b, trans_b) -> torch.Tensor:
    """ADD between two poses per row, over CORNERS, in millimetres."""
    pts = CORNERS.to(rot_a.device, torch.float64)
    pa = pts @ quat_to_mat(rot_a.double()).transpose(1, 2) + trans_a.double()[:, None]
    pb = pts @ quat_to_mat(rot_b.double()).transpose(1, 2) + trans_b.double()[:, None]
    return (pa - pb).norm(dim=-1).mean(-1) * 1e3


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of boxes a [B, A, 4] with one box per row b [B, 4] (xyxy)."""
    lt = torch.maximum(a[..., :2], b[:, None, :2])
    rb = torch.minimum(a[..., 2:], b[:, None, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area_a = (a[..., 2:] - a[..., :2]).clamp_min(0).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).clamp_min(0).prod(-1)
    return inter / (area_a + area_b[:, None] - inter).clamp_min(1e-9)


def _nearest(det: dict, box: torch.Tensor) -> torch.Tensor:
    """The L-infinity distance [B] from box [B, 4] (xyxy) to the nearest box
    the reference decoded in its frame, in that anchor's strides."""
    return ((det["boxes"] - box[:, None]).abs().amax(-1) / det["stride"]).min(1).values


def detection_numbers(det: dict, det16: dict, out: dict, max_objects: int, pre_topk: int,
                      iou_thresh: float) -> tuple:
    """(det_gap, box_err, the bf16 reference's det_gap, its box_err), each
    [B, M], of one batch: det and det16 the reference's detections() of its
    frames in float32 and bf16, out the program's outputs as [B, M, ...].
    The bf16 reference's answer for a slot is its best candidate among
    those left to the program's slot."""
    dev = det["logit"].device
    score = out["det_score"].to(dev, torch.float64)
    valid = out["det_valid"].to(dev)
    port_logit = (torch.log(score) - torch.log1p(-score)).clamp(max=LOGIT_CEILING)
    xywh = out["bbox_xywh"].to(dev, torch.float32)
    boxes = torch.cat([xywh[..., :2], xywh[..., :2] + xywh[..., 2:]], -1)  # [B, M, 4]
    logit = det["logit"].double().clamp(max=LOGIT_CEILING)
    logit16 = det16["logit"].double().clamp(max=LOGIT_CEILING)
    B = logit.shape[0]
    if max_objects == 1:
        avail = torch.ones_like(logit, dtype=torch.bool)
    else:
        top = torch.sort(logit, dim=1, descending=True, stable=True).indices[:, :pre_topk]
        avail = torch.zeros_like(logit, dtype=torch.bool).scatter_(1, top, True)
    none = torch.full_like(logit, -math.inf)
    gaps, errs, gaps16, errs16 = [], [], [], []
    for m in range(boxes.shape[1]):
        left = avail.any(1)
        best = torch.where(avail, logit, none).max(1).values
        best16, arg16 = torch.where(avail, logit16, none).max(1)
        gaps16.append((best - best16).abs())
        errs16.append(_nearest(det, det16["boxes"][torch.arange(B, device=dev), arg16]))
        gap = torch.where(valid[:, m], (best - port_logit[:, m]).abs(), torch.zeros_like(best))
        gaps.append(torch.where(valid[:, m] == left, gap, torch.full_like(gap, math.inf)))
        nearest = _nearest(det, boxes[:, m])
        errs.append(torch.where(valid[:, m], nearest, torch.zeros_like(nearest)))
        same = (det["cls"] == out["class_id"][:, m, None].to(dev)) & valid[:, m, None]
        avail &= ~(same & (_iou(det["boxes"], boxes[:, m]) >= iou_thresh))
    return tuple(torch.stack(t, 1) for t in (gaps, errs, gaps16, errs16))


class Judge:
    """Judges batches of one cell against the reference over the seeded
    state and ring the program was given."""

    def __init__(self, config: dict, traffic: dict, state: tuple, ring: list, limits: dict,
                 block: int = 16):
        self.cfg, self.traffic, self.limits = config, traffic, limits
        self.sd_yolo, self.sd_pose = state
        self.ring, self.block = ring, block
        self._dets = {}

    def _detections(self, r: int, bf16: bool) -> dict:
        """The reference's detections() of ring entry r, in float32 or under
        bf16 autocast."""
        if (r, bf16) not in self._dets:
            frames = self.ring[r]["frames"]
            with torch.autocast(frames.device.type, dtype=torch.bfloat16, enabled=bf16):
                parts = [ref.detections(self.sd_yolo, frames[i:i + self.block],
                                        self.cfg["detector"]["reg_max"])
                         for i in range(0, len(frames), self.block)]
            self._dets[r, bf16] = {
                k: parts[0][k] if k == "stride" else
                torch.cat([p[k].float() if p[k].is_floating_point() else p[k] for p in parts])
                for k in parts[0]}
        return self._dets[r, bf16]

    def _poses(self, r: int, bbox: torch.Tensor, towers=None):
        """The reference's poses of bbox [B, M, 4] in ring entry r, its
        towers in float32 or as `towers` says (reference.pipeline.poses)."""
        entry, pipe = self.ring[r], self.cfg["pipeline"]
        B, M = bbox.shape[:2]
        dev = entry["frames"].device
        rots, transl = [], []
        for i in range(0, B, self.block):
            n = min(self.block, B - i)
            rot, trans = ref.poses(pipe["variant"], self.sd_pose, entry["frames"][i:i + n],
                                   entry["depth"][i:i + n], entry["K"][0],
                                   bbox[i:i + n].reshape(n * M, 4).to(dev),
                                   torch.arange(n, device=dev).repeat_interleave(M),
                                   pipe["img_size"], towers)
            rots.append(rot)
            transl.append(trans)
        return torch.cat(rots), torch.cat(transl)

    def readings(self, r: int, out: dict) -> tuple:
        """({reading: the program's per answer}, {reading: the bf16
        reference's per answer}) of one batch of ring entry r, out its
        outputs as [B, M, ...] tensors."""
        pipe = self.cfg["pipeline"]
        B, M = out["bbox_xywh"].shape[:2]
        gap, err, gap16, err16 = detection_numbers(
            self._detections(r, False), self._detections(r, True), out, M, pipe["nms_pre_topk"],
            pipe["iou_thresh"])
        rot, trans = self._poses(r, out["bbox_xywh"])
        dev = rot.device
        add = add_mm(out["rotation"].reshape(B * M, 4).to(dev),
                     out["translation"].reshape(B * M, 3).to(dev), rot, trans)
        add16 = torch.maximum(*(add_mm(*self._poses(r, out["bbox_xywh"], (torch.bfloat16, fmt)),
                                       rot, trans)
                                for fmt in (torch.contiguous_format, torch.channels_last)))
        program = {"det_gap": gap, "box_err": err, "pose_add_mm": add}
        bf16 = {"det_gap": gap16, "box_err": err16, "pose_add_mm": add16}
        return ({k: v.flatten().double().cpu() for k, v in program.items()},
                {k: v.flatten().double().cpu() for k, v in bf16.items()})

    @torch.no_grad()
    def judge(self, batches: list) -> dict:
        """{"numbers": {number: value}, "readings": {reading: [program's
        99th percentile, bf16 reference's]}, "failed": batches whose own
        numbers exceed a limit, "judged": distinct outputs judged,
        "answers" / "bf16": every answer's readings}."""
        B, M = self.traffic["frames_per_batch"], self.traffic["max_objects"]
        seen = {}
        for b in batches:
            digest = hashlib.sha1(b"".join(np.ascontiguousarray(b.outputs[k]).tobytes()
                                           for k in sorted(b.outputs))).hexdigest()
            seen.setdefault((b.ring, digest), []).append(b)
        program = {k: [] for k in READINGS}
        bf16 = {k: [] for k in READINGS}
        with ref.tf32_off():
            for (r, _), group in seen.items():
                out = {k: torch.from_numpy(v).reshape(B, M, *v.shape[1 if M == 1 else 2:])
                       for k, v in group[0].outputs.items()}
                p, y = self.readings(r, out)
                for k in READINGS:
                    program[k].append(p[k])
                    bf16[k].append(y[k])
        # a batch fails where its own readings, against the whole run's
        # bf16 reference, exceed a limit
        pooled = {k: torch.cat(v) for k, v in bf16.items()}
        failed = sum(len(group) for i, group in enumerate(seen.values())
                     if not self.within(numbers({k: program[k][i] for k in READINGS},
                                                {k: bf16[k][i] for k in READINGS}, pooled)))
        program = {k: torch.cat(v) for k, v in program.items()}
        return {"numbers": numbers(program, pooled, pooled), "failed": failed,
                "judged": len(seen),
                "readings": {k: [quantile(program[k]), quantile(pooled[k])] for k in READINGS},
                "answers": program, "bf16": pooled}

    def within(self, values: dict) -> bool:
        return all(values[k] <= self.limits[k] for k in NUMBERS)


def _finite(x: torch.Tensor) -> torch.Tensor:
    """x with a reading that is infinite or not a number as the largest float."""
    big = torch.finfo(x.dtype).max
    return x.nan_to_num(nan=big, posinf=big)


def quantile(x: torch.Tensor, q: float = QUANTILE) -> float:
    """The q-quantile (linear interpolation) of x's readings."""
    return torch.quantile(_finite(x), q).item()


def numbers(program: dict, bf16: dict, pooled: dict) -> dict:
    """{number: value} of answers whose readings are program[k] and, answer
    for answer, bf16[k] (the bf16 reference's); pooled[k] is the bf16
    reference's readings over the whole run, whose 99th percentile and
    median the numbers are taken against."""
    out = {QUANTILE_NUMBERS[k]: quantile(program[k]) / max(quantile(pooled[k]), 1e-30)
           for k in READINGS}
    for k, name in WORST_NUMBERS.items():
        floor = max(quantile(pooled[k], 0.5), 1e-30)
        out[name] = (_finite(program[k]) / bf16[k].clamp_min(floor)).max().item()
    return out
