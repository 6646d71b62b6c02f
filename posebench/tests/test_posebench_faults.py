"""The check that decides `correct` fails where it has to: the program's
own int8 mode (the lower-precision control) reads above the program on the
numbers compared, and a run whose timed path is broken underneath comes out
not correct, for each fault a serving cell can have: half of each batch
left out (its answers those of the other half), and an answer altered
where it is produced: in a tile of 16 answers a batch, which the 99th
percentiles catch, and in the last answer of each batch alone, which
only the worst-answer numbers can (one answer in 128 at the cells' size).
A run here skips the look for a card (run.main's) and drives the rest of
a run (run.serve_cell) on the CPU at a tiny size."""

import time

import pytest
import torch

from posebench import cells, judge, run
from posebench.tests.tiny import few_threads, tiny_cell

few_threads()
SEED = 2**31 + 11


def _run(cell, control=False):
    r = run.serve_cell(cell, SEED, 0.05, False, "cpu", time.perf_counter(), control)
    return r["verdict"]


@pytest.mark.parametrize("name", ["rgbd_folded.b128x1", "rgbd_geometric_folded.b128x1",
                                  "rgbd_folded.b64x8"])
def test_the_int8_control_reads_above_the_program(name):
    # on the CPU at this size the program read 1.0-2.3 and the control
    # 4.7-17 times the bf16 reference's own error
    program = _run(tiny_cell(name))["numbers"]
    control = _run(tiny_cell(name), control=True)["numbers"]
    for k in program:
        assert control[k] > 2 * program[k], (k, program, control)


def _half_left_out(monkeypatch):
    """The pipeline serves the first half of each batch's frames and answers
    the second half with the first half's answers."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    run_all = PosePipeline._run

    def half(self, frames, camera_K, depth):
        n = frames.shape[0] // 2
        out = run_all(self, frames[:n], camera_K[:n], None if depth is None else depth[:n])
        return {k: v if isinstance(v, dict) else torch.cat([v, v]) for k, v in out.items()}

    monkeypatch.setattr(PosePipeline, "_run", half)


def _pose_altered(monkeypatch):
    """The pose net's answers of one tile of 16 rows of each batch are
    altered where they are produced: each rotation's x and w swapped."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    forward = PosePipeline.pose_forward

    def altered(self, inputs):
        rot, trans = forward(self, inputs)
        rot = rot.clone()
        rot[:16] = rot[:16][:, [3, 1, 2, 0]]
        return rot, trans

    monkeypatch.setattr(PosePipeline, "pose_forward", altered)


def _box_altered(monkeypatch):
    """The decode's detections of one tile of 16 frames of each batch are
    moved by 3 of the finest level's strides."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    decode = PosePipeline._decode

    def altered(self, outputs, det_hw):
        dets = decode(self, outputs, det_hw)
        dets["boxes"] = dets["boxes"].clone()
        dets["boxes"][:16] += 24.0
        return dets

    monkeypatch.setattr(PosePipeline, "_decode", altered)


def _last_pose_altered(monkeypatch):
    """The pose net's answer in the last row of each batch alone is altered
    where it is produced, as by a kernel that mishandles a batch's last
    tile: its rotation turned by a further 90 degrees about x (an ADD of
    ~100 mm on the judge's cube)."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    forward = PosePipeline.pose_forward
    s = c = 0.5**0.5

    def altered(self, inputs):
        rot, trans = forward(self, inputs)
        rot = rot.clone()
        x, y, z, w = rot[-1].unbind(-1)  # xyzw, times (s, 0, 0, c)
        rot[-1] = torch.stack([w * s + x * c, y * c + z * s, z * c - y * s, w * c - x * s])
        return rot, trans

    monkeypatch.setattr(PosePipeline, "pose_forward", altered)


def _last_box_altered(monkeypatch):
    """The decode's detections of the last frame of each batch alone are
    moved by 3 of the finest level's strides."""
    from pose6d_tpu_torch.infer.pipeline import PosePipeline

    decode = PosePipeline._decode

    def altered(self, outputs, det_hw):
        dets = decode(self, outputs, det_hw)
        dets["boxes"] = dets["boxes"].clone()
        dets["boxes"][-1:] += 24.0
        return dets

    monkeypatch.setattr(PosePipeline, "_decode", altered)


@pytest.mark.parametrize("fault", [_half_left_out, _pose_altered, _box_altered,
                                   _last_pose_altered, _last_box_altered])
@pytest.mark.parametrize("name", ["rgbd_folded.b128x1", "rgbd_geometric_folded.b128x1",
                                  "rgbd_folded.b64x8"])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    sound = _run(cell)["numbers"]
    fault(monkeypatch)
    broken = _run(cell)
    checks, correct = run.judged(broken, cell.limits)
    assert not correct, checks
    assert broken["failed"] > 0
    assert max(broken["numbers"].values()) > 3 * max(sound.values()), (sound, checks)
    if fault in (_last_pose_altered, _last_box_altered):
        worst = judge.WORST_NUMBERS["pose_add_mm" if fault is _last_pose_altered else "box_err"]
        assert checks[worst]["value"] > checks[worst]["limit"], checks


def test_one_answer_in_128_fails_a_worst_number_and_no_percentile():
    # the cells' size: a ring of 2 batches of 128 answers, one frame slot
    # wrong in each; the 99th percentiles lie below the 2 wrong answers
    limits = cells.load("rgbd_folded.b128x1").limits
    g = torch.Generator().manual_seed(5)
    bf16 = {k: torch.rand(256, generator=g, dtype=torch.float64) + 0.5 for k in judge.READINGS}
    program = {k: v * (0.8 + 0.4 * torch.rand(256, generator=g, dtype=torch.float64))
               for k, v in bf16.items()}
    sound = judge.numbers(program, bf16, bf16)
    assert all(sound[k] <= limits[k] for k in judge.NUMBERS), sound
    for k, worst in judge.WORST_NUMBERS.items():
        bad = {r: v.clone() for r, v in program.items()}
        bad[k][[127, 255]] *= 20
        n = judge.numbers(bad, bf16, bf16)
        assert n[judge.QUANTILE_NUMBERS[k]] <= limits[judge.QUANTILE_NUMBERS[k]], n
        assert n[worst] > limits[worst], n
