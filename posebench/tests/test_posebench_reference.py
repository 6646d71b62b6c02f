"""The plain reference against the program at a tiny size on the CPU,
where the program's kernel wrappers run their plain versions: in float32
the two agree to rounding; in the configuration's bf16 they differ by
bf16's rounding and no more."""

import time

import pytest

from posebench import run
from posebench.tests.tiny import few_threads, tiny_cell

few_threads()


def _as_float32(cell):
    cell.config["pipeline"]["compute_dtype"] = "float32"
    cell.config["detector"]["dtype"] = "float32"
    return cell


@pytest.mark.parametrize("name", ["rgbd_folded.b128x1", "rgbd_geometric_folded.b128x1",
                                  "rgbd_folded.b64x8"])
def test_float32_program_equals_the_reference(name):
    # float32 throughout, the stem kernel's plain version: what is left is
    # float32 rounding in a different order (BatchNorm folded into the
    # program's convolutions, unfolded in the reference)
    cell = _as_float32(tiny_cell(name))
    r = run.serve_cell(cell, 2**31 + 5, 0.05, False, "cpu", time.perf_counter())
    program = {k: p for k, (p, _) in r["verdict"]["readings"].items()}
    assert program["det_gap"] < 1e-4 and program["box_err"] < 1e-4, program
    assert program["pose_add_mm"] < 0.05, program
    # and well inside bf16's own error, which the numbers compared are over
    assert max(r["verdict"]["numbers"].values()) < 0.05, r["verdict"]["numbers"]


@pytest.mark.parametrize("name", ["rgbd_folded.b128x1", "rgbd_folded.b64x8"])
def test_bf16_program_is_near_the_reference(name):
    # the configuration as served, in bf16: on the CPU at this size the
    # program's readings were 1.0-2.3 times the bf16 reference's own
    r = run.serve_cell(tiny_cell(name), 2**31 + 6, 0.05, False, "cpu", time.perf_counter())
    n = r["verdict"]["numbers"]
    assert max(n.values()) < 3.0, n
    assert r["verdict"]["judged"] >= 1
