"""What a run loads: never JAX nor the JAX package (top-level names
compared whole: the program's own name, pose6d_tpu_torch, begins with the
JAX package's), and the reference nothing of the program."""

import json
import os
import subprocess
import sys

from posebench import cells, run

PROBE_RUN = """
import json, sys, time
import torch
torch.set_num_threads(2)
from posebench import cells, run
from posebench.tests.tiny import tiny_cell
run._environment(cells.ROOT)
r = run.serve_cell(tiny_cell("rgbd_folded.b128x1", img=64), 3, 0.05, False, "cpu",
                   time.perf_counter())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

PROBE_REFERENCE = """
import json, sys
import posebench.reference.pipeline, posebench.reference.nets
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                         text=True, timeout=600, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = set(_modules(PROBE_RUN))
    assert "pose6d_tpu_torch" in top  # the program did run
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _modules(PROBE_REFERENCE)
    assert "posebench.reference.pipeline" in names
    assert not [n for n in names if n.split(".")[0] in ("pose6d_tpu_torch",) + run.FORBIDDEN]
    assert not [n for n in names if n.startswith("posebench.") and
                not n.startswith("posebench.reference")]


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pose6d_tpu_torch_probe", object())
    assert "pose6d_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pose6d_tpu.ops", object())
    assert "pose6d_tpu" in run.loaded_forbidden()
