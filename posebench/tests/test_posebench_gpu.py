"""One short run of a cell on the card: the last line of standard output
is the result, with the keys and the device a caller reads. Skips where
there is no card; run it on the card with
    python -m pytest -p no:cacheprovider posebench/tests/test_posebench_gpu.py
"""

import json
import subprocess
import sys

import pytest

from posebench import cells


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_card_run_prints_its_result(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card only")
    out = subprocess.run([sys.executable, "-m", "posebench.run", "--workload",
                          "rgbd_folded.b128x1", "--seed", str(2**31 + 77), "--seconds", "2",
                          "--trace", str(trace)], cwd=cells.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert line["device"]["memory_peak_bytes"] > 0
    cell = cells.load("rgbd_folded.b128x1")
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in wanted}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    last = out.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") for s in last)
