"""Everything a cell needs is found by name, so that a configuration, a
traffic mix, a cell and a per-layer metric are each added as new files and
entries, with no edit to a file that is there."""

import json
import os
import shutil

import pytest

from posebench import cells, judge

ROOT = cells.ROOT


def test_every_cell_of_the_benchmark_loads():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"frames_per_s", "batch_p95_ms",
                                                         "setup_s"}
        assert set(cell.limits) == set(judge.NUMBERS)
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_an_added_config_mix_cell_and_metric_are_found(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a cell and a
    per-layer metric, each as new files and entries."""
    shutil.copytree(cells.HERE, tmp_path / "posebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    here = tmp_path / "posebench"
    cfg = json.load(open(here / "configs" / "rgbd_folded.json"))
    cfg.update(name="rgbd_unfolded_stem", fold={"pallas_stem": True, "pallas_layer1": False,
                                                 "pallas_stages": []})
    (here / "configs" / "rgbd_unfolded_stem.json").write_text(json.dumps(cfg))
    mix = json.load(open(here / "traffic" / "b128x1.json"))
    mix.update(frames_per_batch=64)
    (here / "traffic" / "b64x1.json").write_text(json.dumps(mix))
    (here / "limits" / "rgbd_unfolded_stem.b64x1.json").write_text(
        json.dumps(dict.fromkeys(judge.NUMBERS, 3.0)))
    (here / "layer_metrics" / "batches_traced.py").write_text(
        "def read(rec):\n    return rec.get('batches')\n")
    bench["configs"].append({"name": "rgbd_unfolded_stem", "source": "x",
                             "file": "posebench/configs/rgbd_unfolded_stem.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "rgbd_unfolded_stem.b64x1",
                               "config": "rgbd_unfolded_stem", "traffic": "b64x1",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "batches_traced", "unit": "batches",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("rgbd_unfolded_stem.b64x1", root=str(tmp_path), here=str(here))
    assert cell.traffic["frames_per_batch"] == 64
    assert cell.config["fold"]["pallas_layer1"] is False
    assert "batches_traced" in [m["name"] for m in cell.per_layer]
    assert cells.reader("batches_traced", here=str(here))({"batches": 12}) == 12


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load("no_such.cell")


def test_readers_return_nothing_where_there_is_nothing_to_read():
    for m in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["per_layer"]:
        assert cells.reader(m["name"])({"batches": 0, "stage_device_ms": {}}) is None, m["name"]
