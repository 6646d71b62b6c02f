"""The evidence document's assembler and markdown producers of the port
(cli/parity_md.py, serving_md.py, multiobj_md.py, parity_diagnosis.py,
parity_summarize.py, selection_study.py) against the JAX scripts on the
same inputs:

  - SECTIONS equals scripts/parity_md.SECTIONS; sections come out in that
    order, rewriting one never clobbers another, and nothing is written
    outside the workdir (not even for a workdir named `parity`);
  - each producer's table rows carry the JAX script's numbers on the same
    canned eval_e2e logs, results.json, probe JSON and metrics.csv files
    (each JAX script run as a subprocess: their top level imports no JAX);
  - the multi-object report lines of the port's eval_e2e parse with the
    JAX multiobj_md's regexes;
  - selection_study with its eval runner stubbed: the JSON, the "—" cells,
    merging into an existing selection_results.json, and a non-zero exit
    when an eval fails, after the table is written.
"""

import argparse
import csv
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

from pose6d_tpu_torch.cli import (eval_e2e, multiobj_md, parity_diagnosis, parity_md,
                                  parity_summarize, selection_study, serving_md)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name: str, *argv) -> None:
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"{name}.py"), *argv],
                       cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


def _table_rows(text: str) -> list:
    """The data rows of the markdown tables in text, as [cells]: the rows
    after each table's |---| separator."""
    rows, in_table = [], False
    for line in text.splitlines():
        if line.startswith("|---"):
            in_table = True
        elif line.startswith("|") and in_table:
            rows.append([c.strip() for c in line.strip().strip("|").split("|")])
        else:
            in_table = False
    return rows


def _numbers(cells) -> list:
    return [float(x) for c in cells for x in re.findall(r"-?\d+\.?\d*|nan", c)
            if x != "nan"]


def _section(workdir, name: str) -> str:
    with open(os.path.join(workdir, "sections", f"{name}.md")) as f:
        return f.read()


def _repo_digest() -> str:
    """A digest of the pre-port evidence the port must never write: the
    root PARITY_RESULTS.md and every file under parity/sections/ and
    parity_sym/."""
    h = hashlib.sha256()
    paths = [os.path.join(REPO, "PARITY_RESULTS.md")]
    for d in ("parity/sections", "parity_sym"):
        for root, _, files in os.walk(os.path.join(REPO, d)):
            paths += [os.path.join(root, f) for f in sorted(files) if f.endswith((".md", ".json"))]
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(p.encode() + f.read())
    return h.hexdigest()


# ------------------------------------------------------------------ assembler

def test_sections_equal_jax():
    assert parity_md.SECTIONS == _jax_script("parity_md").SECTIONS


def test_assembler_order_and_no_clobber(tmp_path):
    wd = str(tmp_path)
    parity_md.write_section(wd, "symmetric", "## Symmetric objects\nS")
    parity_md.write_section(wd, "e2e", "## Full-system (detector-in-the-loop) evaluation\nB")
    parity_md.write_section(wd, "base", "# Accuracy-parity evidence\nA")
    text = (tmp_path / "PARITY_RESULTS.md").read_text()
    assert text.index("# Accuracy") < text.index("## Full-system") < text.index("## Symmetric")
    parity_md.write_section(wd, "base", "# Accuracy-parity evidence\nA2")
    text = (tmp_path / "PARITY_RESULTS.md").read_text()
    assert "A2" in text and "\nB\n" in text and "\nS\n" in text and "\nA\n" not in text
    with pytest.raises(AssertionError):
        parity_md.write_section(wd, "nonsense", "x")


def test_assembler_writes_only_in_its_workdir(tmp_path, monkeypatch):
    """A workdir named `parity` (the JAX assembler's canonical case) and the
    repo as the working directory: only <workdir>/sections/*.md and
    <workdir>/PARITY_RESULTS.md appear, and the repo's evidence is as it was."""
    before = _repo_digest()
    monkeypatch.chdir(REPO)
    wd = tmp_path / "parity"
    for name, header in parity_md.SECTIONS:
        out = parity_md.write_section(str(wd), name, header + "\nbody")
        assert out == str(wd / "sections" / f"{name}.md")
    assert parity_md.assemble(str(wd)) == str(wd / "PARITY_RESULTS.md")
    made = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*") if p.is_file())
    assert made == sorted([f"parity/sections/{n}.md" for n, _ in parity_md.SECTIONS]
                          + ["parity/PARITY_RESULTS.md"])
    text = (wd / "PARITY_RESULTS.md").read_text()
    assert [text.index(h) for _, h in parity_md.SECTIONS] == sorted(
        text.index(h) for _, h in parity_md.SECTIONS)
    assert _repo_digest() == before


def test_card_of(tmp_path):
    assert parity_md.card_of(str(tmp_path)) == "card not recorded"
    (tmp_path / "device.txt").write_text("NVIDIA H100 80GB HBM3, 700.00 W\n3.12.3 2.11.0 12.8\n")
    assert parity_md.card_of(str(tmp_path)) == "NVIDIA H100 80GB HBM3, 700.00 W"


# --------------------------------------------------- canned eval_e2e logs

def _single_log(seed: int) -> str:
    """A single-object eval_e2e report in the port's format (cli/eval_e2e.py)."""
    r = np.random.default_rng(seed)
    det, cls = r.uniform(90, 100), r.uniform(90, 100)
    add, adds, acc = r.uniform(5, 50), r.uniform(3, 20), r.uniform(10, 99)
    return (f"split test: 420 frames\n"
            f"detection rate: {det:.1f}%  class acc (of detected): {cls:.1f}%\n"
            f"ADD (detected): {add:.1f}mm  ADD-S (detected): {adds:.1f}mm  "
            f"ADD-0.1d (detected): {acc:.2f}%\n"
            f"ADD-0.1d (full system, undetected = incorrect): {acc * det / 100:.2f}%\n"
            f"evaluated 420 frames in 3.100 s after set-up: 135.48 frames/s (host clock)\n")


def _multi_log(seed: int) -> str:
    r = np.random.default_rng(seed)
    det, add, adds, acc = r.uniform(50, 100), r.uniform(5, 60), r.uniform(3, 30), r.uniform(5, 99)
    return (f"split train: 96 frames, 384 GT objects (max_objects=4)\n"
            f"object detection rate (class-matched): {det:.1f}%\n"
            f"ADD (matched): {add:.1f}mm  ADD-S (matched): {adds:.1f}mm  "
            f"ADD-0.1d (matched): {acc:.2f}%\n"
            f"ADD-0.1d (full system, unmatched = incorrect): {acc * det / 100:.2f}%\n")


def _write(path, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_serving_rows_match_jax(tmp_path):
    jwd, twd = tmp_path / "jax", tmp_path / "port"
    for i, v in enumerate(("rgbd_geometric", "rgb")):
        for j, mode in enumerate(("float", "int8", "folded", "folded_kernels")):
            text = _single_log(10 * i + j)
            _write(str(twd / "logs" / f"e2e_{mode}_{v}.log"), text)
            if mode != "folded_kernels":
                _write(str(jwd / "logs" / f"e2e_{mode}_{v}.log"), text)
    _run_jax("serving_md", "--workdir", str(jwd))
    serving_md.main(["--workdir", str(twd), "--variants", "rgbd_geometric", "rgb",
                     "--device", "cpu"])
    want = _table_rows(_section(jwd, "serving"))
    got = _table_rows(_section(twd, "serving"))
    assert len(want) == 6 and len(got) == 8
    # the port's rows without its fourth mode, in the JAX script's order
    got_common = [r for r in got if "kernels" not in r[1]]
    assert [r[0] for r in got_common] == [r[0] for r in want]
    for g, w in zip(got_common, want):
        assert _numbers(g[2:]) == _numbers(w[2:]), (g, w)
    kern = [r for r in got if "kernels" in r[1]]
    assert [r[0] for r in kern] == ["rgbd_geometric", "rgb"]
    assert _numbers(kern[0][2:]) == [serving_md.parse_log(str(
        twd / "logs" / "e2e_folded_kernels_rgbd_geometric.log"))[k] for k in serving_md.PATTERNS]


def test_serving_without_logs_exits(tmp_path):
    with pytest.raises(SystemExit) as e:
        serving_md.main(["--workdir", str(tmp_path), "--device", "cpu"])
    assert e.value.code not in (None, 0)


def test_multiobj_rows_match_jax(tmp_path):
    jwd, twd = tmp_path / "jax", tmp_path / "port"
    ft = ("[yolo] epoch 8/9 loss 1.8706 mAP@50 0.9698 (best 0.9726, 120.5s)\n"
          "[yolo] epoch 9/9 loss 1.8241 mAP@50 0.9722 (best 0.9726, 177.4s)\nmAP@50: 0.9722\n")
    _write(str(jwd / "logs" / "r5_yolo_ft.log"), ft)
    _write(str(twd / "logs" / "yolo_ft.log"), ft)
    for i, v in enumerate(("rgb", "rgbd_geometric")):
        for j, det in enumerate(("base", "ftlast")):
            text = _multi_log(10 * i + j)
            _write(str(jwd / "logs" / f"r5_e2e_multiobj_{det}_{v}.log"), text)
            _write(str(twd / "logs" / f"e2e_multiobj_{det}_{v}.log"), text)
        single = _single_log(50 + i)
        _write(str(jwd / "logs" / f"r5_e2e_ftlast_singleobj_{v}.log"), single)
        _write(str(twd / "logs" / f"e2e_ftlast_singleobj_{v}.log"), single)
    _run_jax("multiobj_md", "--workdir", str(jwd))
    multiobj_md.main(["--workdir", str(twd), "--variants", "rgb", "rgbd_geometric",
                      "--device", "cpu"])
    jtext, ttext = _section(jwd, "multiobj"), _section(twd, "multiobj")
    want, got = _table_rows(jtext), _table_rows(ttext)
    assert len(want) == len(got) == 4
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and _numbers(g[2:]) == _numbers(w[2:]), (g, w)
    # the fine-tune's last epoch and each single-object gate, as JAX reads them
    assert "epoch 9, loss 1.8241, mixed-val mAP@50 0.9722" in ttext
    for v in ("rgbd_geometric", "rgb"):
        g = multiobj_md.parse_single(str(twd / "logs" / f"e2e_ftlast_singleobj_{v}.log"))
        line = (f"{v} det {g['det_rate']:.1f}% / class acc {g['cls']:.1f}% / full-system "
                f"{g['full']:.2f}%")
        assert line in ttext and line in jtext


def _fake_multi_inputs():
    """eval_e2e._eval_multi's inputs, stubbed: 3 frames of 2-3 objects, a
    pipeline whose detections match some of them, an evaluator that
    returns fixed metrics."""
    obj = lambda oid: types.SimpleNamespace(obj_id=oid, rot_mat=np.eye(3),  # noqa: E731
                                            trans_mm=np.array([0.0, 0.0, 800.0]))
    frames = [types.SimpleNamespace(img_path="", depth_path="", cam_K=np.eye(3),
                                    objects=[obj(o) for o in oids])
              for oids in ((0, 1), (1, 2, 3), (0, 3))]

    class Pipe:
        def __call__(self, frames, K, depths):
            import torch

            B = len(frames)
            return {"det_valid": torch.tensor([[True, True, False, False]] * B),
                    "class_id": torch.tensor([[0, 1, 2, 3]] * B),
                    "rotation": torch.tensor([[0.0, 0, 0, 1]]).expand(B, 4, 4),
                    "translation": torch.zeros(B, 4, 3)}

    class Evaluator:
        def eval_metrics(self, pq, pt, gq, gt, ids):
            n = int((ids >= 0).sum())
            return {"add_mean": 12.5, "add_s_mean": 7.25, "add_01d_acc": 62.5, "count": n}

    args = argparse.Namespace(max_objects=4, batch_size=2, variant="rgb", int8_backbone=False,
                              split="train")
    return args, frames, Pipe(), Evaluator()


def test_eval_e2e_multi_object_lines_parse_with_jax_regexes(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(eval_e2e, "_load_frames",
                        lambda paths, need_depth: (np.zeros((len(paths), 8, 8, 3), np.uint8),
                                                   np.zeros((len(paths), 8, 8), np.float32)))
    args, frames, pipe, ev = _fake_multi_inputs()
    eval_e2e._eval_multi(args, frames, pipe, ev, {0: 0, 1: 1, 2: 2, 3: 3})
    text = capsys.readouterr().out
    # 7 GT objects; detections of classes 0 and 1 in every frame: 4 matched
    want = {"objects": 7.0, "det_rate": 57.1, "add_mm": 12.5, "add01d_matched": 62.50,
            "add01d_full": 35.71}
    path = str(tmp_path / "multi.log")
    _write(path, text)
    assert _jax_script("multiobj_md").parse_log(path) == want
    assert multiobj_md.parse_log(path) == want


# ------------------------------------------------------------------ diagnosis

def _results_entry(best: float, epoch: int, run: int, loss: float) -> dict:
    return {"best_add01d": best, "best_epoch": epoch, "epochs_run": run,
            "val_add_mm_at_best": 30.0, "val_add_s_mm_at_best": 10.0,
            "final_train_loss": loss, "epoch_half_best": 2}


def test_diagnosis_rows_match_jax(tmp_path):
    results = {"rgbd": _results_entry(4.241, 63, 100, 0.61234),
               "rgbd_widehead": _results_entry(4.24, 40, 75, 0.6),
               "rgbd_noattn": _results_entry(11.3839, 181, 200, 0.2134),
               "rgbd_zeroattn": _results_entry(4.6875, 90, 150, 0.59871)}
    with open(os.path.join(REPO, "parity", "rgbd_gradient_probe.json")) as f:
        probe = f.read()
    for wd in (tmp_path / "jax", tmp_path / "port"):
        _write(str(wd / "results.json"), json.dumps(results))
        _write(str(wd / "rgbd_gradient_probe.json"), probe)
    _run_jax("parity_diagnosis", "--workdir", str(tmp_path / "jax"))
    parity_diagnosis.main(["--workdir", str(tmp_path / "port"), "--device", "cpu"])
    want = _table_rows(_section(tmp_path / "jax", "diagnosis"))
    got = _table_rows(_section(tmp_path / "port", "diagnosis"))
    assert len(want) == len(got) == 4
    for g, w in zip(got, want):
        assert g == w


def test_diagnosis_names_the_arms_not_run(tmp_path):
    _write(str(tmp_path / "results.json"),
           json.dumps({"rgbd": _results_entry(5.0, 10, 100, 0.5)}))
    parity_diagnosis.main(["--workdir", str(tmp_path), "--device", "cpu"])
    text = _section(tmp_path, "diagnosis")
    assert len(_table_rows(text)) == 1
    assert "Not run on the card: `rgbd_widehead`, `rgbd_noattn`, `rgbd_zeroattn`" in text
    assert "The gradient probe has not run" in text


# ------------------------------------------------------------------ summarize

METRICS = ["epoch", "train_loss", "val_add", "val_add_s", "val_acc", "val_acc_deploy", "lr",
           "steps_per_sec", "imgs_per_sec"]


def _metrics_csv(path, rng, epochs: list) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(METRICS)
        for e in epochs:  # repeated epochs: a resume's restart window
            w.writerow([e, *np.round(rng.uniform(0.1, 99, len(METRICS) - 1), 4)])


def _canned_parity_tree(root, extra_result: dict) -> None:
    rng = np.random.default_rng(3)
    _metrics_csv(str(root / "weights_rgbd_geometric" / "metrics.csv"), rng,
                 list(range(6)) + [4, 5, 6, 7])
    _metrics_csv(str(root / "weights_rgbd_geometric_widehead" / "metrics.csv"), rng, [0, 1, 2])
    _metrics_csv(str(root / "weights_rgbd_noattn" / "metrics.csv"), rng, list(range(9)))
    _write(str(root / "results.json"), json.dumps(extra_result))


def test_summarize_matches_jax_summarize_and_refresh(tmp_path):
    gone = {"rgb": _results_entry(6.25, 40, 100, 0.3)}  # its weights are not on disk
    for name in ("jax", "refresh", "port"):
        _canned_parity_tree(tmp_path / name, gone)
    _run_jax("parity_summarize", "--workdir", str(tmp_path / "jax"))
    parity_summarize.main(["--workdir", str(tmp_path / "port"), "--device", "cpu"])
    want = json.load(open(tmp_path / "jax" / "results.json"))
    got = json.load(open(tmp_path / "port" / "results.json"))
    assert got == want and set(got) == {"rgb", "rgbd_geometric", "rgbd_geometric_widehead",
                                        "rgbd_noattn"}
    assert got["rgbd_geometric"]["epochs_run"] == 8
    wrows = _table_rows(_section(tmp_path / "jax", "base"))
    grows = _table_rows(_section(tmp_path / "port", "base"))
    assert [r[0] for r in grows] == [r[0] for r in wrows]
    for g, w in zip(grows, wrows):
        assert _numbers(g[1:]) == _numbers(w[1:])
    # refresh_parity_base refreshes the runs already in results.json that have a curve
    seeded = {k: v if k in gone else dict(v, best_add01d=0.0) for k, v in want.items()}
    _write(str(tmp_path / "refresh" / "results.json"), json.dumps(seeded))
    _run_jax("refresh_parity_base", "--workdir", str(tmp_path / "refresh"))
    assert json.load(open(tmp_path / "refresh" / "results.json")) == got


# ------------------------------------------------------------------ selection

def _e2e_out(acc: float) -> str:
    return (f"detection rate: 99.0%  class acc (of detected): 98.6%\n"
            f"ADD (detected): 10.2mm  ADD-S (detected): 7.5mm  ADD-0.1d (detected): {acc:.2f}%\n"
            f"ADD-0.1d (full system, undetected = incorrect): {acc - 1:.2f}%\n")


def _selection_tree(root, runs: dict) -> None:
    for name, ckpts in runs.items():
        os.makedirs(root / f"weights_{name}", exist_ok=True)
        for c in ckpts:
            (root / f"weights_{name}" / f"{c}.pt").write_bytes(b"")


def test_selection_table_matches_jax(tmp_path):
    results = {"rgb": {"best": {"add01d_full": 27.6}, "last": {"add01d_full": 60.8}},
               "rgbd_geometric": {"best": {"add01d_full": 95.95},
                                  "best_deploy": {"add01d_full": 96.1},
                                  "last": {"add01d_full": 95.7}},
               "rgbd_geometric_widehead": {"best_deploy": {"add01d_full": 97.5}}}
    for name in ("jax", "port"):
        _write(str(tmp_path / name / "selection_results.json"), json.dumps(results))
    _run_jax("selection_study", "--workdir", str(tmp_path / "jax"), "--md-only")
    selection_study.main(["--workdir", str(tmp_path / "port"), "--md-only", "--device", "cpu"])
    want = _table_rows(_section(tmp_path / "jax", "selection"))
    got = _table_rows(_section(tmp_path / "port", "selection"))
    assert got == want and len(got) == 3
    assert got[0] == ["rgb", "27.60", "—", "60.80"]


def test_selection_runs_merges_and_fails_loud(tmp_path):
    wd = tmp_path
    _selection_tree(wd, {"rgbd_geometric": ("best", "best_deploy", "last"),
                         "rgbd_geometric_widehead": ("best_deploy", "last")})
    _write(str(wd / "selection_results.json"),
           json.dumps({"rgb": {"best": {"add01d_full": 27.6}}}))
    ran = []

    def runner(cmd):
        ran.append(cmd)
        ckpt = cmd[cmd.index("--checkpoint") + 1]
        if "widehead" in cmd[cmd.index("--pose-weights") + 1] and ckpt == "last":
            return 3, "Traceback: out of memory\n"
        return 0, _e2e_out({"best": 90.0, "best_deploy": 91.0, "last": 92.0}[ckpt])

    with pytest.raises(SystemExit) as e:
        selection_study.main(["--workdir", str(wd), "--variants", "rgbd_geometric",
                              "rgbd_geometric_widehead", "rgbd", "--device", "cpu"],
                             runner=runner)
    assert e.value.code not in (None, 0) and "rgbd_geometric_widehead/last" in str(e.value.code)
    # 3 + 2 evals (rgbd has no weights), each eval_e2e with the run's flags
    assert len(ran) == 5 and all(c[1:3] == ["-m", "pose6d_tpu_torch.cli.eval_e2e"] for c in ran)
    assert [c[c.index("--checkpoint") + 1] for c in ran] == [
        "best", "best_deploy", "last", "best_deploy", "last"]
    assert all(("--rot-head-wide" in c) == ("widehead" in c[c.index("--pose-weights") + 1])
               and c[c.index("--device") + 1] == "cpu" for c in ran)
    res = json.load(open(wd / "selection_results.json"))
    assert set(res) == {"rgb", "rgbd_geometric", "rgbd_geometric_widehead"}
    assert res["rgbd_geometric"]["last"]["add01d_full"] == 91.0
    assert set(res["rgbd_geometric_widehead"]) == {"best_deploy"}
    assert (wd / "logs" / "selection_rgbd_geometric_widehead_last.log").read_text().startswith(
        "Traceback")
    # the table was written before the exit: every run merged, "—" where missing
    rows = _table_rows(_section(wd, "selection"))
    assert rows == [["rgb", "27.60", "—", "—"],
                    ["rgbd_geometric", "89.00", "90.00", "91.00"],
                    ["rgbd_geometric_widehead", "—", "90.00", "—"]]
