"""The accuracy-evidence CLIs and the one-command reproduction of the port
(cli/parity_run.py, parity_e2e.py, probe_components.py, reproduce.py):

  - summarize_variant on the JAX run's committed metrics.csv equals
    scripts/parity_run.summarize_variant's, and parse_e2e on the JAX run's
    committed eval_e2e logs equals scripts/parity_e2e.parse_e2e's (both
    JAX scripts imported by path: their top level is the standard library);
  - a tiny parity_run on the CPU (2 objects x 10 frames, img 32, 1 epoch,
    rgbd_geometric with the wide head): results.json, metrics.csv, the
    weights and PARITY.md, a second call resuming; probe_components on its
    weights; parity_e2e's table from saved results; the three tables are
    also the base, attribution and e2e sections of PARITY_RESULTS.md;
  - reproduce without --resnet50-pth exits 2 naming resnet50 and writes
    nothing; its stages, their order and the gate with subprocess faked;
    its dry run on the CPU is slow, as tests/test_reproduce_dryrun.py's
    is."""

import argparse
import csv
import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

from pose6d_tpu_torch.cli import parity_e2e, parity_run, probe_components
from torch_port_utils import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("run", ["rgbd_geometric", "rgbd_geometric_widehead", "rgb"])
def test_summarize_variant_matches_jax(run):
    save_dir = os.path.join(REPO, "parity", f"weights_{run}")
    best = max(float(r["val_acc"]) for r in csv.DictReader(open(os.path.join(save_dir,
                                                                             "metrics.csv"))))
    want = _jax_script("parity_run").summarize_variant(save_dir, best)
    assert parity_run.summarize_variant(save_dir, best) == want
    assert want["best_add01d"] == best


@pytest.mark.parametrize("log", ["e2e_float_rgbd_geometric", "e2e_float_rgb",
                                 "e2e_folded_rgb", "e2e_int8_rgbd_geometric"])
def test_parse_e2e_matches_jax(log):
    text = open(os.path.join(REPO, "parity", "logs", f"{log}.log")).read()
    want = _jax_script("parity_e2e").parse_e2e(text)
    assert parity_e2e.parse_e2e(text) == want and len(want) == 6


def test_parse_e2e_reads_the_ports_report():
    """The port's eval_e2e lines (cli/eval_e2e.py), frames/s included."""
    text = ("split test: 420 frames\n"
            "detection rate: 99.0%  class acc (of detected): 98.6%\n"
            "ADD (detected): 10.2mm  ADD-S (detected): 7.5mm  ADD-0.1d (detected): 96.88%\n"
            "ADD-0.1d (full system, undetected = incorrect): 95.95%\n"
            "evaluated 420 frames in 3.100 s after set-up: 135.48 frames/s (host clock)\n")
    assert parity_e2e.parse_e2e(text) == {
        "det_rate": 99.0, "cls_acc": 98.6, "add_mm": 10.2, "add_s_mm": 7.5,
        "add01d_det": 96.88, "add01d_full": 95.95, "frames_per_s": 135.48}


def test_run_names_and_flags():
    args = argparse.Namespace(
        rot_head_wide=True, fusion_attention=False, attn_zero_init=False, z_from_backbone=False,
        z_backbone_wide=False, bf16=True, init_towers_from="donor")
    name = parity_run.run_name("rgbd", args)
    assert name == "rgbd_widehead_noattn_bf16_warmstart"
    assert parity_run.flags_of(name) == {
        "variant": "rgbd", "rot_head_wide": True, "fusion_attention": False,
        "attn_zero_init": False, "z_from_backbone": False, "z_backbone_wide": False,
        "compute_dtype": "bfloat16"}
    assert parity_e2e.eval_args(name) == ("rgbd", ["--rot-head-wide", "--no-fusion-attention"])
    assert parity_e2e.eval_args("rgb_geometric_zbb") == ("rgb_geometric", ["--z-from-backbone"])


def test_tiny_parity_run_probe_and_table(tmp_path, capsys):
    wd = str(tmp_path / "parity")
    argv = ["--workdir", wd, "--objects", "2", "--frames", "10", "--img-size", "32",
            "--batch-size", "4", "--epochs", "1", "--num-workers", "0",
            "--variants", "rgbd_geometric", "--rot-head-wide", "--device", "cpu"]
    parity_run.main(argv)
    name = "rgbd_geometric_widehead"
    save_dir = os.path.join(wd, f"weights_{name}")
    assert sorted(os.listdir(os.path.join(wd, "synth", "data"))) == ["01", "02"]
    results = json.load(open(os.path.join(wd, "results.json")))
    assert list(results) == [name] and results[name]["epochs_run"] == 1
    rows = list(csv.DictReader(open(os.path.join(save_dir, "metrics.csv"))))
    assert len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0].values())
    assert {"last.pt", "best_deploy.pt"} <= set(os.listdir(save_dir))
    assert f"| {name} |" in open(os.path.join(wd, "PARITY.md")).read()
    # the same table is the document's `base` section (cli/parity_md.py)
    assert open(os.path.join(wd, "sections", "base.md")).read() == \
        open(os.path.join(wd, "PARITY.md")).read()
    # a second call resumes: the epoch is done, nothing more trains
    parity_run.main(argv)
    assert len(list(csv.DictReader(open(os.path.join(save_dir, "metrics.csv"))))) == 1

    # the probe reads `last` (best exists only once val ADD-0.1d rose above 0)
    probe_components.main(["--workdir", wd, "--variants", name, "--ckpt", "last",
                           "--img-size", "32", "--batch-size", "2", "--num-workers", "0",
                           "--device", "cpu"])
    probe = json.load(open(os.path.join(wd, "probe_results.json")))
    assert [r["variant"] for r in probe] == [name]
    assert sorted(probe[0]["per_object"]) == ["0", "1"]
    assert all(math.isfinite(probe[0][k])
               for k in ("val_geodesic_deg", "val_xy_err_mm", "val_z_err_mm"))
    assert "| obj 01 (d=121mm) | obj 02 (d=163mm) |" in open(os.path.join(wd, "PROBE.md")).read()
    assert open(os.path.join(wd, "sections", "attribution.md")).read() == \
        open(os.path.join(wd, "PROBE.md")).read()
    for f in os.listdir(save_dir):
        if f.endswith(".pt"):
            os.remove(os.path.join(save_dir, f))

    # parity_e2e --md-only: the table from saved results, nothing run
    json.dump({name: {"det_rate": 99.0, "add01d_full": 95.95}},
              open(os.path.join(wd, "e2e_results.json"), "w"))
    parity_e2e.main(["--workdir", wd, "--md-only", "--device", "cpu"])
    assert f"| {name} | 99.0 | nan |" in open(os.path.join(wd, "E2E.md")).read()
    doc = open(os.path.join(wd, "PARITY_RESULTS.md")).read()
    assert doc.index("# Accuracy-parity evidence") < doc.index("## Component attribution") \
        < doc.index("## Full-system (detector-in-the-loop) evaluation")


def test_reproduce_refuses_without_resnet50(tmp_path):
    """Without --resnet50-pth the real run exits 2, naming resnet50, before
    it imports torch or writes anything."""
    wd = tmp_path / "wd"
    code = ("import sys, runpy; sys.argv = ['reproduce', '--workdir', sys.argv[1]]\n"
            "try:\n    runpy.run_module('pose6d_tpu_torch.cli.reproduce', run_name='__main__')\n"
            "except SystemExit as e:\n    print('torch' in sys.modules)\n    raise\n")
    r = subprocess.run([sys.executable, "-c", code, str(wd)], cwd=REPO, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 2 and "resnet50" in r.stderr.lower(), r.stderr
    assert r.stdout.strip() == "False" and not wd.exists()


@pytest.mark.parametrize("dry_run", [True, False])
def test_reproduce_stages_and_gate(tmp_path, monkeypatch, dry_run):
    """The stages in scripts/reproduce_reference.sh's order, each a
    `python -m pose6d_tpu_torch.cli.<name>` with --device where it computes
    (subprocess.run faked: compare writes the results); the gate against
    the reference's table; a failing stage stops the run with its code."""
    from pose6d_tpu_torch.cli import reproduce

    wd = str(tmp_path / "wd")
    ran = []
    fail = {}

    def fake_run(cmd):
        name = cmd[2].rsplit(".", 1)[1]
        ran.append((name, cmd[cmd.index("--device") + 1] if "--device" in cmd else None))
        if name == "compare":
            acc = {v: t + 0.4 for v, t in reproduce.TARGETS.items()}
            json.dump({v: {"add_01d_acc": a} for v, a in acc.items()},
                      open(cmd[cmd.index("--json-out") + 1], "w"))
        return subprocess.CompletedProcess(cmd, fail.get(name, 0))

    monkeypatch.setattr(reproduce.subprocess, "run", fake_run)
    argv = ["--workdir", wd, "--device", "cpu"] + (
        ["--dry-run"] if dry_run else ["--resnet50-pth", "r50.pth"])
    assert reproduce.main(argv) == 0
    e2e = ["rgbd_geometric"] if dry_run else ["rgb", "rgbd_geometric"]
    assert [n for n, _ in ran] == (["setup_data", "prepare_yolo", "train_yolo"] + ["train"] * 4
                                   + ["compare"] + ["eval_e2e"] * 3 * len(e2e))
    assert all((d == "cpu") == (n not in ("setup_data", "prepare_yolo")) for n, d in ran)
    # off by more than TOL fails the gate (the dry run checks only presence)
    monkeypatch.setattr(reproduce, "TOL", 0.3)
    assert reproduce.main(argv) == (0 if dry_run else 1)
    ran.clear()
    fail["train_yolo"] = 7
    assert reproduce.main(argv) == 7 and ran[-1][0] == "train_yolo"


@pytest.mark.slow
def test_reproduce_dry_run(tmp_path):
    """The whole command graph on the synthetic fixture at tiny sizes, on
    the CPU."""
    wd = tmp_path / "wd"
    r = subprocess.run([sys.executable, "-m", "pose6d_tpu_torch.cli.reproduce", "--dry-run",
                        "--device", "cpu", "--workdir", str(wd)], cwd=REPO, capture_output=True,
                       text=True, timeout=3000)
    tail = r.stdout[-2000:] + "\n--- stderr ---\n" + r.stderr[-2000:]
    assert r.returncode == 0, tail
    assert "dry-run OK" in r.stdout, tail
    results = json.load(open(wd / "reproduce_results.json"))
    assert sorted(results) == sorted(["rgb", "rgb_geometric", "rgbd", "rgbd_geometric"])
