"""The port's command lines (pose6d_tpu_torch/cli/*), the README's workflow,
run in process through runpy.run_module with --device cpu, as
tests/test_cli_smoke.py runs the JAX scripts.

One module-scoped fixture runs, on a port-generated tree of 2 objects x 12
frames (640x480), with the detector at 160 and the pose net at 64:
setup_data --synthetic, prepare_yolo, train_yolo --epochs 1, train
--variant rgb --epochs 1 --pretrained-backbone <a seeded torchvision-layout
.pth> (the train split resident, batches gathered), compare, infer,
eval_e2e (plain and --folded-backbone), and convert_reference_weights
to-torch then to-port.
The tests then check each step's output: eval_e2e's printed detection rate
and ADD-0.1d equal those of a PosePipeline + ADDEvaluator run in process on
the same checkpoint and frames; eval_e2e also runs --int8-backbone and
--max-objects 2 on a multi-object scene; infer's PNG decodes to the frame's shape; the to-torch / to-port
round trip is bit-equal; the zip branch of setup_data extracts a zip the
test builds; demo runs once at its smallest settings; no compute CLI falls
back to the CPU without --device cpu.
"""

import contextlib
import io
import os
import re
import runpy
import sys
import zipfile

import numpy as np
import pytest
import torch

from torch_port_utils import few_torch_threads  # noqa: F401

DET, POSE = "160", "64"


def run_cli(name, argv):
    """Run pose6d_tpu_torch.cli.<name> as __main__ with argv; its stdout."""
    buf, old = io.StringIO(), sys.argv
    sys.argv = [name] + [str(a) for a in argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module(f"pose6d_tpu_torch.cli.{name}", run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    from pose6d_tpu_torch.convert import init_torchvision_resnet50

    wd = str(tmp_path_factory.mktemp("cli"))
    out = {"wd": wd}
    out["setup_data"] = run_cli("setup_data", ["--dest", wd, "--synthetic", "--objects", 2,
                                               "--frames", 12])
    data = os.path.join(wd, "Linemod_synthetic", "data")
    models = os.path.join(wd, "Linemod_synthetic", "models")
    out.update(data=data, models=models)
    out["prepare_yolo"] = run_cli("prepare_yolo", ["--source", data,
                                                   "--dest", os.path.join(wd, "yolo_ready")])
    out["train_yolo"] = run_cli("train_yolo", ["--data-root", data, "--save-dir",
                                               os.path.join(wd, "yolo"), "--epochs", 1,
                                               "--img-size", DET, "--batch-size", 8,
                                               "--device", "cpu"])
    tv_path = os.path.join(wd, "resnet50_tv.pth")
    torch.save(init_torchvision_resnet50(3), tv_path)
    out["tv_path"] = tv_path
    out["train"] = run_cli("train", ["--variant", "rgb", "--data-root", data, "--mesh-dir",
                                     models, "--save-dir", os.path.join(wd, "weights_rgb"),
                                     "--epochs", 1, "--img-size", POSE, "--batch-size", 8,
                                     "--num-workers", 0, "--pretrained-backbone", tv_path,
                                     "--device", "cpu"])
    out["compare"] = run_cli("compare", ["--data-root", data, "--mesh-dir", models,
                                         "--weights-root", wd, "--variants", "rgb",
                                         "--batch-size", 8, "--img-size", POSE,
                                         "--device", "cpu"])
    out["image"] = os.path.join(data, "01", "rgb", "0008.png")
    out["infer_png"] = os.path.join(wd, "overlay.png")
    out["infer"] = run_cli("infer", ["--variant", "rgb", "--image", out["image"],
                                     "--yolo-weights", os.path.join(wd, "yolo"),
                                     "--pose-weights", os.path.join(wd, "weights_rgb"),
                                     "--mesh-dir", models, "--num-classes", 2,
                                     "--img-size", POSE, "--f32", "--output", out["infer_png"],
                                     "--device", "cpu"])
    e2e = ["--variant", "rgb", "--data-root", data, "--mesh-dir", models,
           "--yolo-weights", os.path.join(wd, "yolo"),
           "--pose-weights", os.path.join(wd, "weights_rgb"), "--img-size", POSE,
           "--batch-size", 4, "--conf-thresh", 0.0, "--device", "cpu"]
    out["e2e_args"] = e2e
    out["eval_e2e"] = run_cli("eval_e2e", e2e)
    out["eval_e2e_folded"] = run_cli("eval_e2e", e2e + ["--folded-backbone"])
    ref_pth = os.path.join(wd, "reference.pth")
    out["to_torch"] = run_cli("convert_reference_weights",
                              ["to-torch", "--variant", "rgb", "--weights",
                               os.path.join(wd, "weights_rgb"), "--out", ref_pth])
    out["to_port"] = run_cli("convert_reference_weights",
                             ["to-port", "--variant", "rgb", "--pth", ref_pth,
                              "--dest", os.path.join(wd, "weights_back")])
    out["ref_pth"] = ref_pth
    return out


def test_setup_data_and_prepare_yolo(workflow):
    assert "synthetic dataset ready" in workflow["setup_data"]
    assert sorted(os.listdir(workflow["data"])) == ["01", "02"]
    assert len(os.listdir(os.path.join(workflow["data"], "02", "depth"))) == 12
    assert "train: 20" in workflow["prepare_yolo"] and "val: 2" in workflow["prepare_yolo"]
    assert os.path.isfile(os.path.join(workflow["wd"], "yolo_ready", "dataset.yaml"))


def test_training_clis_write_checkpoints(workflow):
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.models.convert import load_torch_state_dict, resnet50_from_torchvision
    from pose6d_tpu_torch.train.checkpoint import load_model_variables

    assert "mAP@50" in workflow["train_yolo"]
    assert os.path.isfile(os.path.join(workflow["wd"], "yolo", "last.pt"))
    assert "Training complete" in workflow["train"]
    state = load_model_variables(os.path.join(workflow["wd"], "weights_rgb"),
                                 get_preset("rgb", img_size=64), name="last")
    # one epoch moved the pretrained tower, which it started from
    tv = resnet50_from_torchvision(load_torch_state_dict(workflow["tv_path"]))
    assert state["backbone.conv1.weight"].shape == tv["conv1.weight"].shape
    assert not torch.equal(state["backbone.conv1.weight"], tv["conv1.weight"])
    assert "rgb" in workflow["compare"] and "Best model: rgb" in workflow["compare"]


def _pct(pattern, text):
    return re.search(pattern, text).group(1)


def test_eval_e2e_equals_in_process_pipeline(workflow):
    """The printed detection rate and full-system ADD-0.1d equal those of
    PosePipeline + ADDEvaluator on the same checkpoint and frames."""
    from scipy.spatial.transform import Rotation

    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.data.linemod import build_index
    from pose6d_tpu_torch.data.png import read_png
    from pose6d_tpu_torch.infer.pipeline import PipelineConfig, PosePipeline
    from pose6d_tpu_torch.losses.add import ADDEvaluator
    from pose6d_tpu_torch.models.yolo.model import YoloConfig
    from pose6d_tpu_torch.models.yolo.train import load_yolo_variables
    from pose6d_tpu_torch.train.checkpoint import load_model_variables

    wd = workflow["wd"]
    samples = build_index(workflow["data"], "val")
    ycfg = YoloConfig(num_classes=2)
    for text, folded in ((workflow["eval_e2e"], False), (workflow["eval_e2e_folded"], True)):
        pipe = PosePipeline(
            PipelineConfig(variant="rgb", img_size=64, conf_thresh=0.0,
                           compute_dtype=torch.bfloat16 if folded else torch.float32),
            ycfg, load_yolo_variables(os.path.join(wd, "yolo"), ycfg),
            load_model_variables(os.path.join(wd, "weights_rgb"), get_preset("rgb", img_size=64)),
            device="cpu")
        if folded:
            pipe.fold_backbones()
        evaluator = ADDEvaluator(workflow["models"], device="cpu")
        frames = np.stack([read_png(s.img_path) for s in samples])
        K = np.stack([s.cam_K for s in samples]).astype(np.float32)
        out = pipe(frames, K)
        valid = out["det_valid"].numpy()
        ids = np.asarray([s.obj_id for s in samples])
        m = evaluator.eval_metrics(
            out["rotation"], out["translation"],
            np.asarray([Rotation.from_matrix(s.rot_mat).as_quat() for s in samples], np.float32),
            np.asarray([s.trans_mm / 1000.0 for s in samples], np.float32),
            np.where(valid, ids, -1))
        det_rate = valid.mean()
        assert len(samples) <= 4  # one batch of the CLI's --batch-size 4
        assert f"split val: {len(samples)} frames" in text
        assert _pct(r"detection rate: ([\d.]+)%", text) == f"{det_rate * 100:.1f}"
        assert _pct(r"full system, undetected = incorrect\): ([\d.]+)%", text) == \
            f"{m['add_01d_acc'] * det_rate:.2f}"
        assert re.search(rf"evaluated {len(samples)} frames in [\d.]+ s after set-up: "
                         r"[\d.]+ frames/s", text)


def test_eval_e2e_int8_and_multi_object_scene(workflow, tmp_path):
    """--int8-backbone (towers and detector calibrated on the first batch),
    and --max-objects 2 on a multi-object scene of both objects (their
    colours recovered from the tree) with the detector's classes named."""
    from pose6d_tpu_torch.data.synthetic import generate_synthetic_scene, recover_object_colors

    text = run_cli("eval_e2e", workflow["e2e_args"] + ["--int8-backbone"])
    assert "detection rate:" in text and "ADD-0.1d (full system" in text
    colors = recover_object_colors(workflow["data"])
    assert sorted(colors) == [1, 2]
    scene = generate_synthetic_scene(str(tmp_path / "scene"), colors, frames=4, seed=2,
                                     max_angle_deg=75.0, write_models=False)
    argv = [a for a in workflow["e2e_args"]]
    argv[argv.index("--data-root") + 1] = scene["data"]
    text = run_cli("eval_e2e", argv + ["--max-objects", 2, "--classes", "1,2",
                                       "--split", "train"])
    assert "GT objects (max_objects=2)" in text
    assert "object detection rate (class-matched)" in text
    assert "full system, unmatched = incorrect" in text


def test_infer_writes_the_overlay(workflow):
    from pose6d_tpu_torch.data.png import read_png

    text = workflow["infer"]
    assert "quat(xyzw):" in text and "saved" in text
    overlay = read_png(workflow["infer_png"])
    frame = read_png(workflow["image"])
    assert overlay.shape == frame.shape and overlay.dtype == np.uint8
    assert (overlay != frame).any(axis=-1).sum() > 0  # something was drawn


def test_reference_round_trip_bit_equal(workflow):
    from pose6d_tpu_torch.configs.presets import get_preset
    from pose6d_tpu_torch.models.convert import load_torch_state_dict
    from pose6d_tpu_torch.train.checkpoint import load_model_variables

    wd = workflow["wd"]
    assert "exported" in workflow["to_torch"] and "imported" in workflow["to_port"]
    ref = load_torch_state_dict(workflow["ref_pth"])
    assert "backbone.4.0.conv1.weight" in ref and "rot_head.10.weight" in ref
    cfg = get_preset("rgb")
    before = load_model_variables(os.path.join(wd, "weights_rgb"), cfg)
    after = load_model_variables(os.path.join(wd, "weights_back"), cfg)
    assert set(before) == set(after)
    for k in before:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(before[k], after[k]), k


def test_setup_data_zip_branch(tmp_path):
    src = tmp_path / "Linemod_preprocessed.zip"
    with zipfile.ZipFile(src, "w") as zf:
        zf.writestr("Linemod_preprocessed/data/01/gt.yml", "0:\n")
        zf.writestr("Linemod_preprocessed/models/models_info.yml", "1: {diameter: 1.0}\n")
    text = run_cli("setup_data", ["--dest", tmp_path])
    assert "Extracting" in text
    assert (tmp_path / "Linemod_preprocessed" / "data" / "01" / "gt.yml").read_text() == "0:\n"
    assert "already exists" in run_cli("setup_data", ["--dest", tmp_path])
    # neither a zip nor gdown: JAX's message
    with pytest.raises(SystemExit, match="gdown is unavailable"):
        run_cli("setup_data", ["--dest", tmp_path / "empty"])


def test_train_mesh_is_the_next_slice(workflow):
    """--mesh is ported (tests/test_torch_parallel_trainer.py runs it under
    torchrun); launched without torchrun's environment it exits naming
    torchrun."""
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        run_cli("train", ["--variant", "rgb", "--data-root", workflow["data"], "--mesh-dir",
                          workflow["models"], "--mesh", "2,1", "--device", "cpu"])


def test_compare_visual_writes_the_grids(workflow, tmp_path):
    """GT beside each trained variant (here rgb): one PNG per sample, two
    frame-wide panels, the ground-truth box drawn in green on both."""
    from pose6d_tpu_torch.data.png import read_png

    out_dir = str(tmp_path / "grids")
    text = run_cli("compare_visual", ["--data-root", workflow["data"], "--mesh-dir",
                                      workflow["models"], "--weights-root", workflow["wd"],
                                      "--num-samples", 2, "--out-dir", out_dir, "--img-size",
                                      POSE, "--device", "cpu"])
    assert "panels: GT, rgb" in text
    pngs = sorted(os.listdir(out_dir))
    assert len(pngs) == 2 and all(p.startswith("comparison_") for p in pngs)
    grid = read_png(os.path.join(out_dir, pngs[0]))
    assert grid.shape == (480, 2 * 640, 3)
    green = (grid[..., 0] == 0) & (grid[..., 1] == 255) & (grid[..., 2] == 0)
    assert green[:, :640].any() and green[:, 640:].any()


def test_visualize_yolo_writes_the_boxes(workflow, tmp_path):
    from pose6d_tpu_torch.data.png import read_png

    out_dir = str(tmp_path / "yolo")
    text = run_cli("visualize_yolo", ["--data-root", workflow["data"], "--yolo-weights",
                                      os.path.join(workflow["wd"], "yolo"), "--num-images", 1,
                                      "--out-dir", out_dir, "--device", "cpu"])
    assert f"saved {os.path.join(out_dir, 'yolo_det_0.png')}" in text
    assert read_png(os.path.join(out_dir, "yolo_det_0.png")).shape == (640, 640, 3)


def test_package_and_setup_weights(workflow, tmp_path):
    """package_weights zips the save directories it finds under --root
    (here rgb's, with the workflow's metrics.csv and a small stand-in for
    its checkpoint, and the detector's); setup_weights unpacks the zip,
    finds both checkpoints and names the three it lacks; without the zip
    it says where to put it and downloads nothing."""
    root = tmp_path / "root"
    for d, name in (("weights_rgb", "last.pt"), (os.path.join("runs", "detect", "linemod_yolo"),
                                                  "best.pt")):
        os.makedirs(root / d)
        torch.save({"model": {"w": torch.arange(4.0)}}, str(root / d / name))
    with open(os.path.join(workflow["wd"], "weights_rgb", "metrics.csv"), "rb") as f:
        (root / "weights_rgb" / "metrics.csv").write_bytes(f.read())
    zip_path = str(tmp_path / "pretrained_weights.zip")
    text = run_cli("package_weights", ["--root", root, "--out", zip_path])
    assert "packaged weights_rgb" in text and "packaged runs/detect/linemod_yolo" in text
    with zipfile.ZipFile(zip_path) as zf:
        names = set(zf.namelist())
    assert names == {"weights_rgb/last.pt", "weights_rgb/metrics.csv",
                     "runs/detect/linemod_yolo/best.pt"}
    dest = str(tmp_path / "unpacked")
    text = run_cli("setup_weights", ["--zip", zip_path, "--dest", dest])
    assert torch.equal(torch.load(os.path.join(dest, "weights_rgb", "last.pt"))["model"]["w"],
                       torch.arange(4.0))
    assert text.count("expected checkpoint missing") == 3 and "weights_rgb/" not in text
    with pytest.raises(SystemExit, match="nothing is downloaded"):
        run_cli("setup_weights", ["--zip", str(tmp_path / "absent.zip"), "--dest", dest])


def test_compute_clis_default_to_the_card(workflow):
    """Without --device the CLIs ask for "cuda": on a machine without a card
    they fail, they do not fall back to the CPU."""
    argv = [a for a in workflow["e2e_args"]]
    i = argv.index("--device")
    del argv[i:i + 2]
    with pytest.raises((AssertionError, RuntimeError)):
        run_cli("eval_e2e", argv)


def test_demo_smallest(tmp_path):
    text = run_cli("demo", ["--workdir", tmp_path, "--epochs", 1, "--variant", "rgbd_geometric",
                            "--img-size", 32, "--det-size", 96, "--frames", 10,
                            "--device", "cpu"])
    assert "demo complete" in text
    assert os.path.isfile(tmp_path / "demo_result.png")
    assert os.path.isfile(tmp_path / "yolo_ckpt" / "last.pt")
    assert os.path.isfile(tmp_path / "weights_rgbd_geometric" / "last.pt")
