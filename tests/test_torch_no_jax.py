"""pose6d_tpu_torch imports nothing of JAX, flax, optax, orbax,
torchvision, ultralytics, cv2, PyYAML, PIL or the JAX package: every
submodule imports in a fresh interpreter in which those names are blocked
(the card's machine has none of them installed), the detector-training
modules, the converters, the generator, utils, every CLI (the evidence tools
too) and the request trace with its train and int8 profilers among them;
the LineMOD loader, the parser, the detector trainer and the synthetic
generator's CLI also run there."""

import os
import pkgutil
import subprocess
import sys

import pose6d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "torchvision", "ultralytics", "cv2", "yaml",
           "PIL", "pose6d_tpu")
# the detector-training slice, named so that a rename cannot drop it from the probe
DETECTOR_MODULES = ("pose6d_tpu_torch.models.yolo.loss", "pose6d_tpu_torch.models.yolo.train",
                    "pose6d_tpu_torch.data.detection")
# the interop, generator, utils, parallel and CLI slices, named for the same reason
WORKFLOW_MODULES = tuple(f"pose6d_tpu_torch.{m}" for m in (
    "models.convert", "models.convert_posenet", "models.yolo.convert", "models.pretrained",
    "data.synthetic", "data.raster", "utils", "utils.camera", "utils.mesh", "utils.viz", "cli",
    "cli.setup_data", "cli.prepare_yolo", "cli.train_yolo", "cli.train", "cli.compare",
    "cli.infer", "cli.eval_e2e", "cli.convert_reference_weights", "cli.demo",
    "parallel", "parallel.mesh", "parallel.collectives", "parallel.heads",
    "cli.compare_visual", "cli.visualize_yolo", "cli.package_weights", "cli.setup_weights",
    "cli.parity_run", "cli.parity_e2e", "cli.probe_components", "cli.reproduce",
    "ops.profile_pipeline", "data.seeded_tree",
    "cli.parity_md", "cli.parity_symmetric", "cli.probe_rgbd_gradients", "cli.parity_diagnosis",
    "cli.selection_study", "cli.serving_md", "cli.multiobj_md", "cli.parity_summarize",
    "cli.parity_report", "ops.profile_train", "ops.profile_int8",
    "ops.profile_sweep"))

_PROBE = """
import importlib, importlib.abc, sys
BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in {modules!r}:
    importlib.import_module(name)
import chip_smoke
print("imported", len({modules!r}))
"""


def _modules():
    names = ["pose6d_tpu_torch"]
    for info in pkgutil.walk_packages(pose6d_tpu_torch.__path__, "pose6d_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    modules = _modules()
    assert len(modules) > 15 and set(DETECTOR_MODULES + WORKFLOW_MODULES) <= set(modules)
    code = _PROBE.format(blocked=BLOCKED, modules=modules)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"imported {len(modules)}" in r.stdout


def test_blocker_catches_the_jax_package():
    """The probe really blocks: importing the JAX package under it fails."""
    code = _PROBE.format(blocked=BLOCKED, modules=["pose6d_tpu.geometry.quat"])
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and "blocked import" in r.stderr


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA, chip_smoke.py exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


_LOADER_RUN = """
import numpy as np
from pose6d_tpu_torch.data.pipeline import LineMODPoseLoader
from pose6d_tpu_torch.losses.add import load_object_models
loader = LineMODPoseLoader({data!r}, mode="train", flavor="rgbd", img_size=32, num_workers=0,
                           compact_arrays=True)
batch = next(loader.batches(4, np.random.default_rng(0)))
models = load_object_models({models!r})
print("batch", batch["rgb"].shape, batch["depth_mm"].dtype, int(models.present.sum()))
"""


def test_loader_runs_without_cv2_yaml_or_pil(tmp_path):
    """The loader decodes, parses and crops a generated LineMOD tree, and
    the meshes load, with cv2, yaml and PIL blocked."""
    from pose6d_tpu.data.synthetic import generate_synthetic_linemod

    paths = generate_synthetic_linemod(str(tmp_path), obj_ids=(1,), frames_per_obj=10,
                                       img_w=96, img_h=64, seed=1)
    code = _PROBE.format(blocked=BLOCKED, modules=[]).replace("import chip_smoke\n", "")
    code += _LOADER_RUN.format(data=paths["data"], models=paths["models"])
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "batch (4, 32, 32, 3) uint16 1" in r.stdout


_DETECTOR_RUN = """
import torch
from pose6d_tpu_torch.models.yolo.train import DetTrainConfig, DetectionTrainer
torch.set_num_threads(2)
tr = DetectionTrainer({data!r}, {save!r}, DetTrainConfig(img_size=32, batch_size=4, epochs=1),
                      device="cpu")
m = tr.fit()
tr.close()
print("fit", tr.global_step, round(m, 4) >= 0.0)
"""


def test_detector_trainer_runs_without_jax_cv2_yaml_or_pil(tmp_path):
    """DetectionTrainer reads a generated LineMOD tree, trains an epoch,
    validates and checkpoints with the blocked modules unavailable."""
    from pose6d_tpu.data.synthetic import generate_synthetic_linemod

    paths = generate_synthetic_linemod(str(tmp_path), obj_ids=(1,), frames_per_obj=10,
                                       img_w=96, img_h=64, seed=1)
    code = _PROBE.format(blocked=BLOCKED, modules=[]).replace("import chip_smoke\n", "")
    code += _DETECTOR_RUN.format(data=paths["data"], save=str(tmp_path / "save"))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "fit 2 True" in r.stdout


_SETUP_RUN = """
import runpy
sys.argv = ["setup_data", "--dest", {dest!r}, "--synthetic", "--objects", "1", "--frames", "2"]
runpy.run_module("pose6d_tpu_torch.cli.setup_data", run_name="__main__")
from pose6d_tpu_torch.data.png import read_png
print("frame", read_png({dest!r} + "/Linemod_synthetic/data/01/rgb/0001.png").shape)
"""


def test_synthetic_generator_cli_runs_without_cv2(tmp_path):
    """`python -m pose6d_tpu_torch.cli.setup_data --synthetic` writes a tree
    with cv2, yaml, PIL and JAX blocked."""
    code = _PROBE.format(blocked=BLOCKED, modules=[]).replace("import chip_smoke\n", "")
    code += _SETUP_RUN.format(dest=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "frame (480, 640, 3)" in r.stdout
