"""pose6d_tpu_torch imports nothing of JAX, flax, torchvision, cv2, PyYAML,
PIL or the JAX package: every submodule imports in a fresh interpreter in
which those names are blocked (the card's machine has none of them
installed), and the LineMOD loader, the parser and the trainer also run a
batch there."""

import os
import pkgutil
import subprocess
import sys

import pose6d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "torchvision", "cv2", "yaml", "PIL", "pose6d_tpu")

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
    assert len(modules) > 15
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
