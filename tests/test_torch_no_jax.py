"""pose6d_tpu_torch imports nothing of JAX, flax, torchvision, cv2 or the
JAX package: every submodule imports in a fresh interpreter in which those
names are blocked (the card's machine has none of them installed)."""

import os
import pkgutil
import subprocess
import sys

import pose6d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "torchvision", "cv2", "pose6d_tpu")

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
