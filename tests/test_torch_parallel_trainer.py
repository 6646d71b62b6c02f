"""Trainer(mesh=) and `train --mesh` on the CPU (gloo processes), on the
port's generator at tests/test_parallel.py's size (objects 01 and 02, 20
frames each, seed 3; rgb at img 64, batch 8, 1 epoch, the train split
resident): a (2, 2) fit writes metrics.csv (rank 0 alone) and checkpoints
in the one-process layout; its last.pt resumes in a one-process Trainer
with the same bits as the mesh's gathered state, and a one-process run's
last.pt resumes on the mesh the same way; the mesh epoch's train loss is
the one-process epoch's. In the same world, an epoch from the host loaders
(device_preprocess=False) in float64 on the (2, 2) mesh, whose data axis
of 2 is (2, 1)'s, ends with the one-process epoch's state and validation
within 1e-12 per leaf, each rank's loaders decoding only its half of
each global batch. The CLI runs under torchrun with --mesh 2,1."""

import csv
import os
import subprocess
import sys

import pytest
import torch

import torch_parallel_utils as U
from torch_port_utils import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from pose6d_tpu_torch.data.synthetic import generate_synthetic_linemod

    root = tmp_path_factory.mktemp("linemod_mesh")
    return generate_synthetic_linemod(str(root), obj_ids=(1, 2), frames_per_obj=20, seed=3)


def _rows(save_dir):
    with open(os.path.join(save_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _one_process(tree, save_dir, fit: bool):
    from pose6d_tpu_torch.train.trainer import Trainer

    tr = Trainer(U.trainer_config(), tree["data"], tree["models"], save_dir, seed=0,
                 num_workers=0, device_preprocess=True, device="cpu")
    try:
        if fit:
            tr.fit(epochs=1)
            resumed = None
        else:
            resumed = tr.try_resume()
        payload = {"model": tr.state.model.state_dict(), "optimizer": tr.state.tx.state_dict()}
        return resumed, tr.start_epoch, U.payload_digest(payload)
    finally:
        tr.close()


def _one_process_host_epoch(tree, save_dir):
    """U.host_epoch without a mesh: its loads, and its state and
    validation in shared memory for the ranks."""
    from pose6d_tpu_torch.train.trainer import Trainer

    tr = Trainer(U.trainer_config(), tree["data"], tree["models"], save_dir, seed=0,
                 num_workers=0, device_preprocess=False, device="cpu")
    try:
        loads, state, val = U.host_epoch(tr)
    finally:
        tr.close()
    share = lambda d: {k: v.share_memory_() for k, v in d.items()}  # noqa: E731
    return loads, {"state": share(state), "val": share(val)}


def test_mesh_fit_and_resume_across_layouts(tree, tmp_path):
    mesh_dir, one_dir = str(tmp_path / "mesh"), str(tmp_path / "one")
    # a one-process run first, for the mesh to resume
    _, _, one_digest = _one_process(tree, one_dir, fit=True)
    host_loads, host_ref = _one_process_host_epoch(tree, str(tmp_path / "host_one"))
    runs = U.run_world(U.trainer_rank, 4, tmp_path, tree["data"], tree["models"],
                       [(mesh_dir, (2, 2), False), (one_dir, (2, 2), True),
                        (str(tmp_path / "host_mesh"), (2, 2), False, host_ref)])
    fit, back, host = [r[0] for r in runs], [r[1] for r in runs], [r[2] for r in runs]
    # C6: each rank's loaders decode its half of each global batch, and the
    # float64 epoch and its validation are the one-process ones
    assert host_loads["train"] > 0 and host_loads["val"] > 0
    assert all(r["loads"] == {k: v // 2 for k, v in host_loads.items()} for r in host)
    errs = host[0]["errs"]
    assert any(k.startswith("epoch/val") for k in errs) and len(errs) > 300
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-12, (worst, errs[worst])
    assert [r["primary"] for r in fit] == [True, False, False, False]
    assert len({r["digest"] for r in fit}) == 1
    assert sorted(os.listdir(mesh_dir)) == ["best_deploy.pt", "last.pt", "metrics.csv"] or \
        sorted(os.listdir(mesh_dir)) == ["best.pt", "best_deploy.pt", "last.pt", "metrics.csv"]
    mesh_rows = _rows(mesh_dir)
    assert len(mesh_rows) == 1 and mesh_rows[0]["epoch"] == "0"
    # the mesh's checkpoint resumes without a mesh, bit for bit
    resumed, start, digest = _one_process(tree, mesh_dir, fit=False)
    assert resumed and start == 1 and digest == fit[0]["digest"]
    # the one-process run's checkpoint resumed on the mesh, bit for bit
    assert all(r["resumed"] and r["start_epoch"] == 1 and r["digest"] == one_digest
               for r in back)
    # the sharded epoch is the one-process epoch (f32: summation orders differ)
    a, b = float(mesh_rows[0]["train_loss"]), float(_rows(one_dir)[0]["train_loss"])
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    for f in (mesh_dir, one_dir):
        for name in os.listdir(f):
            if name.endswith(".pt"):
                os.remove(os.path.join(f, name))


def test_trainer_rejects_indivisible_batch(tree, tmp_path):
    """tests/test_parallel.py::test_trainer_rejects_indivisible_batch: a
    batch of 6 on a data axis of 4."""
    from pose6d_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
    from pose6d_tpu_torch.train.trainer import Trainer

    mesh = Mesh({DATA_AXIS: 4, MODEL_AXIS: 1}, 0, 0, 0, None, None, None)
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(U.trainer_config(batch_size=6), "/nonexistent", "/nonexistent",
                str(tmp_path), mesh=mesh, device="cpu")


def test_train_cli_under_torchrun(tree, tmp_path):
    """python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    pose6d_tpu_torch.cli.train --mesh 2,1 --device cpu: one epoch, rank 0
    prints and writes the checkpoints; each rank on one thread."""
    save = str(tmp_path / "weights_rgb")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "pose6d_tpu_torch.cli.train", "--variant", "rgb", "--data-root",
           tree["data"], "--mesh-dir", tree["models"], "--save-dir", save, "--epochs", "1",
           "--img-size", str(U.S), "--batch-size", "8", "--num-workers", "0", "--mesh", "2,1",
           "--device", "cpu"]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("Training rgb -> ") == 1 and "mesh {'data': 2, 'model': 1}" in r.stdout
    assert r.stdout.count("Epoch 1/1") == 1
    assert len(_rows(save)) == 1
    payload = torch.load(os.path.join(save, "last.pt"), map_location="cpu", weights_only=True)
    assert payload["model"]["rot_dense0.weight"].shape == (2048, 2048)
    assert payload["meta"]["epoch"] == 0
