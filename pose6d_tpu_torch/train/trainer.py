"""The pose-model trainer (counterpart of pose6d_tpu/train/trainer.py):
epoch loop, validation, plateau schedule, checkpoints and resume.

    cfg = get_preset("rgbd")                     # configs/presets.py
    Trainer(cfg, data_root, mesh_dir, save_dir).fit()

Semantics of the reference's training scripts
(scripts/training/train_{rgb,rgb_geometric,rgbd,rgbd_geometric}.py), as
the JAX Trainer keeps them:
  - validation every epoch on ADD metrics, averaged as the mean of
    per-batch means (train_rgb.py:124-139), with the learned X/Y and, for
    rgb / rgbd, the deployed (pinhole) X/Y;
  - ReduceLROnPlateau(mode='max', factor 0.5, patience 5) on val ADD-0.1d;
  - `last` every epoch, `best` on a strict improvement, `best_deploy` on
    the deployed metric (seeded on the first epoch); resume restores
    model, optimizer, epoch, best values and the scheduler;
  - metrics.csv with the JAX Trainer's columns.

Two input paths, as in JAX: the host loader's compact batches through
make_train_step (data/pipeline.py: PNG decode and crop on CPU threads), or
with device_preprocess=True the train split resident on the card
(DeviceFrameStore.from_loader) and one make_train_epoch call per epoch.
Validation always reads through the host loader. The step's random draws
come from a torch.Generator on the device seeded with seed * 100003 +
epoch, where JAX derives its key; the numpy generator of the shuffle and
the jitter is JAX's, drawn in JAX's order.

pretrained_backbone= (a torchvision resnet50 .pth) loads the towers before
the first step (models/pretrained.py), as JAX's create_train_state does.
TensorBoard summaries, optional in JAX, are left out: the CSV is always
written.

mesh= (a parallel.Mesh, parallel.make_mesh's) runs the Trainer in each
rank's process (torchrun launches them; the caller has
initialized torch.distributed): the state is sharded on the mesh
(parallel.shard_state), every rank holds the resident split on its own card
(JAX replicates it: each rank's gather can reach any frame) and draws the
same shuffle, jitter and random streams. A resident step takes the rank's
rows of the global metadata batch (train/loop.py); the host loaders (the
host path's train batches, and validation on both paths) decode and crop
only the rank's rows, parallel.local_rows, of each global batch. The
validation metrics are reduced over the data group, so every rank makes the
same decisions. Rank 0 alone prints, writes metrics.csv and writes the
checkpoints, in the one-process layout (every
rank waits for them); a resume cuts them to each rank's slices, so a run
resumes across mesh shapes, or without one.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..data.device_pipeline import DeviceFrameStore
from ..data.pipeline import LineMODPoseLoader
from ..losses.add import ADDEvaluator
from .checkpoint import BEST_DEPLOY_NAME, BEST_NAME, CheckpointManager
from .loop import (TrainConfig, create_train_state, make_eval_step, make_train_epoch,
                   make_train_step)
from .schedule import ReduceLROnPlateau

LOG_FIELDS = ["epoch", "train_loss", "val_add", "val_add_s", "val_acc", "val_acc_deploy", "lr",
              "steps_per_sec", "imgs_per_sec"]
VAL_KEYS = ("add_mean", "add_s_mean", "add_01d_acc", "loss", "add_01d_acc_deploy")


class Trainer:
    def __init__(self, cfg: TrainConfig, data_root: str, mesh_dir: str, save_dir: str,
                 seed: int = 0, num_workers: int = 8, profile_dir: Optional[str] = None,
                 pretrained_backbone: Optional[str] = None, cache_decoded: bool = False,
                 mesh=None, device_preprocess: bool = False, device=DEFAULT_DEVICE):
        if mesh is not None and cfg.batch_size % mesh.dp:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by data axis {mesh.dp}")
        self.mesh = mesh
        self.primary = mesh is None or mesh.is_primary
        self.cfg = cfg
        self.seed = seed
        self.profile_dir = profile_dir
        self.device = torch.device(device)
        # this rank's rows of each global batch, which its loaders decode
        self.rows = None
        if mesh is not None:
            from ..parallel.mesh import local_rows

            self.rows = local_rows(cfg.batch_size, mesh)
        flavor = "rgbd" if cfg.variant.startswith("rgbd") else "rgb"
        self.train_loader = LineMODPoseLoader(
            data_root, mode="train", flavor=flavor, img_size=cfg.img_size,
            num_workers=num_workers, cache_decoded=cache_decoded, compact_arrays=True)
        self.val_loader = LineMODPoseLoader(
            data_root, mode="val", flavor=flavor, img_size=cfg.img_size, augment_bbox=False,
            num_workers=num_workers, cache_decoded=cache_decoded, compact_arrays=True)

        self.device_preprocess = device_preprocess
        self.frame_store = None
        if device_preprocess:
            self.frame_store = DeviceFrameStore.from_loader(self.train_loader, device=self.device)
            self._print(f"device_preprocess: {len(self.frame_store)} frames resident "
                  f"({self.frame_store.nbytes() / 2**20:.1f} MiB on {self.device})")

        self.evaluator = ADDEvaluator(mesh_dir, device=self.device)
        self.state = create_train_state(cfg, seed=seed, device=self.device,
                                        pretrained_backbone=pretrained_backbone)
        if mesh is not None:
            from ..parallel import shard_state

            self.state = shard_state(self.state, mesh)
        if device_preprocess:
            self.train_step = None
            self.train_epoch_fn = make_train_epoch(
                cfg, frame_hw=(self.frame_store.frame_h, self.frame_store.frame_w), mesh=mesh)
        else:
            self.train_step = make_train_step(cfg, mesh=mesh)
            self.train_epoch_fn = None
        self.eval_step = make_eval_step(cfg, self.evaluator, mesh=mesh)

        self.scheduler = ReduceLROnPlateau(lr=cfg.learning_rate, factor=cfg.plateau_factor,
                                           patience=cfg.plateau_patience, min_lr=cfg.min_lr)
        self.ckpt = CheckpointManager(save_dir)
        self.start_epoch = 0
        self.best_acc = 0.0
        self.best_deploy_acc = 0.0
        self.epoch_timing: Optional[dict] = None  # the last device epoch's split, seconds
        self._metrics_path = os.path.join(save_dir, "metrics.csv")

    def _print(self, *args, **kwargs) -> None:
        if self.primary:
            print(*args, **kwargs)

    def close(self) -> None:
        """Stop the loaders' threads."""
        self.train_loader.close()
        self.val_loader.close()

    # ------------------------------------------------------------------ resume

    def try_resume(self) -> bool:
        """Restore `last`, or `best` when `last` is missing or unreadable;
        False (nothing changed) when neither restores."""
        restored = self.ckpt.restore(self.state)
        if restored is None:
            restored = self.ckpt.restore(self.state, name=BEST_NAME)
            if restored is not None:
                self._print("`last` checkpoint unreadable; resuming from `best`")
        if restored is None:
            return False
        meta = restored["meta"]
        self.start_epoch = int(meta["epoch"]) + 1
        self.best_acc = float(meta["best_acc"])
        self.best_deploy_acc = float(meta.get("best_deploy_acc", 0.0))
        self.scheduler.load_state_dict(restored["scheduler"])
        self._print(f"Resumed at epoch {self.start_epoch}, best accuracy: {self.best_acc:.2f}%")
        return True

    # ------------------------------------------------------------------- train

    def _generator(self, epoch: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed * 100003 + epoch)

    def train_epoch(self, epoch: int, rng: np.random.Generator) -> dict:
        cfg = self.cfg
        losses = []
        t0 = time.monotonic()
        gen = self._generator(epoch)
        if self.frame_store is not None:
            fs = self.frame_store
            meta, n_steps = fs.epoch_meta(cfg.batch_size, rng, shuffle=True)
            if n_steps:
                t_meta = time.monotonic()
                self.state, loss_arr = self.train_epoch_fn(self.state, fs.rgb_frames,
                                                           fs.depth_frames, meta, gen)
                t_disp = time.monotonic()
                losses.append(loss_arr.cpu())  # the epoch's one wait for the card
                t_exec = time.monotonic()
                # meta: host bookkeeping; dispatch: the epoch call's return
                # (its launches enqueued); exec+fetch: the card finishing
                self.epoch_timing = {"meta_s": t_meta - t0, "dispatch_s": t_disp - t_meta,
                                     "exec_fetch_s": t_exec - t_disp}
                self._print(f"  [epoch-timing] meta {t_meta - t0:.2f}s | dispatch "
                      f"{t_disp - t_meta:.2f}s | exec+fetch {t_exec - t_disp:.2f}s", flush=True)
        else:
            step_losses = []
            for batch in self.train_loader.batches(cfg.batch_size, rng, shuffle=True,
                                                   rows=self.rows):
                self.state, metrics = self.train_step(self.state, batch, gen)
                step_losses.append(metrics["loss"])
            if step_losses:
                losses.append(torch.stack(step_losses).cpu())
        flat = torch.cat(losses).numpy() if losses else np.zeros(0, np.float32)
        dt = time.monotonic() - t0
        steps_per_sec = len(flat) / dt if dt > 0 else 0.0
        return {"train_loss": float(np.sum(flat)) / max(len(flat), 1),
                "steps_per_sec": steps_per_sec,
                "imgs_per_sec": steps_per_sec * cfg.batch_size}

    def validate(self, rng: np.random.Generator) -> dict:
        """Val metrics over the val split, the mean of per-batch means."""
        acc = []
        for batch in self.val_loader.batches(self.cfg.batch_size, rng, shuffle=False,
                                             drop_remainder=False, rows=self.rows):
            m = self.eval_step(self.state, batch)
            # f32, or a float64 module's float64
            dt = torch.promote_types(m["loss"].dtype, torch.float32)
            acc.append(torch.stack([m[k].to(dt) for k in VAL_KEYS]))
        vals = (np.mean(torch.stack(acc).cpu().numpy(), axis=0) if acc
                else np.zeros(len(VAL_KEYS)))
        return {"val_add": float(vals[0]), "val_add_s": float(vals[1]),
                "val_acc": float(vals[2]), "val_loss": float(vals[3]),
                "val_acc_deploy": float(vals[4])}

    def _profiled(self, epoch: int):
        """torch.profiler over the second epoch of this run, when profile_dir
        is set; its trace is written there as trace_epoch<N>.json."""
        if not self.profile_dir or epoch != self.start_epoch + 1 or not self.primary:
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def fit(self, epochs: Optional[int] = None, early_stop_acc: Optional[float] = None) -> float:
        """Train from the last checkpoint (if any) up to `epochs` (cfg's by
        default); stop early once the best val ADD-0.1d reaches
        early_stop_acc. Returns the best val ADD-0.1d."""
        epochs = epochs or self.cfg.epochs
        self.try_resume()
        rng = np.random.default_rng(self.seed)
        # a header if the file is absent or empty (a kill before the first
        # flush can leave it empty)
        write_header = (not os.path.exists(self._metrics_path)
                        or os.path.getsize(self._metrics_path) == 0)
        # rank 0 writes the log; the other ranks write nowhere
        with open(self._metrics_path if self.primary else os.devnull, "a", newline="") as fcsv:
            writer = csv.DictWriter(fcsv, fieldnames=LOG_FIELDS, extrasaction="ignore")
            if write_header:
                writer.writeheader()
            for epoch in range(self.start_epoch, epochs):
                prof = self._profiled(epoch)
                if prof is not None:
                    prof.__enter__()
                tm = self.train_epoch(epoch, rng)
                vm = self.validate(rng)
                if prof is not None:
                    prof.__exit__(None, None, None)
                    os.makedirs(self.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(self.profile_dir,
                                                          f"trace_epoch{epoch}.json"))
                lr = self.scheduler.step(vm["val_acc"])
                self.state.tx.learning_rate = lr
                row = {"epoch": epoch, "lr": lr, **tm, **vm}
                writer.writerow(row)
                fcsv.flush()
                self._print(f"Epoch {epoch + 1}/{epochs}  Loss: {tm['train_loss']:.4f} | "
                      f"ADD: {vm['val_add']:.1f}mm | ADD-0.1d: {vm['val_acc']:.1f}% | "
                      f"LR: {lr:.2e} | {tm['imgs_per_sec']:.0f} img/s")
                is_best = vm["val_acc"] > self.best_acc
                if is_best:
                    self.best_acc = vm["val_acc"]
                    self._print(f"  New best model saved (ADD-0.1d: {self.best_acc:.2f}%)")
                is_best_deploy = (vm["val_acc_deploy"] > self.best_deploy_acc
                                  or not self.ckpt.has_checkpoint(BEST_DEPLOY_NAME))
                if is_best_deploy:
                    self.best_deploy_acc = max(self.best_deploy_acc, vm["val_acc_deploy"])
                    self._print("  New deployment-aligned best saved "
                          f"(corrected ADD-0.1d: {self.best_deploy_acc:.2f}%)")
                self.ckpt.save(self.state, epoch, self.best_acc, vm["val_acc"], vm["val_add"],
                               self.scheduler.state_dict(), is_best,
                               best_deploy_acc=self.best_deploy_acc,
                               is_best_deploy=is_best_deploy)
                if early_stop_acc is not None and self.best_acc >= early_stop_acc:
                    self._print(f"  Early stop: ADD-0.1d {self.best_acc:.2f}% >= {early_stop_acc}%")
                    break
        self._print(f"\nTraining complete. Best ADD-0.1d: {self.best_acc:.2f}%")
        return self.best_acc
