"""Checkpoints with the reference's last / best policy (counterpart of
pose6d_tpu/train/checkpoint.py), saved by torch.save.

Every epoch writes `last`; `best` when val ADD-0.1d improves (reference
scripts/training/train_rgb.py:80-90, 146-162); `best_deploy` on the
deployment-aligned val metric. A checkpoint holds the model's state_dict
(parameters and BatchNorm statistics), the PoseOptimizer's state (AdamW's
moments and step counts, its learning rate), the count of steps taken, the
meta {epoch, best_acc, best_deploy_acc, curr_acc, curr_add} and the
plateau scheduler's state, which the reference drops on resume.

Each file is written under a temporary name and then os.replace'd onto
`<save_dir>/<name>.pt`, so a kill mid-save leaves the previous file whole.

A state sharded on a mesh (parallel.shard_state) is saved in the
one-process layout: every rank gathers it (parallel.gather_state), rank 0
writes, and every rank waits at a barrier until the file is there. A load
into a sharded state cuts the file's tensors to each rank's slices. So a
checkpoint written under a mesh resumes without one, and the reverse.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

LAST_NAME = "last"
BEST_NAME = "best"
# best by the deployment-aligned val metric (X/Y from the pinhole model,
# train/loop.make_eval_step); `best` keeps the reference's rule
BEST_DEPLOY_NAME = "best_deploy"


class CheckpointManager:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}.pt")

    def _write(self, name: str, payload: dict) -> None:
        tmp = f"{self.path(name)}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(name))

    def save(self, state, epoch: int, best_acc: float, curr_acc: float, curr_add: float,
             scheduler_state: dict, is_best: bool, best_deploy_acc: float = 0.0,
             is_best_deploy: bool = False) -> None:
        """Write `last`, and `best` / `best_deploy` where asked, of a
        train.loop.TrainState. `best`'s best_acc is this epoch's accuracy."""
        meta = {"epoch": int(epoch), "best_acc": float(best_acc),
                "best_deploy_acc": float(best_deploy_acc), "curr_acc": float(curr_acc),
                "curr_add": float(curr_add)}
        mesh = getattr(state.model, "mesh", None)
        if mesh is None:
            payload = {"model": state.model.state_dict(), "optimizer": state.tx.state_dict(),
                       "step": int(state.step)}
        else:
            from ..parallel.mesh import gather_state

            payload = gather_state(state)
        payload.update(meta=meta, scheduler={k: float(v) for k, v in scheduler_state.items()})
        if mesh is None or mesh.is_primary:
            self._write(LAST_NAME, payload)
            if is_best:
                self._write(BEST_NAME, {**payload, "meta": {**meta, "best_acc": float(curr_acc)}})
            if is_best_deploy:
                self._write(BEST_DEPLOY_NAME, payload)
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    def load(self, model, name: str = LAST_NAME) -> Optional[dict]:
        """The payload of checkpoint `name`, its tensors on the CPU, or None
        when there is none, it does not load, or its model state does not
        fit `model` (keys, shapes, dtypes; a sharded model's one-process
        shapes). load_state_dict moves the
        tensors to the model's device; AdamW's step counts stay on the CPU,
        where a fresh AdamW keeps them (on the card, reading them each step
        would wait for it)."""
        path = self.path(name)
        if not os.path.exists(path):
            return None
        try:
            payload = torch.load(path, map_location="cpu", weights_only=True)
            want = model.state_dict()
            if getattr(model, "mesh", None) is not None:
                from ..parallel.mesh import full_shape

                want = {k: v.new_empty(full_shape(k, v, model.mesh)) for k, v in want.items()}
            got = payload["model"]
            if set(got) != set(want) or any(got[k].shape != want[k].shape
                                             or got[k].dtype != want[k].dtype for k in want):
                raise ValueError("the model's state does not match the checkpoint's")
            return payload
        except Exception as e:  # a different model or a damaged file: a fresh start
            print(f"Checkpoint {path} not restored ({type(e).__name__}: {e})")
            return None

    def restore(self, state, name: str = LAST_NAME) -> Optional[dict]:
        """Load checkpoint `name` into `state` (a train.loop.TrainState: its
        model, optimizer and step count) and return {"state", "meta",
        "scheduler"}; None, with `state` untouched, when load() gives none."""
        payload = self.load(state.model, name)
        if payload is None:
            return None
        try:
            model_before = {k: v.clone() for k, v in state.model.state_dict().items()}
            if getattr(state.model, "mesh", None) is None:
                state.model.load_state_dict(payload["model"], strict=True)
                state.tx.load_state_dict(payload["optimizer"])
            else:
                from ..parallel.mesh import load_gathered

                load_gathered(state, payload)
        except Exception as e:
            state.model.load_state_dict(model_before)
            print(f"Checkpoint {self.path(name)} not restored ({type(e).__name__}: {e})")
            return None
        state.step = int(payload["step"])
        return {"state": state, "meta": payload["meta"], "scheduler": payload["scheduler"]}

    def has_checkpoint(self, name: str = LAST_NAME) -> bool:
        return os.path.exists(self.path(name))


def load_model_variables(save_dir: str, train_cfg, name: str = BEST_NAME) -> Optional[dict]:
    """A trained PoseNet's state_dict (CPU tensors) from a Trainer's
    checkpoint directory: `name`, else `last`; None when neither fits a
    model of train_cfg."""
    from ..models.posenet import PoseNet
    from .loop import pose_config

    model = PoseNet(pose_config(train_cfg))
    mgr = CheckpointManager(save_dir)
    payload = mgr.load(model, name)
    if payload is None and name != LAST_NAME:
        payload = mgr.load(model, LAST_NAME)
    return None if payload is None else payload["model"]
