"""Host-side ReduceLROnPlateau (counterpart of pose6d_tpu/train/schedule.py).

The reference steps torch's ReduceLROnPlateau(mode='max', factor=0.5,
patience=5[, min_lr=1e-7]) on val ADD-0.1d
(scripts/training/train_rgb.py:71,141). This is the JAX package's state
machine, copied: torch's rules including the relative threshold and
cooldown, with state that serializes for checkpoint and resume. The
learning rate it returns is set on the optimizer between epochs
(train.loop.PoseOptimizer.learning_rate).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    mode: str = "max"
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    cooldown: int = 0
    min_lr: float = 0.0

    best: float | None = None
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def _is_better(self, a: float, best: float) -> bool:
        # torch's is_better: rel mode compares with best*(1+threshold) for
        # max and best*(1-threshold) for min, whatever best's sign
        if self.mode == "max":
            if self.threshold_mode == "rel":
                return a > best * (self.threshold + 1.0)
            return a > best + self.threshold
        if self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        return a < best - self.threshold

    def step(self, metric: float) -> float:
        """Update with this epoch's metric; returns the (possibly reduced) lr."""
        if self.best is None or self._is_better(metric, self.best):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best if self.best is not None else float("-inf"),
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        best = float(d["best"])
        self.best = None if best == float("-inf") else best
        self.num_bad_epochs = int(d["num_bad_epochs"])
        self.cooldown_counter = int(d["cooldown_counter"])
