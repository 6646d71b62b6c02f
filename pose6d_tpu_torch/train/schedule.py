"""Host-side schedules: ReduceLROnPlateau (counterpart of
pose6d_tpu/train/schedule.py) for the pose trainer, and the detector
trainer's warmup-cosine learning rate and EMA decay (optax's
warmup_cosine_decay_schedule and pose6d_tpu/models/yolo/train.py's
ema_update), evaluated on the host from a step count the host keeps, so
that reading them never waits for the card.

The reference steps torch's ReduceLROnPlateau(mode='max', factor=0.5,
patience=5[, min_lr=1e-7]) on val ADD-0.1d
(scripts/training/train_rgb.py:71,141). This is the JAX package's state
machine, copied: torch's rules including the relative threshold and
cooldown, with state that serializes for checkpoint and resume. The
learning rate it returns is set on the optimizer between epochs
(train.loop.PoseOptimizer.learning_rate).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math

import numpy as np


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


# ------------------------------------------------------ detector training

_F32 = np.float32


def _fma32(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (a float32 product is exact in
    float64, so one more rounding of the float64 sum is all that differs
    from a fused multiply-add in the rare double-rounding case)."""
    return _F32(float(_F32(a)) * float(_F32(b)) + float(_F32(c)))


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def warmup_cosine_decay(step: int, init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> float:
    """optax.warmup_cosine_decay_schedule(init_value, peak_value,
    warmup_steps, decay_steps, end_value) at `step`, as the float32 number
    JAX computes for it on the CPU: linear from init_value to peak_value
    over warmup_steps, then cosine from peak_value to end_value by
    decay_steps (the total, warmup included), end_value after it. The
    operations are XLA's for the jitted schedule: the division by a
    constant as a multiply by its float32 reciprocal, the fused
    multiply-adds it contracts, the constants it folds, and the C
    library's cosf. Returns a Python float holding the float32 value."""
    if step < warmup_steps:
        if warmup_steps <= 0:
            return float(_F32(init_value))
        c = _F32(min(max(step, 0), warmup_steps))
        frac = _fma32(-c, _F32(1.0) / _F32(warmup_steps), 1.0)
        return float(_fma32(frac, init_value - peak_value, peak_value))
    decay = decay_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"the cosine phase needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    c = min(_F32(step - warmup_steps), _F32(decay))
    arg = _F32(c * (_F32(math.pi) / _F32(decay)))
    cos = _F32(_libm_cosf()(float(arg)))
    decayed = _fma32(_F32(cos + _F32(1.0)), _F32(0.5) * _F32(1.0 - alpha), alpha)
    return float(_F32(decayed * _F32(peak_value)))


def ema_decay(step: int, decay: float = 0.9999) -> float:
    """The detector EMA's ramped decay after `step` steps, ultralytics'
    ModelEMA d = decay * (1 - exp(-step / 2000)), as the float32 number JAX
    computes (pose6d_tpu/models/yolo/train.py ema_update): -step times the
    float32 1/2000, exp rounded once to float32, then 1 - e and the product
    in float32. XLA's own exp is not correctly rounded; where it rounds the
    other way the two differ by one float32 ulp."""
    x = _F32(-_F32(step)) * _F32(0.0005)
    e = _F32(math.exp(float(x)))
    return float(_F32(_F32(_F32(1.0) - e) * _F32(decay)))
