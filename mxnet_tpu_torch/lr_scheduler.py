"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (an own copy: it is plain
Python): FactorScheduler, MultiFactorScheduler, PolyScheduler,
CosineScheduler, all with linear warmup and the call protocol
``lr = sched(num_update)``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr: float = 0.01, warmup_steps: int = 0,
                 warmup_begin_lr: float = 0.0,
                 warmup_mode: str = "linear") -> None:
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update: int) -> float:
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / max(self.warmup_steps, 1)
            return self.warmup_begin_lr + inc
        return self.warmup_final_lr  # constant

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every ``step`` updates (with optional floor)."""

    def __init__(self, step: int, factor: float = 1.0,
                 stop_factor_lr: float = 1e-8, base_lr: float = 0.01,
                 **kwargs) -> None:
        super().__init__(base_lr, **kwargs)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        exp = (num_update - self.warmup_steps) // self.step
        lr = self.base_lr * (self.factor ** exp)
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each listed step (the classic ResNet schedule)."""

    def __init__(self, step: Sequence[int], factor: float = 1.0,
                 base_lr: float = 0.01, **kwargs) -> None:
        super().__init__(base_lr, **kwargs)
        self.step = sorted(step)
        self.factor = factor

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update: int, base_lr: float = 0.01,
                 pwr: float = 2, final_lr: float = 0.0, **kwargs) -> None:
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = min(num_update, self.max_update) - self.warmup_steps
        span = max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 - n / span) ** self.power


class CosineScheduler(LRScheduler):
    def __init__(self, max_update: int, base_lr: float = 0.01,
                 final_lr: float = 0.0, **kwargs) -> None:
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update: int) -> float:
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        n = min(num_update, self.max_update) - self.warmup_steps
        span = max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * n / span)) / 2
