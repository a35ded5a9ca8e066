"""Optimizers: ``SGD``, ``Adam``, ``AdamW`` and the base class.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (``Optimizer``,
``MasterWeightState``, ``register``/``create``, ``SGD``, ``Adam``,
``AdamW``) with the same math and bookkeeping: a per-index update count
``t`` (Adam's bias correction), ``rescale_grad`` and ``clip_gradient``
applied to the gradient first, lr and wd multipliers per parameter, an
optional learning-rate schedule, and ``multi_precision``: an f32 master
copy for bf16/fp16 weights, updated in f32 and cast back.

The JAX package compiles each update with ``jax.jit`` and donates the
buffers; here the update is eager PyTorch and runs in place on the weight
and the state tensors. The JAX package left this math to XLA, so the port
has no kernel for it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["Optimizer", "MasterWeightState", "register", "create", "SGD",
           "Adam", "AdamW"]


class MasterWeightState(NamedTuple):
    """f32 master weight of a low-precision parameter, beside the inner
    optimizer state; recognised by type, never by structure."""
    master: Any
    inner: Any


_OPT_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    _OPT_REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name: str, **kwargs: Any) -> "Optimizer":
    """Instantiate a registered optimizer by name."""
    if name.lower() not in _OPT_REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; "
                         f"known: {sorted(_OPT_REGISTRY)}")
    return _OPT_REGISTRY[name.lower()](**kwargs)


def _f32(x: float) -> float:
    """A scalar rounded to f32, as the JAX package passes lr/wd/t."""
    return float(_np.float32(x))


class Optimizer:
    """Base optimizer: hyperparameters, schedule, multipliers, gradient
    rescale/clip and the update count. Subclasses define
    ``create_state(index, weight)`` and ``_step``, which updates the weight
    and the state in place."""

    def __init__(self, learning_rate: float = 0.01,
                 rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None, wd: float = 0.0,
                 lr_scheduler: Any = None, multi_precision: bool = False,
                 param_dict: Optional[Dict[int, Any]] = None,
                 begin_num_update: int = 0, **kwargs: Any) -> None:
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and hasattr(lr_scheduler, "base_lr"):
            self.lr_scheduler.base_lr = learning_rate
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.wd = wd
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self._lr_mult: Dict[Any, float] = {}
        self._wd_mult: Dict[Any, float] = {}
        self.param_dict = param_dict or {}

    def set_learning_rate(self, lr: float) -> None:
        self.lr = lr

    @property
    def learning_rate(self) -> float:
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult: Dict[Any, float]) -> None:
        self._lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[Any, float]) -> None:
        self._wd_mult = dict(args_wd_mult)

    def _get_lr(self, index: Any) -> float:
        lr = self.learning_rate
        param = self.param_dict.get(index)
        if param is not None:
            return lr * getattr(param, "lr_mult", 1.0)
        return lr * self._lr_mult.get(index, 1.0)

    def _get_wd(self, index: Any) -> float:
        param = self.param_dict.get(index)
        if param is not None:
            return self.wd * getattr(param, "wd_mult", 1.0)
        return self.wd * self._wd_mult.get(index, 1.0)

    def _update_count(self, index: Any) -> None:
        self._index_update_count[index] = \
            self._index_update_count.get(index, self.begin_num_update) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def create_state(self, index: Any, weight: torch.Tensor) -> Any:
        return ()

    def create_state_multi_precision(self, index: Any,
                                     weight: torch.Tensor) -> Any:
        if self.multi_precision and weight.dtype in (torch.float16,
                                                     torch.bfloat16):
            master = weight.detach().float().clone()
            return MasterWeightState(master, self.create_state(index, master))
        return self.create_state(index, weight)

    def _hyper(self, index: Any) -> tuple:
        return ()

    @staticmethod
    def _step(w, g, states, lr, wd, t, hp):  # pragma: no cover - abstract
        raise NotImplementedError

    @torch.no_grad()
    def update(self, index: Any, weight: torch.Tensor, grad: torch.Tensor,
               state: Any) -> Any:
        """Apply one update in place on ``weight``; returns the state."""
        self._update_count(index)
        lr, wd = _f32(self._get_lr(index)), _f32(self._get_wd(index))
        t = _f32(self._index_update_count[index])
        g = grad.float() if grad.dtype != weight.dtype else grad
        g = g * _f32(self.rescale_grad)
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return type(self)._step(weight, g, state, lr, wd, t,
                                self._hyper(index))

    @torch.no_grad()
    def update_multi_precision(self, index: Any, weight: torch.Tensor,
                               grad: torch.Tensor, state: Any) -> Any:
        if isinstance(state, MasterWeightState):
            inner = self.update(index, state.master, grad, state.inner)
            weight.copy_(state.master.to(weight.dtype))
            return MasterWeightState(state.master, inner)
        return self.update(index, weight, grad, state)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(lr={self.learning_rate})"


@register
class SGD(Optimizer):
    """SGD with momentum: ``m = mu*m + g + wd*w; w -= lr*m`` (without
    momentum ``w -= lr*(g + wd*w)``)."""

    def __init__(self, momentum: float = 0.0, lazy_update: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(weight),)

    def _hyper(self, index):
        return (self.momentum,)

    @staticmethod
    def _step(w, g, states, lr, wd, t, hp):
        (momentum,) = hp
        g = g + wd * w
        if momentum == 0.0:
            w.sub_((lr * g).to(w.dtype))
            return ()
        (m,) = states
        m.mul_(momentum).add_(g)
        w.sub_((lr * m).to(w.dtype))
        return (m,)


@register
class Adam(Optimizer):
    """Adam with L2 weight decay folded into the gradient."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 lazy_update: bool = False, **kwargs: Any) -> None:
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32),
                torch.zeros_like(weight, dtype=torch.float32))

    def _hyper(self, index):
        return (self.beta1, self.beta2, self.epsilon)

    @staticmethod
    def _step(w, g, states, lr, wd, t, hp):
        beta1, beta2, eps = hp
        m, v = states
        g = g + wd * w
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * g.square())
        lr_t = _f32(lr * _np.sqrt(_f32(1 - _f32(beta2 ** t)))
                    / _f32(1 - _f32(beta1 ** t)))
        w.sub_((lr_t * m / (v.sqrt() + eps)).to(w.dtype))
        return (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay, multiplied by the learning rate:
    ``w -= lr * (mhat / (sqrt(vhat) + eps) + wd * w)``."""

    @staticmethod
    def _step(w, g, states, lr, wd, t, hp):
        beta1, beta2, eps = hp
        m, v = states
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * g.square())
        mhat = m / _f32(1 - _f32(beta1 ** t))
        vhat = v / _f32(1 - _f32(beta2 ** t))
        upd = mhat / (vhat.sqrt() + eps) + wd * w
        w.sub_((lr * upd).to(w.dtype))
        return (m, v)
