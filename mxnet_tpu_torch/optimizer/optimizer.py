"""Optimizers: ``SGD``, ``Adam``, ``AdamW`` and the base class.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py`` (``Optimizer``,
``MasterWeightState``, ``register``/``create``, ``SGD``, ``Adam``,
``AdamW``) with the same math and bookkeeping: a per-index update count
``t`` (Adam's bias correction), ``rescale_grad`` and ``clip_gradient``
applied to the gradient first, lr and wd multipliers per parameter, an
optional learning-rate schedule, and ``multi_precision``: an f32 master
copy for bf16/fp16 weights, updated in f32 and cast back.

The JAX package compiles each update with ``jax.jit`` and donates the
buffers, and its trainer applies one program to a group of up to
``aggregate_num`` parameters (``MXNET_OPTIMIZER_AGGREGATION_SIZE``,
default 4). Here :meth:`Optimizer.update_group` is that group entry: it
takes the update count, lr and wd of each index in order, then chooses
the route. On CUDA tensors it launches the hand-written multi-tensor
kernel once for the group (``ops/cuda/multi_tensor.py`` over
``csrc/multi_tensor.cu``), handing it tensors and numbers: the kernel's
operation (:meth:`Optimizer._kernel_op`), the group's scalars and each
tensor's (lr, wd, a, b), every one rounded here as the eager version
rounds it. On CPU tensors it runs :meth:`Optimizer._plain_update`, the
eager per-parameter version, for each. ``update`` and
``update_multi_precision`` are groups of one. Either way the weight, the
master and the states are updated in place, with the same bits. An
optimizer whose ``_step`` the kernel does not implement (a user's
subclass: ``_kernel_op`` is None) runs its own ``_step`` eagerly on
either device; the trainer never groups it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as _np
import torch

from ..base import MXNetError, getenv, register_env
from ..ops.cuda import multi_tensor as _mt

__all__ = ["Optimizer", "MasterWeightState", "register", "create", "SGD",
           "Adam", "AdamW"]


class MasterWeightState(NamedTuple):
    """f32 master weight of a low-precision parameter, beside the inner
    optimizer state; recognised by type, never by structure."""
    master: Any
    inner: Any


_OPT_REGISTRY: Dict[str, type] = {}

register_env("MXNET_OPTIMIZER_AGGREGATION_SIZE", 4,
             "Number of parameters fused per multi-tensor update batch.")


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


def _bias(beta: float, t: float) -> float:
    """Adam's bias correction ``1 - beta**t``, rounded to f32."""
    return _f32(1 - _f32(beta ** t))


def _adam_lr_t(lr: float, t: float, beta1: float, beta2: float) -> float:
    """Adam's bias-corrected step size, rounded to f32."""
    return _f32(lr * _np.sqrt(_bias(beta2, t)) / _bias(beta1, t))


def _scalar_as(x: float, dtype) -> float:
    """A Python scalar as a tensor of ``dtype`` receives it (to f32, then
    to 16 bits)."""
    return float(torch.tensor(_f32(x)).to(dtype).float())


def _split(state) -> tuple:
    """(master or None, state tensors) of a parameter's state."""
    if isinstance(state, MasterWeightState):
        return state.master, tuple(state.inner)
    return None, tuple(state)


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
        self.aggregate_num = getenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", 4)

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

    def _next_hypers(self, index: Any) -> tuple:
        """Count one update of ``index``, then its (lr, wd, t) rounded to
        f32, in the JAX package's order (``trainer.py:843-846``)."""
        self._update_count(index)
        return (_f32(self._get_lr(index)), _f32(self._get_wd(index)),
                _f32(self._index_update_count[index]))

    @torch.no_grad()
    def _plain_update(self, index: Any, weight: torch.Tensor,
                      grad: torch.Tensor, state: Any, lr: float, wd: float,
                      t: float) -> Any:
        """The eager per-parameter update, in place, with the hyperparameters
        given: the gradient's rescale and clip, ``_step``, and for a
        :class:`MasterWeightState` the step on the master and its cast back
        to the weight. Returns the state."""
        if isinstance(state, MasterWeightState):
            inner = self._plain_update(index, state.master, grad,
                                       state.inner, lr, wd, t)
            weight.copy_(state.master.to(weight.dtype))
            return MasterWeightState(state.master, inner)
        g = grad.float() if grad.dtype != weight.dtype else grad
        g = g * _f32(self.rescale_grad)
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        return type(self)._step(weight, g, state, lr, wd, t,
                                self._hyper(index))

    def _kernel_op(self) -> Optional[int]:
        """The multi-tensor kernel's operation for this optimizer's
        ``_step``; None where the kernel has none (a user's ``_step``)."""
        return None

    @staticmethod
    def _kernel_params(hp: tuple) -> tuple:
        """The kernel's five group parameters from ``_hyper``, in f32."""
        return (0.0,) * 5

    @staticmethod
    def _kernel_hypers(lr: float, wd: float, t: float, hp: tuple) -> tuple:
        """One tensor's (lr, wd, a, b) for the kernel."""
        return (lr, wd, 0.0, 0.0)

    def _kernel_scalars(self, hp: tuple, math) -> tuple:
        """A group's (rescale, lo, hi, clip, p0..p4): the clip bounds as a
        gradient of the update's ``math`` dtype receives them."""
        clip = self.clip_gradient
        lo = hi = 0.0
        if clip is not None:
            lo, hi = _scalar_as(-clip, math), _scalar_as(clip, math)
        return (_f32(self.rescale_grad), lo, hi,
                int(clip is not None)) + self._kernel_params(hp)

    def _group_key(self, index: Any, weight: torch.Tensor,
                   state: Any) -> tuple:
        """What the parameters of one group share: device, weight dtype,
        whether an f32 master stands beside the weight, and the
        hyperparameters of ``_hyper``."""
        return (weight.device, weight.dtype,
                isinstance(state, MasterWeightState), self._hyper(index))

    def _plain_update_groups(self, groups: Any, hypers: Any) -> list:
        """The plain version: :meth:`_plain_update` for each ``(index,
        weight, grad, state)`` with its ``(lr, wd, t)``; returns the
        states, group by group."""
        return [[self._plain_update(i, w, g, s, *h)
                 for (i, w, g, s), h in zip(entries, hyps)]
                for entries, hyps in zip(groups, hypers)]

    @torch.no_grad()
    def _update_groups(self, groups: Any, hypers: Any) -> list:
        """Update groups of ``(index, weight, grad, state)`` in place with
        their ``(lr, wd, t)``; returns the states, group by group. CUDA
        tensors: one launch of the multi-tensor kernel a layout (weight
        dtype, master or none) for all the groups, after one table copy.
        CPU tensors, or a ``_step`` the kernel does not implement:
        :meth:`_plain_update_groups`."""
        op = self._kernel_op()
        if op is None or not any(w.is_cuda for entries in groups
                                 for _, w, _, _ in entries):
            return self._plain_update_groups(groups, hypers)
        work = []
        for entries, hyps in zip(groups, hypers):
            if not entries:
                continue
            hp = self._hyper(entries[0][0])
            if any(self._hyper(i) != hp for i, _, _, _ in entries):
                raise MXNetError("update_group: the parameters of a group "
                                 "must share the optimizer's "
                                 "hyperparameters")
            master = isinstance(entries[0][3], MasterWeightState)
            math = torch.float32 if master else entries[0][1].dtype
            work.append(([(w, g) + _split(s) for _, w, g, s in entries],
                         [self._kernel_hypers(*h, hp) for h in hyps],
                         self._kernel_scalars(hp, math)))
        _mt.update_groups(op, work)
        return [[s for _, _, _, s in entries] for entries in groups]

    def update_group(self, entries: Any) -> list:
        """Update a group of ``(index, weight, grad, state)`` in place and
        return their states: one kernel launch on CUDA tensors, the plain
        per-parameter update on CPU tensors."""
        hypers = [self._next_hypers(e[0]) for e in entries]
        return self._update_groups([list(entries)], [hypers])[0]

    def update(self, index: Any, weight: torch.Tensor, grad: torch.Tensor,
               state: Any) -> Any:
        """Apply one update in place on ``weight``; returns the state."""
        return self.update_group([(index, weight, grad, state)])[0]

    @torch.no_grad()
    def update_multi_precision(self, index: Any, weight: torch.Tensor,
                               grad: torch.Tensor, state: Any) -> Any:
        """:meth:`update`; a :class:`MasterWeightState` is stepped on its
        master and cast back to the weight (one launch on CUDA tensors).
        A subclass's own ``update`` is called on the master, then the
        master is cast, as in the JAX package."""
        if type(self).update is Optimizer.update:
            return self.update_group([(index, weight, grad, state)])[0]
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

    def _kernel_op(self):
        if type(self)._step is not SGD._step:
            return None
        return _mt.SGD if self.momentum == 0.0 else _mt.SGD_MOM

    @staticmethod
    def _kernel_params(hp):
        return (_f32(hp[0]), 0.0, 0.0, 0.0, 0.0)

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

    def _kernel_op(self):
        return _mt.ADAM if type(self)._step is Adam._step else None

    @staticmethod
    def _kernel_params(hp):
        b1, b2, eps = hp
        return (_f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2), _f32(eps))

    @staticmethod
    def _kernel_hypers(lr, wd, t, hp):
        """Adam's lr_t in ``a``."""
        b1, b2, _ = hp
        return (lr, wd, _adam_lr_t(lr, t, b1, b2), 0.0)

    @staticmethod
    def _step(w, g, states, lr, wd, t, hp):
        beta1, beta2, eps = hp
        m, v = states
        g = g + wd * w
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * g.square())
        lr_t = _adam_lr_t(lr, t, beta1, beta2)
        w.sub_((lr_t * m / (v.sqrt() + eps)).to(w.dtype))
        return (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay, multiplied by the learning rate:
    ``w -= lr * (mhat / (sqrt(vhat) + eps) + wd * w)``."""

    def _kernel_op(self):
        return _mt.ADAMW if type(self)._step is AdamW._step else None

    @staticmethod
    def _kernel_hypers(lr, wd, t, hp):
        """The f32 reciprocals of the bias corrections in ``a`` and ``b``:
        PyTorch runs ``m / c1`` as a product with ``1 / c1`` in f32."""
        b1, b2, _ = hp
        one = _np.float32(1.0)
        return (lr, wd, float(one / _np.float32(_bias(b1, t))),
                float(one / _np.float32(_bias(b2, t))))

    @staticmethod
    def _step(w, g, states, lr, wd, t, hp):
        beta1, beta2, eps = hp
        m, v = states
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * g.square())
        mhat = m / _bias(beta1, t)
        vhat = v / _bias(beta2, t)
        upd = mhat / (vhat.sqrt() + eps) + wd * w
        w.sub_((lr * upd).to(w.dtype))
        return (m, v)
