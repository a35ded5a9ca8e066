"""Trainer — applies an optimizer to a set of parameters on one device.

Counterpart of the single-device part of ``mxnet_tpu/gluon/trainer.py``:
``step`` (``rescale_grad = 1 / batch_size``, reduce, update), ``update``,
``allreduce_grads`` (nothing to reduce on one device), the stale-gradient
error, ``zero_grad``, ``save_states``/``load_states``, and tied parameters
optimised once. Multi-device and distributed kvstores, gradient
compression, gradient streaming, fault sites and tracing spans are not
ported yet: a kvstore other than a local one, or ``compression_params``
that ask for compression, raise.

Trainer state files cross packages: ``save_states`` writes the JAX
package's format-2 pickle (``{"format", "num_update",
"index_update_count", "states"}``, states as numpy arrays, a master-weight
state as ``mxnet_tpu.optimizer.optimizer.MasterWeightState``), and
``load_states`` reads it, and format 1, from either package. The port
imports nothing of ``mxnet_tpu``: the JAX class is written and read by
name, and reading admits numpy's array reconstructors, builtin containers
and that one class, nothing else. State indices follow the
``collect_params()`` order, which is the same in both packages.
"""
from __future__ import annotations

import importlib
import io
import pickle
from typing import Any, Dict, Optional, Union

import numpy as _np
import torch

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")
# the JAX package's MasterWeightState, as its pickles name it
_JAX_MASTER = ("mxnet_tpu.optimizer.optimizer", "MasterWeightState")
# what a trainer state file may name besides it
_NUMPY_NAMES = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (f"numpy.{core}.{mod}", name) for core in ("core", "_core")
    for mod, name in (("multiarray", "_reconstruct"),
                      ("multiarray", "scalar"), ("numeric", "_frombuffer"))}
_BUILTIN_NAMES = {("builtins", n) for n in (
    "tuple", "list", "dict", "set", "frozenset", "int", "float", "bool",
    "complex", "bytes", "bytearray", "str")}


def _dedupe(named):
    """Keep each parameter once, under its first name (a tied parameter,
    such as BERT's MLM decoder weight, is optimised exactly once)."""
    names, params, seen = [], [], set()
    for name, p in named:
        if id(p) not in seen:
            seen.add(id(p))
            names.append(name)
            params.append(p)
    return names, params


def _to_numpy(state):
    """Optimizer state with every tensor as a numpy array (the JAX
    package's ``tree_map(np.asarray, state)``)."""
    if isinstance(state, opt.MasterWeightState):
        return opt.MasterWeightState(_to_numpy(state.master),
                                     _to_numpy(state.inner))
    if isinstance(state, (tuple, list)):
        return tuple(_to_numpy(s) for s in state)
    if state.dtype == torch.bfloat16:
        raise MXNetError("save_states: a bfloat16 optimizer state has no "
                         "numpy dtype; keep master weights "
                         "(multi_precision=True) for bfloat16 parameters")
    return state.detach().cpu().numpy()


def _to_torch(state, device):
    if isinstance(state, opt.MasterWeightState):
        return opt.MasterWeightState(_to_torch(state.master, device),
                                     _to_torch(state.inner, device))
    if isinstance(state, (tuple, list)):
        return tuple(_to_torch(s, device) for s in state)
    return torch.from_numpy(_np.array(state)).to(device)


class _StatePickler(pickle._Pickler):
    """Writes the port's MasterWeightState under the JAX package's name.
    The pure-Python pickler, because the C one checks a class's name by
    importing its module."""

    def save_global(self, obj, name=None):
        if obj is not opt.MasterWeightState:
            return super().save_global(obj, name)
        self.save(_JAX_MASTER[0])
        self.save(_JAX_MASTER[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _StateUnpickler(pickle.Unpickler):
    """Reads a trainer state file of either package: admits numpy's array
    reconstructors, builtin containers and MasterWeightState (as the
    port's class), and refuses every other name."""

    def find_class(self, module, name):
        if (module, name) == _JAX_MASTER or (module, name) == (
                opt.MasterWeightState.__module__, "MasterWeightState"):
            return opt.MasterWeightState
        if (module, name) in _NUMPY_NAMES:
            if module.startswith("numpy.core.") and hasattr(_np, "_core"):
                module = "numpy._core." + module[len("numpy.core."):]
            return getattr(importlib.import_module(module), name)
        if (module, name) in _BUILTIN_NAMES:
            return getattr(importlib.import_module("builtins"), name)
        raise MXNetError(f"trainer state file names {module}.{name}; only "
                         "numpy arrays, builtin containers and "
                         "MasterWeightState may appear in one")


class Trainer:
    def __init__(self, params: Any, optimizer: Union[str, "opt.Optimizer"],
                 optimizer_params: Optional[Dict[str, Any]] = None,
                 kvstore: Union[str, Any, None] = "device",
                 compression_params: Optional[Dict[str, Any]] = None,
                 update_on_kvstore: Optional[bool] = None) -> None:
        if isinstance(params, dict):
            named = list(params.items())
        elif isinstance(params, (list, tuple)):
            named = [(getattr(p, "name", str(i)), p)
                     for i, p in enumerate(params)]
        else:
            raise MXNetError(
                "Trainer expects a dict of Parameters (from collect_params()) "
                f"or a list of Parameters, got {type(params)}")
        for _, p in named:
            if not isinstance(p, Parameter):
                raise MXNetError(f"non-Parameter {p!r} passed to Trainer")
        if compression_params:
            raise MXNetError(
                f"Trainer: gradient compression ({compression_params!r}) is "
                "not ported yet (ROADMAP Queue A 13, the distributed "
                "kvstores); pass compression_params=None")
        if kvstore not in _LOCAL_KVSTORES or update_on_kvstore:
            raise MXNetError(
                f"Trainer: kvstore {kvstore!r} (update_on_kvstore="
                f"{update_on_kvstore}) is not ported yet; the port trains "
                "on one device (kvstore='device')")
        self._param_names, self._params = _dedupe(named)
        optimizer_params = optimizer_params or {}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        # param_dict drives the lr_mult/wd_mult lookups by index
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._states: Dict[int, Any] = {}

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    @property
    def optimizer(self) -> "opt.Optimizer":
        return self._optimizer

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self, ignore_stale_grad: bool = False) -> None:
        """Sum gradients across devices: one device has nothing to sum."""

    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Rescale gradients by 1/batch_size and apply one update."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Apply the optimizer without gradient reduction."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False) -> None:
        updatable = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p.data().grad is None or not p._fresh_grad:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    f"Gradient of Parameter `{self._param_names[i]}` has not "
                    "been updated by backward since the last step — run "
                    "autograd.backward() on a loss computed inside "
                    "autograd.record() first, or pass ignore_stale_grad=True")
            updatable.append((i, p))
        o = self._optimizer
        for i, p in updatable:
            w = p.data()
            if i not in self._states:
                self._states[i] = o.create_state_multi_precision(i, w)
            self._states[i] = o.update_multi_precision(i, w, w.grad,
                                                       self._states[i])
            p._fresh_grad = False

    def zero_grad(self) -> None:
        for p in self._params:
            p.zero_grad()

    def save_states(self, fname: str) -> None:
        """Write the optimizer's update counts and states to ``fname`` as
        the JAX package's format-2 pickle."""
        payload = {
            "format": 2,
            "num_update": self._optimizer.num_update,
            "index_update_count": dict(self._optimizer._index_update_count),
            "states": {i: _to_numpy(s) for i, s in self._states.items()},
        }
        buf = io.BytesIO()
        _StatePickler(buf, protocol=4).dump(payload)
        with open(fname, "wb") as f:
            f.write(buf.getvalue())

    def load_states(self, fname: str) -> None:
        """Restore a state file of either package onto each parameter's
        device. A format-1 file's master-weight states, plain
        ``(master, inner)`` tuples, are rewrapped as the JAX package does
        (``trainer.py:934-953``)."""
        with open(fname, "rb") as f:
            payload = _StateUnpickler(f).load()
        legacy = payload.get("format", 1) < 2

        def restore(i, s):
            if legacy and self._optimizer.multi_precision and \
                    type(s) is tuple and len(s) == 2 and \
                    isinstance(s[0], _np.ndarray) and \
                    s[0].dtype == _np.float32 and \
                    isinstance(s[1], tuple) and \
                    i < len(self._params) and \
                    self._params[i].dtype != torch.float32 and \
                    tuple(s[0].shape) == self._params[i].shape:
                s = opt.MasterWeightState(s[0], s[1])
            return _to_torch(s, self._params[i].device)

        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(
            payload["index_update_count"])
        self._states = {i: restore(i, s)
                        for i, s in payload["states"].items()}
