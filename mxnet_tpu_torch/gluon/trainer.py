"""Trainer — applies an optimizer to a set of parameters on one device.

Counterpart of the single-device part of ``mxnet_tpu/gluon/trainer.py``:
``step`` (``rescale_grad = 1 / batch_size``, reduce, update), ``update``,
``allreduce_grads`` (nothing to reduce on one device), the stale-gradient
error, ``zero_grad``, ``save_states``/``load_states``, and tied parameters
optimised once, and the JAX package's hooks (``trainer.py:570-603``): the
``trainer.step`` span, ``mxnet_trainer_step_seconds`` and the
``trainer.step`` fault site, whose ``kind=nan`` poisons the first fresh
gradient in place before the update. Multi-device and distributed
kvstores, gradient compression and gradient streaming are not ported yet:
a kvstore other than a local one, or ``compression_params`` that ask for
compression, raise.

The update is the JAX package's ``_update_entries_impl`` (``trainer.py:
738-883``): an optimizer that keeps ``Optimizer.update`` and
``update_multi_precision`` and whose ``_step`` the kernel implements
(``_fused_optimizer_ok``) updates its dense
parameters (``_param_fusible``; row-sparse gradients never join, and the
port has none yet) in groups of at most ``aggregate_num``
(``MXNET_OPTIMIZER_AGGREGATION_SIZE``, default 4); every other optimizer,
and any parameter left out, takes ``update_multi_precision`` one at a time.
On CUDA tensors every group of a step goes to the multi-tensor kernel in
one call, which launches it once for each layout (weight dtype, master or
none) after one host-to-device copy of the tables
(``ops/cuda/multi_tensor.py``); on CPU tensors each takes the eager
per-parameter update; a group of one is the same as
``update_multi_precision``. The
update counts, lrs and wds are taken in the JAX package's order before
any launch.

The grouping rule for master weights differs from the JAX package's, which
keeps every ``MasterWeightState`` out of its groups: the port's training
paths run bf16 weights with f32 masters, so that rule would group nothing.
Here a parameter with a master joins a group of parameters that share its
layout and the optimizer's hyperparameters (``Optimizer._group_key``:
device, weight dtype, a master or none, ``_hyper``); the kernel steps
each master and rounds it to its weight, element by element as
``update_multi_precision`` does, so the result is the same bits.
Parameters of one layout are grouped in their order; groups come in the
order of their first parameter (:func:`group_plan`).

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
import time
from typing import Any, Dict, Optional, Union

import numpy as _np
import torch

from .. import faults as _faults
from .. import metrics as _metrics
from .. import optimizer as opt
from .. import tracing as _tracing
from ..base import MXNetError
from .parameter import Parameter, dedupe_shared

__all__ = ["Trainer", "group_plan"]

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


def group_plan(keys, agg: int):
    """Positions ``0..len(keys)-1`` in groups: the positions of each key in
    their order, at most ``agg`` a group; groups ordered by their first
    position. One key throughout gives the JAX package's consecutive
    chunks."""
    open_, groups = {}, []
    for k, key in enumerate(keys):
        grp = open_.get(key)
        if grp is None or len(grp) == agg:
            grp = open_[key] = []
            groups.append(grp)
        grp.append(k)
    return groups


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
        self._param_names, self._params = dedupe_shared(named)
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
        if _faults._ARMED:
            self._fault_site()
        t0 = time.perf_counter()
        try:
            with _tracing.span("trainer.step", batch_size=batch_size):
                self._optimizer.rescale_grad = 1.0 / batch_size
                self.allreduce_grads()
                self._update(ignore_stale_grad)
        finally:
            _metrics.TRAINER_STEP_SECONDS.observe(time.perf_counter() - t0)

    def _fault_site(self) -> None:
        """The ``trainer.step`` fault site: ``kind=nan`` writes NaN into
        the first element of the first fresh gradient, in the
        parameter's gradient itself, before the update."""
        target = None
        for p in self._params:
            if p.grad_req != "null" and p.is_initialized \
                    and p.data().grad is not None and p._fresh_grad:
                target = p.data().grad
                break
        if target is None:
            _faults.maybe_fault("trainer.step")
            return
        out = _faults.maybe_corrupt("trainer.step", [target])
        if out[0] is not target:
            with torch.no_grad():
                target.copy_(out[0])

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
        entries = []
        for i, p in updatable:
            w = p.data()
            if i not in self._states:
                self._states[i] = o.create_state_multi_precision(i, w)
            entries.append((i, w, w.grad))
        self._update_entries(entries)
        for _, p in updatable:
            p._fresh_grad = False

    def _update_entries(self, updatable) -> None:
        """Apply the optimizer to ``(index, weight, grad)`` entries: groups
        of up to ``aggregate_num`` fusible parameters, then the rest one by
        one (the JAX package's ``_update_entries_impl``)."""
        o = self._optimizer
        agg = o.aggregate_num
        if len(updatable) > 1 and agg > 1 and self._fused_optimizer_ok():
            fusible, rest = [], []
            for t in updatable:
                (fusible if self._param_fusible(t) else rest).append(t)
            if len(fusible) < 2:
                fusible, rest = [], updatable
            if fusible:
                self._fused_update(fusible, agg)
        else:
            rest = updatable
        for i, w, g in rest:
            self._states[i] = o.update_multi_precision(i, w, g,
                                                       self._states[i])

    def _fused_optimizer_ok(self) -> bool:
        """Optimizers the kernel implements group; ones that override
        ``update`` / ``update_multi_precision``, or whose ``_step`` the
        kernel lacks, take the per-parameter path."""
        o = self._optimizer
        cls = type(o)
        return not (o._kernel_op() is None or
                    cls.update is not opt.Optimizer.update or
                    cls.update_multi_precision is not
                    opt.Optimizer.update_multi_precision)

    def _param_fusible(self, t) -> bool:
        """Dense parameters join a group, master weights included (the
        module docstring says why)."""
        _, _, g = t
        return getattr(g, "stype", "default") != "row_sparse"

    def _fused_update(self, fusible, agg: int) -> None:
        """Every group of the plan in one ``_update_groups`` call: the
        counts, lrs and wds first, in the parameters' order, then one
        kernel launch a layout on CUDA tensors."""
        o = self._optimizer
        entries = [(i, w, g, self._states[i]) for i, w, g in fusible]
        plan = group_plan([o._group_key(i, w, s) for i, w, _, s in entries],
                          agg)
        hypers = [o._next_hypers(i) for i, _, _, _ in entries]
        states = o._update_groups(
            [[entries[k] for k in grp] for grp in plan],
            [[hypers[k] for k in grp] for grp in plan])
        for grp, sts in zip(plan, states):
            for k, st in zip(grp, sts):
                self._states[entries[k][0]] = st

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
