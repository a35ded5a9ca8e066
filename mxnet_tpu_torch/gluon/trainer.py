"""Trainer — applies an optimizer to a set of parameters on one device.

Counterpart of the single-device part of ``mxnet_tpu/gluon/trainer.py``:
``step`` (``rescale_grad = 1 / batch_size``, reduce, update), ``update``,
``allreduce_grads`` (nothing to reduce on one device), the stale-gradient
error, ``zero_grad``, ``save_states``/``load_states``, and tied parameters
optimised once. Multi-device and distributed kvstores, gradient streaming,
fault sites and tracing spans are not ported yet: a kvstore other than a
local one raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


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


def _encode(state):
    """Optimizer state as dicts, lists and CPU tensors (what
    ``torch.load(weights_only=True)`` reads back)."""
    if isinstance(state, opt.MasterWeightState):
        return {"master": state.master.detach().cpu(),
                "inner": _encode(state.inner)}
    if isinstance(state, (tuple, list)):
        return [_encode(s) for s in state]
    return state.detach().cpu()


def _decode(state, device):
    if isinstance(state, dict):
        return opt.MasterWeightState(state["master"].to(device),
                                     _decode(state["inner"], device))
    if isinstance(state, list):
        return tuple(_decode(s, device) for s in state)
    return state.to(device)


class Trainer:
    def __init__(self, params: Any, optimizer: Union[str, "opt.Optimizer"],
                 optimizer_params: Optional[Dict[str, Any]] = None,
                 kvstore: Union[str, Any, None] = "device",
                 update_on_kvstore: Optional[bool] = None) -> None:
        if isinstance(params, dict):
            named = list(params.items())
        elif isinstance(params, (list, tuple)):
            named = [(getattr(p, "mx_name", str(i)), p)
                     for i, p in enumerate(params)]
        else:
            raise MXNetError(
                "Trainer expects a dict of Parameters (from collect_params()) "
                f"or a list of Parameters, got {type(params)}")
        for _, p in named:
            if not isinstance(p, Parameter):
                raise MXNetError(f"non-Parameter {p!r} passed to Trainer")
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

    def allreduce_grads(self) -> None:
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
            if p.grad is None or not p._fresh_grad:
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
            if i not in self._states:
                self._states[i] = o.create_state_multi_precision(i, p)
            self._states[i] = o.update_multi_precision(i, p, p.grad,
                                                       self._states[i])
            p._fresh_grad = False

    def zero_grad(self) -> None:
        for p in self._params:
            p.zero_grad()

    def save_states(self, fname: str) -> None:
        """Write the optimizer's update counts and states to ``fname``."""
        torch.save({
            "format": 2,
            "num_update": self._optimizer.num_update,
            "index_update_count": dict(self._optimizer._index_update_count),
            "states": {i: _encode(s) for i, s in self._states.items()},
        }, fname)

    def load_states(self, fname: str) -> None:
        """Restore what :meth:`save_states` wrote, onto each parameter's
        device."""
        payload = torch.load(fname, map_location="cpu", weights_only=True)
        self._optimizer.num_update = payload["num_update"]
        self._optimizer._index_update_count = dict(
            payload["index_update_count"])
        self._states = {i: _decode(s, self._params[i].device)
                        for i, s in payload["states"].items()}
