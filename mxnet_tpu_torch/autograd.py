"""Autograd — ``record`` / ``pause`` / ``train_mode`` / ``backward`` on torch.

Counterpart of ``mxnet_tpu/autograd.py`` and the mode flags of
``mxnet_tpu/_tape.py``. Recording is torch's autograd: ``record()`` enables
gradients for its scope and ``pause()`` disables them. The training flag
(``is_training``) is the framework's own, per thread as in the JAX package:
``record()`` turns it on by default, and it is what makes the model zoo's
dropout active.

:func:`backward` gives MXNet's semantics on top of torch's:

- a head that is not a scalar is seeded with ones (MXNet's default head
  gradient), where torch would refuse it;
- a parameter with ``grad_req='write'`` gets the new gradient in place of
  the old one, ``'add'`` accumulates, ``'null'`` has none (torch itself
  always accumulates); every parameter the heads reach is marked fresh for
  the trainer's stale-gradient check.

A head computed outside ``record()`` has no graph, and ``backward`` raises.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Union

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward"]


class _ModeState(threading.local):
    def __init__(self) -> None:
        self.recording = False
        self.training = False


_STATE = _ModeState()


def is_recording() -> bool:
    return _STATE.recording


def is_training() -> bool:
    return _STATE.training


def set_recording(flag: bool) -> bool:
    """Set the recording flag; returns the previous one."""
    prev, _STATE.recording = _STATE.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    """Set the training flag; returns the previous one."""
    prev, _STATE.training = _STATE.training, bool(flag)
    return prev


class _RecordingStateScope:
    """Scope that sets the recording/training flags (and torch's grad mode
    with recording) and restores them on exit."""

    def __init__(self, is_record: Optional[bool],
                 train: Optional[bool]) -> None:
        self._enter_record = is_record
        self._enter_train = train
        self._prev_record: Optional[bool] = None
        self._prev_train: Optional[bool] = None
        self._grad_mode: Optional[torch.set_grad_enabled] = None

    def __enter__(self) -> None:
        if self._enter_record is not None:
            self._prev_record = set_recording(self._enter_record)
            self._grad_mode = torch.set_grad_enabled(self._enter_record)
        if self._enter_train is not None:
            self._prev_train = set_training(self._enter_train)

    def __exit__(self, *exc: Any) -> None:
        if self._grad_mode is not None:
            self._grad_mode.__exit__(*exc)
            set_recording(self._prev_record)
        if self._prev_train is not None:
            set_training(self._prev_train)


def record(train_mode: bool = True) -> _RecordingStateScope:
    """Scope recording ops for :func:`backward` (``autograd.record``)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingStateScope:
    """Scope suspending recording (``autograd.pause``)."""
    return _RecordingStateScope(False, train_mode)


def train_mode() -> _RecordingStateScope:
    """Scope forcing training behaviour of ops (dropout active)."""
    return _RecordingStateScope(None, True)


def predict_mode() -> _RecordingStateScope:
    """Scope forcing inference behaviour of ops."""
    return _RecordingStateScope(None, False)


def _as_list(x: Any) -> List[Any]:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _leaves(heads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every leaf tensor that gradients of ``heads`` reach (the variables
    of torch's AccumulateGrad nodes), each once."""
    seen, out = set(), {}
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            out[id(var)] = var
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return list(out.values())


def backward(heads: Union[torch.Tensor, Sequence[torch.Tensor]],
             head_grads: Optional[Union[torch.Tensor,
                                        Sequence[Optional[torch.Tensor]]]] = None,
             retain_graph: bool = False, train_mode: bool = True) -> None:
    """Compute the gradients of ``heads`` into the parameters they reach,
    by each parameter's ``grad_req`` (``autograd.backward``)."""
    heads = _as_list(heads)
    grads = _as_list(head_grads) if head_grads is not None \
        else [None] * len(heads)
    if len(grads) != len(heads):
        raise MXNetError(f"backward: {len(heads)} heads but {len(grads)} "
                         "head gradients")
    for h in heads:
        if not isinstance(h, torch.Tensor) or h.grad_fn is None:
            raise MXNetError(
                "backward: a head was not computed under autograd.record() "
                "(it has no graph) — run the forward inside "
                "`with autograd.record():`")
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, grads)]
    leaves = _leaves(heads)
    for p in leaves:
        if getattr(p, "grad_req", "write") == "write":
            p.grad = None
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)
    for p in leaves:
        if hasattr(p, "grad_req"):
            p._fresh_grad = True
