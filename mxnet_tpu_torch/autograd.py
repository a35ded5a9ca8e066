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

Heads, head gradients and variables may be NDArrays (``mxnet_tpu_torch.nd``)
as well as tensors. An NDArray variable (``attach_grad`` /
:func:`mark_variables`) is a torch leaf that names its owner: after
``torch.autograd.backward`` its gradient is written into the owner's
``grad`` buffer by the owner's ``grad_req`` (the buffer stays the same
NDArray object) and cleared from the leaf.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Union

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "mark_variables", "grad"]


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


def _tensor(x: Any) -> Any:
    """The tensor of an NDArray (anything else as it is)."""
    from .ndarray.ndarray import NDArray
    return x._data if isinstance(x, NDArray) else x


def _heads(heads: Any) -> List[torch.Tensor]:
    out = [_tensor(h) for h in _as_list(heads)]
    for h in out:
        if not isinstance(h, torch.Tensor) or h.grad_fn is None:
            raise MXNetError(
                "backward: a head was not computed under autograd.record() "
                "(it has no graph) — run the forward inside "
                "`with autograd.record():`")
    return out


def _head_grads(heads: List[torch.Tensor], head_grads: Any
                ) -> List[torch.Tensor]:
    grads = _as_list(head_grads) if head_grads is not None \
        else [None] * len(heads)
    if len(grads) != len(heads):
        raise MXNetError(f"backward: {len(heads)} heads but {len(grads)} "
                         "head gradients")
    return [torch.ones_like(h) if g is None else _tensor(g)
            for h, g in zip(heads, grads)]


def _owner(leaf: torch.Tensor) -> Any:
    ref = getattr(leaf, "_mx_owner", None)
    return ref() if ref is not None else None


def backward(heads: Any, head_grads: Any = None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Compute the gradients of ``heads`` into the parameters and
    variables they reach, by each one's ``grad_req``
    (``autograd.backward``)."""
    heads = _heads(heads)
    grads = _head_grads(heads, head_grads)
    leaves = _leaves(heads)
    for p in leaves:
        if getattr(p, "grad_req", "write") == "write" \
                or _owner(p) is not None:
            p.grad = None
    torch.autograd.backward(heads, grads, retain_graph=retain_graph)
    for p in leaves:
        if hasattr(p, "grad_req"):
            p._fresh_grad = True
        owner = _owner(p)
        if owner is not None:
            owner._write_grad(p.grad)
            p.grad = None


def mark_variables(variables: Any, gradients: Any,
                   grad_reqs: Union[str, Sequence[str]] = "write") -> None:
    """Make NDArrays variables with the given gradient buffers
    (``MXAutogradMarkVariables``)."""
    from .ndarray.ndarray import _make_leaf
    variables, gradients = _as_list(variables), _as_list(gradients)
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {req!r}")
        v._grad_req, v._grad = req, g
        v._data = v._data.detach()
        if req != "null":
            _make_leaf(v, v._data)


def grad(heads: Any, variables: Any, head_grads: Any = None,
         retain_graph: Optional[bool] = None, create_graph: bool = False,
         train_mode: bool = True) -> Any:
    """The gradients of ``heads`` with respect to ``variables``, returned
    as new NDArrays; no gradient buffer is written (``autograd.grad``)."""
    from .ndarray.ndarray import NDArray
    if create_graph:
        raise MXNetError("create_graph=True (higher-order imperative "
                         "autograd) is not supported")
    single = not isinstance(variables, (list, tuple))
    vars_l = _as_list(variables)
    heads_t = _heads(heads)
    outs = torch.autograd.grad(
        heads_t, [_tensor(v) for v in vars_l], _head_grads(heads_t, head_grads),
        retain_graph=bool(retain_graph), allow_unused=True)
    res = [NDArray(torch.zeros_like(_tensor(v)) if g is None else g.detach(),
                   ctx=v.context, _wrap=True) for v, g in zip(vars_l, outs)]
    return res[0] if single else res
