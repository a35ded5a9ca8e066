"""Op invocation and the op registry.

Counterpart of ``mxnet_tpu/ndarray/register.py``: ``invoke``,
``invoke_with_custom_vjp``, ``wrap_out`` and ``register_op`` / ``get_op`` /
``list_ops``. An op is a function over torch tensors; ``invoke`` runs it on
the tensors of its NDArray inputs and wraps what it returns.

Recording follows the JAX package (``register.py:485``): an op is recorded
only when ``autograd.record()`` is on and one of its inputs is on the tape
(a variable or the output of a recorded op). It then runs under torch's
grad mode, and otherwise with grad mode off, so that nothing outside
``record()`` builds a graph. Torch's autograd is the tape.

Each output that shares memory with an input (a view: basic slicing,
``reshape``, ``transpose``, an op that returns its input) is copied, so no
two NDArrays share a buffer (``ndarray.py``, value semantics). Each output
is canonicalized to the JAX package's 32-bit types.

Each call counts into ``mxnet_ops_dispatched_total{op=...}``
(:func:`~mxnet_tpu_torch.metrics.inc_op`) and passes the ``dispatch.op``
fault site, as in the JAX package (``register.py:406-408,447-449``).

Not here, as in eager torch they have no meaning or belong to a later
slice: the XLA executable cache and eager-op bulking, mesh harmonization,
the AMP cast, profiler timers and the monitor hooks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from .. import faults as _faults
from .. import metrics as _metrics
from ..autograd import is_recording
from .ndarray import NDArray, canonical_dtype

__all__ = ["invoke", "invoke_with_custom_vjp", "register_op", "get_op",
           "list_ops", "wrap_out"]

# name -> {"fn": public python function, "doc": ...}
_OP_REGISTRY: Dict[str, Dict[str, Any]] = {}


def register_op(name: str, fn: Callable, doc: str = "") -> Callable:
    """Register a public op under ``name`` (``NNVM_REGISTER_OP``)."""
    _OP_REGISTRY[name] = {"fn": fn, "doc": doc or (fn.__doc__ or "")}
    return fn


def get_op(name: str) -> Callable:
    """Look up a registered op by name."""
    return _OP_REGISTRY[name]["fn"]


def list_ops() -> List[str]:
    """All registered op names."""
    return sorted(_OP_REGISTRY)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _own(out: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``out``, canonicalized, copied when it shares memory with an
    input."""
    dt = canonical_dtype(out.dtype)
    if dt != out.dtype:
        return out.to(dt)
    if out.numel() and any(t.numel() and _storage(t) == _storage(out)
                           for t in inputs):
        return out.clone()
    return out


def wrap_out(data: torch.Tensor, ctx=None) -> NDArray:
    """Wrap a tensor (already owned by no other NDArray) as an NDArray."""
    return NDArray(data, ctx=ctx, _wrap=True)


def invoke(name: str, impl: Callable, inputs: Sequence[NDArray],
           ctx=None) -> Any:
    """Run ``impl`` over the tensors of ``inputs``; returns one NDArray or
    a tuple of them, as ``impl`` returns one tensor or a tuple."""
    _metrics.inc_op(name)
    if _faults._ARMED:
        _faults.maybe_fault("dispatch.op", op=name)
    tensors = [x._data for x in inputs]
    record = is_recording() and any(x._on_tape for x in inputs)
    with torch.set_grad_enabled(record):
        outs = impl(*tensors)
    single = not isinstance(outs, (tuple, list))
    outs_t = (outs,) if single else tuple(outs)
    wrapped = [wrap_out(_own(o, tensors), ctx) for o in outs_t]
    return wrapped[0] if single else tuple(wrapped)


class _CustomVJP(torch.autograd.Function):
    """An op whose backward is a user function: ``vjp(out_cot)`` gives the
    cotangent of each input (None for an input without one)."""

    @staticmethod
    def forward(ctx, impl, vjp_fn, *tensors):
        ctx.vjp_fn = vjp_fn
        ctx.n = len(tensors)
        return impl(*tensors)

    @staticmethod
    def backward(ctx, cot):
        cots = list(ctx.vjp_fn(cot))
        if len(cots) != ctx.n:
            raise RuntimeError(f"vjp gave {len(cots)} cotangents for "
                               f"{ctx.n} inputs")
        cots = [c._data if isinstance(c, NDArray) else c for c in cots]
        return (None, None, *cots)


def invoke_with_custom_vjp(name: str, impl: Callable,
                           inputs: Sequence[NDArray], vjp_fn: Callable,
                           ctx=None) -> NDArray:
    """Like :func:`invoke` with a hand-written pullback:
    ``vjp_fn(out_cot) -> per-input cotangents`` (tensors; None entries
    give no gradient). Single-output ops only."""
    _metrics.inc_op(name)
    if _faults._ARMED:
        _faults.maybe_fault("dispatch.op", op=name)
    tensors = [x._data for x in inputs]
    if is_recording() and any(x._on_tape for x in inputs):
        with torch.enable_grad():
            out = _CustomVJP.apply(impl, vjp_fn, *tensors)
    else:
        with torch.no_grad():
            out = impl(*tensors)
    return wrap_out(_own(out, tensors), ctx)
