"""NDArray — the imperative tensor, over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. An NDArray holds one tensor
on an explicit device. Three rules keep its behaviour the JAX package's:

- **Value semantics.** JAX arrays are immutable, so there an NDArray never
  sees a write made through another. Torch hands out views (basic slicing,
  ``reshape``, ``transpose``) and writes in place (``t[k] = v``). Here no
  op returns a tensor that shares memory with one of its inputs
  (``register.invoke`` copies such an output), ``__setitem__`` writes into
  a copy and rebinds, and the in-place operators rebind to a new tensor.
  So ``b = a[1:3]; a[1] = 7`` leaves ``b`` as it was. The one in-place
  writer is ``rtc.CudaKernel.launch``, which writes into the arrays it is
  given, as upstream MXNet's does.
- **Dtypes.** The JAX package runs with 64-bit types off, so every result
  here is canonicalized the same way: int64 -> int32, float64 -> float32,
  complex128 -> complex64, uint64 -> uint32 (``canonical_dtype``).
  ``dtype`` gives a numpy dtype, or the string ``'bfloat16'`` (numpy has
  none; ``mx.np.bfloat16`` is that string in both packages).
- **Gradients.** ``attach_grad`` makes the tensor a torch leaf that
  requires a gradient and allocates ``grad``, an NDArray that stays the
  same object after every ``backward`` (``grad_req`` ``'write'``
  overwrites it, ``'add'`` accumulates, ``'null'`` has none). Recording is
  torch's autograd (see ``mxnet_tpu_torch/autograd.py``); there is no
  second tape.
"""
from __future__ import annotations

import weakref
from typing import Any, Optional

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, current_context

__all__ = ["NDArray", "waitall", "canonical_dtype",
           "to_torch_dtype", "dtype_name"]

# x64 off, as the JAX package runs
_CANON = {torch.int64: torch.int32, torch.float64: torch.float32,
          torch.complex128: torch.complex64, torch.uint64: torch.uint32}
_PY_TYPES = {float: torch.float32, int: torch.int32, bool: torch.bool,
             complex: torch.complex64}
# CUDA devices that hold an NDArray, for waitall
_CUDA_IN_USE: set = set()


def canonical_dtype(dt: torch.dtype) -> torch.dtype:
    return _CANON.get(dt, dt)


def to_torch_dtype(dtype: Any) -> Optional[torch.dtype]:
    """A dtype given as a string, numpy dtype, python type or torch dtype,
    canonicalized (``'float64'`` -> ``torch.float32``); None stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return canonical_dtype(dtype)
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return canonical_dtype(getattr(torch, _np.dtype(dtype).name))


def dtype_name(dt: torch.dtype) -> str:
    """``'float32'`` for ``torch.float32`` (numpy's names)."""
    return str(dt).split(".")[-1]


def _np_dtype(dt: torch.dtype) -> Any:
    return "bfloat16" if dt == torch.bfloat16 else _np.dtype(dtype_name(dt))


def _ctx_of(t: torch.Tensor) -> Context:
    if t.device.type == "cuda":
        return Context("gpu", t.device.index or 0)
    return Context("cpu", 0)


def _host_tensor(data: Any, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A new CPU tensor from an array-like (numpy, lists, scalars): the
    caller's buffer is copied, never shared."""
    a = _np.asarray(data)
    if a.dtype.name == "bfloat16":           # an ml_dtypes array
        t = torch.from_numpy(_np.array(a.view(_np.uint16))).view(torch.bfloat16)
        return t if dtype in (None, torch.bfloat16) else t.to(dtype)
    if dtype is None:
        dtype = canonical_dtype(getattr(torch, a.dtype.name))
    if dtype == torch.bfloat16:
        return torch.from_numpy(_np.array(a, dtype=_np.float32)).to(dtype)
    return torch.from_numpy(_np.array(a, dtype=dtype_name(dtype), copy=True))


def _note_device(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        _CUDA_IN_USE.add(t.device.index or 0)


def _raw(x: Any) -> Any:
    return x._data if isinstance(x, NDArray) else x


def _flip_negative_steps(t: torch.Tensor, key: Any):
    """Torch refuses slices with a negative step. Returns ``(dims, key)``:
    index ``t.flip(dims)`` with ``key`` to select what the original key
    selects, in the same order (a slice ``s:e:-k`` of an axis of length n
    is the slice ``n-1-s : n-e : k`` of the flipped axis)."""
    items = list(key) if isinstance(key, tuple) else [key]
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in items):
        return (), key

    def width(k):
        if k is None or k is Ellipsis:
            return 0
        if isinstance(k, torch.Tensor) and k.dtype in (torch.bool,
                                                       torch.uint8):
            return k.ndim
        return 1
    used = sum(width(k) for k in items)
    out, dims, dim = [], [], 0
    for k in items:
        if k is Ellipsis:
            dim += t.ndim - used
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            n = t.shape[dim]
            r = range(*k.indices(n))
            k = slice(n - 1 - r[0], n - r[-1], -k.step) if len(r) \
                else slice(0, 0)
            dims.append(dim)
        dim += width(k)
        out.append(k)
    return tuple(dims), (tuple(out) if isinstance(key, tuple) else out[0])


def _torch_key(t: torch.Tensor, key: Any):
    """``(flip dims, key)`` for indexing ``t``: NDArrays, numpy arrays and
    lists made into tensors on ``t``'s device (integer indices as int64,
    as torch wants), negative-step slices as in
    :func:`_flip_negative_steps`."""
    def one(k):
        k = _raw(k)
        if isinstance(k, (list, _np.ndarray)):
            k = torch.as_tensor(_np.asarray(k))
        if isinstance(k, torch.Tensor):
            k = k.to(t.device)
            if k.dtype not in (torch.bool, torch.uint8):
                k = k.long()
        return k
    key = tuple(one(k) for k in key) if isinstance(key, tuple) else one(key)
    return _flip_negative_steps(t, key)


def _getitem(t: torch.Tensor, key: Any) -> torch.Tensor:
    dims, key = _torch_key(t, key)
    return (t.flip(dims) if dims else t)[key]


class NDArray:
    """A multi-dimensional array on a device context.

    Create with ``mx.np.array`` / ``mx.nd.zeros`` / ...; direct
    construction from any array-like also works:
    ``NDArray([[1, 2], [3, 4]], ctx=mx.cpu())``.
    """

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_fresh_grad",
                 "__weakref__")

    __array_priority__ = 1000.0

    def __init__(self, data: Any, ctx: Optional[Context] = None,
                 dtype: Any = None, _wrap: bool = False) -> None:
        if _wrap:
            t = data
        else:
            ctx = ctx or current_context()
            dt = to_torch_dtype(dtype)
            data = _raw(data)
            if isinstance(data, torch.Tensor):
                t = data.detach().clone()
                t = t.to(dt or canonical_dtype(t.dtype))
            else:
                t = _host_tensor(data, dt)
            t = t.to(ctx.torch_device)
        _note_device(t)
        self._data = t
        self._ctx = ctx or _ctx_of(t)
        self._grad = None
        self._grad_req = "null"
        self._fresh_grad = False

    # -- the tensor ------------------------------------------------------
    def _set_data(self, t: torch.Tensor) -> "NDArray":
        """Rebind to ``t``. An array with a gradient buffer stays a leaf
        variable: it takes ``t``'s value, not the op that made it (the
        JAX package's ``_adopt`` moves the buffer, not the tape)."""
        if self._grad_req != "null":
            t = _make_leaf(self, t.detach())
        self._data = t
        return self

    # -- basic properties ------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self._data.shape)

    @property
    def dtype(self) -> Any:
        return _np_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def context(self) -> Context:
        return self._ctx

    ctx = context
    device = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def grad(self) -> Optional["NDArray"]:
        """Gradient buffer attached by :meth:`attach_grad`."""
        return self._grad

    @property
    def _on_tape(self) -> bool:
        return self._data.requires_grad or self._grad_req != "null"

    # -- sync and transfer -----------------------------------------------
    def wait_to_read(self) -> None:
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    def asnumpy(self) -> _np.ndarray:
        """A new numpy array with this array's value (bf16 as float32:
        numpy has no bfloat16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out = t.cpu().numpy()
        return out.copy() if t.device.type == "cpu" else out

    def item(self) -> Any:
        return self.asnumpy().item()

    def tolist(self):
        return self.asnumpy().tolist()

    def asscalar(self) -> Any:
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.item()

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        from .register import invoke
        return invoke("astype", lambda a: a.to(dt), (self,))

    def copy(self) -> "NDArray":
        from .register import invoke
        return invoke("copy", lambda a: a.clone(), (self,))

    def copyto(self, other) -> "NDArray":
        """Copy into another NDArray (rebinding it) or onto a Context."""
        if isinstance(other, Context):
            return self.as_in_context(other)
        if isinstance(other, NDArray):
            t = self._data.detach().to(other._data.device, copy=True)
            _note_device(t)
            return other._set_data(t)
        raise TypeError(f"copyto does not support type {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        """A copy on ``ctx`` (this array if it is already there)."""
        if self.context == ctx:
            return self
        dev = ctx.torch_device
        from ..autograd import is_recording
        from .register import invoke
        if is_recording() and self._on_tape:
            return invoke("as_in_context", lambda a: a.to(dev), (self,),
                          ctx=ctx)
        return NDArray(self._data.detach().to(dev, copy=True), ctx=ctx,
                       _wrap=True)

    as_in_ctx = as_in_context
    to_device = as_in_context

    def as_nd_ndarray(self) -> "NDArray":
        return self

    def as_np_ndarray(self) -> "NDArray":
        return self

    def detach(self) -> "NDArray":
        """The same value, off the autograd graph."""
        return NDArray(self._data.detach(), ctx=self._ctx, _wrap=True)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype: str = None) -> None:
        """Allocate a gradient buffer that ``backward()`` fills."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"invalid grad_req {grad_req!r}")
        self._grad_req = grad_req
        if grad_req == "null":
            self._grad = None
            self._data = self._data.detach()
            return
        self._data = _make_leaf(self, self._data.detach())
        self._grad = NDArray(torch.zeros_like(self._data.detach()),
                             ctx=self._ctx, _wrap=True)

    def _write_grad(self, cot: Optional[torch.Tensor]) -> None:
        """Write one backward's gradient into the buffer by ``grad_req``:
        the buffer is rebound, so ``x.grad`` stays the same object."""
        if self._grad_req == "null":
            return
        if cot is None:
            cot = torch.zeros_like(self._data.detach())
        cot = cot.detach().to(self._data.dtype)
        if self._grad is None:
            self._grad = NDArray(cot, ctx=self._ctx, _wrap=True)
        elif self._grad_req == "add":
            self._grad._data = self._grad._data + cot
        else:
            self._grad._data = cot
        self._fresh_grad = True

    def backward(self, out_grad: Optional["NDArray"] = None,
                 retain_graph: bool = False, train_mode: bool = True) -> None:
        """Compute the gradients of this array into the attached
        variables."""
        from ..autograd import backward
        backward([self], None if out_grad is None else [out_grad],
                 retain_graph=retain_graph)

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key) -> "NDArray":
        from .register import invoke
        nd_keys = [k for k in (key if isinstance(key, tuple) else (key,))
                   if isinstance(k, NDArray)]
        if nd_keys:
            # NDArray indices ride as inputs: the gather differentiates
            # with respect to self only
            def impl(a, *idx):
                it = iter(idx)
                kk = tuple(next(it) if isinstance(k, NDArray) else k
                           for k in (key if isinstance(key, tuple)
                                     else (key,)))
                return _getitem(a, kk if isinstance(key, tuple) else kk[0])
            return invoke("getitem", impl, (self, *nd_keys))
        return invoke("getitem", lambda a: _getitem(a, key), (self,))

    def __setitem__(self, key, value) -> None:
        t = self._data.detach()
        v = _raw(value)
        if not isinstance(v, torch.Tensor):
            v = _host_tensor(v, t.dtype)
        dims, k = _torch_key(t, key)
        with torch.no_grad():
            new = t.flip(dims) if dims else t.clone()
            new[k] = v.to(device=t.device, dtype=t.dtype)
        self._set_data(new.flip(dims) if dims else new)

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self) -> bool:
        if self.size != 1:
            raise ValueError("The truth value of an array with more than one "
                             "element is ambiguous.")
        return bool(self.item())

    def __float__(self) -> float:
        return float(self.item())

    def __int__(self) -> int:
        return int(self.item())

    def __index__(self) -> int:
        return int(self.item())

    def __repr__(self) -> str:
        return (f"{_np.array2string(self.asnumpy())}\n"
                f"<NDArray {self.shape} @{self.context}>")

    __hash__ = None  # elementwise __eq__, as numpy

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- operator sugar ----------------------------------------------------
    def _binop(self, name, other, swap=False):
        from . import ops
        fn = getattr(ops, name)
        return fn(other, self) if swap else fn(self, other)

    def __add__(self, o): return self._binop("add", o)
    def __radd__(self, o): return self._binop("add", o, True)
    def __sub__(self, o): return self._binop("subtract", o)
    def __rsub__(self, o): return self._binop("subtract", o, True)
    def __mul__(self, o): return self._binop("multiply", o)
    def __rmul__(self, o): return self._binop("multiply", o, True)
    def __truediv__(self, o): return self._binop("divide", o)
    def __rtruediv__(self, o): return self._binop("divide", o, True)
    def __floordiv__(self, o): return self._binop("floor_divide", o)
    def __rfloordiv__(self, o): return self._binop("floor_divide", o, True)
    def __mod__(self, o): return self._binop("mod", o)
    def __rmod__(self, o): return self._binop("mod", o, True)
    def __pow__(self, o): return self._binop("power", o)
    def __rpow__(self, o): return self._binop("power", o, True)
    def __matmul__(self, o): return self._binop("matmul", o)
    def __rmatmul__(self, o): return self._binop("matmul", o, True)
    def __neg__(self): return self._binop("multiply", -1)
    def __pos__(self): return self

    def __abs__(self):
        from . import ops
        return ops.abs(self)

    def __eq__(self, o): return self._binop("equal", o)
    def __ne__(self, o): return self._binop("not_equal", o)
    def __lt__(self, o): return self._binop("less", o)
    def __le__(self, o): return self._binop("less_equal", o)
    def __gt__(self, o): return self._binop("greater", o)
    def __ge__(self, o): return self._binop("greater_equal", o)

    def __iadd__(self, o): return self._set_data(self._binop("add", o)._data)
    def __isub__(self, o):
        return self._set_data(self._binop("subtract", o)._data)
    def __imul__(self, o):
        return self._set_data(self._binop("multiply", o)._data)
    def __itruediv__(self, o):
        return self._set_data(self._binop("divide", o)._data)

    # -- method forms ------------------------------------------------------
    def _op(self, name, *args, **kw):
        from . import ops
        return getattr(ops, name)(self, *args, **kw)

    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._op("reshape", shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._op("transpose", axes if axes else None)

    def swapaxes(self, a1, a2): return self._op("swapaxes", a1, a2)

    def flatten(self):
        if self.ndim > 1:
            return self.reshape(self.shape[0], -1)
        return self.reshape(-1)

    def ravel(self): return self.reshape(-1)
    def expand_dims(self, axis): return self._op("expand_dims", axis)
    def squeeze(self, axis=None): return self._op("squeeze", axis)
    def broadcast_to(self, shape): return self._op("broadcast_to", shape)
    def broadcast_like(self, other):
        return self._op("broadcast_to", other.shape)
    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats, axis)
    def tile(self, reps): return self._op("tile", reps)
    def split(self, *a, **kw): return self._op("split", *a, **kw)
    def flip(self, axis=None): return self._op("flip", axis)
    def take(self, indices, axis=None, mode="clip"):
        return self._op("take", indices, axis, mode)
    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def sum(self, axis=None, keepdims=False, dtype=None):
        return self._op("sum", axis=axis, keepdims=keepdims, dtype=dtype)
    def mean(self, axis=None, keepdims=False, dtype=None):
        return self._op("mean", axis=axis, keepdims=keepdims, dtype=dtype)
    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=axis, keepdims=keepdims)
    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=axis, keepdims=keepdims)
    def prod(self, axis=None, keepdims=False):
        return self._op("prod", axis=axis, keepdims=keepdims)
    def argmax(self, axis=None): return self._op("argmax", axis=axis)
    def argmin(self, axis=None): return self._op("argmin", axis=axis)
    def norm(self, ord=None, axis=None, keepdims=False):  # noqa: A002
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)
    def cumsum(self, axis=None): return self._op("cumsum", axis=axis)
    def var(self, axis=None, keepdims=False):
        return self._op("var", axis=axis, keepdims=keepdims)
    def std(self, axis=None, keepdims=False):
        return self._op("std", axis=axis, keepdims=keepdims)

    def dot(self, other): return self._op("dot", other)
    def abs(self): return self._op("abs")
    def exp(self): return self._op("exp")
    def log(self): return self._op("log")
    def sqrt(self): return self._op("sqrt")
    def square(self): return self._op("square")
    def sign(self): return self._op("sign")
    def round(self, decimals=0): return self._op("round", decimals)
    def floor(self): return self._op("floor")
    def ceil(self): return self._op("ceil")
    def clip(self, a_min=None, a_max=None):
        return self._op("clip", a_min, a_max)
    def maximum(self, other): return self._op("maximum", other)
    def minimum(self, other): return self._op("minimum", other)
    def sigmoid(self): return self._op("sigmoid")
    def tanh(self): return self._op("tanh")
    def relu(self): return self._op("relu")
    def one_hot(self, depth, **kw): return self._op("one_hot", depth, **kw)
    def astype_like(self, other): return self.astype(other.dtype)
    def zeros_like(self): return self._op("zeros_like")
    def ones_like(self): return self._op("ones_like")

    def tostype(self, stype: str) -> "NDArray":
        if stype == "default":
            return self
        raise MXNetError(f"storage type {stype!r}: sparse arrays are not "
                         "part of the port yet")


def _make_leaf(owner: NDArray, t: torch.Tensor) -> torch.Tensor:
    """``t`` as a leaf variable of ``owner`` (floating types only: torch
    has no gradients of integers). The tensor names its owner so that
    ``autograd.backward`` can write the owner's gradient buffer."""
    if t.is_floating_point() or t.is_complex():
        t.requires_grad_(True)
        t._mx_owner = weakref.ref(owner)
    return t


def waitall() -> None:
    """Wait for all work on every CUDA device that holds an NDArray."""
    for i in sorted(_CUDA_IN_USE):
        torch.cuda.synchronize(i)
