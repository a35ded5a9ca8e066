"""Operator library: creation, elementwise, reductions, shape, indexing,
ordering, linear algebra and the legacy aliases.

Counterpart of ``mxnet_tpu/ndarray/ops.py``, one function for each public
name there (aliases included), each an ``invoke`` over torch ops. These
are XLA ops in the JAX package, not Pallas kernels, so the torch library
call is their port. Results follow the JAX package's types (64-bit off;
see ``ndarray.py``): where torch's own rule differs (an int64 ``argmax``,
``sum`` or ``cumsum``; ``mean`` of integers; ``prod`` over several axes)
the function below does what the JAX package does.
"""
from __future__ import annotations

import builtins
import functools
from typing import Any, Optional

import numpy as _np
import torch
import torch.nn.functional as F

from ..context import Context, current_context
from .ndarray import (NDArray, _getitem, _host_tensor, dtype_name,
                      to_torch_dtype)
from .ndarray import waitall as _waitall
from .register import invoke, register_op

__all__: list = []  # filled by _public


def _public(fn, name=None):
    name = name or fn.__name__
    __all__.append(name)
    register_op(name, fn)
    return fn


def _as_nd(x: Any, ref: Optional[NDArray] = None) -> NDArray:
    """``x`` as an NDArray; a python scalar with ``ref`` takes ``ref``'s
    dtype (and device), as in the JAX package."""
    if isinstance(x, NDArray):
        return x
    dtype = None
    if ref is not None and isinstance(x, (bool, int, float)):
        dtype = ref._data.dtype
    t = _host_tensor(x, dtype)
    if ref is not None:
        t = t.to(ref._data.device)
    return NDArray(t, _wrap=True)


def _scalar(v: Any, like: torch.Tensor) -> torch.Tensor:
    """A python scalar as a 0-d tensor on ``like``'s device: torch promotes
    a 0-d operand the way JAX promotes a weakly typed scalar (int32 and
    2.5 give float32; float16 and 2.0 give float16)."""
    return torch.tensor(v, device=like.device)


def _dims(axis, ndim):
    """A reduction's axes as a tuple (all of them for None)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(axis)
    return (axis,)


def _float(x: torch.Tensor) -> torch.Tensor:
    """Integers and booleans as float32 (jnp's rule for mean, var, ...)."""
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(torch.float32)


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def _device(ctx: Optional[Context]) -> torch.device:
    return (ctx or current_context()).torch_device


def _create(t: torch.Tensor, ctx) -> NDArray:
    return NDArray(t.to(_device(ctx)), ctx=ctx or current_context(),
                   _wrap=True)


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


@_public
def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray from any array-like (``mx.nd.array``), copied."""
    return NDArray(source_array, ctx=ctx, dtype=dtype)


asarray = _public(array, "asarray")


@_public
def zeros(shape, ctx=None, dtype="float32") -> NDArray:
    return _create(torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype)),
                   ctx)


@_public
def ones(shape, ctx=None, dtype="float32") -> NDArray:
    return _create(torch.ones(_shape(shape), dtype=to_torch_dtype(dtype)),
                   ctx)


@_public
def full(shape, val, ctx=None, dtype="float32") -> NDArray:
    return _create(torch.full(_shape(shape), val,
                              dtype=to_torch_dtype(dtype)), ctx)


@_public
def empty(shape, ctx=None, dtype="float32") -> NDArray:
    return zeros(shape, ctx, dtype)


@_public
def arange(start, stop=None, step=1.0, ctx=None, dtype="float32") -> NDArray:
    if stop is None:
        start, stop = 0, start
    return _create(torch.arange(start, stop, step,
                                dtype=to_torch_dtype(dtype)), ctx)


def _linspace(start, stop, num, endpoint, dtype, device=None):
    """``jnp.linspace``'s arithmetic: ``start * (1 - s) + stop * s`` in
    float32 with ``s = i / div``, then the exact endpoint."""
    f32 = dict(dtype=torch.float32, device=device)
    lo, hi = torch.tensor(start, **f32), torch.tensor(stop, **f32)
    div = num - 1 if endpoint else num
    if num > 1:
        step = torch.arange(div, **f32) / torch.tensor(div, **f32)
        out = lo * (1 - step) + hi * step
        if endpoint:
            out = torch.cat([out, hi[None]])
    else:
        out = lo[None][:num]
    if not (dtype.is_floating_point or dtype.is_complex):
        out = torch.floor(out)
    return out.to(dtype)


@_public
def linspace(start, stop, num=50, endpoint=True, ctx=None, dtype="float32"):
    return _create(_linspace(start, stop, num, endpoint,
                             to_torch_dtype(dtype)), ctx)


@_public
def eye(N, M=None, k=0, ctx=None, dtype="float32") -> NDArray:
    M = N if M is None else M
    t = torch.ones(N, M, dtype=to_torch_dtype(dtype)).triu(k).tril(k)
    return _create(t, ctx)


@_public
def zeros_like(a: NDArray, dtype=None) -> NDArray:
    dt = to_torch_dtype(dtype)
    return invoke("zeros_like", lambda x: torch.zeros_like(x, dtype=dt),
                  (_as_nd(a),))


@_public
def ones_like(a: NDArray, dtype=None) -> NDArray:
    dt = to_torch_dtype(dtype)
    return invoke("ones_like", lambda x: torch.ones_like(x, dtype=dt),
                  (_as_nd(a),))


@_public
def full_like(a: NDArray, fill_value, dtype=None) -> NDArray:
    dt, v = to_torch_dtype(dtype), fill_value
    return invoke("full_like", lambda x: torch.full_like(x, v, dtype=dt),
                  (_as_nd(a),))


# ---------------------------------------------------------------------------
# Elementwise unary
# ---------------------------------------------------------------------------

def _cbrt(x):
    x = _float(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY_TABLE = {
    "negative": torch.neg, "abs": torch.abs, "absolute": torch.abs,
    "sign": torch.sign, "rint": torch.round, "floor": torch.floor,
    "ceil": torch.ceil, "trunc": torch.trunc, "fix": torch.trunc,
    "square": torch.square, "sqrt": torch.sqrt, "cbrt": _cbrt,
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": lambda x: torch.rad2deg(_float(x)),
    "radians": lambda x: torch.deg2rad(_float(x)),
    "reciprocal": torch.reciprocal,
    "logical_not": torch.logical_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "erf": lambda x: torch.special.erf(_float(x)),
    "erfinv": lambda x: torch.special.erfinv(_float(x)),
    "gamma": lambda x: torch.exp(torch.special.gammaln(_float(x))),
    "gammaln": lambda x: torch.special.gammaln(_float(x)),
    "sigmoid": lambda x: torch.sigmoid(_float(x)),
    "relu": torch.relu,
    "softsign": lambda x: F.softsign(_float(x)),
}


def _make_unary(name, impl):
    def op(a, **kw):
        return invoke(name, impl, (_as_nd(a),))
    op.__name__ = name
    op.__doc__ = f"Elementwise ``{name}``."
    return _public(op, name)


for _n, _f in _UNARY_TABLE.items():
    globals()[_n] = _make_unary(_n, _f)

rsqrt = _public(lambda a: invoke("rsqrt", lambda x: torch.rsqrt(_float(x)),
                                 (_as_nd(a),)), "rsqrt")
rcbrt = _public(lambda a: invoke("rcbrt", lambda x: 1.0 / _cbrt(x),
                                 (_as_nd(a),)), "rcbrt")


@_public
def round(a, decimals=0):  # noqa: A001
    d = decimals
    return invoke("round", lambda x: torch.round(x, decimals=d)
                  if x.is_floating_point() else x.clone(), (_as_nd(a),))


# ---------------------------------------------------------------------------
# Elementwise binary, broadcasting (a python scalar operand is bound into
# the op as a 0-d tensor)
# ---------------------------------------------------------------------------

def _true_divide(x, y):
    return torch.true_divide(x, y)


_BINARY_TABLE = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": _true_divide, "true_divide": _true_divide,
    "floor_divide": torch.floor_divide, "mod": torch.remainder,
    "fmod": torch.fmod, "remainder": torch.remainder,
    "power": torch.pow, "maximum": torch.maximum, "minimum": torch.minimum,
    "fmax": torch.fmax, "fmin": torch.fmin,
    "hypot": lambda x, y: torch.hypot(_float(x), _float(y)),
    "arctan2": lambda x, y: torch.atan2(_float(x), _float(y)),
    "logaddexp": lambda x, y: torch.logaddexp(_float(x), _float(y)),
    "copysign": lambda x, y: torch.copysign(_float(x), y),
    "equal": torch.eq, "not_equal": torch.ne,
    "less": torch.lt, "less_equal": torch.le,
    "greater": torch.gt, "greater_equal": torch.ge,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}


def _make_binary(name, impl):
    def op(lhs, rhs, **kw):
        l_nd, r_nd = isinstance(lhs, NDArray), isinstance(rhs, NDArray)
        if l_nd and r_nd:
            return invoke(name, impl, (lhs, rhs))
        if l_nd:
            s = rhs
            return invoke(name, lambda a: impl(a, _scalar(s, a)), (lhs,))
        if r_nd:
            s = lhs
            return invoke(name, lambda b: impl(_scalar(s, b), b), (rhs,))
        t = impl(torch.tensor(lhs), torch.tensor(rhs))
        return NDArray(t, ctx=current_context())
    op.__name__ = name
    op.__doc__ = f"Broadcasting ``{name}``."
    return _public(op, name)


for _n, _f in _BINARY_TABLE.items():
    globals()[_n] = _make_binary(_n, _f)


@_public
def clip(a, a_min=None, a_max=None):
    lo, hi = a_min, a_max

    def impl(x):
        if lo is not None:
            x = torch.maximum(x, _scalar(lo, x))
        if hi is not None:
            x = torch.minimum(x, _scalar(hi, x))
        return x
    return invoke("clip", impl, (_as_nd(a),))


@_public
def where(condition, x=None, y=None):
    if x is None and y is None:
        return invoke("where_idx", lambda c: torch.where(c),
                      (_as_nd(condition),))
    c = _as_nd(condition)
    return invoke("where", lambda cc, a, b: torch.where(cc.bool(), a, b),
                  (c, _as_nd(x), _as_nd(y)))


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------

def _sum(x, axis, keepdims, dtype):
    return torch.sum(x, dim=_dims(axis, x.ndim), keepdim=keepdims,
                     dtype=to_torch_dtype(dtype))


def _mean(x, axis, keepdims, dtype):
    dt = to_torch_dtype(dtype)
    return torch.mean(_float(x), dim=_dims(axis, x.ndim), keepdim=keepdims,
                      dtype=dt)


def _prod(x, axis, keepdims, dtype):
    dt = to_torch_dtype(dtype)
    if x.ndim == 0:
        return torch.prod(x, dtype=dt)
    # torch reduces one axis at a time: the highest first, so the lower
    # axes keep their numbers
    for d in sorted({d % x.ndim for d in _dims(axis, x.ndim)}, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdims, dtype=dt)
    return x


def _amax(x, axis, keepdims):
    return torch.amax(x, dim=_dims(axis, x.ndim), keepdim=keepdims)


def _amin(x, axis, keepdims):
    return torch.amin(x, dim=_dims(axis, x.ndim), keepdim=keepdims)


def _all(x, axis, keepdims):
    return torch.all(x, dim=_dims(axis, x.ndim), keepdim=keepdims)


def _any(x, axis, keepdims):
    return torch.any(x, dim=_dims(axis, x.ndim), keepdim=keepdims)


def _make_reduce(name, impl, has_dtype=True):
    def op(a, axis=None, keepdims=False, dtype=None, **kw):
        ax, kd, dt = axis, keepdims, dtype
        if has_dtype:
            fn = lambda x: impl(x, ax, kd, dt)  # noqa: E731
        else:
            fn = lambda x: impl(x, ax, kd)  # noqa: E731
        return invoke(name, fn, (_as_nd(a),))
    op.__name__ = name
    op.__doc__ = f"Reduction ``{name}`` over axes."
    return _public(op, name)


sum = _make_reduce("sum", _sum)  # noqa: A001
mean = _make_reduce("mean", _mean)
prod = _make_reduce("prod", _prod)
max = _make_reduce("max", _amax, has_dtype=False)  # noqa: A001
min = _make_reduce("min", _amin, has_dtype=False)  # noqa: A001
amax, amin = max, min
_public(max, "amax")
_public(min, "amin")
all = _make_reduce("all", _all, has_dtype=False)  # noqa: A001
any = _make_reduce("any", _any, has_dtype=False)  # noqa: A001


@_public
def var(a, axis=None, ddof=0, keepdims=False, dtype=None):
    ax, kd, dd = axis, keepdims, ddof
    return invoke("var", lambda x: torch.var(
        _float(x), dim=_dims(ax, x.ndim), correction=dd, keepdim=kd),
        (_as_nd(a),))


@_public
def std(a, axis=None, ddof=0, keepdims=False, dtype=None):
    ax, kd, dd = axis, keepdims, ddof
    return invoke("std", lambda x: torch.std(
        _float(x), dim=_dims(ax, x.ndim), correction=dd, keepdim=kd),
        (_as_nd(a),))


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


@_public
def argmax(a, axis=None, keepdims=False):
    ax, kd = axis, keepdims
    return invoke("argmax", lambda x: _arg(torch.argmax, x, ax, kd),
                  (_as_nd(a),))


@_public
def argmin(a, axis=None, keepdims=False):
    ax, kd = axis, keepdims
    return invoke("argmin", lambda x: _arg(torch.argmin, x, ax, kd),
                  (_as_nd(a),))


@_public
def norm(a, ord=None, axis=None, keepdims=False):  # noqa: A002
    o, ax, kd = ord, axis, keepdims

    def impl(x):
        x = _float(x)
        if ax is None and x.ndim > 2:
            flat = torch.linalg.norm(x.reshape(-1), ord=o)
            return flat.reshape((1,) * x.ndim) if kd else flat
        dim = tuple(ax) if isinstance(ax, list) else ax
        return torch.linalg.norm(x, ord=o, dim=dim, keepdim=kd)
    return invoke("norm", impl, (_as_nd(a),))


def _scan(fn, x, axis, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return fn(x, dim=axis, dtype=to_torch_dtype(dtype))


@_public
def cumsum(a, axis=None, dtype=None):
    ax, dt = axis, dtype
    return invoke("cumsum", lambda x: _scan(torch.cumsum, x, ax, dt),
                  (_as_nd(a),))


@_public
def cumprod(a, axis=None):
    ax = axis
    return invoke("cumprod", lambda x: _scan(torch.cumprod, x, ax),
                  (_as_nd(a),))


@_public
def logsumexp(a, axis=None, keepdims=False):
    ax, kd = axis, keepdims
    return invoke("logsumexp", lambda x: torch.logsumexp(
        _float(x), dim=_dims(ax, x.ndim), keepdim=kd), (_as_nd(a),))


# ---------------------------------------------------------------------------
# Shape and layout
# ---------------------------------------------------------------------------

@_public
def reshape(a, newshape, order="C"):
    shp = tuple(newshape) if not isinstance(newshape, int) else (newshape,)
    return invoke("reshape", lambda x: torch.reshape(x, shp), (_as_nd(a),))


@_public
def transpose(a, axes=None):
    ax = tuple(axes) if axes else None
    return invoke("transpose", lambda x: x.permute(
        ax if ax is not None else tuple(range(x.ndim))[::-1]), (_as_nd(a),))


@_public
def swapaxes(a, axis1, axis2):
    a1, a2 = axis1, axis2
    return invoke("swapaxes", lambda x: torch.swapaxes(x, a1, a2),
                  (_as_nd(a),))


@_public
def moveaxis(a, source, destination):
    s, d = source, destination
    return invoke("moveaxis", lambda x: torch.movedim(x, s, d), (_as_nd(a),))


@_public
def expand_dims(a, axis):
    ax = axis

    def impl(x):
        axes = (ax,) if isinstance(ax, int) else tuple(ax)
        n = x.ndim + len(axes)
        for d in sorted(d % n for d in axes):
            x = x.unsqueeze(d)
        return x
    return invoke("expand_dims", impl, (_as_nd(a),))


@_public
def squeeze(a, axis=None):
    ax = axis
    return invoke("squeeze", lambda x: torch.squeeze(x) if ax is None
                  else torch.squeeze(x, ax), (_as_nd(a),))


@_public
def broadcast_to(a, shape):
    shp = tuple(shape)
    return invoke("broadcast_to", lambda x: torch.broadcast_to(x, shp),
                  (_as_nd(a),))


@_public
def ravel(a):
    return reshape(a, (-1,))


@_public
def flatten(a):
    """Collapse all but the first axis (legacy ``Flatten``)."""
    nd = _as_nd(a)
    return reshape(nd, (nd.shape[0], -1))


@_public
def concatenate(seq, axis=0):
    ax = axis
    arrs = [_as_nd(s) for s in seq]
    return invoke("concatenate", lambda *xs: torch.cat(
        [x.reshape(-1) for x in xs] if ax is None else xs,
        dim=0 if ax is None else ax), arrs)


@_public
def concat(*data, dim=0, axis=None):
    """Legacy ``concat`` (``dim``); also takes one list."""
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        data = tuple(data[0])
    return concatenate(data, axis=dim if axis is None else axis)


@_public
def stack(seq, axis=0):
    ax = axis
    arrs = [_as_nd(s) for s in seq]
    return invoke("stack", lambda *xs: torch.stack(xs, dim=ax), arrs)


def _sections(i):
    return list(i) if isinstance(i, (list, tuple)) else i


@_public
def split(a, indices_or_sections, axis=0):
    i, ax = _sections(indices_or_sections), axis
    return invoke("split", lambda x: tuple(torch.tensor_split(x, i, dim=ax)),
                  (_as_nd(a),))


@_public
def slice_channel(data, num_outputs, axis=1, squeeze_axis=False):
    """Split along ``axis`` into ``num_outputs`` equal parts
    (``SliceChannel``)."""
    n, ax, sq = num_outputs, axis, squeeze_axis

    def impl(x):
        parts = torch.tensor_split(x, n, dim=ax)
        if sq:
            parts = [torch.squeeze(p, ax) for p in parts]
        return tuple(parts)
    return invoke("slice_channel", impl, (_as_nd(data),))


@_public
def array_split(a, indices_or_sections, axis=0):
    i, ax = _sections(indices_or_sections), axis
    return invoke("array_split",
                  lambda x: tuple(torch.tensor_split(x, i, dim=ax)),
                  (_as_nd(a),))


@_public
def tile(a, reps):
    r = (reps,) if isinstance(reps, int) else tuple(reps)
    return invoke("tile", lambda x: torch.tile(x, r), (_as_nd(a),))


@_public
def repeat(a, repeats, axis=None):
    r, ax = repeats, axis

    def impl(x):
        rr = r if isinstance(r, int) else torch.as_tensor(r, device=x.device)
        return torch.repeat_interleave(x, rr, dim=ax)
    return invoke("repeat", impl, (_as_nd(a),))


@_public
def flip(a, axis=None):
    ax = axis
    return invoke("flip", lambda x: torch.flip(x, _dims(ax, x.ndim)),
                  (_as_nd(a),))


@_public
def roll(a, shift, axis=None):
    s, ax = shift, axis
    return invoke("roll", lambda x: torch.roll(x, s, ax), (_as_nd(a),))


def _pad_pairs(pw, ndim):
    pw = _np.broadcast_to(_np.asarray(pw, dtype=_np.int64).reshape(-1, 2)
                          if _np.ndim(pw) else _np.full((1, 2), pw), (ndim, 2))
    return [(int(lo), int(hi)) for lo, hi in pw]


@_public
def pad(a, pad_width, mode="constant", constant_values=0):
    pw, m, cv = pad_width, mode, constant_values

    def impl(x):
        pairs = _pad_pairs(pw, x.ndim)
        if m == "constant":
            flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
            return F.pad(x, flat, value=cv)
        # every other mode is a gather: numpy's pad of the positions
        for d, (lo, hi) in enumerate(pairs):
            idx = _np.pad(_np.arange(x.shape[d]), (lo, hi), mode=m)
            x = x.index_select(d, torch.as_tensor(idx, device=x.device))
        return x
    return invoke("pad", impl, (_as_nd(a),))


@_public
def slice_axis(a, axis, begin, end):
    ax, b, e = axis, begin, end

    def impl(x):
        idx = [builtins.slice(None)] * x.ndim
        idx[ax] = builtins.slice(b, e)
        return x[tuple(idx)]
    return invoke("slice_axis", impl, (_as_nd(a),))


@_public
def slice_like(a, b, axes=None):
    axs = axes
    bshape = _as_nd(b).shape

    def impl(x):
        idx = [builtins.slice(None)] * x.ndim
        for ax in (axs if axs is not None else range(x.ndim)):
            idx[ax] = builtins.slice(0, bshape[ax])
        return x[tuple(idx)]
    return invoke("slice_like", impl, (_as_nd(a),))


@_public
def atleast_1d(a):
    return invoke("atleast_1d", torch.atleast_1d, (_as_nd(a),))


@_public
def atleast_2d(a):
    return invoke("atleast_2d", torch.atleast_2d, (_as_nd(a),))


@_public
def tril(a, k=0):
    kk = k
    return invoke("tril", lambda x: torch.tril(x, kk), (_as_nd(a),))


@_public
def triu(a, k=0):
    kk = k
    return invoke("triu", lambda x: torch.triu(x, kk), (_as_nd(a),))


@_public
def diag(a, k=0):
    kk = k
    return invoke("diag", lambda x: torch.diag(x, kk), (_as_nd(a),))


# ---------------------------------------------------------------------------
# Indexing, gather and scatter
# ---------------------------------------------------------------------------

def _take(x, i, axis, mode):
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.ndim
    n = x.shape[axis]
    i = i.long()
    if mode == "wrap":
        i = torch.remainder(i, n)
    else:                      # 'clip', and 'raise' as the JAX package does
        i = i.clamp(0, n - 1)
    out = x.index_select(axis, i.reshape(-1))
    return out.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])


@_public
def take(a, indices, axis=None, mode="clip"):
    ax, md = axis, mode
    return invoke("take", lambda x, i: _take(x, i, ax, md),
                  (_as_nd(a), _as_nd(indices)))


@_public
def take_along_axis(a, indices, axis):
    ax = axis
    return invoke("take_along_axis",
                  lambda x, i: torch.take_along_dim(x, i.long(), dim=ax),
                  (_as_nd(a), _as_nd(indices)))


@_public
def gather_nd(data, indices):
    """Gather with a leading index tensor."""
    def impl(x, i):
        i = i.long()
        return x[tuple(i[k] for k in range(i.shape[0]))]
    return invoke("gather_nd", impl, (_as_nd(data), _as_nd(indices)))


@_public
def scatter_nd(data, indices, shape):
    shp = tuple(shape)

    def impl(d, i):
        i = i.long()
        idx = tuple(i[k] for k in range(i.shape[0]))
        return torch.zeros(shp, dtype=d.dtype, device=d.device).index_put(
            idx, d, accumulate=True)
    return invoke("scatter_nd", impl, (_as_nd(data), _as_nd(indices)))


@_public
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    d, on, off, dt = depth, on_value, off_value, to_torch_dtype(dtype)

    def impl(i):
        hot = (i.long()[..., None] == torch.arange(d, device=i.device)).to(dt)
        return hot * (on - off) + off
    return invoke("one_hot", impl, (_as_nd(indices),))


def _from_host(res, like: NDArray):
    return NDArray(res, ctx=like.context)


@_public
def unique(a, return_index=False, return_inverse=False, return_counts=False):
    nd = _as_nd(a)
    res = _np.unique(nd.asnumpy(), return_index=return_index,
                     return_inverse=return_inverse, return_counts=return_counts)
    if isinstance(res, tuple):
        return tuple(_from_host(r, nd) for r in res)
    return _from_host(res, nd)


@_public
def nonzero(a):
    nd = _as_nd(a)
    return tuple(_from_host(r, nd) for r in _np.nonzero(nd.asnumpy()))


@_public
def boolean_mask(data, mask):
    nd, m = _as_nd(data), _as_nd(mask)
    return _from_host(nd.asnumpy()[m.asnumpy().astype(bool)], nd)


# ---------------------------------------------------------------------------
# Ordering (stable sorts: ties keep index order, as jnp's and lax.top_k's)
# ---------------------------------------------------------------------------

@_public
def sort(a, axis=-1, is_ascend=True):
    ax, asc = axis, is_ascend

    def impl(x):
        s = torch.sort(x, dim=ax, stable=True).values
        return s if asc else torch.flip(s, (ax,))
    return invoke("sort", impl, (_as_nd(a),))


@_public
def argsort(a, axis=-1, is_ascend=True, dtype="float32"):
    ax, asc, dt = axis, is_ascend, to_torch_dtype(dtype)

    def impl(x):
        s = torch.argsort(x, dim=ax, stable=True)
        if not asc:
            s = torch.flip(s, (ax,))
        return s.to(dt)
    return invoke("argsort", impl, (_as_nd(a),))


@_public
def topk(a, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
    ax, kk, rt, asc, dt = axis, k, ret_typ, is_ascend, to_torch_dtype(dtype)

    def impl(x):
        xm = torch.movedim(x, ax, -1)
        s = torch.sort(xm, dim=-1, descending=not asc, stable=True)
        vals = torch.movedim(s.values[..., :kk], -1, ax)
        idx = torch.movedim(s.indices[..., :kk], -1, ax)
        if rt == "value":
            return vals
        if rt == "indices":
            return idx.to(dt)
        return (vals, idx.to(dt))
    return invoke("topk", impl, (_as_nd(a),))


@_public
def searchsorted(a, v, side="left"):
    right = side == "right"
    return invoke("searchsorted",
                  lambda x, q: torch.searchsorted(x, q, right=right),
                  (_as_nd(a), _as_nd(v)))


# ---------------------------------------------------------------------------
# Linear algebra
# ---------------------------------------------------------------------------

def _promote(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@_public
def dot(a, b):
    """MXNet ``dot``: the last axis of a with the first axis of b."""
    def impl(x, y):
        x, y = _promote(x, y)
        if x.ndim == 1 and y.ndim == 1:
            return torch.dot(x, y)
        return torch.tensordot(x, y, dims=([x.ndim - 1], [0]))
    return invoke("dot", impl, (_as_nd(a), _as_nd(b)))


@_public
def matmul(a, b):
    return invoke("matmul", lambda x, y: torch.matmul(*_promote(x, y)),
                  (_as_nd(a), _as_nd(b)))


@_public
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    ta, tb = transpose_a, transpose_b

    def impl(x, y):
        if ta:
            x = torch.swapaxes(x, -1, -2)
        if tb:
            y = torch.swapaxes(y, -1, -2)
        return torch.matmul(*_promote(x, y))
    return invoke("batch_dot", impl, (_as_nd(a), _as_nd(b)))


@_public
def tensordot(a, b, axes=2):
    ax = axes
    return invoke("tensordot",
                  lambda x, y: torch.tensordot(*_promote(x, y), dims=ax),
                  (_as_nd(a), _as_nd(b)))


@_public
def einsum(subscripts, *operands, optimize=True):
    sub = subscripts
    arrs = [_as_nd(o) for o in operands]
    return invoke("einsum", lambda *xs: torch.einsum(sub, *xs), arrs)


@_public
def inner(a, b):
    return invoke("inner", lambda x, y: torch.inner(*_promote(x, y)),
                  (_as_nd(a), _as_nd(b)))


@_public
def outer(a, b):
    return invoke("outer", lambda x, y: torch.outer(
        *_promote(x.reshape(-1), y.reshape(-1))), (_as_nd(a), _as_nd(b)))


@_public
def kron(a, b):
    return invoke("kron", lambda x, y: torch.kron(*_promote(x, y)),
                  (_as_nd(a), _as_nd(b)))


@_public
def vdot(a, b):
    return invoke("vdot", lambda x, y: torch.vdot(
        *_promote(x.reshape(-1), y.reshape(-1))), (_as_nd(a), _as_nd(b)))


@_public
def trace(a, offset=0, axis1=0, axis2=1):
    o, a1, a2 = offset, axis1, axis2
    return invoke("trace", lambda x: torch.diagonal(x, o, a1, a2).sum(-1),
                  (_as_nd(a),))


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

@_public
def cast(a, dtype):
    dt = to_torch_dtype(dtype)
    return invoke("cast", lambda x: x.to(dt), (_as_nd(a),))


astype = _public(cast, "astype")


@_public
def identity(a):
    return invoke("identity", lambda x: x + 0, (_as_nd(a),))


@_public
def stop_gradient(a):
    return invoke("stop_gradient", lambda x: x.detach(), (_as_nd(a),))


BlockGrad = _public(stop_gradient, "BlockGrad")


@_public
def add_n(*args):
    """Sum of a list of arrays (``ElementwiseSum``), added left to right."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    arrs = [_as_nd(a) for a in args]
    return invoke("add_n", lambda *xs: functools.reduce(torch.add, xs), arrs)


ElementWiseSum = _public(add_n, "ElementWiseSum")


@_public
def maximum_n(*args):
    arrs = [_as_nd(a) for a in args]
    return invoke("maximum_n",
                  lambda *xs: functools.reduce(torch.maximum, xs), arrs)


@_public
def isclose(a, b, rtol=1e-5, atol=1e-8):
    rt, at = rtol, atol
    return invoke("isclose", lambda x, y: torch.isclose(
        *_promote(x, y), rtol=rt, atol=at), (_as_nd(a), _as_nd(b)))


@_public
def nan_to_num(a, nan=0.0, posinf=None, neginf=None):
    n, p, ng = nan, posinf, neginf
    return invoke("nan_to_num", lambda x: torch.nan_to_num(
        x, nan=n, posinf=p, neginf=ng), (_as_nd(a),))


@_public
def diff(a, n=1, axis=-1):
    nn, ax = n, axis
    return invoke("diff", lambda x: torch.diff(x, n=nn, dim=ax), (_as_nd(a),))


@_public
def meshgrid(*xs, indexing="xy"):
    arrs = [_as_nd(x) for x in xs]
    outs = torch.meshgrid(*[a._data.detach() for a in arrs], indexing=indexing)
    return tuple(NDArray(o.clone(), ctx=arrs[0].context, _wrap=True)
                 for o in outs)


@_public
def histogram(a, bins=10, range=None):  # noqa: A002
    """Counts and edges, binned as ``jnp.histogram`` bins: by
    ``searchsorted`` on the edges, the last edge inclusive."""
    nd = _as_nd(a)
    x = _float(nd._data.detach()).reshape(-1)
    lo, hi = range if range is not None else (x.min().item(), x.max().item())
    edges = _linspace(lo, hi, bins + 1, True, x.dtype, x.device)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=x.dtype, device=x.device)
    counts = counts.index_add(0, idx, torch.ones_like(x))[1:bins + 1]
    return (NDArray(counts, ctx=nd.context, _wrap=True),
            NDArray(edges, ctx=nd.context, _wrap=True))


def _interp(x, xp, fp):
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(_np.spacing(_np.finfo(dtype_name(xp.dtype)).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


@_public
def interp(x, xp, fp):
    return invoke("interp", _interp, (_as_nd(x), _as_nd(xp), _as_nd(fp)))


@_public
def waitall():
    _waitall()


# ---------------------------------------------------------------------------
# Legacy names and the remaining tensor ops
# ---------------------------------------------------------------------------

_g = globals()
broadcast_add = _public(_g["add"], "broadcast_add")
broadcast_plus = _public(_g["add"], "broadcast_plus")
broadcast_sub = _public(_g["subtract"], "broadcast_sub")
broadcast_minus = _public(_g["subtract"], "broadcast_minus")
broadcast_mul = _public(_g["multiply"], "broadcast_mul")
broadcast_div = _public(_g["divide"], "broadcast_div")
broadcast_mod = _public(_g["mod"], "broadcast_mod")
broadcast_power = _public(_g["power"], "broadcast_power")
broadcast_maximum = _public(_g["maximum"], "broadcast_maximum")
broadcast_minimum = _public(_g["minimum"], "broadcast_minimum")
broadcast_equal = _public(_g["equal"], "broadcast_equal")
broadcast_not_equal = _public(_g["not_equal"], "broadcast_not_equal")
broadcast_greater = _public(_g["greater"], "broadcast_greater")
broadcast_greater_equal = _public(_g["greater_equal"],
                                  "broadcast_greater_equal")
broadcast_lesser = _public(_g["less"], "broadcast_lesser")
broadcast_lesser_equal = _public(_g["less_equal"], "broadcast_lesser_equal")
broadcast_logical_and = _public(_g["logical_and"], "broadcast_logical_and")
broadcast_logical_or = _public(_g["logical_or"], "broadcast_logical_or")
broadcast_logical_xor = _public(_g["logical_xor"], "broadcast_logical_xor")
elemwise_add = _public(_g["add"], "elemwise_add")
elemwise_sub = _public(_g["subtract"], "elemwise_sub")
elemwise_mul = _public(_g["multiply"], "elemwise_mul")
elemwise_div = _public(_g["divide"], "elemwise_div")


@_public
def broadcast_axis(data, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    if len(axes) != len(sizes):
        raise ValueError(f"broadcast_axis: axis {axes} and size {sizes} "
                         "must have the same length")

    def impl(x):
        shape = list(x.shape)
        for ax, s in zip(axes, sizes):
            shape[ax] = s
        return torch.broadcast_to(x, shape)
    return invoke("broadcast_axis", impl, (_as_nd(data),))


broadcast_axes = _public(_g["broadcast_axis"], "broadcast_axes")


@_public
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    l, r = _as_nd(lhs), _as_nd(rhs)
    if lhs_axes is None:
        return invoke("broadcast_like",
                      lambda a, b: torch.broadcast_to(a, b.shape), (l, r))
    if rhs_axes is None or len(tuple(lhs_axes)) != len(tuple(rhs_axes)):
        raise ValueError("broadcast_like: lhs_axes and rhs_axes must be "
                         "given together with equal length")
    l_axes, r_axes = tuple(lhs_axes), tuple(rhs_axes)

    def impl(a, b):
        shape = list(a.shape)
        for la, ra in zip(l_axes, r_axes):
            shape[la] = b.shape[ra]
        return torch.broadcast_to(a, shape)
    return invoke("broadcast_like", impl, (l, r))


@_public
def reshape_like(lhs, rhs):
    return invoke("reshape_like", lambda a, b: torch.reshape(a, b.shape),
                  (_as_nd(lhs), _as_nd(rhs)))


@_public
def reverse(data, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return invoke("reverse", lambda x: torch.flip(x, axes), (_as_nd(data),))


@_public
def slice(data, begin, end, step=None):  # noqa: A001
    b, e = tuple(begin), tuple(end)
    st = tuple(step) if step is not None else (1,) * len(b)
    if len(b) != len(e) or len(st) != len(b):
        raise ValueError(f"slice: begin {b}, end {e}, step {st} must have "
                         "equal lengths")
    if 0 in st:
        raise ValueError("slice: step cannot be 0")
    sl = tuple(builtins.slice(bb, ee, ss) for bb, ee, ss in zip(b, e, st))
    return invoke("slice", lambda x: _getitem(x, sl), (_as_nd(data),))


@_public
def softmin(data, axis=-1):
    return invoke("softmin", lambda x: torch.softmax(
        -x.to(torch.float32), dim=axis).to(x.dtype), (_as_nd(data),))


@_public
def moments(data, axes=None, keepdims=False):
    ax = tuple(axes) if axes is not None else None

    def impl(x):
        dims = _dims(ax, x.ndim)
        m = torch.mean(_float(x), dim=dims, keepdim=keepdims)
        v = torch.var(_float(x), dim=dims, correction=0, keepdim=keepdims)
        return m, v
    return invoke("moments", impl, (_as_nd(data),))


@_public
def shape_array(data):
    nd = _as_nd(data)
    return NDArray(torch.tensor(nd.shape, dtype=torch.int32), ctx=nd.context)


@_public
def size_array(data):
    nd = _as_nd(data)
    return NDArray(torch.tensor([nd.size], dtype=torch.int32), ctx=nd.context)


@_public
def batch_take(a, indices):
    return invoke("batch_take", lambda x, idx: torch.take_along_dim(
        x, idx[:, None].long(), dim=1)[:, 0], (_as_nd(a), _as_nd(indices)))


def _lin(lo, hi, n, like):
    return _linspace(lo, hi, n, True, torch.float32, like.device)


@_public
def grid_generator(data, transform_type="affine", target_shape=None):
    """Sampling grids for spatial transformers: ``'affine'`` from (N, 6)
    parameters, ``'warp'`` from (N, 2, H, W) pixel offsets; (N, 2, H, W)
    x/y in [-1, 1]."""
    th, tw = (target_shape if transform_type == "affine"
              else _as_nd(data).shape[2:])

    def impl(d):
        if transform_type == "affine":
            n = d.shape[0]
            gy, gx = torch.meshgrid(_lin(-1.0, 1.0, th, d),
                                    _lin(-1.0, 1.0, tw, d), indexing="ij")
            base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                                torch.ones_like(gx).reshape(-1)])
            theta = d.reshape(n, 2, 3).to(torch.float32)
            return torch.einsum("nij,jk->nik", theta, base).reshape(
                n, 2, th, tw)
        n, _, h, w = d.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=d.device),
            torch.arange(w, dtype=torch.float32, device=d.device),
            indexing="ij")
        fx = (gx + d[:, 0].to(torch.float32)) * 2.0 / builtins.max(w - 1, 1) \
            - 1.0
        fy = (gy + d[:, 1].to(torch.float32)) * 2.0 / builtins.max(h - 1, 1) \
            - 1.0
        return torch.stack([fx, fy], dim=1)
    return invoke("grid_generator", impl, (_as_nd(data),))


@_public
def bilinear_sampler(data, grid, cudnn_off=None):
    """Bilinear sampling of (N, C, H, W) ``data`` at ``grid`` (N, 2, Ho,
    Wo), x/y in [-1, 1]; samples outside the image read zero."""
    def impl(x, g):
        n, c, h, w = x.shape
        gx = (g[:, 0].to(torch.float32) + 1.0) * (w - 1) / 2.0
        gy = (g[:, 1].to(torch.float32) + 1.0) * (h - 1) / 2.0
        x0, y0 = torch.floor(gx), torch.floor(gy)
        wx, wy = gx - x0, gy - y0
        batch = torch.arange(n, device=x.device)[:, None, None]

        def gather(yy, xx):
            yi = torch.clamp(yy, 0, h - 1).long()
            xi = torch.clamp(xx, 0, w - 1).long()
            valid = ((yy >= 0) & (yy <= h - 1) &
                     (xx >= 0) & (xx <= w - 1)).to(torch.float32)
            return x[batch, :, yi, xi].permute(0, 3, 1, 2), valid

        v00, m00 = gather(y0, x0)
        v01, m01 = gather(y0, x0 + 1)
        v10, m10 = gather(y0 + 1, x0)
        v11, m11 = gather(y0 + 1, x0 + 1)
        w00 = ((1 - wy) * (1 - wx) * m00)[:, None]
        w01 = ((1 - wy) * wx * m01)[:, None]
        w10 = (wy * (1 - wx) * m10)[:, None]
        w11 = (wy * wx * m11)[:, None]
        out = (v00.to(torch.float32) * w00 + v01.to(torch.float32) * w01 +
               v10.to(torch.float32) * w10 + v11.to(torch.float32) * w11)
        return out.to(x.dtype)
    return invoke("bilinear_sampler", impl, (_as_nd(data), _as_nd(grid)))


@_public
def depth_to_space(data, block_size: int):
    """Depth blocks into spatial blocks, NCHW, DCR layout (reshape
    (N, b, b, C/b², H, W), transpose, (N, C/b², H·b, W·b))."""
    b = int(block_size)

    def impl(x):
        n, c, h, w = x.shape
        t = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return t.reshape(n, c // (b * b), h * b, w * b)

    nd = _as_nd(data)
    if b <= 0 or nd.ndim != 4 or nd.shape[1] % (b * b):
        raise ValueError(
            f"depth_to_space: need NCHW with C divisible by block² and "
            f"a positive block (got shape {nd.shape}, block {b})")
    return invoke("depth_to_space", impl, (nd,))


@_public
def space_to_depth(data, block_size: int):
    """Inverse of :func:`depth_to_space`."""
    b = int(block_size)

    def impl(x):
        n, c, h, w = x.shape
        t = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return t.reshape(n, c * b * b, h // b, w // b)

    nd = _as_nd(data)
    if b <= 0 or nd.ndim != 4 or nd.shape[2] % b or nd.shape[3] % b:
        raise ValueError(
            f"space_to_depth: need NCHW with H, W divisible by block "
            f"and a positive block (got shape {nd.shape}, block {b})")
    return invoke("space_to_depth", impl, (nd,))


@_public
def shuffle(data):
    """A random permutation along the first axis, drawn from the
    framework generator of the array's device (``mxnet_tpu_torch.random``,
    never torch's global one)."""
    from ..random import generator

    def impl(x):
        perm = torch.randperm(x.shape[0], generator=generator(x.device),
                              device=x.device)
        return x[perm]
    return invoke("shuffle", impl, (_as_nd(data),))


@_public
def spatial_transformer(data, loc, target_shape=None,
                        transform_type: str = "affine",
                        sampler_type: str = "bilinear"):
    """Affine grid from ``loc`` (N, 6), then bilinear sampling of
    ``data``."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise ValueError("spatial_transformer supports transform_type="
                         "'affine' with sampler_type='bilinear'")
    if target_shape is None:
        target_shape = _as_nd(data).shape[2:]
    grid = grid_generator(loc, "affine", tuple(target_shape))
    return bilinear_sampler(data, grid)


@_public
def khatri_rao(*matrices):
    """Column-wise Kronecker product of (r_i, k) matrices:
    ((Π r_i), k)."""
    if not matrices:
        raise ValueError("khatri_rao needs at least one matrix")
    nds = tuple(_as_nd(m) for m in matrices)
    if builtins.any(m.ndim != 2 for m in nds) or \
            len({m.shape[-1] for m in nds}) != 1:
        raise ValueError(
            "khatri_rao needs 2-D matrices with a COMMON column count; "
            f"got shapes {[m.shape for m in nds]}")

    def impl(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
        return out
    return invoke("khatri_rao", impl, nds)
