"""BatchNorm's training forward and backward: the Hopper kernels, their
plain versions, autograd.

Counterpart of ``mxnet_tpu/ops/nn.py``: :class:`_BatchNormTrain` is
``_bn_train_core`` with its custom VJP (``_bn_train_math``,
``_bn_train_fwd``, ``_bn_train_bwd``) and :class:`_BatchStats` is
``_bn_batch_stats``, the fused junction's statistics. The JAX package
leaves this math to XLA; here ``csrc/batch_norm.cu`` computes it in four
kernels, built and loaded by :mod:`mxnet_tpu_torch._kernels`, over x viewed
as (outer, C, inner) for any channel axis, per channel and over its
N = outer * inner elements:

- ``bn_stats``: the f32 sums of ``x - s`` and ``(x - s)^2`` about a shift
  ``s``; shifted statistics ``mean = E[x - s] + s``, ``var = max(E[(x -
  s)^2] - E[x - s]^2, 0)``, or, about the mean of a first sweep, centered
  ``var = E[(x - mean)^2]``; and ``inv = 1 / sqrt(var + eps)``;
- ``bn_apply``: ``out = ((x - mean) * inv) * g + b`` in x's dtype;
- ``bn_bwd_reduce``: ``dg = sum(dy * xhat)`` and ``db = sum(dy)`` in f32,
  with ``xhat = (x - mean) * inv`` recomputed;
- ``bn_bwd_apply``: ``dx = (g * inv) * ((dy - db/N) - xhat * dg/N) +
  dmean/N + dvar * (2/N) * (x - mean)`` in x's dtype, each term only when
  its operand is given (``_BatchStats`` has no dy).

The forward saves x in its own dtype and three per-channel vectors (g,
mean, inv), as ``_bn_train_fwd`` does: no f32 copy of x and no xhat.

Routing: a tensor on the CPU takes the plain versions
(:func:`bn_stats_reference`, :func:`bn_apply_reference`,
:func:`bn_bwd_reduce_reference`, :func:`bn_bwd_apply_reference`); a CUDA
tensor launches the kernels or raises :class:`MXNetError` (f64 among
them). Nothing falls back. Each launch adds one to its kernel's entry in
:data:`launches`. The sums are the same from run to run, to the bit
(:func:`bn_plan` and :func:`bn_reduce_plan` are pure functions of the
shape, the dtype and the alignment, and the kernels add in a fixed order
with no float atomics).

The two reductions are one launch each: channel groups times a
thread-block cluster of up to :data:`MAX_CLUSTER` blocks, whose
per-channel sums meet in distributed shared memory in rank order. Where
such clusters cannot fill the card (few channels, large images),
several clusters a group add theirs through a workspace and an int
counter a (group, rank); the counters are kept a device and stream
(:func:`_second_level`) and each launch leaves them at 0, so no launch
zeroes them (a CUDA graph zeroes its own at each replay).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ...base import MXNetError

__all__ = ["batch_norm_train", "batch_stats", "bn_stats_reference",
           "bn_apply_reference", "bn_bwd_reduce_reference",
           "bn_bwd_apply_reference", "bn_plan", "bn_reduce_plan", "launches",
           "KERNELS"]

KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_apply")
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_FNS = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 256              # csrc/batch_norm.cu bn::T
MAX_SPAN = 2048            # bn::MAX_SPAN: positions a group's span holds
LONG_RUN = 256             # runs at least this long take one channel a block
_TARGET_BLOCKS = 8 * 132   # eight 256-thread blocks on each of 132 SMs
_MAX_SPLITS = 128          # the most splits of the applies' grid
# the reductions' grid (bn_reduce_plan; tools/torch_bn_plans.py sets these)
MAX_CLUSTER = 8            # bn::MAX_CLUSTER: the portable cluster size
MAX_CG = MAX_SPAN // 2     # bn::MAX_CG: channels a group's sums hold
LOADS = 4                  # bn::NB: loads a thread keeps in flight
_REDUCE_BLOCKS = 2 * 132   # the most blocks: two an SM
_REDUCE_BLOCKS_ONE = 4 * 132   # with one channel a group: four an SM
_MIN_REDUCE_BLOCKS = 128   # the fewest, however little each thread loads
_MIN_SPAN_BYTES = 128      # an image's span of a group at the least
_SECOND_BELOW = 132        # fewer blocks than SMs: clusters split the images
_MIN_PASSES = 4            # a second-level block's passes at the least


# ---------------------------------------------------------- plain versions
def _c(v):
    return v.reshape(1, -1, 1)


def bn_stats_reference(x3, shift, eps: float, centered: bool = False):
    """Plain version of ``bn_stats`` over x3 (outer, C, inner): returns f32
    (mean, var, inv). ``shift`` None means 0; ``centered``: ``shift`` is
    the mean of a first sweep, which comes back as the mean."""
    n = x3.shape[0] * x3.shape[2]
    d = x3.float()
    if shift is not None:
        d = d - _c(shift.float())
    s1 = d.sum(dim=(0, 2))
    s2 = (d * d).sum(dim=(0, 2))
    if centered:
        mean, var = shift.float(), s2 / n
    else:
        mc = s1 / n
        var = torch.clamp_min(s2 / n - mc * mc, 0.0)
        mean = mc if shift is None else mc + shift.float()
    return mean, var, 1.0 / torch.sqrt(var + eps)


def bn_apply_reference(x3, mean, inv, g, b):
    """Plain version of ``bn_apply``: ``((x - mean) * inv) * g + b`` in
    f32, rounded to x's dtype once."""
    out = ((x3.float() - _c(mean)) * _c(inv)) * _c(g.float()) + _c(b.float())
    return out.to(x3.dtype)


def bn_bwd_reduce_reference(x3, dy3, mean, inv):
    """Plain version of ``bn_bwd_reduce``: f32 ``(dg, db)``,
    ``dg = sum(dy * xhat)`` and ``db = sum(dy)``."""
    dyf = dy3.float()
    xh = (x3.float() - _c(mean)) * _c(inv)
    return (dyf * xh).sum(dim=(0, 2)), dyf.sum(dim=(0, 2))


def _coefficients(n: int):
    """1/N and 2/N rounded to f32, as the kernel receives them."""
    return (ctypes.c_float(1.0 / n).value, ctypes.c_float(2.0 / n).value)


def bn_bwd_apply_reference(x3, dy3, mean, inv, g, dg, db, dmean=None,
                           dvar=None):
    """Plain version of ``bn_bwd_apply``: dx in x's dtype, every f32
    operation in the kernel's order."""
    n = x3.shape[0] * x3.shape[2]
    inv_n, two_n = _coefficients(n)
    d = x3.float() - _c(mean)
    dx = torch.zeros_like(d)
    if dy3 is not None:
        xh = d * _c(inv)
        a = g.float() * inv
        dx = _c(a) * ((dy3.float() - _c(db * inv_n)) - xh * _c(dg * inv_n))
    if dmean is not None:
        dx = dx + _c(dmean.float() * inv_n)
    if dvar is not None:
        dx = dx + _c(dvar.float() * two_n) * d
    return dx.to(x3.dtype)


# ------------------------------------------------------------------- plan
def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bn_plan(outer: int, C: int, inner: int, dtype, align: int = 16) -> dict:
    """How the four kernels walk x (outer, C, inner): a pure function of the
    shape, the dtype and ``align`` (the largest power of two up to 16
    dividing the operands' addresses), so the order of every sum is too.

    ``vec``: elements an access, 16 bytes where every vector starts
    16-byte aligned, else 8 bytes where every one starts 8-byte aligned,
    else 1. ``one``: runs of at least :data:`LONG_RUN` take a block a
    channel (``cg`` 1), whose threads walk the (image, vector) pairs flat,
    a vector within a run; shorter runs take ``cg`` channels a block, a
    span of ``cg * inner`` contiguous elements an image (a vector may
    cross from one channel's run into the next), up to 256 threads x 4
    elements (x 8 with 16-byte vectors of 16-bit elements; channel rows,
    inner 1, take 32 vectors), held as ``max(1, 4 // vec)`` vectors a
    thread, and ``rows`` images at once where the span has fewer vectors
    than the block has threads.
    ``groups`` channel groups times ``splits`` splits of ``per`` images
    make the grid, about :data:`_TARGET_BLOCKS` blocks, at most
    :data:`_MAX_SPLITS` splits."""
    elem = torch.empty((), dtype=dtype).element_size()
    widths = [v for v in (16 // elem, 8 // elem) if align >= v * elem]
    if inner >= LONG_RUN:
        # a vector holds one channel's elements: runs of whole vectors
        vec = next((v for v in widths if inner % v == 0), 1)
        one, cg, rows = True, 1, 1
    else:
        # a vector may hold two channels' elements (each position keeps
        # its own channel): spans and image strides of whole vectors
        one, vec, cg = False, 1, max(1, min(C, THREADS * 4 // inner))
        for v in widths:
            step = v // math.gcd(inner, v)    # channels a whole vector
            g = min(C, THREADS * v * max(1, 4 // v) // inner) // step * step
            if C * inner % v == 0 and g:
                vec, cg = v, g
                break
        if inner == 1:          # rows of 32 vectors, several rows at once
            cg = min(cg, 32 * vec)
        slots = cg * inner // vec
        rows = 1 if slots >= THREADS else THREADS // slots
    groups = _cdiv(C, cg)
    splits = max(1, min(outer, _MAX_SPLITS, _cdiv(_TARGET_BLOCKS, groups)))
    per = max(_cdiv(outer, splits), min(rows, outer))
    splits = _cdiv(outer, per)
    return dict(one=one, vec=vec, cg=cg, rows=rows, groups=groups,
                splits=splits, per=per, blocks=groups * splits)


def bn_reduce_plan(outer: int, C: int, inner: int, dtype,
                   align: int = 16) -> dict:
    """How the two reductions (``bn_stats``, ``bn_bwd_reduce``) walk x
    (outer, C, inner) and combine their blocks: a pure function of the
    shape, the dtype and ``align``, so the order of every sum is too.

    ``one``, ``vec`` and ``rows`` as :func:`bn_plan`. The grid aims for
    one batch of :data:`LOADS` vectors a thread, between
    :data:`_MIN_REDUCE_BLOCKS` blocks and :data:`_REDUCE_BLOCKS`
    (:data:`_REDUCE_BLOCKS_ONE` with one channel a group). A group of short
    runs takes at most :func:`bn_plan`'s ``cg`` channels, and fewer (by
    whole vectors, an image's span at least :data:`_MIN_SPAN_BYTES`) until
    the groups alone make that grid; then ``cluster`` blocks a group (1,
    2, 4 or 8, no more than its passes: ``rows`` images, or a vector a
    thread) while the grid stays within it. Where that leaves fewer than
    :data:`_SECOND_BELOW` blocks, ``splits`` clusters a group take the
    second level (a workspace and a counter a (group, rank)), each block
    at least :data:`_MIN_PASSES` passes; else ``splits`` is 1. Each block
    takes ``per`` images (a multiple of ``rows``) or ``per`` vectors
    (``one``) of its group in order, the last ones fewer or none.

    Chosen on the card (``tools/torch_bn_plans.py``; PERF.md §6): a
    cluster costs its blocks a barrier and, at 8 blocks, the chance that
    the grid no longer fits one wave, so narrow groups come first."""
    walk = bn_plan(outer, C, inner, dtype, align)
    one, vec, cg = walk["one"], walk["vec"], walk["cg"]
    vectors = outer * C * (inner // vec) if one else outer * C * inner // vec
    want = max(_MIN_REDUCE_BLOCKS,
               min(_REDUCE_BLOCKS_ONE if one else _REDUCE_BLOCKS,
                   _cdiv(vectors, LOADS * THREADS)))
    if one:
        rows = 1
        passes = _cdiv(outer * (inner // vec), THREADS)
    else:
        step = vec // math.gcd(inner, vec)     # channels a whole vector
        elem = torch.empty((), dtype=dtype).element_size()
        least = _cdiv(_cdiv(_MIN_SPAN_BYTES, inner * elem), step) * step
        cg = min(cg, max(least, C // want // step * step))
        slots = cg * inner // vec
        rows = 1 if slots >= THREADS else THREADS // slots
        passes = _cdiv(outer, rows)
    groups = _cdiv(C, cg)
    cluster = 1
    while cluster < MAX_CLUSTER and 2 * groups * cluster <= want and \
            2 * cluster <= passes:
        cluster *= 2
    splits = 1
    if groups * cluster < _SECOND_BELOW:
        splits = max(1, min(want // (groups * cluster),
                            passes // (cluster * _MIN_PASSES)))
    per_passes = _cdiv(passes, cluster * splits)
    splits = _cdiv(passes, cluster * per_passes)
    per = per_passes * (THREADS if one else rows)
    return dict(one=one, vec=vec, cg=cg, rows=rows, groups=groups,
                cluster=cluster, splits=splits, per=per,
                blocks=groups * cluster * splits)


# ------------------------------------------------------------- the kernels
def _kernel(name: str):
    """The ctypes entry of kernel ``name``, its library built on first use."""
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    from ... import _kernels
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _kernels.load("batch_norm")
    walk = [i, i, i, i, i, i, i, i, i, p]           # bn_plan's
    rwalk = [i, i, i, i, i, i, i, i, i, i, p]       # bn_reduce_plan's
    if name == "bn_stats":
        fn = lib.mxt_bn_stats
        fn.argtypes = [i, p, p, i, f, p, p, p, p, p] + rwalk
    elif name == "bn_apply":
        fn = lib.mxt_bn_apply
        fn.argtypes = [i, p, p, p, p, p, p] + walk
    elif name == "bn_bwd_reduce":
        fn = lib.mxt_bn_bwd_reduce
        fn.argtypes = [i, p, p, p, p, p, p, p, p] + rwalk
    else:
        fn = lib.mxt_bn_bwd_apply
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, f, f] + walk
    fn.restype = ctypes.c_int
    _FNS[name] = fn
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, x3, others=(), vecs=()):
    """x3 and ``others`` (dy) contiguous on one CUDA device in one dtype of
    f32 / bf16 / fp16, the same shape; ``vecs`` contiguous f32 (C,) there."""
    ts = [t for t in others if t is not None]
    vs = [v for v in vecs if v is not None]
    if not all(t.is_cuda and t.device == x3.device for t in [x3] + ts + vs):
        raise MXNetError(f"{name}: every operand must lie on one CUDA device")
    if x3.dtype not in _DTYPE_CODE or any(t.dtype != x3.dtype for t in ts):
        raise MXNetError(f"{name}: x and dy must share one dtype of "
                         f"float32/bfloat16/float16; got "
                         f"{[t.dtype for t in [x3] + ts]}")
    if any(v.dtype != torch.float32 for v in vs):
        raise MXNetError(f"{name}: the per-channel operands must be float32")
    if not all(t.is_contiguous() for t in [x3] + ts + vs):
        raise MXNetError(f"{name}: operands must be contiguous")
    if any(tuple(t.shape) != tuple(x3.shape) for t in ts) or \
            any(v.numel() != x3.shape[1] for v in vs) or x3.ndim != 3:
        raise MXNetError(f"{name}: shapes do not match: x "
                         f"{tuple(x3.shape)}, others "
                         f"{[tuple(t.shape) for t in ts + vs]}")
    if x3.numel() == 0 or x3.shape[0] * x3.shape[2] >= 2 ** 31:
        raise MXNetError(f"{name}: x {tuple(x3.shape)} is empty or has 2^31 "
                         "or more elements a channel")


def _align(*ts) -> int:
    a = 16
    for t in ts:
        if t is not None:
            while t.data_ptr() % a:
                a //= 2
    return a


def _walk(plan) -> tuple:
    return (int(plan["one"]), plan["vec"], plan["cg"], plan["per"],
            plan["splits"], plan["rows"])


def _run(name, *args, device) -> None:
    fn = _kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches[name] += 1


def _plan_of(x3, *ts):
    outer, C, inner = x3.shape
    return bn_plan(outer, C, inner, x3.dtype, _align(x3, *ts))


def _reduce_plan_of(x3, *ts):
    outer, C, inner = x3.shape
    return bn_reduce_plan(outer, C, inner, x3.dtype, _align(x3, *ts))


def _rwalk(plan) -> tuple:
    return (int(plan["one"]), plan["vec"], plan["cg"], plan["per"],
            plan["rows"], plan["cluster"], plan["splits"])


# the second level's counters, one int a (group, rank), kept per device and
# stream: each launch leaves them at 0, so they are zeroed once, when made
# (a stream's launches run in order; two streams keep two sets)
_COUNTERS = {}


def _second_level(x3, plan):
    """(ws, count) for a plan with ``splits`` > 1: f32 sums (splits, C, 2)
    and the counters; (None, None) for one split. A CUDA graph being
    captured gets counters of its own, zeroed in the graph at each replay:
    a kept set's address would be baked into every graph that met it, and
    two graphs replayed on two streams would share it."""
    if plan["splits"] == 1:
        return None, None
    ws = torch.empty(plan["splits"] * x3.shape[1] * 2, dtype=torch.float32,
                     device=x3.device)
    n = plan["groups"] * plan["cluster"]
    if torch.cuda.is_current_stream_capturing():
        return ws, torch.zeros(n, dtype=torch.int32, device=x3.device)
    key = (x3.device.index, torch.cuda.current_stream(x3.device).cuda_stream)
    with _COUNT_LOCK:
        count = _COUNTERS.get(key)
        if count is None or count.numel() < n:
            count = torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=x3.device)
            _COUNTERS[key] = count
    return ws, count


def _stats(x3, shift, eps: float, centered: bool):
    if not x3.is_cuda:
        return bn_stats_reference(x3, shift, eps, centered)
    _check("bn_stats", x3, vecs=(shift,))
    plan = _reduce_plan_of(x3)
    outer, C, inner = x3.shape
    var = torch.empty(C, dtype=torch.float32, device=x3.device)
    inv = torch.empty_like(var)
    mean = shift if centered else torch.empty_like(var)
    ws, count = _second_level(x3, plan)
    _run("bn_stats", _DTYPE_CODE[x3.dtype], x3.data_ptr(), _ptr(shift),
         int(centered), float(eps), None if centered else mean.data_ptr(),
         var.data_ptr(), inv.data_ptr(), _ptr(ws), _ptr(count),
         outer, C, inner, *_rwalk(plan), device=x3.device)
    return mean, var, inv


def _apply(x3, mean, inv, g, b):
    if not x3.is_cuda:
        return bn_apply_reference(x3, mean, inv, g, b)
    _check("bn_apply", x3, vecs=(mean, inv, g, b))
    plan = _plan_of(x3)
    out = torch.empty_like(x3)
    _run("bn_apply", _DTYPE_CODE[x3.dtype], x3.data_ptr(), mean.data_ptr(),
         inv.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(),
         *x3.shape, *_walk(plan), device=x3.device)
    return out


def _bwd_reduce(x3, dy3, mean, inv):
    if not x3.is_cuda:
        return bn_bwd_reduce_reference(x3, dy3, mean, inv)
    _check("bn_bwd_reduce", x3, (dy3,), (mean, inv))
    plan = _reduce_plan_of(x3, dy3)
    dg = torch.empty_like(mean)
    db = torch.empty_like(mean)
    ws, count = _second_level(x3, plan)
    _run("bn_bwd_reduce", _DTYPE_CODE[x3.dtype], x3.data_ptr(),
         dy3.data_ptr(), mean.data_ptr(), inv.data_ptr(), dg.data_ptr(),
         db.data_ptr(), _ptr(ws), _ptr(count), *x3.shape, *_rwalk(plan),
         device=x3.device)
    return dg, db


def _bwd_apply(x3, dy3, mean, inv, g, dg, db, dmean=None, dvar=None):
    if not x3.is_cuda:
        return bn_bwd_apply_reference(x3, dy3, mean, inv, g, dg, db, dmean,
                                      dvar)
    _check("bn_bwd_apply", x3, (dy3,), (mean, inv, g, dg, db, dmean, dvar))
    if dy3 is not None and (g is None or inv is None or dg is None
                            or db is None):
        raise MXNetError("bn_bwd_apply: dy needs inv, g, dg and db")
    plan = _plan_of(x3, dy3)
    dx = torch.empty_like(x3)
    _run("bn_bwd_apply", _DTYPE_CODE[x3.dtype], x3.data_ptr(), _ptr(dy3),
         mean.data_ptr(), _ptr(inv), _ptr(g), _ptr(dg), _ptr(db),
         _ptr(dmean), _ptr(dvar), dx.data_ptr(),
         *_coefficients(x3.shape[0] * x3.shape[2]), *x3.shape, *_walk(plan),
         device=x3.device)
    return dx


# ---------------------------------------------------------------- autograd
def _view3(x, axis: int):
    """x contiguous, viewed as (outer, C, inner) around channel ``axis``."""
    ax = axis % x.ndim
    outer = 1
    for s in x.shape[:ax]:
        outer *= s
    inner = 1
    for s in x.shape[ax + 1:]:
        inner *= s
    return x.contiguous().view(outer, x.shape[ax], inner)


def _vec(t):
    return None if t is None else t.detach().float().contiguous()


def _statistics(x3, shift, eps: float, centered: bool):
    """(mean, var, inv): one sweep about ``shift``, or, centered, the mean
    by a first sweep and the variance by a second about it."""
    if centered:
        mean = _stats(x3, None, eps, False)[0]
        return _stats(x3, mean, eps, True)
    return _stats(x3, shift, eps, False)


class _BatchNormTrain(torch.autograd.Function):
    """``_bn_train_core`` with its custom VJP: returns out (x's dtype) and
    f32 (mean, var); the backward is one sweep for dg and db and one for
    dx, with the mean and var cotangents folded in when present."""

    @staticmethod
    def forward(ctx, x, g, b, shift, eps, centered, axis):
        x3 = _view3(x, axis)
        gf, bf = _vec(g), _vec(b)
        mean, var, inv = _statistics(x3, _vec(shift), eps, centered)
        out = _apply(x3, mean, inv, gf, bf)
        ctx.save_for_backward(x3, gf, mean, inv)
        ctx.set_materialize_grads(False)
        ctx.shape, ctx.axis, ctx.dtypes = x.shape, axis, (g.dtype, b.dtype)
        return out.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dout, dmean, dvar):
        x3, gf, mean, inv = ctx.saved_tensors
        dy3 = None if dout is None else _view3(dout, ctx.axis)
        dg = db = None
        if dy3 is not None:
            dg, db = _bwd_reduce(x3, dy3, mean, inv)
        if dy3 is None and dmean is None and dvar is None:
            return (None,) * 7
        dx = _bwd_apply(x3, dy3, mean, inv, gf, dg, db, _vec(dmean),
                        _vec(dvar))
        if dg is not None:
            dg, db = dg.to(ctx.dtypes[0]), db.to(ctx.dtypes[1])
        return dx.view(ctx.shape), dg, db, None, None, None, None


class _BatchStats(torch.autograd.Function):
    """``_bn_batch_stats``: f32 (mean, var) by the statistics kernel, the
    backward ``dx = dmean/N + dvar * (2/N) * (x - mean)`` by the apply
    kernel with no dy."""

    @staticmethod
    def forward(ctx, x, shift, eps, centered, axis):
        x3 = _view3(x, axis)
        mean, var, _ = _statistics(x3, _vec(shift), eps, centered)
        ctx.save_for_backward(x3, mean)
        ctx.set_materialize_grads(False)
        ctx.shape, ctx.axis = x.shape, axis
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x3, mean = ctx.saved_tensors
        if dmean is None and dvar is None:
            return None, None, None, None, None
        dx = _bwd_apply(x3, None, mean, None, None, None, None, _vec(dmean),
                        _vec(dvar))
        return dx.view(ctx.shape), None, None, None, None


def batch_norm_train(x, g, b, shift, eps: float = 1e-5,
                     centered: bool = False, axis: int = 1):
    """Training BatchNorm over channel ``axis``: ``(out, mean, var)``, out
    in x's dtype, the statistics in f32; shifted statistics about
    ``shift`` (no gradient), or centered. Differentiable in x, g and b
    (and through mean and var)."""
    return _BatchNormTrain.apply(x, g, b, shift, float(eps), bool(centered),
                                 int(axis))


def batch_stats(x, shift, centered: bool = False, axis: int = 1,
                eps: float = 1e-5):
    """f32 batch ``(mean, var)`` over channel ``axis`` by the statistics
    kernel, differentiable in x."""
    return _BatchStats.apply(x, shift, float(eps), bool(centered), int(axis))

