"""Flash attention: the Hopper kernels, their plain versions, routing, autograd.

Counterpart of ``mxnet_tpu/ops/pallas/attention.py`` (``flash_attention``,
``_flash2`` and its custom VJP, ``_flash_forward``, ``_flash_backward``,
``_dropout_keep``). The kernels are CUDA C++ for ``sm_90a``, built and loaded
by :mod:`mxnet_tpu_torch._kernels`:

- ``csrc/flash_attention_fwd.cu`` replaces ``_flash_fwd_kernel``;
- ``csrc/flash_attention_bwd.cu`` replaces ``_flash_bwd_fused_kernel``,
  ``_flash_bwd_dq_kernel`` (16-bit) and ``_flash_bwd_dkv_kernel`` (16-bit
  up to :data:`MAX_HEAD_DIM`, f32 at every head dim: the key-block walk on
  3xTF32 wgmma, streaming the head dim above :data:`FUSED_MAX_HEAD_DIM`);
- ``csrc/flash_attention_wide_wg.cu`` replaces ``_flash_fwd_kernel`` and
  ``_flash_bwd_dq_kernel`` at every head dim above :data:`MAX_HEAD_DIM`
  (``wide_fwd``, ``wide_dq``: 16-bit on wgmma tiles over the head dim's
  64-column panels, streamed through the ring above
  :data:`WIDE_WG_MAX_HEAD_DIM`; f32 on 3xTF32 wgmma over 32-column panels,
  streamed at every D), and the f32 ``_flash_bwd_dq_kernel`` at every head
  dim; ``csrc/flash_attention_wide_dkv.cu`` replaces
  ``_flash_bwd_dkv_kernel`` for 16-bit q, k, v above :data:`MAX_HEAD_DIM`
  (``wide_dkv``, the key-block walk, streaming the head dim above
  :data:`WIDE_WG_MAX_HEAD_DIM`);
- ``csrc/philox.cuh`` replaces ``_dropout_keep``: the keep bit of a score is
  a pure function of (seed, batch, head, row, col), never of tile shape, so
  every kernel and :func:`dropout_keep_reference` draw the same mask.

Routing: a tensor on the CPU takes the plain versions
(:func:`flash_attention_reference`, :func:`flash_attention_backward_reference`);
a CUDA tensor launches the kernels or raises :class:`MXNetError`. Nothing
falls back. Each launch adds one to its kernel's entry in :data:`launches`.

The forward is the registered op ``mxnet_tpu_torch::flash_attention_fwd``
(``torch.library.custom_op``), so that ``torch.export`` traces it as one
node of an exported program (``HybridBlock.export``): its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, and its fake implementation gives the outputs' shapes and
strides. Both implementations return ``out`` as a (B, H, Tq, D) view of a
(B, Tq, H, D) buffer whose rows are padded to a multiple of 8 elements
(:func:`_bthd_empty`) and ``lse`` as (B, H, Tq, 1) f32, the fake's
layout. The operand checks run inside the CUDA implementation, so a trace
does not specialise on them.
The tiled forward and backward kernels take head dims up to 256
(:data:`MAX_HEAD_DIM`); a larger head dim takes the wide kernels, forward
and backward, so the card takes any head dim, as the JAX package and the
plain versions do. Which source a kernel of a wide head dim comes from is
:func:`head_dim_route`, a pure function of (D, dtype) and a contract of
the port: 16-bit at 256 < D <= 512 takes the tiled ``wide_fwd``,
``wide_dq`` and ``wide_dkv`` (``"wide_wg"``), 16-bit above 512 the tiled
three that stream the head dim (``"wide_stream"``), f32 the 3xTF32
``wide_fwd``, ``wide_dq`` and dk / dv (``"wide_f32"``). :func:`_source`
names each kernel's library: the f32 pair at every head dim is the 3xTF32
dq of ``flash_attention_wide_wg.cu`` and dk / dv of
``flash_attention_bwd.cu``. A build or launch that fails raises; no route
gives way to another. The f32 FMA forward of head dims up to
:data:`MAX_HEAD_DIM` reads every operand through its strides, so it
copies nothing. Every other kernel (:func:`_uses_tma`) reads q, k, v and
dout and writes out, dq, dk and dv by TMA (the f32 fused pass and dk / dv
store dk and dv from their threads), which needs a 16-byte aligned
base and strides that are multiples of 16 bytes; an operand that lacks
either (a 16-bit head dim that is not a multiple of 8, an f32 one not a
multiple of 4) is first copied into a padded contiguous buffer (an output
is written there and copied back), once for both kernels of a backward
pair, and :data:`padded_copies` counts those copies.
The 3xTF32 kernels (the wide f32 forward, every f32 backward kernel) run
their f32 products on the tensor cores as three TF32 products of split
halves: f32-accurate (about 2**-21 relative), whatever
``torch.backends.cuda.matmul.allow_tf32`` says.

Routing of the backward (:func:`backward_route`), a contract of the port:
for D <= 128, the fused single pass when Tk fits one k-block
(``Tk <= block_k``) and the two-pass dq/dkv pair otherwise, the JAX rule;
for 128 < D <= 256 the pair at every Tk; for D > 256 the wide pair
(``"wide"``). The fused kernel keeps dk and dv
for 64 keys a warpgroup in f32 registers and its K, V and two ring stages
of q and dout in shared memory: at D = 256 that is 256 registers a thread
(the cap is 232) and 256 KB (a block has 227 KB), so those head dims take
the pair, which computes the same function with a deterministic dq.
The fused kernel adds each key tile's share of dq into a zeroed f32
accumulator of the port's own layout, (B, H, Tq rounded up to 64, DP + 8)
(:func:`dq_accumulator`: one contiguous run per 64-row tile, added by one
bulk reduce-add a q tile, 64 rows in 16 bits, 32 in f32), and
:func:`dq_from_accumulator` casts it into the (B, T, H, D) layout the model
reads. The order in which the key tiles' shares arrive changes from run to
run, so the fused dq is reproducible to rounding, not bit for bit. The
pair's dq kernel keeps dq in registers over all key tiles and writes it
once: the pair is deterministic, bit for bit, and so are the wide kernels
on both routes (out, lse, dq, dk and dv).
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from ...base import MXNetError

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_backward_reference", "dropout_keep_reference",
           "launches", "padded_copies", "KERNELS", "DEFAULT_BLOCK_Q",
           "DEFAULT_BLOCK_K", "MAX_HEAD_DIM", "FUSED_MAX_HEAD_DIM",
           "WIDE_WG_MAX_HEAD_DIM", "backward_route", "head_dim_route",
           "dq_accumulator", "dq_from_accumulator"]

_NEG_INF = -1e30

# the JAX entry point's defaults; the kernels tile by 64, so block_k only
# routes fused vs two-pass and block_q is accepted and unused
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 1024

KERNELS = ("flash_attention_fwd", "flash_attention_bwd_fused",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_wide_fwd", "flash_attention_wide_dq",
           "flash_attention_wide_dkv")
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
# operands of the forward copied because TMA could not read them in place
padded_copies = 0
# the tiled kernels take head dims up to this, the wide ones any above it;
# the fused backward up to FUSED_MAX_HEAD_DIM
MAX_HEAD_DIM = 256
FUSED_MAX_HEAD_DIM = 128
# 16-bit wide heads up to this take the tiled wide kernels, wider ones the
# tiled kernels that stream the head dim
WIDE_WG_MAX_HEAD_DIM = 512
_HALF = (torch.bfloat16, torch.float16)
# rows of one tile of the fused backward's dq accumulator, and the floats
# that pad each of its rows
DQ_TILE_ROWS = 64
DQ_ROW_PAD = 8
_COUNT_LOCK = threading.Lock()
_FNS = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_BWD_KIND = {"flash_attention_bwd_fused": 0, "flash_attention_bwd_dq": 1,
             "flash_attention_bwd_dkv": 2, "flash_attention_wide_dq": 1,
             "flash_attention_wide_dkv": 2}

# ---------------------------------------------------------------- dropout
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """Keep iff a Philox word >= this (``_dropout_keep``'s threshold)."""
    return min(_U32, int(rate * 4294967296.0))


def _mulhilo(m: int, x: torch.Tensor):
    """(lo, hi) words of the 64-bit product of the constant ``m`` and the
    uint32 values held in int64 ``x``, without int64 overflow: x is split
    into 16-bit halves so every partial product stays below 2**49."""
    t1 = m * (x & 0xFFFF)
    t2 = m * (x >> 16)
    mid = t1 + ((t2 & 0xFFFF) << 16)
    return mid & _U32, (t2 >> 16) + (mid >> 32)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 values (broadcast
    together); the same rounds as ``csrc/philox.cuh``."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        lo0, hi0 = _mulhilo(_M0, c0)
        lo1, hi1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep_reference(seed: torch.Tensor, B: int, H: int, Tq: int,
                           Tk: int, rate: float) -> torch.Tensor:
    """The kernels' keep mask, (B, H, Tq, Tk) bool on ``seed``'s device.

    ``seed`` is the (2,) int32 key. One Philox call per 2 x 2 block of
    scores: counter (col >> 1, row >> 1, head, batch), word
    ``((row & 1) << 1) | (col & 1)``; keep iff word >= rate * 2**32."""
    dev = seed.device
    key = seed.to(torch.int64) & _U32
    R, C = (Tq + 1) // 2, (Tk + 1) // 2
    i64 = dict(dtype=torch.int64, device=dev)
    words = philox4x32_10(
        torch.arange(C, **i64)[None, None, None, :],
        torch.arange(R, **i64)[None, None, :, None],
        torch.arange(H, **i64)[None, :, None, None],
        torch.arange(B, **i64)[:, None, None, None],
        key[0], key[1])
    w = torch.stack([x.expand(B, H, R, C) for x in words], dim=-1)
    # word ((row & 1) << 1) | (col & 1) of block (row >> 1, col >> 1)
    w = w.reshape(B, H, R, C, 2, 2).permute(0, 1, 2, 4, 3, 5)
    w = w.reshape(B, H, 2 * R, 2 * C)[:, :, :Tq, :Tk]
    return w >= dropout_threshold(rate)


# ---------------------------------------------------------- plain versions
def _scores(q, k, bias, scale, causal):
    """f32 scaled scores with the bias, and the causal keep mask or None."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    keep = None
    if causal:
        Tq, Tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
    return s, keep


def flash_attention_reference(q, k, v, bias=None, scale: Optional[float] = None,
                              causal: bool = False, seed=None,
                              rate: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel over (B, H, T, D)
    operands: returns ``(out (B, H, Tq, D) in q's dtype, lse (B, H, Tq, 1)
    f32)``.

    Same math as the kernel's result: f32 scores, bias added, causal-masked
    scores set to -1e30 (top-left, ``col <= row``), the row max floored at
    -1e30 as the kernel's running max starts there, the denominator over
    the undropped probabilities guarded by ``max(l, 1e-30)``, and with
    ``rate > 0`` the kept probabilities scaled by ``1 / (1 - rate)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, keep = _scores(q, k, bias, scale, causal)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if rate > 0:
        B, H, Tq, Tk = p.shape
        drop = dropout_keep_reference(seed, B, H, Tq, Tk, rate)
        p = torch.where(drop, p * (1.0 / (1.0 - rate)), torch.zeros_like(p))
    out = torch.matmul(p, v.float()) / denom
    return out.to(q.dtype), m + torch.log(denom)


def flash_attention_backward_reference(q, k, v, bias, seed, rate: float, out,
                                       lse, do, scale: float, causal: bool,
                                       want_ds: bool):
    """Plain PyTorch version of the backward kernels over (B, H, T, D):
    ``(dq, dk, dv, ds or None)`` in f32, from the same formulas as the
    kernels (``_flash_backward``): p = exp(s - lse) masked, the dropout
    mask of :func:`dropout_keep_reference`, delta = rowsum(do * out),
    ds = p * (dp - delta); ds is returned unscaled when ``want_ds``."""
    s, keep = _scores(q, k, bias, scale, causal)
    p = torch.exp(s - lse.float())
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    pd = p
    if rate > 0:
        B, H, Tq, Tk = p.shape
        drop = dropout_keep_reference(seed, B, H, Tq, Tk, rate)
        inv = 1.0 / (1.0 - rate)
        zero = torch.zeros_like(p)
        pd = torch.where(drop, p * inv, zero)
        dp = torch.where(drop, dp * inv, zero)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dv = torch.matmul(pd.transpose(-1, -2), dof)
    dq = torch.matmul(ds * scale, k.float())
    dk = torch.matmul((ds * scale).transpose(-1, -2), q.float())
    return dq, dk, dv, (ds if want_ds else None)


# ------------------------------------------------------------- the kernels
def _check_bias(bias, B, H, Tq, Tk):
    if bias.ndim != 4 or bias.shape[2] not in (1, Tq) \
            or bias.shape[3] != Tk or bias.shape[0] not in (1, B) \
            or bias.shape[1] not in (1, H):
        raise ValueError(
            f"flash_attention bias must be (1|B, 1|H, 1|Tq, Tk); got "
            f"{tuple(bias.shape)} for B={B}, H={H}, Tq={Tq}, Tk={Tk}")


def head_dim_route(D: int, dtype) -> str:
    """The kernels a CUDA tensor of head dim ``D`` and ``dtype`` takes:
    ``"tiled"`` (D <= :data:`MAX_HEAD_DIM`: ``flash_attention_fwd.cu``,
    ``flash_attention_bwd.cu``; the f32 pair as :func:`_source` says),
    ``"wide_wg"`` (bf16 / fp16 up to :data:`WIDE_WG_MAX_HEAD_DIM`) and
    ``"wide_stream"`` (bf16 / fp16 above it: the head dim streamed), both
    with ``wide_fwd`` and ``wide_dq`` from ``flash_attention_wide_wg.cu``
    and ``wide_dkv`` from ``flash_attention_wide_dkv.cu``, or
    ``"wide_f32"`` (f32: the 3xTF32 ``wide_fwd`` and ``wide_dq`` from
    ``flash_attention_wide_wg.cu``, the 3xTF32 dk / dv from
    ``flash_attention_bwd.cu``)."""
    if D <= MAX_HEAD_DIM:
        return "tiled"
    if dtype not in _HALF:
        return "wide_f32"
    return "wide_wg" if D <= WIDE_WG_MAX_HEAD_DIM else "wide_stream"


def _source(name: str, dtype) -> Tuple[str, str]:
    """(library, C entry) of kernel ``name`` for ``dtype`` (a wide kernel's
    name is its route's, :func:`head_dim_route`): the f32 pair at every
    head dim is ``wide_dq_tf32`` of ``flash_attention_wide_wg.cu`` and the
    3xTF32 dk / dv of ``flash_attention_bwd.cu``."""
    fwd = name.endswith("_fwd")
    if dtype not in _HALF and name.endswith("_dq"):
        return ("flash_attention_wide_wg", "mxt_flash_wide_wg_bwd")
    if dtype not in _HALF and name.endswith("_dkv"):
        return ("flash_attention_bwd", "mxt_flash_attention_bwd")
    if not _wide(name):
        return (("flash_attention_fwd", "mxt_flash_attention_fwd") if fwd
                else ("flash_attention_bwd", "mxt_flash_attention_bwd"))
    if name == "flash_attention_wide_dkv":
        return ("flash_attention_wide_dkv", "mxt_flash_wide_wg_dkv")
    return ("flash_attention_wide_wg",
            "mxt_flash_wide_wg_fwd" if fwd else "mxt_flash_wide_wg_bwd")


def _kernel(name: str, dtype):
    """The ctypes entry of kernel ``name`` for ``dtype`` (which decide its
    source, :func:`_source`), its library built on first use."""
    lib, entry = _source(name, dtype)
    fn = _FNS.get((lib, entry))
    if fn is not None:
        return fn
    from ... import _kernels
    p, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    fn = getattr(_kernels.load(lib), entry)
    if name.endswith("_fwd"):
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, strides,
                       ctypes.c_float, i, p, i, ctypes.c_uint,
                       ctypes.c_float, p]
    else:
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                       strides, ctypes.c_float, i, p, i, ctypes.c_uint,
                       ctypes.c_float, p]
    fn.restype = ctypes.c_int
    _FNS[(lib, entry)] = fn
    return fn


def _wide(name: str) -> bool:
    return name.startswith("flash_attention_wide")


def _uses_tma(name: str, route: str, dtype) -> bool:
    """Whether kernel ``name`` on ``route`` reads and writes its operands
    by TMA: every kernel but the f32 FMA forward of head dims up to
    :data:`MAX_HEAD_DIM`."""
    return dtype in _HALF or route != "tiled" or name != "flash_attention_fwd"


def _bht(t):
    """(batch, head, time) strides of a (B, H, T, D) view."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def _check_operands(q, k, v, extra=()):
    """q/k/v (and ``extra``, read or written with them) as (B, H, T, D)
    views on one CUDA device in one dtype with a contiguous head dim."""
    ts = (q, k, v) + tuple(extra)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise MXNetError("flash_attention: q, k, v and out must lie on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or not all(t.dtype == q.dtype for t in ts):
        raise MXNetError(f"flash_attention: q, k, v must share one dtype of "
                         f"float32/bfloat16/float16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.stride(-1) == 1 for t in ts):
        raise MXNetError("flash_attention: the head dimension must be "
                         "contiguous (stride 1) in q, k, v")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or tuple(v.shape) != (B, H, Tk, D):
        raise MXNetError(f"flash_attention: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    return B, H, Tq, Tk, D


def _bias_args(bias, q, B, H, Tq, Tk):
    """(f32 bias or None, its 4 broadcast strides)."""
    if bias is None:
        return None, [0, 0, 0, 0]
    _check_bias(bias, B, H, Tq, Tk)
    if not bias.is_cuda or bias.device != q.device:
        raise MXNetError("flash_attention: bias must lie on q's device")
    bias = bias.float()
    return bias, [bias.stride(i) if bias.shape[i] > 1 else 0
                  for i in range(4)]


def _seed_args(seed, rate, q):
    if rate <= 0:
        return None, 0, 0, 1.0
    if seed is None or not seed.is_cuda or seed.device != q.device \
            or seed.dtype != torch.int32 or seed.numel() != 2:
        raise MXNetError("flash_attention: dropout needs a (2,) int32 seed "
                         "tensor on q's device")
    seed = seed.contiguous()
    return seed, 1, dropout_threshold(rate), 1.0 / (1.0 - rate)


def _count(name: str) -> None:
    with _COUNT_LOCK:
        launches[name] += 1


def _tma_ready(t) -> bool:
    """TMA reads or writes a (B, H, T, D) view in place: 16-byte aligned
    base, and every stride of a dimension longer than 1 a multiple of 16
    bytes (8 16-bit elements, 4 f32)."""
    return t.data_ptr() % 16 == 0 and all(
        t.stride(i) * t.element_size() % 16 == 0
        for i in range(3) if t.shape[i] > 1)


def _padded_buffer(t):
    """An empty (B, H, T, D) view shaped like ``t`` whose rows are padded
    to a multiple of 8 elements: a layout TMA can describe."""
    B, H, T, D = t.shape
    return torch.empty((B, H, T, -(-D // 8) * 8), dtype=t.dtype,
                       device=t.device)[..., :D]


def _count_copy() -> None:
    global padded_copies
    with _COUNT_LOCK:
        padded_copies += 1


def _tma_operand(t):
    """``t`` itself when TMA can read it, else a counted padded copy."""
    if _tma_ready(t):
        return t
    _count_copy()
    return _padded_buffer(t).copy_(t)


def _bthd_empty(B, H, T, D, dtype, device):
    """An empty (B, H, T, D) view of a (B, T, H, D) buffer, the layout the
    model merges heads from without a copy, with rows padded to a multiple
    of 8 elements so that TMA writes it in place."""
    return torch.empty((B, T, H, -(-D // 8) * 8), dtype=dtype,
                       device=device)[..., :D].transpose(1, 2)


def _tma_operands(names, route, ts):
    """The operands ``ts`` of the kernels ``names`` on ``route`` (the
    forward's q, k, v, or the backward pair's q, k, v, dout): when one of
    them reads by TMA, each operand that TMA cannot address copied once for
    all (:func:`_tma_operand`, counted), so that the pair's second kernel
    finds it ready; else as they are."""
    if not any(_uses_tma(n, route, ts[0].dtype) for n in names):
        return tuple(ts)
    return tuple(_tma_operand(t) for t in ts)


def _padded_output(t):
    """A counted padded buffer standing in for an output TMA cannot
    write in place; the caller copies it back."""
    _count_copy()
    return _padded_buffer(t)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, bias, seed, rate, out, lse, scale: float,
                causal: bool, fn=None) -> None:
    """The forward kernel on (B, H, T, D) views; ``out`` is written in
    place, ``lse`` is (B, H, Tq, 1) contiguous f32. Operands of a kernel
    that reads by TMA (:func:`_uses_tma`) that TMA cannot address are
    copied first (:func:`_tma_operand`); an output it cannot address is
    written to a padded buffer and copied back. Above
    :data:`MAX_HEAD_DIM` the wide kernel of :func:`head_dim_route` runs.
    ``fn``: another build of the same C entry (an experiment's variant, ``chip_smoke.py
    --probe-fwd``); its launches are not counted."""
    B, H, Tq, Tk, D = _check_operands(q, k, v, (out,))
    route = head_dim_route(D, q.dtype)
    name = ("flash_attention_fwd" if route == "tiled"
            else "flash_attention_wide_fwd")
    dest = out
    if _uses_tma(name, route, q.dtype):
        q, k, v = _tma_operands((name,), route, (q, k, v))
        if not _tma_ready(out):
            out = _padded_output(out)
    ts = (q, k, v, out)
    flat = [s for t in ts for s in _bht(t)]
    bias, bstrides = _bias_args(bias, q, B, H, Tq, Tk)
    seed, drop, thresh, drop_scale = _seed_args(seed, rate, q)
    variant = fn is not None
    fn = fn or _kernel(name, q.dtype)
    arr = (ctypes.c_longlong * 16)(*(flat + bstrides))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), _ptr(bias), out.data_ptr(), lse.data_ptr(),
                 B, H, Tq, Tk, D, arr, float(scale), int(bool(causal)),
                 _ptr(seed), drop, thresh, drop_scale, stream)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    if not variant:
        _count(name)
    if out is not dest:
        dest.copy_(out)


def dq_accumulator(B: int, H: int, Tq: int, D: int, device) -> torch.Tensor:
    """The fused backward's zeroed f32 dq accumulator: (B, H, Tq rounded
    up to 64, DP + 8), contiguous, DP = 64 for D <= 64 and 128 above, so
    each 64-row tile of one (batch, head) is one contiguous run that the
    kernel adds in one bulk reduce-add (the 8 padding floats of a row keep
    its shared-memory staging free of bank conflicts; they receive zeros).
    Only the first Tq rows and D columns are dq."""
    rows = -(-Tq // DQ_TILE_ROWS) * DQ_TILE_ROWS
    return torch.zeros((B, H, rows, (64 if D <= 64 else 128) + DQ_ROW_PAD),
                       dtype=torch.float32, device=device)


def dq_from_accumulator(acc: torch.Tensor, Tq: int, D: int,
                        dtype) -> torch.Tensor:
    """dq as a (B, H, Tq, D) view of a dense (B, Tq, H, D) tensor of
    ``dtype`` (the layout of the model's projections), cast from the
    accumulator's first Tq rows and D columns."""
    B, H = acc.shape[:2]
    dq = torch.empty((B, Tq, H, D), dtype=dtype,
                     device=acc.device).transpose(1, 2)
    return dq.copy_(acc[:, :, :Tq, :D])


def _launch_bwd(name, q, k, v, do, bias, seed, rate, lse, delta, dq, dk, dv,
                ds, scale: float, causal: bool, fn=None) -> None:
    """One backward kernel on (B, H, T, D) views. ``dq`` is the
    :func:`dq_accumulator` for the fused kernel, q's dtype for the dq
    kernel; kernels that do not write an output get None for it. Every
    backward kernel (:func:`_uses_tma`) reads q, k, v, do and writes dk, dv
    and the dq kernel's dq by TMA (the f32 fused pass and dk / dv store dk,
    dv from their threads, through the same buffers): operands it cannot
    address are copied first and outputs written to a padded buffer and
    copied back (:func:`_tma_operand`, counted; :func:`_backward_kernels`
    copies a pair's operands once, for both, :func:`_tma_operands`).
    ``fn``:
    another build of the same C entry (``chip_smoke.py --probe-bwd``); its
    launches are not counted."""
    B, H, Tq, Tk, D = _check_operands(q, k, v, (do,))
    route = head_dim_route(D, q.dtype)
    fused = name == "flash_attention_bwd_fused"
    # the outputs in q's dtype (the fused kernel's dq is its accumulator)
    dests = [None if fused else dq, dk, dv]
    written = dests
    if _uses_tma(name, route, q.dtype):
        q, k, v, do = (_tma_operand(t) for t in (q, k, v, do))
        written = [t if t is None or _tma_ready(t) else _padded_output(t)
                   for t in dests]
        dq = dq if fused else written[0]
        dk, dv = written[1:]
    ts = (q, k, v, do)
    flat = [s for t in ts for s in _bht(t)]
    outs = [_bht(t) if t is not None else [0, 0, 0] for t in (dq, dk, dv)]
    bias, bstrides = _bias_args(bias, q, B, H, Tq, Tk)
    seed, drop, thresh, drop_scale = _seed_args(seed, rate, q)
    variant = fn is not None
    fn = fn or _kernel(name, q.dtype)
    arr = (ctypes.c_longlong * 25)(
        *(flat + [s for o in outs for s in o] + bstrides))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_BWD_KIND[name], _DTYPE_CODE[q.dtype], q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(bias),
                 lse.data_ptr(), delta.data_ptr(), _ptr(dq), _ptr(dk),
                 _ptr(dv), _ptr(ds), B, H, Tq, Tk, D, arr, float(scale),
                 int(bool(causal)), _ptr(seed), drop, thresh, drop_scale,
                 stream)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    if not variant:
        _count(name)
    for dest, t in zip(dests, written):
        if t is not dest:
            dest.copy_(t)


_FWD_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? seed, "
               "float scale, bool causal, float rate) -> (Tensor, Tensor)")


def _fwd_outputs(q):
    """Empty (out, lse) of the forward over (B, H, T, D) ``q``: out a
    (B, H, Tq, D) view of a (B, Tq, H, D) buffer, the layout the model
    merges heads from without a copy; lse (B, H, Tq, 1) f32."""
    B, H, Tq, D = q.shape
    return (_bthd_empty(B, H, Tq, D, q.dtype, q.device),
            torch.empty((B, H, Tq, 1), dtype=torch.float32, device=q.device))


@torch.library.custom_op("mxnet_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu",
                         schema=_FWD_SCHEMA)
def flash_attention_fwd(q, k, v, bias, seed, scale, causal, rate):
    """The forward over (B, H, T, D) q/k/v: ``(out, lse)``. On the CPU the
    plain version (:func:`flash_attention_reference`), written into the
    kernel's output layout."""
    ref, lse = flash_attention_reference(q, k, v, bias, scale, causal, seed,
                                         rate)
    out, _ = _fwd_outputs(q)
    return out.copy_(ref), lse


@flash_attention_fwd.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, bias, seed, scale, causal, rate):
    """The forward kernel's launch (operands checked in it)."""
    out, lse = _fwd_outputs(q)
    _launch_fwd(q, k, v, bias, seed, rate, out, lse, scale, causal)
    return out, lse


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, bias, seed, scale, causal, rate):
    return _fwd_outputs(q)


def _flash_forward(q, k, v, bias, scale: float, causal: bool, seed=None,
                   rate: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v: (B, H, T, D). Returns (out (B, H, Tq, D), lse (B, H, Tq, 1))
    from the registered op: the kernel on the card, the plain version on
    the CPU."""
    return flash_attention_fwd(q, k, v, bias, seed, float(scale),
                               bool(causal), float(rate))


def _reduce_ds(ds, bias):
    """The bias gradient: ds summed over the bias's broadcast dims."""
    red = tuple(ax for ax, size in enumerate(bias.shape[:3]) if size == 1)
    d_bias = ds.sum(dim=red, keepdim=True) if red else ds
    return d_bias.to(bias.dtype)


def backward_route(D: int, Tk: int, block_k: int) -> str:
    """``"fused"``, ``"two_pass"`` or ``"wide"``: the backward kernels a
    CUDA tensor takes. The fused single pass when Tk fits one k-block and
    D <= :data:`FUSED_MAX_HEAD_DIM`, the dq/dkv pair up to
    :data:`MAX_HEAD_DIM`, the wide dq/dkv pair above it (the module
    docstring says why; :func:`head_dim_route` says which wide
    kernels)."""
    if D > MAX_HEAD_DIM:
        return "wide"
    return "fused" if Tk <= block_k and D <= FUSED_MAX_HEAD_DIM \
        else "two_pass"


def _flash_backward(q, k, v, bias, seed, o, lse, g, scale: float,
                    causal: bool, block_k: int, rate: float,
                    bias_grad: bool = True):
    """Gradients of attention over (B, H, T, D): ``(dq, dk, dv, d_bias)``,
    d_bias reduced to the bias's shape, or None without a bias or with
    ``bias_grad=False`` (a mask: its O(B*H*T^2) ds is never formed).
    ``o`` and ``lse`` are the forward's (global) output and log-sum-exp."""
    want_ds = bias is not None and bias_grad
    if not q.is_cuda:
        dq, dk, dv, ds = flash_attention_backward_reference(
            q, k, v, bias, seed, rate, o, lse, g, scale, causal, want_ds)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                _reduce_ds(ds, bias) if want_ds else None)
    return _backward_kernels(q, k, v, bias, seed, o, lse, g, scale, causal,
                             block_k, rate, want_ds)


def _backward_kernels(q, k, v, bias, seed, o, lse, g, scale: float,
                      causal: bool, block_k: int, rate: float,
                      want_ds: bool):
    """The card's side of :func:`_flash_backward`: delta, the buffers, and
    the kernels :func:`backward_route` picks."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    # the kernels read dout in place: a unit stride on D, no broadcast dims
    # (the expanded gradient of a sum has zero strides)
    if g.stride(-1) != 1 or 0 in g.stride():
        g = g.contiguous()
    dev = q.device
    delta = (g.float() * o.float()).sum(dim=-1).contiguous()   # (B, H, Tq)
    lse = lse.reshape(B, H, Tq).contiguous()
    ds = (torch.zeros((B, H, Tq, Tk), dtype=torch.float32, device=dev)
          if want_ds else None)
    # gradients in the (B, T, H, D) layout of the model's projections, rows
    # padded to a multiple of 8 elements so that TMA stores in place
    dk = _bthd_empty(B, H, Tk, D, k.dtype, dev)
    dv = _bthd_empty(B, H, Tk, D, v.dtype, dev)
    common = (q, k, v, g, bias, seed, rate, lse, delta)
    route = backward_route(D, Tk, block_k)
    if route == "fused":
        dq_acc = dq_accumulator(B, H, Tq, D, dev)
        _launch_bwd("flash_attention_bwd_fused", *common, dq_acc, dk, dv, ds,
                    scale, causal)
        dq = dq_from_accumulator(dq_acc, Tq, D, q.dtype)
    else:
        pair = ("flash_attention_wide_dq", "flash_attention_wide_dkv") \
            if route == "wide" else ("flash_attention_bwd_dq",
                                     "flash_attention_bwd_dkv")
        common = _tma_operands(pair, head_dim_route(D, q.dtype),
                               common[:4]) + common[4:]
        dq = _bthd_empty(B, H, Tq, D, q.dtype, dev)
        _launch_bwd(pair[0], *common, dq, None, None, ds, scale, causal)
        _launch_bwd(pair[1], *common, None, dk, dv, None, scale, causal)
    return dq, dk, dv, (_reduce_ds(ds, bias) if want_ds else None)


class _FlashAttention(torch.autograd.Function):
    """``_flash2`` with its custom VJP: the forward kernel, and the
    backward kernels on the saved (q, k, v, bias, seed, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, rate, scale, causal, block_k,
                bias_grad):
        out, lse = _flash_forward(q, k, v, bias, scale, causal, seed, rate)
        ctx.save_for_backward(q, k, v, bias, seed, out, lse)
        ctx.cfg = (rate, scale, causal, block_k, bias_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, seed, out, lse = ctx.saved_tensors
        rate, scale, causal, block_k, bias_grad = ctx.cfg
        # a bias nobody differentiates needs no ds either
        bias_grad = bias_grad and ctx.needs_input_grad[3]
        dq, dk, dv, d_bias = _flash_backward(
            q, k, v, bias, seed, out, lse, g, scale, causal, block_k, rate,
            bias_grad=bias_grad)
        if d_bias is None and bias is not None and ctx.needs_input_grad[3]:
            d_bias = torch.zeros_like(bias)
        return dq, dk, dv, d_bias, None, None, None, None, None, None


def flash_attention(q, k, v, scale: Optional[float] = None,
                    causal: bool = False, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K, bias=None,
                    dropout: float = 0.0, dropout_seed=None,
                    bias_grad: bool = True):
    """Flash attention over (B, T, H, D) inputs (the JAX package's layout),
    differentiable.

    ``bias``: additive score bias of shape (1|B, 1|H, 1|Tq, Tk);
    ``bias_grad=False`` marks a mask that is not learned: its gradient is
    zero and the O(B*H*T^2) softmax cotangent is never formed.
    ``dropout``: probability-dropout rate on the attention weights, drawn
    in the kernels; ``dropout_seed``: (2,) int32 key, required when
    ``dropout > 0``. ``block_k`` routes the backward: the fused single pass
    when Tk <= block_k and D <= 128, the two-pass dq/dkv kernels otherwise,
    the wide pair above D = 256 (:func:`backward_route`). ``block_q``
    keeps the JAX signature; the kernels tile by 64 and do not read it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if bias is not None:
        _check_bias(bias, B, H, Tq, Tk)
    rate = float(dropout)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash_attention: dropout must be in [0, 1), got "
                         f"{rate}")
    seed = None
    if rate > 0:
        if dropout_seed is None:
            raise ValueError("flash_attention: dropout > 0 needs "
                             "dropout_seed")
        seed = torch.as_tensor(dropout_seed, dtype=torch.int32,
                               device=q.device).reshape(2)
    block_k = min(block_k, max(Tk, 8))
    out = _FlashAttention.apply(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, seed,
        rate, float(scale), bool(causal), int(block_k), bool(bias_grad))
    return out.transpose(1, 2)
