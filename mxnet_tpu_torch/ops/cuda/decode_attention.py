"""One-token decode attention over a slot-based KV cache: the Hopper kernel
and its plain version.

Counterpart of the per-slot decode attention in
``mxnet_tpu/serving/model.py:335-343`` (``_slot_block_step``), which the
JAX package leaves to XLA einsums. Slot ``s`` attends with its one query
over its first ``pos[s] + 1`` cache rows (clamped to the bucket ``L``):
``softmax(q k^T * scale) v``, in f32, rounded to the cache's dtype.

``csrc/decode_attention.cu`` reads only those rows, in chunks of
:func:`chunk` positions (a block each, the chunks combined in chunk order
by the last block of a slot and head to finish, in the same launch), and
sums in an order fixed by position, the visible length and the head dim,
so a slot's output has the same bits whatever the bucket, the slot index
or the other slots: the generation engine's bucket migrations and
speculative passes change no token (``serving/model.py``). The plain
version computes each slot over exactly its visible rows too (a host
loop, reading ``pos``), so on the CPU the same holds.

Operands: ``q`` (S, H, D) with a contiguous head dim (a view of the fused
QKV projection), ``k`` and ``v`` (S, L, H, D) contiguous, ``pos`` (S,)
int64 on the same device, any head dim (above 256 a kernel whose lanes
stride the head dim, up to what a block's shared memory holds). The
kernel's scratch, :class:`Workspace` (the chunks' f32 records and a
ticket counter a slot and head, which the kernel leaves at 0), is made per
call unless the caller keeps one (:func:`workspace`: the decode graphs
keep one a cache and bucket, so a replay allocates nothing). On CUDA
tensors the kernel runs or :class:`MXNetError` is raised; each launch
adds one to :data:`launches`. On CPU tensors the plain version runs.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional

import torch

from ...base import MXNetError

__all__ = ["decode_attention", "decode_attention_reference", "workspace",
           "Workspace", "chunk", "launches", "KERNELS"]

KERNELS = ("decode_attention",)
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_LIB = []
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _library():
    """The kernel's library, its entry's argument types set."""
    if not _LIB:
        from ... import _kernels
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib = _kernels.load("decode_attention")
        lib.mxt_decode_attention.argtypes = [
            i, p, ll, ll, p, p, ll, ll, ll, p, p, p, p, ll, ll, i, i, i, i,
            ctypes.c_float, i, p]
        lib.mxt_decode_attention.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def chunk() -> int:
    """Positions a block of the kernel takes (``da::CHUNK``)."""
    return int(_library().mxt_decode_chunk())


class Workspace(NamedTuple):
    """The kernel's scratch for (S, H, L, D): the chunks' f32 records and a
    zeroed int32 ticket a slot and head (the kernel leaves it at 0)."""
    records: torch.Tensor
    tickets: torch.Tensor


def workspace(S: int, H: int, L: int, D: int, device) -> Workspace:
    """A :class:`Workspace` for calls over (S, H, D) queries and buckets of
    up to ``L`` positions on ``device``."""
    nc = -(-L // chunk())
    return Workspace(
        torch.empty(S * H * nc * (D + 2), dtype=torch.float32, device=device),
        torch.zeros(S * H, dtype=torch.int32, device=device))


def decode_attention_reference(q, k, v, pos, scale: Optional[float] = None):
    """The plain version: each slot over exactly its visible rows, in f32
    (reads ``pos`` on the host)."""
    S, H, D = q.shape
    L = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for s, p in enumerate(pos.tolist()):
        n = min(max(int(p), 0) + 1, L)
        kk = k[s, :n].float()                          # (n, H, D)
        sc = torch.einsum("hd,thd->ht", q[s].float(), kk) * scale
        pr = torch.softmax(sc, dim=-1)
        out[s] = torch.einsum("ht,thd->hd", pr, v[s, :n].float())
    return out


def _check(q, k, v, pos):
    if not all(t.is_cuda and t.device == q.device for t in (k, v, pos)):
        raise MXNetError("decode_attention: q, k, v and pos must lie on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(f"decode_attention: q, k, v must share one dtype of "
                         f"float32/bfloat16/float16; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    S, H, D = q.shape
    if k.ndim != 4 or tuple(k.shape) != tuple(v.shape) \
            or (k.shape[0], k.shape[2], k.shape[3]) != (S, H, D):
        raise MXNetError(f"decode_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} as (S, L, H, D)")
    if not (k.is_contiguous() and v.is_contiguous()) or q.stride(2) != 1:
        raise MXNetError("decode_attention: k and v must be contiguous and "
                         "q's head dim contiguous")
    if pos.dtype != torch.int64 or tuple(pos.shape) != (S,):
        raise MXNetError("decode_attention: pos must be an (S,) int64 "
                         "tensor")
    return S, H, k.shape[1], D


def _vectors(q, k, v) -> bool:
    """Every row of q, k and v 16-byte aligned: the kernel may load 16
    bytes at a time."""
    e = q.element_size()
    return all(t.data_ptr() % 16 == 0 for t in (q, k, v)) and all(
        st * e % 16 == 0 for st in (q.stride(0), q.stride(1), k.stride(0),
                                    k.stride(1), k.stride(2)))


def decode_attention(q, k, v, pos, scale: Optional[float] = None,
                     out=None, work: Optional[Workspace] = None):
    """(S, H, D) attention of each slot's query over its visible cache
    rows. ``out``: an (S, H, D) tensor to write (a new one by default);
    ``work``: a :func:`workspace` for at least these (S, H, L, D) (a new
    one by default)."""
    if not q.is_cuda:
        ref = decode_attention_reference(q, k, v, pos, scale)
        return ref if out is None else out.copy_(ref)
    S, H, L, D = _check(q, k, v, pos)
    lib = _library()
    if not lib.mxt_decode_fits(_DTYPE_CODE[q.dtype], L, D):
        raise MXNetError(f"decode_attention: head_dim {D} at bucket {L} "
                         f"needs more shared memory than a block has")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if out is None:
        out = torch.empty((S, H, D), dtype=q.dtype, device=q.device)
    elif out.stride(2) != 1 or tuple(out.shape) != (S, H, D):
        raise MXNetError("decode_attention: out must be (S, H, D) with a "
                         "contiguous head dim")
    if work is None:
        work = workspace(S, H, L, D, q.device)
    elif work.tickets.numel() < S * H or work.records.numel() < \
            S * H * -(-L // chunk()) * (D + 2) or \
            work.records.device != q.device:
        raise MXNetError(f"decode_attention: the workspace does not hold "
                         f"S={S}, H={H}, L={L}, D={D} on {q.device}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxt_decode_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), q.stride(0), q.stride(1),
            k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
            k.stride(2), pos.data_ptr(), work.records.data_ptr(),
            work.tickets.data_ptr(), out.data_ptr(), out.stride(0),
            out.stride(1), S, H, L, D, scale, int(_vectors(q, k, v)), stream)
    if err != 0:
        raise MXNetError(f"decode_attention kernel launch failed: CUDA error "
                         f"{err}")
    with _COUNT_LOCK:
        launches["decode_attention"] += 1
    return out
