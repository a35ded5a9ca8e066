"""Greedy non-maximum suppression's keep mask: the Hopper kernel and its
plain version.

Counterpart of the sweep of ``mxnet_tpu/ops/boxes.py`` ``box_nms``
(``:98-116``): over a batch row's score-sorted corner boxes, row ``i``
suppresses every later box ``j`` whose IoU with it exceeds ``thresh`` and
whose class matches (any class with ``force``), when ``i`` itself is alive
(valid and not suppressed); ``keep = valid & ~suppressed``. The JAX package
runs it as a ``lax.fori_loop`` of N steps over the (B, N, N) matrix;
``csrc/box_nms.cu`` computes the matrix as 64-bit words (pass 1) and sweeps
it a 64-row chunk at a time (pass 2), one call launching both passes. Its
IoU rounds every f32 operation as the plain version does, so the keep mask
equals the plain version's to the bit.

:func:`nms_keep` takes the sorted boxes (B, n, 4), class ids (B, n) and
validity (B, N) (n <= N: the caller restricts the sweep to the first n
rows, its ``topk``, when no later row is valid). On CPU tensors the plain
version runs (the JAX sweep as a torch loop); on CUDA tensors the kernel
runs or :class:`MXNetError` is raised. Each call on the card adds one to
:data:`launches` (its two passes are one kernel of this table). Its mask
workspace, (B, n, ceil(n / 64)) words, is allocated per call. No host
synchronization.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ...base import MXNetError

__all__ = ["nms_keep", "nms_keep_reference", "pairwise_iou", "launches",
           "KERNELS"]

KERNELS = ("box_nms",)
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_FN = []
# the sweep's suppressed set lives in shared memory: ceil(n / 64) words
_MAX_ROWS = 200 * 1024 // 8 * 64


def _kernel():
    if not _FN:
        from ... import _kernels
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = _kernels.load("box_nms").mxt_box_nms
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def pairwise_iou(a, b):
    """a (..., M, 4), b (..., N, 4) corner boxes -> (..., M, N) IoU, in the
    JAX package's order of operations (``boxes.py:_pairwise_iou``)."""
    ax1, ay1, ax2, ay2 = a[..., :, None, :].unbind(-1)
    bx1, by1, bx2, by2 = b[..., None, :, :].unbind(-1)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_keep_reference(boxes, cls, valid, thresh: float, force: bool):
    """The plain version: the JAX package's sweep, one row a step, each
    row's IoUs computed as the kernel computes them. Returns (B, N) bool."""
    B, n = boxes.shape[:2]
    N = valid.shape[1]
    suppressed = torch.zeros((B, n), dtype=torch.bool, device=boxes.device)
    cols = torch.arange(n, device=boxes.device)
    for i in range(n):
        alive = ~suppressed[:, i] & valid[:, i]
        row = (pairwise_iou(boxes[:, i:i + 1], boxes)[:, 0] > thresh) \
            & (cols > i)
        if not force:
            row &= cls[:, i:i + 1] == cls
        suppressed |= row & alive[:, None]
    keep = torch.zeros((B, N), dtype=torch.bool, device=boxes.device)
    keep[:, :n] = valid[:, :n] & ~suppressed
    return keep


def nms_keep(boxes, cls, valid, thresh: float, force: bool):
    """(B, N) bool keep mask of greedy NMS over the score-sorted ``boxes``
    (B, n, 4) corner and ``cls`` (B, n), ``valid`` (B, N), n <= N."""
    if not boxes.is_cuda:
        return nms_keep_reference(boxes, cls, valid, thresh, force)
    B, n = boxes.shape[:2]
    N = valid.shape[1]
    if not (cls.device == valid.device == boxes.device):
        raise MXNetError("box_nms: boxes, classes and validity must lie on "
                         "one CUDA device")
    if boxes.dtype != torch.float32 or cls.dtype != torch.float32 or \
            tuple(cls.shape) != (B, n) or boxes.shape[2] != 4 or \
            valid.shape[0] != B or not 0 < n <= N:
        raise MXNetError(f"box_nms: boxes {tuple(boxes.shape)} "
                         f"{boxes.dtype}, classes {tuple(cls.shape)} "
                         f"{cls.dtype}, validity {tuple(valid.shape)}: "
                         "expected f32 (B, n, 4), f32 (B, n), (B, N), "
                         "0 < n <= N")
    if n > _MAX_ROWS or B > 65535:
        raise MXNetError(f"box_nms: {B} x {n} rows exceed the kernel's "
                         f"65535 x {_MAX_ROWS}")
    boxes, cls = boxes.contiguous(), cls.contiguous()
    valid8 = valid.to(torch.uint8).contiguous()
    mask = torch.empty((B, n, -(-n // 64)), dtype=torch.int64,
                       device=boxes.device)
    keep = torch.empty((B, N), dtype=torch.uint8, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = _kernel()(boxes.data_ptr(), cls.data_ptr(), valid8.data_ptr(),
                        mask.data_ptr(), keep.data_ptr(), B, N, n,
                        float(thresh), int(bool(force)), stream)
    if err != 0:
        raise MXNetError(f"box_nms kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches["box_nms"] += 1
    return keep.bool()
