"""The trainer's multi-tensor optimizer update: the Hopper kernel and its
plain version.

Counterpart of ``mxnet_tpu/gluon/trainer.py:833`` ``_fused_update``: one
program applies SGD (with or without momentum), Adam or AdamW to a group of
parameters, with per-tensor lr, wd and update count, ``rescale_grad`` and
``clip_gradient`` applied to the gradient first. The JAX package leaves the
math to XLA; here ``csrc/multi_tensor.cu`` runs it, built and loaded by
:mod:`mxnet_tpu_torch._kernels`, one launch a group.

Covered: f32 weights; bf16 and fp16 weights with an f32
:class:`~mxnet_tpu_torch.optimizer.MasterWeightState` (the master is
updated, then rounded to the weight); bf16 and fp16 weights alone. The
kernel writes the bits of the plain version (the eager per-parameter
``Optimizer._plain_update``): it rounds each f32
operation, and each value the eager version keeps in a 16-bit tensor, as
PyTorch does, with every Python scalar rounded on the host as PyTorch
rounds it (to f32; a division by one becomes a multiplication by its f32
reciprocal; a clip bound of a 16-bit gradient goes to f32, then 16 bits).

The wrapper takes tensors and numbers only: the optimizer
(``Optimizer.update_group``) chooses the route, the operation code and
the rounded scalars. :func:`update_groups` takes any number of groups,
packs every group's table (tensor addresses, sizes, per-tensor lr, wd and
bias terms) into one pinned host buffer, copies it to the device once, and
launches the kernel once a group. No ``.item()``, no synchronize. The
tables hold the addresses of this call's tensors, so a replaced tensor
(``load_states``, ``cast``, ``reset_ctx``) is simply read at its new
address. Every tensor must lie on one CUDA device: the plain version on
CPU tensors is ``Optimizer._plain_update``. A tensor the kernel does not
take (f64, strided, on the CPU) raises :class:`MXNetError`; nothing falls
back. Each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import numpy as _np
import torch

from ...base import MXNetError

__all__ = ["update_groups", "launches", "KERNELS", "CHUNK", "SGD", "SGD_MOM",
           "ADAM", "ADAMW"]

KERNELS = ("multi_tensor_update",)
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_FN = []
CHUNK = 1024                   # elements a block (csrc/multi_tensor.cu Args)
_REC = 7                       # int64 a record: w, g, master, s1, s2, n, chunk0
_HYP = 4                       # f32 a record: lr, wd, a, b
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's operations: SGD without and with momentum, Adam, AdamW
SGD, SGD_MOM, ADAM, ADAMW = range(4)
_N_STATES = {SGD: 0, SGD_MOM: 1, ADAM: 2, ADAMW: 2}


def _kernel():
    if _FN:
        return _FN[0]
    from ... import _kernels
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _kernels.load("multi_tensor").mxt_multi_tensor_update
    fn.argtypes = [i, i, i, p, p, i, ctypes.c_longlong, i, f, f, f, i, f, f,
                   f, f, f, p]
    fn.restype = ctypes.c_int
    _FN.append(fn)
    return fn


def _check(op: int, tensors) -> tuple:
    """Every tensor of the group on one CUDA device, contiguous, of the
    weight's size, of the dtypes the operation keeps; returns the group's
    (device, weight dtype, master)."""
    w0, _, m0, _ = tensors[0]
    dev, wdt, master = w0.device, w0.dtype, m0 is not None
    if wdt not in _DTYPE_CODE or (master and wdt == torch.float32):
        raise MXNetError(f"multi_tensor_update: weights of dtype {wdt} "
                         f"{'with' if master else 'without'} a master are "
                         "not covered (f32; bf16 or fp16 with or without an "
                         "f32 master)")
    math = torch.float32 if master else wdt
    want = {SGD: (), SGD_MOM: (math,), ADAM: (torch.float32,) * 2,
            ADAMW: (torch.float32,) * 2}[op]
    for k, (w, g, m, states) in enumerate(tensors):
        if (w.dtype, m is not None) != (wdt, master):
            raise MXNetError(f"multi_tensor_update: tensor {k} ({w.dtype}, "
                             f"{'a' if m is not None else 'no'} master) does "
                             f"not share the group's layout ({wdt}, "
                             f"{'a' if master else 'no'} master)")
        ts = [w, g] + ([m] if master else []) + list(states)
        if not w.is_cuda or any(t.device != dev for t in ts):
            raise MXNetError("multi_tensor_update: every tensor of a group "
                             "must lie on one CUDA device")
        if g.dtype != wdt or (master and m.dtype != torch.float32) or \
                tuple(t.dtype for t in states) != want:
            raise MXNetError(
                f"multi_tensor_update: tensor {k}: gradient {g.dtype}, "
                f"master {None if m is None else m.dtype}, states "
                f"{[t.dtype for t in states]}; expected gradient {wdt}"
                f"{', an f32 master' if master else ''}, states {want}")
        if any(not t.is_contiguous() or t.numel() != w.numel() for t in ts):
            raise MXNetError(f"multi_tensor_update: tensor {k}: every "
                             "tensor must be contiguous and of the weight's "
                             "size")
    return dev, wdt, master


def _align(n: int) -> int:
    return -(-n // 16) * 16


def update_groups(op: int, groups: Sequence[tuple]) -> None:
    """Update each group in place, one kernel launch a group, after one
    host-to-device copy of every group's table. A group is ``(tensors,
    hypers, scalars)``: ``tensors`` a list of ``(weight, grad, master or
    None, states)``; ``hypers`` each tensor's ``(lr, wd, a, b)`` (Adam's
    lr_t in ``a``; AdamW's f32 reciprocals of its bias corrections in ``a``
    and ``b``); ``scalars`` the group's ``(rescale, lo, hi, clip, p0..p4)``
    (clip bounds in the update's math dtype; SGD's momentum, or beta1,
    1 - beta1, beta2, 1 - beta2, eps), every number rounded as the plain
    version rounds it."""
    if op not in _N_STATES:
        raise MXNetError(f"multi_tensor_update: unknown operation {op}")
    plans, size = [], 0
    for tensors, hyps, scalars in groups:
        if not tensors:
            continue
        dev, wdt, master = _check(op, tensors)
        recs, hyp, chunks = [], [], 0
        for (w, g, m, states), h in zip(tensors, hyps):
            if w.numel() == 0:
                continue
            ptrs = [t.data_ptr() for t in states] + [0, 0]
            recs.append((w.data_ptr(), g.data_ptr(),
                         0 if m is None else m.data_ptr(), ptrs[0], ptrs[1],
                         w.numel(), chunks))
            hyp.append(tuple(h))
            chunks += -(-w.numel() // CHUNK)
        if not recs:
            continue
        at = size
        size = _align(at + 8 * _REC * len(recs))
        hyp_at = size
        size = _align(hyp_at + 4 * _HYP * len(recs))
        plans.append((dev, wdt, master, tuple(scalars), recs, hyp, chunks,
                      at, hyp_at))
    if plans:
        _launch(op, plans, size)


def _launch(op: int, plans, size: int) -> None:
    dev = plans[0][0]
    if any(p[0] != dev for p in plans):
        raise MXNetError("multi_tensor_update: every group must lie on one "
                         "CUDA device")
    host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for _, _, _, _, recs, hyp, _, at, hyp_at in plans:
        n = len(recs)
        buf[at:at + 8 * _REC * n] = _np.asarray(
            recs, _np.int64).reshape(-1).view(_np.uint8)
        buf[hyp_at:hyp_at + 4 * _HYP * n] = _np.asarray(
            hyp, _np.float32).reshape(-1).view(_np.uint8)
    fn = _kernel()
    with torch.cuda.device(dev):
        table = host.to(dev, non_blocking=True)
        base = table.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for _, wdt, master, sc, recs, _, chunks, at, hyp_at in plans:
            err = fn(op, _DTYPE_CODE[wdt], int(master), base + at,
                     base + hyp_at, len(recs), chunks, CHUNK, *sc, stream)
            if err != 0:
                raise MXNetError(f"multi_tensor_update kernel launch "
                                 f"failed: CUDA error {err}")
            with _COUNT_LOCK:
                launches["multi_tensor_update"] += 1
