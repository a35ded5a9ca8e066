"""The trainer's multi-tensor optimizer update: the Hopper kernel and its
plain version.

Counterpart of ``mxnet_tpu/gluon/trainer.py:833`` ``_fused_update``: one
program applies SGD (with or without momentum), Adam or AdamW to a group of
parameters, with per-tensor lr, wd and update count, ``rescale_grad`` and
``clip_gradient`` applied to the gradient first. The JAX package leaves the
math to XLA; here ``csrc/multi_tensor.cu`` runs it, built and loaded by
:mod:`mxnet_tpu_torch._kernels`, one launch for every tensor of a call that
shares a layout (the operation, the weight dtype, an f32 master or none),
whatever the groups: a contract of the port (ROADMAP Queue C). The groups
(``aggregate_num``) still decide which parameters the trainer updates
together; they no longer set the launches.

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
the rounded scalars. :func:`update_groups` takes any number of groups;
:func:`launch_plan`, a pure host function, makes one launch a layout in
the order the layouts first appear, each with a record a tensor (its
addresses and size, its lr, wd and bias terms, its group's scalars, and
whether every address is 16-byte aligned, so the kernel may use 16-byte
accesses) and a table of chunks of :data:`CHUNK` elements (a record and
the chunk's index in it) that the kernel's persistent grid walks.
Every launch's tables go into one pinned host buffer, copied to the device
once a call. No ``.item()``, no synchronize. The
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
from typing import NamedTuple, Optional, Sequence

import numpy as _np
import torch

from ...base import MXNetError

__all__ = ["update_groups", "launch_plan", "launches", "KERNELS", "CHUNK",
           "SGD", "SGD_MOM", "ADAM", "ADAMW"]

KERNELS = ("multi_tensor_update",)
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_FN = []
# elements a chunk of the kernel's walk (a multiple of 8), and blocks an SM
CHUNK = 16384
BLOCKS_PER_SM = 8
# csrc/multi_tensor.cu Rec and Chunk
_REC = _np.dtype([("w", "<i8"), ("g", "<i8"), ("master", "<i8"),
                  ("s1", "<i8"), ("s2", "<i8"), ("n", "<i8"),
                  ("lr", "<f4"), ("wd", "<f4"), ("a", "<f4"), ("b", "<f4"),
                  ("rescale", "<f4"), ("lo", "<f4"), ("hi", "<f4"),
                  ("p", "<f4", (5,)), ("clip", "<i4"), ("aligned", "<i4")])
_CHUNK = _np.dtype([("rec", "<i4"), ("index", "<i4")])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's operations: SGD without and with momentum, Adam, AdamW
SGD, SGD_MOM, ADAM, ADAMW = range(4)
_N_STATES = {SGD: 0, SGD_MOM: 1, ADAM: 2, ADAMW: 2}


def _kernel():
    if _FN:
        return _FN[0]
    from ... import _kernels
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _kernels.load("multi_tensor").mxt_multi_tensor_update
    fn.argtypes = [i, i, i, p, p, i, i, i, p]
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


class Launch(NamedTuple):
    """One kernel launch of :func:`launch_plan`: the layout's weight dtype
    and master flag, its records (``_REC``) and chunks (``_CHUNK``)."""
    wdtype: torch.dtype
    master: bool
    recs: _np.ndarray
    chunks: _np.ndarray


def launch_plan(groups: Sequence[tuple], chunk: Optional[int] = None
                ) -> list:
    """The launches that update ``groups`` (as :func:`update_groups` takes
    them): one a layout (weight dtype, master or none), in the order the
    layouts first appear; a record for each tensor with elements, in the
    groups' order, carrying its group's scalars; its chunks ``(record,
    index)`` covering elements ``[index * chunk, (index + 1) * chunk)``.
    Reads only the tensors' addresses, sizes and dtypes: a pure host
    function (it runs on CPU tensors too). ``chunk``: :data:`CHUNK` by
    default."""
    chunk = CHUNK if chunk is None else int(chunk)
    if chunk < 8 or chunk % 8:
        raise MXNetError(f"multi_tensor_update: a chunk must be a positive "
                         f"multiple of 8 elements, got {chunk}")
    layouts = {}
    for tensors, hyps, scalars in groups:
        rescale, lo, hi, clip = scalars[:4]
        for (w, g, m, states), h in zip(tensors, hyps):
            if w.numel() == 0:
                continue
            ptrs = [t.data_ptr() for t in states] + [0, 0]
            addr = (w.data_ptr(), g.data_ptr(),
                    0 if m is None else m.data_ptr(), ptrs[0], ptrs[1])
            rec = addr + (w.numel(),) + tuple(h) + (
                rescale, lo, hi, tuple(scalars[4:9]), int(clip),
                int(all(a % 16 == 0 for a in addr)))
            layouts.setdefault((w.dtype, m is not None), []).append(rec)
    plan = []
    for (wdt, master), recs in layouts.items():
        recs = _np.array(recs, dtype=_REC)
        per = -(-recs["n"] // chunk)
        first = _np.cumsum(per) - per
        chunks = _np.empty(int(per.sum()), dtype=_CHUNK)
        chunks["rec"] = _np.repeat(_np.arange(len(recs)), per)
        chunks["index"] = _np.arange(len(chunks)) - _np.repeat(first, per)
        plan.append(Launch(wdt, master, recs, chunks))
    return plan


def update_groups(op: int, groups: Sequence[tuple]) -> None:
    """Update each group in place: one kernel launch a layout (the weight
    dtype, an f32 master or none) for all of them, after one
    host-to-device copy of every launch's tables. A group is ``(tensors,
    hypers, scalars)``: ``tensors`` a list of ``(weight, grad, master or
    None, states)``; ``hypers`` each tensor's ``(lr, wd, a, b)`` (Adam's
    lr_t in ``a``; AdamW's f32 reciprocals of its bias corrections in ``a``
    and ``b``); ``scalars`` the group's ``(rescale, lo, hi, clip, p0..p4)``
    (clip bounds in the update's math dtype; SGD's momentum, or beta1,
    1 - beta1, beta2, 1 - beta2, eps), every number rounded as the plain
    version rounds it."""
    if op not in _N_STATES:
        raise MXNetError(f"multi_tensor_update: unknown operation {op}")
    devs = {_check(op, tensors)[0] for tensors, _, _ in groups if tensors}
    if len(devs) > 1:
        raise MXNetError("multi_tensor_update: every group must lie on one "
                         "CUDA device")
    chunk = CHUNK
    plan = launch_plan(groups, chunk)
    if plan:
        _launch(op, devs.pop(), plan, chunk)


def _launch(op: int, dev, plan, chunk: int) -> None:
    offsets, size = [], 0
    for lp in plan:
        at = size
        chunks_at = _align(at + lp.recs.nbytes)
        size = _align(chunks_at + lp.chunks.nbytes)
        offsets.append((at, chunks_at))
    host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    for lp, (at, chunks_at) in zip(plan, offsets):
        buf[at:at + lp.recs.nbytes] = lp.recs.view(_np.uint8)
        buf[chunks_at:chunks_at + lp.chunks.nbytes] = \
            lp.chunks.view(_np.uint8)
    fn = _kernel()
    with torch.cuda.device(dev):
        table = host.to(dev, non_blocking=True)
        base = table.data_ptr()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lp, (at, chunks_at) in zip(plan, offsets):
            err = fn(op, _DTYPE_CODE[lp.wdtype], int(lp.master), base + at,
                     base + chunks_at, len(lp.chunks), chunk, BLOCKS_PER_SM,
                     stream)
            if err != 0:
                raise MXNetError(f"multi_tensor_update kernel launch "
                                 f"failed: CUDA error {err}")
            with _COUNT_LOCK:
                launches["multi_tensor_update"] += 1
