"""int8 x int8 -> int32 convolution and fully connected product: the Hopper
kernel and its plain version.

Counterpart of the int8 products of ``mxnet_tpu/ops/quantization.py``:
``quantized_conv`` (``:203-255``, ``lax.conv_general_dilated``) and
``quantized_fully_connected`` (``:157-200``, ``lax.dot_general``), both
with ``preferred_element_type=int32``. The JAX package leaves them to XLA
and the TPU's int8 matrix unit; PyTorch has no int8 convolution on the
card, so ``csrc/int8_conv.cu`` computes both: one implicit-GEMM kernel on
the int8 tensor cores (``mma.sync`` m16n8k32), the FC layer its GEMM case.
Every argument of the JAX op is taken: stride, padding, dilation, groups,
1-, 2- and 3-d inputs, and the six layouts of the JAX package's
``ops/nn.py:_CONV_DIMNUMS`` (data NCW / NWC / NCHW / NHWC / NCDHW / NDHWC,
weight OI* for channels-first data, *IO for channels-last).

The kernel reads its input channels-last and its weight as (O, taps and
channels) rows, and writes a channels-last int32 output. So for a
channels-first layout the result is a view, logically in that layout, of
a channels-last tensor, and the input is read without a copy when its
memory is channels-last already (what this kernel writes, and what every
elementwise op keeps); otherwise the wrapper copies it and counts the copy
in :data:`copies` (``"input"``), as it counts a weight it has to repack
(``"weight"``: a 3x3 or 7x7 OIHW weight, or a row not a multiple of 16
bytes, zero-padded). The int32 bias, when given, is added in the
kernel's epilogue.

The plain version computes the same product on the int8 values in float64
through the library and casts to int32: exact, since |acc| <= K * 127^2 <
2^53. On CPU tensors it runs; on CUDA tensors the kernel runs or
:class:`MXNetError` is raised, nothing falls back. Each launch adds one to
:data:`launches`. No host synchronization: a CUDA graph captures it.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence

import torch
import torch.nn.functional as F

from ...base import MXNetError

__all__ = ["conv", "fully_connected", "conv_reference",
           "fully_connected_reference", "launches", "copies", "KERNELS",
           "LAYOUTS"]

KERNELS = ("int8_conv",)
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
# operand copies the wrapper made for the kernel's layout
copies = {"input": 0, "weight": 0}
_COUNT_LOCK = threading.Lock()
_FN = []
# data layout -> (channels first, spatial dims); the weight is OI* for a
# channels-first layout and *IO for a channels-last one (_CONV_DIMNUMS)
LAYOUTS = {"NCW": (True, 1), "NWC": (False, 1), "NCHW": (True, 2),
           "NHWC": (False, 2), "NCDHW": (True, 3), "NDHWC": (False, 3)}
_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _kernel():
    if not _FN:
        from ... import _kernels
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = _kernels.load("int8_conv").mxt_int8_conv
        fn.argtypes = [p, p, p, p] + [i] * 25 + [p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _layout(layout: str, ndim: int):
    if layout not in LAYOUTS or LAYOUTS[layout][1] != ndim:
        raise MXNetError(f"quantized_conv: layout {layout!r} does not fit "
                         f"{ndim} spatial dims (one of {sorted(LAYOUTS)})")
    return LAYOUTS[layout][0]


def _channels_first(w, first: bool):
    """The weight as (O, I/groups, k...) whatever its layout."""
    if first:
        return w
    n = w.ndim
    return w.permute(n - 1, n - 2, *range(n - 2))


def _out_size(i, k, s, p, d):
    return (i + 2 * p - d * (k - 1) - 1) // s + 1


def conv_reference(x, w, bias32=None, stride=(1,), pad=(0,), dilate=(1,),
                   groups: int = 1, layout: str = "NCHW"):
    """The plain version: the convolution of the int8 values in float64
    through the library, cast to int32 (exact), plus ``bias32``; the result
    in ``layout``."""
    nd = x.ndim - 2
    first = _layout(layout, nd)
    xf = x.double() if first else x.double().movedim(-1, 1)
    wf = _channels_first(w, first).double()
    y = _CONV_FNS[nd](xf, wf, None, tuple(stride), tuple(pad), tuple(dilate),
                      groups).to(torch.int32)
    if bias32 is not None:
        y = y + bias32.reshape((1, -1) + (1,) * nd)
    return y if first else y.movedim(1, -1).contiguous()


def fully_connected_reference(x, w, bias32=None):
    """The plain version of the product: ``x (M, K) . w (N, K)^T`` in
    float64, cast to int32, plus ``bias32``."""
    y = (x.double() @ w.double().t()).to(torch.int32)
    return y if bias32 is None else y + bias32


def _check(x, w, bias32):
    if not (x.is_cuda and w.device == x.device):
        raise MXNetError("int8_conv: data and weight must lie on one CUDA "
                         "device")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise MXNetError(f"int8_conv: data and weight must be int8, got "
                         f"{x.dtype} and {w.dtype}")
    if bias32 is not None and (bias32.dtype != torch.int32
                               or bias32.device != x.device):
        raise MXNetError("int8_conv: the bias must be int32 on the data's "
                         "device")


def _packed_weight(w5):
    """(O, Kp) int8 rows of K taps (kd, kh, kw, c), K padded to a multiple
    of 16; a copy (counted) unless ``w5``'s rows already are that."""
    O = w5.shape[0]
    K = w5[0].numel()
    wk = w5.reshape(O, K) if w5.is_contiguous() else None
    if wk is not None and K % 16 == 0 and wk.data_ptr() % 16 == 0:
        return wk, K
    Kp = -(-K // 16) * 16
    out = torch.zeros((O, Kp), dtype=torch.int8, device=w5.device)
    out[:, :K] = w5.reshape(O, K)
    with _COUNT_LOCK:
        copies["weight"] += 1
    return out, Kp


def _launch(x5, wp, Kp, bias32, y, geom, groups: int) -> None:
    """One kernel launch over channels-last x5 (N, D, H, W, C) into y."""
    N, D, H, W, C = x5.shape
    (OD, OH, OW), O, (KD, KH, KW), st, pd, dl = geom
    Cg = C // groups
    vec = int(Cg % 16 == 0 and x5.data_ptr() % 16 == 0)
    bn = 64 if O // groups <= 64 else 128
    with torch.cuda.device(x5.device):
        stream = torch.cuda.current_stream(x5.device).cuda_stream
        err = _kernel()(
            x5.data_ptr(), wp.data_ptr(),
            None if bias32 is None else bias32.data_ptr(), y.data_ptr(),
            N, D, H, W, C, OD, OH, OW, O, KD, KH, KW, *st, *pd, *dl,
            groups, Kp, vec, bn, stream)
    if err != 0:
        raise MXNetError(f"int8_conv kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        launches["int8_conv"] += 1


def _pad3(v: Sequence[int], fill: int):
    return (fill,) * (3 - len(v)) + tuple(v)


def conv(x, w, bias32=None, stride=(1,), pad=(0,), dilate=(1,),
         groups: int = 1, layout: str = "NCHW"):
    """int8 convolution -> int32 (+ ``bias32``), ``x`` and ``w`` in
    ``layout``'s data and weight layouts; the result logically in
    ``layout`` (on the card, its memory channels-last)."""
    if not x.is_cuda:
        return conv_reference(x, w, bias32, stride, pad, dilate, groups,
                              layout)
    _check(x, w, bias32)
    nd = x.ndim - 2
    first = _layout(layout, nd)
    wc = _channels_first(w, first)
    O, Cg = wc.shape[0], wc.shape[1]
    N = x.shape[0]
    C = x.shape[1] if first else x.shape[-1]
    sp = tuple(x.shape[2:] if first else x.shape[1:-1])
    if groups < 1 or C != Cg * groups or O % groups:
        raise MXNetError(f"quantized_conv: {C} input channels, weight "
                         f"{tuple(wc.shape)} and num_group {groups} do not "
                         "agree")
    ks = tuple(wc.shape[2:])
    osp = tuple(_out_size(i, k, s, p, d) for i, k, s, p, d in
                zip(sp, ks, stride, pad, dilate))
    y = torch.empty((N,) + osp + (O,), dtype=torch.int32, device=x.device)
    if y.numel():
        xl = x.movedim(1, -1) if first else x
        if not xl.is_contiguous():
            xl = xl.contiguous()
            with _COUNT_LOCK:
                copies["input"] += 1
        wp, Kp = _packed_weight(wc.movedim(1, -1))
        geom = (_pad3(osp, 1), O, _pad3(ks, 1), _pad3(stride, 1),
                _pad3(pad, 0), _pad3(dilate, 1))
        _launch(xl.reshape((N,) + _pad3(sp, 1) + (C,)), wp, Kp, bias32, y,
                geom, groups)
    return y.movedim(-1, 1) if first else y


def fully_connected(x, w, bias32=None):
    """``x (M, K) . w (N, K)^T`` -> int32 (M, N) (+ ``bias32``): the
    kernel's GEMM case."""
    if not x.is_cuda:
        return fully_connected_reference(x, w, bias32)
    _check(x, w, bias32)
    M, K = x.shape
    N = w.shape[0]
    if w.shape[1] != K:
        raise MXNetError(f"quantized_fully_connected: data {tuple(x.shape)} "
                         f"and weight {tuple(w.shape)} do not agree")
    y = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if not y.numel():
        return y
    if not x.is_contiguous():
        x = x.contiguous()
        with _COUNT_LOCK:
            copies["input"] += 1
    wp, Kp = _packed_weight(w)
    geom = ((1, 1, 1), N, (1, 1, 1), (1, 1, 1), (0, 0, 0), (1, 1, 1))
    _launch(x.reshape(M, 1, 1, 1, K), wp, Kp, bias32, y, geom, 1)
    return y
