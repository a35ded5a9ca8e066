"""int8 convolution and fully connected product, and the whole quantized
layer around them: the Hopper kernel and its plain versions.

Counterpart of the int8 products of ``mxnet_tpu/ops/quantization.py``:
``quantized_conv`` (``:203-255``, ``lax.conv_general_dilated``) and
``quantized_fully_connected`` (``:157-200``, ``lax.dot_general``), both
with ``preferred_element_type=int32``, and of the chain that
``mxnet_tpu/contrib/quantization.py``'s ``QuantizedConv`` /
``QuantizedDense`` run around them (``quantize_v2``, the product,
``dequantize``, the activation), which XLA fuses into one program. The JAX
package leaves them to XLA and the TPU's int8 matrix unit; PyTorch has no
int8 convolution on the card, so ``csrc/int8_conv.cu`` computes them: one
implicit-GEMM kernel on the int8 tensor cores (``wgmma`` s8, its operands
by TMA or gathered by a producer warpgroup), the FC layer its GEMM case,
in two variants:

- :func:`conv` / :func:`fully_connected`: int8 in, int32 out (+ the int32
  bias), the quantized operators' product;
- :func:`conv_f32` / :func:`fully_connected_f32`: f32 in, f32 out, a whole
  quantized layer: ``q = clamp(rint(x * scale), -127, 127)`` as the kernel
  stages its input, ``float(acc + bias32) * step`` and the relu in its
  epilogue, each f32 operation the operators' own, so the bits equal the
  unfused ``quantize_v2`` -> product -> ``dequantize`` -> activation.
  ``scale`` and ``step`` are 0-d device tensors: nothing is read back to
  the host, and a CUDA graph captures the launch.

Every argument of the JAX op is taken: stride, padding, dilation, groups,
1-, 2- and 3-d inputs, and the six layouts of the JAX package's
``ops/nn.py:_CONV_DIMNUMS`` (data NCW / NWC / NCHW / NHWC / NCDHW / NDHWC,
weight OI* for channels-first data, *IO for channels-last).

:func:`int8_plan`, a pure function of the shape, picks how the kernel's A
operand reaches shared memory (``route``): by TMA where it is a plain
(positions, channels) matrix (a 1x1 stride-1 convolution, the FC layer);
f32 in runs of whole 32-channel pieces of a tap, one bulk copy a run,
where a group's channels are a multiple of 32; in 16-byte pieces where
they fill whole pieces; element by element otherwise; the reduction's order (channels-last ``(kd, kh, kw,
c)``, or ``(c, kd, kh, kw)`` over a channels-first input taken element by
element: conv1's NCHW image is read as it lies); the tile's output
channels; and how many blocks of a thread-block cluster split the
reduction where the tiles alone leave SMs idle.

The kernel writes a channels-last output, so for a channels-first layout
the result is a view, logically in that layout, of a channels-last tensor.
It reads its input in place when its memory is what the route takes
(channels-last: what this kernel writes and every elementwise op keeps;
channels-first contiguous for the ``(c, kd, kh, kw)`` order); otherwise
the wrapper copies it and counts the copy in :data:`copies` (``"input"``),
as it counts a weight it has to repack per call (``"weight"``: a 3x3 or
7x7 weight whose rows are not the reduction's order, or not a multiple of
16 bytes). A quantized layer packs its weight once, at construction
(:func:`pack_weight`), and passes it as ``packed``.

The plain versions compute the product on the int8 values in float64
through the library and cast to int32: exact, since |acc| <= K * 127^2 <
2^53; the f32 variant's plain version is the operator sequence on it. On
CPU tensors they run; on CUDA tensors the kernel runs or
:class:`MXNetError` is raised, nothing falls back. Each launch adds one to
:data:`launches`, under the variant's name: ``"int8_conv"`` for an int8
input, ``"int8_conv_f32"`` for an f32 one. No host synchronization: a
CUDA graph captures it.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from ...base import MXNetError

__all__ = ["conv", "fully_connected", "conv_f32", "fully_connected_f32",
           "conv_reference", "fully_connected_reference",
           "conv_f32_reference", "fully_connected_f32_reference",
           "pack_weight", "pack_layer_weight", "Packed", "int8_plan",
           "Plan", "launches",
           "copies", "KERNELS", "LAYOUTS"]

# the kernel's two variants by its input: int8 (the operators' product)
# and f32 (a whole quantized layer)
KERNELS = ("int8_conv", "int8_conv_f32")
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
# the kernel's tile (csrc/int8_conv.cu): 128 positions, a reduction step of
# 128, 64 or 128 output channels; clusters of up to 8 blocks split K
BM, BK = 128, 128
SPLITS = (1, 2, 4, 8)
ROUTES = ("tma", "chunk", "elem", "runs")
_SMS = {}


def _kernel():
    if not _FN:
        from ... import _kernels
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = _kernels.load("int8_conv").mxt_int8_conv
        fn.argtypes = [p] * 6 + [i] * 30 + [p]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


class Plan(NamedTuple):
    """A launch of the kernel: A's ``route`` (``"tma"``, ``"chunk"``,
    ``"elem"``, ``"runs"``), the reduction order ``cf`` ((c, kd, kh, kw) over a
    channels-first input, else (kd, kh, kw, c)), the tile's output channels
    ``bn``, the cluster's ``split`` of the reduction, its 128-wide
    ``steps`` and the output ``tiles``."""
    route: str
    cf: bool
    bn: int
    split: int
    steps: int
    tiles: int


def int8_plan(M: int, C: int, Og: int, G: int, K: int, one: bool,
              esize: int, channels_first: bool, sms: int = 132) -> Plan:
    """The kernel's launch for M output positions, C input and G * Og output
    channels in G groups, K = taps * C / G a group's reduction, ``one`` a
    1x1 stride-1 unpadded convolution (or the FC layer), input elements of
    ``esize`` bytes (1 int8, 4 f32), the layout's channels first, on a card
    of ``sms`` SMs.

    The split: with one block an SM, a tile's time is its steps, so a
    launch takes (waves of blocks) x (steps a block, plus about one for the
    cluster's combine where the reduction is split); the smallest such
    split of 1, 2, 4, 8 (at most the steps), the smaller on a tie."""
    Cg = C // G
    if one and (C * esize) % 16 == 0:
        route = "tma"
    elif esize == 4 and Cg % 32 == 0:
        route = "runs"
    elif Cg % (16 // esize) == 0:
        route = "chunk"
    else:
        route = "elem"
    bn = 64 if Og <= 64 else 128
    tiles = -(-M // BM) * -(-Og // bn) * G
    steps = -(-K // BK)
    best = None
    for s in SPLITS:
        if s > steps:
            break
        cost = -(-tiles * s // sms) * (-(-steps // s) + (s > 1))
        if best is None or cost < best[0]:
            best = (cost, s)
    return Plan(route, route == "elem" and channels_first, bn, best[1], steps,
                tiles)


def _sms(device) -> int:
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


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


def _pad3(v: Sequence[int], fill: int):
    return (fill,) * (3 - len(v)) + tuple(v)


# ------------------------------------------------------------ plain versions
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


def _codes(x, scale):
    """``quantize_v2``'s int8 codes of ``x`` at ``scale`` (a 0-d f32
    tensor): ``ops/quantization.int8_codes``."""
    from .. import quantization
    return quantization.int8_codes(x.float(), scale)


def _dequantize(y, step, relu: bool):
    """``dequantize`` of an int32 accumulator by its step (a 0-d f32
    tensor: ``ops/quantization.dequantize_by``), then the relu."""
    from .. import quantization
    out = quantization.dequantize_by(y, step)
    return torch.relu(out) if relu else out


def conv_f32_reference(x, w, bias32, scale, step, stride=(1,), pad=(0,),
                       dilate=(1,), groups: int = 1, layout: str = "NCHW",
                       relu: bool = False):
    """The plain version of a quantized convolution layer: its input's
    int8 codes, :func:`conv_reference`, ``dequantize``, the relu."""
    y = conv_reference(_codes(x, scale), w, bias32, stride, pad, dilate,
                       groups, layout)
    return _dequantize(y, step, relu)


def fully_connected_f32_reference(x, w, bias32, scale, step,
                                  relu: bool = False):
    """The plain version of a quantized fully connected layer."""
    y = fully_connected_reference(_codes(x, scale), w, bias32)
    return _dequantize(y, step, relu)


# ------------------------------------------------------------------- packing
class Packed(NamedTuple):
    """A weight as the kernel reads it: (O, Kp) int8 rows of the reduction
    in ``cf``'s order, K zero-padded to ``Kp``, a multiple of 16."""
    w: torch.Tensor
    Kp: int
    cf: bool


def pack_weight(w, layout: str, cf: bool):
    """``w`` (int8, in ``layout``'s weight layout) packed for the kernel.
    Returns ``(packed, copied)``: the rows are ``w``'s own memory where
    they already are the packed rows (a 1x1 weight, or cf's OI* order, K a
    multiple of 16), else a copy."""
    nd = w.ndim - 2
    first = _layout(layout, nd)
    wc = _channels_first(w, first)
    w5 = wc if cf else wc.movedim(1, -1)
    O, K = w5.shape[0], w5[0].numel()
    wk = w5.reshape(O, K) if w5.is_contiguous() else None
    if wk is not None and K % 16 == 0 and wk.data_ptr() % 16 == 0:
        return Packed(wk, K, cf), False
    Kp = -(-K // 16) * 16
    out = torch.zeros((O, Kp), dtype=torch.int8, device=w.device)
    out[:, :K] = w5.reshape(O, K)
    return Packed(out, Kp, cf), True


def pack_layer_weight(w, stride=(1,), pad=(0,), groups: int = 1,
                      layout: str = "NCHW", esize: int = 4) -> Packed:
    """A layer's weight ``w`` packed once, in the reduction order that
    :func:`int8_plan` takes for its inputs of ``esize``-byte elements."""
    nd = w.ndim - 2
    first = _layout(layout, nd)
    wc = _channels_first(w, first)
    O, Cg = wc.shape[0], wc.shape[1]
    one = all(k == 1 for k in wc.shape[2:]) and all(v == 1 for v in stride) \
        and all(v == 0 for v in pad)
    cf = int8_plan(1, Cg * groups, O // groups, groups,
                   math.prod(wc.shape[1:]), one, esize, first).cf
    return pack_weight(w, layout, cf)[0]


def _count(what: str) -> None:
    with _COUNT_LOCK:
        copies[what] += 1


# -------------------------------------------------------------------- launch
def _check(x, w, bias32, in_f32: bool):
    if not (x.is_cuda and w.device == x.device):
        raise MXNetError("int8_conv: data and weight must lie on one CUDA "
                         "device")
    want = torch.float32 if in_f32 else torch.int8
    if x.dtype != want or w.dtype != torch.int8:
        raise MXNetError(f"int8_conv: data must be {want} and the weight "
                         f"int8, got {x.dtype} and {w.dtype}")
    if bias32 is not None and (bias32.dtype != torch.int32
                               or bias32.device != x.device):
        raise MXNetError("int8_conv: the bias must be int32 on the data's "
                         "device")


def _scalar(t, x, what: str):
    if not (isinstance(t, torch.Tensor) and t.numel() == 1
            and t.dtype == torch.float32 and t.device == x.device):
        raise MXNetError(f"int8_conv: the {what} must be a one-element f32 "
                         "tensor on the data's device")
    return t


class _Shape(NamedTuple):
    first: bool
    N: int
    C: int
    sp: tuple
    O: int
    Cg: int
    ks: tuple
    osp: tuple


def _shape(x, w, stride, pad, dilate, groups, layout) -> _Shape:
    nd = x.ndim - 2
    first = _layout(layout, nd)
    wc = _channels_first(w, first)
    O, Cg = wc.shape[0], wc.shape[1]
    C = x.shape[1] if first else x.shape[-1]
    sp = tuple(x.shape[2:] if first else x.shape[1:-1])
    if groups < 1 or C != Cg * groups or O % groups:
        raise MXNetError(f"quantized_conv: {C} input channels, weight "
                         f"{tuple(wc.shape)} and num_group {groups} do not "
                         "agree")
    ks = tuple(wc.shape[2:])
    osp = tuple(_out_size(i, k, s, p, d) for i, k, s, p, d in
                zip(sp, ks, stride, pad, dilate))
    return _Shape(first, x.shape[0], C, sp, O, Cg, ks, osp)


def _plan(s: _Shape, stride, pad, groups, esize, device) -> Plan:
    one = all(k == 1 for k in s.ks) and all(v == 1 for v in stride) \
        and all(v == 0 for v in pad)
    K = math.prod(s.ks) * s.Cg
    return int8_plan(s.N * math.prod(s.osp), s.C, s.O // groups, groups, K,
                     one, esize, s.first, _sms(device))


def _input(x, s: _Shape, plan: Plan):
    """x as the route reads it: (N, C, D, H, W) contiguous for cf, else
    (N, D, H, W, C) contiguous; 16-byte aligned unless element by element.
    A copy where its memory is not that, counted."""
    if plan.cf:
        xl = x
    else:
        xl = x.movedim(1, -1) if s.first else x
    if not xl.is_contiguous() or (plan.route != "elem"
                                  and xl.data_ptr() % 16):
        xl = xl.contiguous() if not xl.is_contiguous() else xl.clone()
        _count("input")
    sp3 = _pad3(s.sp, 1)
    return xl.reshape((s.N, s.C) + sp3 if plan.cf else (s.N,) + sp3 + (s.C,))


def _launch(x5, packed: Packed, bias32, y, s: _Shape, stride, pad, dilate,
            groups: int, plan: Plan, scale=None, step=None,
            relu: bool = False, fn=None) -> None:
    """One kernel launch into y (N * positions, O), channels-last; ``fn``:
    an experiment's build of the entry (not counted)."""
    if packed.cf != plan.cf:
        raise MXNetError("int8_conv: the packed weight's reduction order "
                         "is not the plan's")
    N, C = s.N, s.C
    sp3, os3, ks3 = _pad3(s.sp, 1), _pad3(s.osp, 1), _pad3(s.ks, 1)
    with torch.cuda.device(x5.device):
        stream = torch.cuda.current_stream(x5.device).cuda_stream
        err = (fn or _kernel())(
            x5.data_ptr(), packed.w.data_ptr(),
            None if bias32 is None else bias32.data_ptr(), y.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if step is None else step.data_ptr(),
            N, *sp3, C, *os3, s.O, *ks3, *_pad3(stride, 1), *_pad3(pad, 0),
            *_pad3(dilate, 1), groups, packed.Kp,
            int(x5.dtype == torch.float32), int(y.dtype == torch.float32),
            int(relu), ROUTES.index(plan.route), int(plan.cf), plan.bn,
            plan.split, stream)
    if err != 0:
        raise MXNetError(f"int8_conv kernel launch failed: CUDA error {err}")
    if fn is None:
        with _COUNT_LOCK:
            launches[KERNELS[x5.dtype == torch.float32]] += 1


def _conv(x, w, bias32, stride, pad, dilate, groups, layout, packed,
          scale, step, relu, fn=None):
    """The kernel over ``x`` (int8, or f32 with ``scale``) into an int32
    (or, with ``step``, f32) output in ``layout``."""
    in_f32 = scale is not None
    _check(x, w, bias32, in_f32)
    s = _shape(x, w, stride, pad, dilate, groups, layout)
    out = torch.float32 if step is not None else torch.int32
    y = torch.empty((s.N,) + s.osp + (s.O,), dtype=out, device=x.device)
    if y.numel():
        plan = _plan(s, stride, pad, groups, 4 if in_f32 else 1, x.device)
        if packed is None or packed.cf != plan.cf:
            packed, copied = pack_weight(w, layout, plan.cf)
            if copied:
                _count("weight")
        _launch(_input(x, s, plan), packed, bias32, y, s, stride, pad,
                dilate, groups, plan, scale, step, relu, fn)
    return y.movedim(-1, 1) if s.first else y


def conv(x, w, bias32=None, stride=(1,), pad=(0,), dilate=(1,),
         groups: int = 1, layout: str = "NCHW"):
    """int8 convolution -> int32 (+ ``bias32``), ``x`` and ``w`` in
    ``layout``'s data and weight layouts; the result logically in
    ``layout`` (on the card, its memory channels-last)."""
    if not x.is_cuda:
        return conv_reference(x, w, bias32, stride, pad, dilate, groups,
                              layout)
    return _conv(x, w, bias32, tuple(stride), tuple(pad), tuple(dilate),
                 groups, layout, None, None, None, False)


def conv_f32(x, w, bias32, scale, step, stride=(1,), pad=(0,), dilate=(1,),
             groups: int = 1, layout: str = "NCHW", relu: bool = False,
             packed: Optional[Packed] = None):
    """A quantized convolution layer: f32 ``x`` quantized by ``scale``, the
    int8 convolution with ``w`` (+ ``bias32``), the sums dequantized by
    ``step`` and relu'd with ``relu``; f32 in ``layout`` (on the card, its
    memory channels-last). ``packed``: ``w`` packed once by the caller."""
    if not x.is_cuda:
        return conv_f32_reference(x, w, bias32, scale, step, stride, pad,
                                  dilate, groups, layout, relu)
    return _conv(x, w, bias32, tuple(stride), tuple(pad), tuple(dilate),
                 groups, layout, packed, _scalar(scale, x, "scale"),
                 _scalar(step, x, "step"), relu)


def _fc(x, w, bias32, packed, scale, step, relu, fn=None):
    if w.ndim != 2 or x.ndim != 2 or w.shape[1] != x.shape[1]:
        raise MXNetError(f"quantized_fully_connected: data {tuple(x.shape)} "
                         f"and weight {tuple(w.shape)} do not agree")
    _check(x, w, bias32, scale is not None)
    M, K = x.shape
    N = w.shape[0]
    out = torch.float32 if step is not None else torch.int32
    y = torch.empty((M, N), dtype=out, device=x.device)
    if not y.numel():
        return y
    # the 1x1 convolution of M positions of K channels
    s = _Shape(False, M, K, (), N, K, (), ())
    plan = int8_plan(M, K, N, 1, K, True, 4 if scale is not None else 1,
                     False, _sms(x.device))
    if packed is None:
        packed, copied = pack_weight(w.reshape(N, K, 1), "NCW", False)
        if copied:
            _count("weight")
    _launch(_input(x, s, plan), packed, bias32, y, s, (), (), (), 1, plan,
            scale, step, relu, fn)
    return y


def fully_connected(x, w, bias32=None):
    """``x (M, K) . w (N, K)^T`` -> int32 (M, N) (+ ``bias32``): the
    kernel's GEMM case."""
    if not x.is_cuda:
        return fully_connected_reference(x, w, bias32)
    return _fc(x, w, bias32, None, None, None, False)


def fully_connected_f32(x, w, bias32, scale, step, relu: bool = False,
                        packed: Optional[Packed] = None):
    """A quantized fully connected layer: f32 ``x (M, K)`` quantized by
    ``scale``, times ``w (N, K)^T`` (+ ``bias32``), dequantized by ``step``,
    relu'd with ``relu``: f32 (M, N)."""
    if not x.is_cuda:
        return fully_connected_f32_reference(x, w, bias32, scale, step, relu)
    return _fc(x, w, bias32, packed, _scalar(scale, x, "scale"),
               _scalar(step, x, "step"), relu)
