"""INT8 quantization operators.

Counterpart of ``mxnet_tpu/ops/quantization.py``: ``quantize``,
``quantize_v2``, ``dequantize``, ``requantize``,
``quantized_fully_connected``, ``quantized_conv``, ``quantized_pooling``,
``quantized_act`` and ``quantized_flatten``, with the JAX signatures and
the reference's three-output convention: a quantized tensor travels with
its float range as two 0-d f32 tensors, ``(q, min, max)``. Symmetric int8
(zero point 0) or affine uint8. Plain functions on tensors, like the other
operators of ``ops``; each is also ``register_op``'ed as an NDArray
operator (``mx.nd.<name>``, ``mx.nd.contrib.<name>``), as the JAX package
registers them.

The arithmetic is the JAX package's, in its order, in f32: the scale
``q_max / max(amax, 1e-30)``, round half to even (``torch.round``), the
clamp, and the bias rescaled into the accumulator's step. A division by a
constant (255, 127, 127^2, 2^31 - 1, a pooling window's size) is what XLA
compiles it to: a product by the constant's f32 reciprocal; any other
division is one IEEE division of two f32 tensors, never by a Python
number, which PyTorch on the card would turn into a product by a
reciprocal rounded in double. A range given as a Python number becomes a
0-d f32 tensor on the data's device; ``contrib.quantization`` passes
device tensors, so a forward copies nothing from the host and a CUDA
graph captures it.

The int8 products (``quantized_conv``, ``quantized_fully_connected``) run
on :mod:`.cuda.int8_conv`: the hand-written int8 tensor-core kernel on a
CUDA tensor, its exact float64 plain version on a CPU tensor.
:func:`int8_layer_constants` gives a quantized layer the scale, step and
rescaled bias these operators compute around its product, for the
kernel's f32 variant, which runs the whole layer.
``quantized_pooling`` pools the int8 values as f32 through the library,
which is exact: a maximum is, and an average sums fewer than 2^24 / 127
integers before ``round(sum / n)``.

On the same inputs every output equals the JAX package's on the CPU but
one: XLA contracts uint8 ``dequantize``'s ``q * scale + min`` into a fused
multiply-add, which PyTorch does not, so about half its values differ by
an ulp (``tests/test_torch_quantization.py`` counts them).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ndarray.ndarray import to_torch_dtype
from ..ndarray.register import register_tensor_op
from .cuda import int8_conv

__all__ = [
    "quantize", "quantize_v2", "dequantize", "requantize",
    "quantized_fully_connected", "quantized_conv", "quantized_pooling",
    "quantized_act", "quantized_flatten",
]

_INT8_MAX = 127.0
_UINT8_MAX = 255.0
_INT32_MAX = 2147483647.0


def _range_for(out_type: str) -> float:
    if out_type == "int8":
        return _INT8_MAX
    if out_type == "uint8":
        return _UINT8_MAX
    raise MXNetError(f"unsupported quantized dtype {out_type!r} "
                     "(expected 'int8' or 'uint8')")


def _const(v: float, like) -> torch.Tensor:
    """``v`` as a 0-d f32 tensor on ``like``'s device (a fill, which a CUDA
    graph captures)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _over(x, c: float):
    """``x / c`` for a constant ``c`` as XLA compiles it: ``x`` times the
    f32 reciprocal of ``c``."""
    return x * _const(float(np.float32(1) / np.float32(c)), x)


def _f32(v, like) -> torch.Tensor:
    """A range argument (a tensor of one element or a number) as a 0-d f32
    tensor on ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(device=like.device, dtype=torch.float32)
    return _const(float(v), like)


def _amax(mn, mx):
    return torch.maximum(mn.abs(), mx.abs())


def int8_scale(amax):
    """The int8 quantizing scale of the range [-amax, amax] (a 0-d f32
    tensor): ``127 / max(amax, 1e-30)``, one IEEE division."""
    return _const(_INT8_MAX, amax) / amax.clamp_min(1e-30)


def int8_codes(x, scale):
    """The int8 codes of f32 ``x`` at ``scale``: the product, round half
    to even, the clamp to +-127, the cast."""
    return torch.clamp(torch.round(x * scale), -_INT8_MAX,
                       _INT8_MAX).to(torch.int8)


def dequantize_step(mn, mx, qmax: float):
    """The f32 step of a signed type's codes over the range [mn, mx]:
    ``max(|mn|, |mx|) / qmax``, as XLA compiles the division."""
    return _over(_amax(mn, mx), qmax)


def dequantize_by(data, step, dtype=torch.float32):
    """Codes or an accumulator times their f32 ``step`` (converted to f32
    inside the product, one pass over them), in ``dtype``."""
    return (data * step).to(dtype)


def _quantize(x, mn, mx, out_type: str):
    """``x`` (f32) into ``out_type`` over the range [mn, mx]."""
    q_max = _range_for(out_type)
    if out_type == "int8":
        amax = _amax(mn, mx)
        return int8_codes(x, int8_scale(amax)), -amax, amax
    scale = _const(q_max, x) / (mx - mn).clamp_min(1e-30)
    q = torch.clamp(torch.round((x - mn) * scale), 0.0, q_max)
    return q.to(torch.uint8), mn, mx


def quantize(data, min_range, max_range, out_type: str = "uint8"):
    """Quantize float data into ``out_type`` given a float range; returns
    ``(q, min, max)``. int8 is symmetric (scale from max(|min|, |max|)),
    uint8 affine on [min, max]."""
    return _quantize(data.float(), _f32(min_range, data),
                     _f32(max_range, data), out_type)


def quantize_v2(data, min_calib_range: Optional[float] = None,
                max_calib_range: Optional[float] = None,
                out_type: str = "int8"):
    """Quantize with a calibrated range, or the data's own min and max
    without one."""
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx = _f32(min_calib_range, data), _f32(max_calib_range, data)
    else:
        mn, mx = data.min().float(), data.max().float()
    return _quantize(data.float(), mn, mx, out_type)


def dequantize(data, min_range, max_range, out_type: str = "float32"):
    """int8 / uint8 / int32 and its range -> float; uint8 affine, signed
    types symmetric over their own maximum."""
    mn, mx = _f32(min_range, data), _f32(max_range, data)
    dt = to_torch_dtype(out_type)
    if data.dtype == torch.uint8:
        return (data * _over(mx - mn, _UINT8_MAX) + mn).to(dt)
    qmax = float(torch.iinfo(data.dtype).max)
    return dequantize_by(data, dequantize_step(mn, mx, qmax), dt)


def requantize(data, min_range, max_range,
               min_calib_range: Optional[float] = None,
               max_calib_range: Optional[float] = None):
    """int32 accumulator and its float range -> int8 and its range; the
    calibrated range, or the accumulator's own abs-max."""
    mn, mx = _f32(min_range, data), _f32(max_range, data)
    real = data.float() * dequantize_step(mn, mx, _INT32_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        amax = _const(max(abs(min_calib_range), abs(max_calib_range)), data)
    else:
        amax = torch.maximum(real.min().abs(), real.max().abs())
    return int8_codes(real, int8_scale(amax)), -amax, amax


def _int8_range_prod(mn_a, mx_a, mn_b, mx_b):
    """Float range of an int32 accumulator of a_q . b_q: its int32 maximum
    stands for amax_a * amax_b / 127^2 * (2^31 - 1)."""
    amax_out = _over(_amax(mn_a, mx_a) * _amax(mn_b, mx_b),
                     _INT8_MAX * _INT8_MAX) * _INT32_MAX
    return -amax_out, amax_out


def _bias32(bias, mn_b, mx_b, mx_o):
    """The int8 bias rescaled into the int32 accumulator's step."""
    amax_b = _amax(mn_b, mx_b)
    acc_step = _over(mx_o, _INT32_MAX)
    return torch.round(bias.float() * _over(amax_b, _INT8_MAX)
                       / acc_step.clamp_min(1e-30)).to(torch.int32)


def _ranges(data, min_data, max_data, min_weight, max_weight):
    return _int8_range_prod(_f32(min_data, data), _f32(max_data, data),
                            _f32(min_weight, data), _f32(max_weight, data))


def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden: int = 0,
                              no_bias: bool = False, flatten: bool = True):
    """int8 x . W^T (+ b) -> int32 and its range; the int8 bias is rescaled
    into the accumulator's scale and added in the kernel's epilogue."""
    x = data
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    mn_o, mx_o = _ranges(data, min_data, max_data, min_weight, max_weight)
    b32 = None
    if bias is not None and not no_bias:
        b32 = _bias32(bias, _f32(min_bias, data), _f32(max_bias, data), mx_o)
    y = int8_conv.fully_connected(x.reshape(-1, x.shape[-1]), weight, b32)
    return y.reshape(x.shape[:-1] + (y.shape[-1],)), mn_o, mx_o


def int8_layer_constants(mn, mx, min_weight, max_weight, bias=None,
                         min_bias=None, max_bias=None):
    """What one int8 layer's forward computes around its product, given its
    input range [mn, mx] (0-d f32 tensors): the quantizing ``scale`` of
    ``quantize_v2``, the dequantizing ``step`` of the int32 accumulator's
    range and the int8 ``bias`` rescaled into it (``bias32``; None without
    a bias), by the same operations as ``quantize_v2``,
    ``quantized_conv`` / ``quantized_fully_connected`` and ``dequantize``,
    so the same bits. Returns ``(scale, step, bias32)``."""
    amax = _amax(mn, mx)
    mn_o, mx_o = _ranges(mn, -amax, amax, min_weight, max_weight)
    b32 = None
    if bias is not None:
        b32 = _bias32(bias, _f32(min_bias, mn), _f32(max_bias, mn), mx_o)
    return (int8_scale(amax), dequantize_step(mn_o, mx_o, _INT32_MAX),
            b32)


def _tuple(v, n: int):
    return (v,) * n if isinstance(v, int) else tuple(v)


def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None,
                   kernel=None, stride=None, pad=None, dilate=None,
                   num_filter: int = 0, num_group: int = 1,
                   no_bias: bool = False, layout: str = "NCHW"):
    """int8 convolution -> int32 and its range, in any of the six layouts
    of the JAX package's ``_CONV_DIMNUMS``."""
    ndim = data.ndim - 2
    stride = _tuple(stride or 1, ndim)
    dilate = _tuple(dilate or 1, ndim)
    pad = _tuple(pad if pad is not None else 0, ndim)
    mn_o, mx_o = _ranges(data, min_data, max_data, min_weight, max_weight)
    b32 = None
    if bias is not None and not no_bias:
        b32 = _bias32(bias, _f32(min_bias, data), _f32(max_bias, data), mx_o)
    y = int8_conv.conv(data, weight, b32, stride, pad, dilate, num_group,
                       layout)
    return y, mn_o, mx_o


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _sum_pool(x, win, st, pd):
    """Window sums of f32 ``x`` (N, C, spatial...), padding counted as 0."""
    if x.ndim == 3:
        return F.avg_pool2d(x[:, :, None], (1,) + win, (1,) + st,
                            (0,) + pd, divisor_override=1)[:, :, 0]
    fn = F.avg_pool2d if x.ndim == 4 else F.avg_pool3d
    return fn(x, win, st, pd, divisor_override=1)


def quantized_pooling(data, min_data, max_data, kernel=None, stride=None,
                      pad=None, pool_type: str = "max",
                      global_pool: bool = False, layout: str = "NCHW"):
    """Max or average pooling of int8 / uint8 data; the range is
    unchanged. An average is ``round(window sum / window size)``, padding
    counted as zeros."""
    q = data
    ndim = q.ndim - 2
    last = layout.endswith("C")
    x = (q.movedim(-1, 1) if last else q).float()
    if global_pool:
        win = tuple(x.shape[2:])
        st, pd = win, (0,) * ndim
    else:
        win = _tuple(kernel, ndim)
        st = _tuple(stride or 1, ndim)
        pd = _tuple(pad if pad is not None else 0, ndim)
    if pool_type == "max":
        out = _MAX_POOL[ndim](x, win, st, pd)
    elif pool_type == "avg":
        out = torch.round(_over(_sum_pool(x, win, st, pd),
                                math.prod(win)))
    else:
        raise MXNetError(f"unsupported quantized pool_type {pool_type!r}")
    out = out.to(q.dtype)
    return (out.movedim(1, -1) if last else out), \
        _f32(min_data, data), _f32(max_data, data)


def quantized_act(data, min_data, max_data, act_type: str = "relu"):
    """relu on int8: a clamp at the zero point (0 for symmetric int8)."""
    if act_type != "relu":
        raise MXNetError("only act_type='relu' has an int8 fast path")
    return data.clamp_min(0), _f32(min_data, data).clamp_min(0.0), \
        _f32(max_data, data)


def quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), _f32(min_data, data), \
        _f32(max_data, data)


for _name in __all__:
    register_tensor_op(_name, globals()[_name])
