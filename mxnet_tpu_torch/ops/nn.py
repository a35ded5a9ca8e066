"""Neural-network ops used by the BERT and ResNet models and their loss.

Counterpart of the matching functions in ``mxnet_tpu/ops/nn.py``:
``fully_connected`` (weight layout (num_hidden, in_units)), ``activation``,
``relu``, ``gelu`` (exact erf form unless ``approximate``), ``layer_norm``,
``dropout`` (identity outside training), ``embedding``, ``take_positions``,
``log_softmax``, ``pick``, and the vision subset: ``convolution``,
``pooling``, ``batch_norm``, ``conv_fusion_enabled``,
``batch_norm_relu_conv1x1`` and ``relu_conv1x1``. Plain functions on
tensors; the matrix products and convolutions go to PyTorch (cuBLAS and
cuDNN on the GPU) as the JAX package left them to XLA, except the
prologue-fused 1x1 convolutions and BatchNorm's training forward and
backward, which run the hand-written kernels of :mod:`.cuda.conv_fused`
and :mod:`.cuda.batch_norm`. Random draws take the framework generator of the
data's device (:mod:`mxnet_tpu_torch.random`), never torch's global one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .. import random as _random
from ..autograd import is_training
from ..base import MXNetError, getenv, register_env

__all__ = ["fully_connected", "activation", "relu", "gelu", "layer_norm",
           "dropout", "embedding", "take_positions", "log_softmax", "pick",
           "convolution", "pooling", "batch_norm", "conv_fusion_enabled",
           "batch_norm_relu_conv1x1", "relu_conv1x1"]

_ACT_FNS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


def fully_connected(data, weight, bias=None, num_hidden: Optional[int] = None,
                    no_bias: bool = False, flatten: bool = True):
    """y = x · Wᵀ + b with the reference weight layout (num_hidden, in_units)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


def activation(data, act_type: str = "relu"):
    return _ACT_FNS[act_type](data)


def relu(data):
    return torch.relu(data)


def gelu(data, approximate: bool = False):
    return F.gelu(data, approximate="tanh" if approximate else "none")


def layer_norm(data, gamma, beta, axis: int = -1, eps: float = 1e-5):
    x = data.movedim(axis, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return out.movedim(-1, axis)


def dropout(data, p: float = 0.5, mode: str = "training", axes=None,
            training: Optional[bool] = None):
    """Inverted dropout; identity unless training (``autograd.is_training()``
    when ``training`` is None) or ``mode == "always"``, and ``p > 0``.
    ``axes``: the mask is shared along these axes (variational dropout).
    The mask draws from the framework generator of the data's device."""
    train = is_training() if training is None else training
    if (not train and mode != "always") or p <= 0.0:
        return data
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    keep = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device)) >= p
    return torch.where(keep, data / (1.0 - p), torch.zeros_like(data))


def embedding(data, weight, input_dim: Optional[int] = None,
              output_dim: Optional[int] = None, dtype=None,
              sparse_grad: bool = False):
    """Table lookup: out[i...] = weight[data[i...]]. ``dtype`` is accepted
    and unused, as in the JAX package; ``sparse_grad=True`` (a row-sparse
    weight gradient) is not ported."""
    if sparse_grad:
        raise MXNetError("embedding(sparse_grad=True): row-sparse gradients "
                         "are not ported yet (ROADMAP Queue A 10)")
    return F.embedding(data.long(), weight)


def take_positions(data, positions):
    """Gather per-batch sequence positions: (B,T,C),(B,P) -> (B,P,C)."""
    idx = positions.long()[:, :, None].expand(-1, -1, data.shape[-1])
    return torch.gather(data, 1, idx)


def log_softmax(data, axis: int = -1, temperature: Optional[float] = None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


def _fill_value(dtype):
    """What an index past the axis reads (``jnp.take_along_axis``'s fill):
    NaN, the least signed or the greatest unsigned integer, or True."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


def pick(data, index, axis: int = -1, keepdims: bool = False,
         mode: str = "clip"):
    """``out[i...] = data[i..., index[i...], ...]`` along ``axis``, as the
    JAX package computes it whatever ``mode`` says: an index in [-L, L)
    counts from the end when negative, and any other index reads
    :func:`_fill_value` (NaN for floats). Masked on every device: nothing
    reaches the gather out of range."""
    ax = axis % data.ndim
    n = data.shape[ax]
    idx = index.long().unsqueeze(ax)
    inside = (idx >= -n) & (idx < n)
    idx = torch.where(inside, torch.where(idx < 0, idx + n, idx),
                      torch.zeros_like(idx))
    out = torch.gather(data, ax, idx)
    out = torch.where(inside, out, torch.full_like(out, _fill_value(
        data.dtype)))
    return out if keepdims else out.squeeze(ax)


# ------------------------------------------------------------------ vision
_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL_FNS = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL_FNS = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _tuple(v, n: int):
    return (v,) * n if isinstance(v, int) else tuple(v)


def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter: int = 0,
                num_group: int = 1, no_bias: bool = False,
                layout: str = "NCHW"):
    """N-d convolution over channels-first data, weight (O, I/groups,
    k...), computed in the data's dtype by PyTorch (cuDNN on the GPU).
    The JAX package's space-to-depth rewrite of stride-2 small-channel
    stems (``_s2d_stem_conv``) packs lanes for the TPU's matrix unit and
    is exact, so it has no counterpart here."""
    ndim = data.ndim - 2
    if ndim not in _CONV_FNS or not layout.startswith("NC"):
        raise MXNetError(f"convolution: layout {layout!r} with {ndim} "
                         "spatial dims is not supported (channels-first, "
                         "1-3 spatial dims)")
    return _CONV_FNS[ndim](
        data, weight, None if no_bias else bias, _tuple(stride or 1, ndim),
        _tuple(pad if pad is not None else 0, ndim),
        _tuple(dilate or 1, ndim), num_group)


def pooling(data, kernel=None, pool_type: str = "max", stride=None, pad=None,
            global_pool: bool = False, count_include_pad: bool = True,
            layout: str = "NCHW"):
    """Max, average or sum pooling over channels-first data; ``global_pool``
    reduces every spatial axis and keeps them as size 1."""
    ndim = data.ndim - 2
    if not layout.startswith("NC"):
        raise MXNetError(f"pooling: layout {layout!r} is not supported "
                         "(channels-first only)")
    if global_pool:
        axes = tuple(range(2, data.ndim))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = _tuple(kernel, ndim)
    stride = _tuple(stride or kernel, ndim)
    pad = _tuple(pad if pad is not None else 0, ndim)
    if pool_type == "max":
        return _MAX_POOL_FNS[ndim](data, kernel, stride, pad)
    if pool_type in ("avg", "sum"):
        out = _AVG_POOL_FNS[ndim](data, kernel, stride, pad,
                                  count_include_pad=count_include_pad
                                  or pool_type == "sum")
        if pool_type == "sum":
            out = out * math.prod(kernel)
        return out
    raise ValueError(f"unknown pool_type {pool_type}")


register_env("MXNET_BN_STATS", "shifted",
             "BatchNorm training statistics: 'shifted' one-pass about the "
             "layer's stat-shift buffer, or 'centered' two-pass.")
register_env("MXNET_FUSE_BN_CONV", "0",
             "Fuse BatchNorm-apply+ReLU (or a plain ReLU) into a consuming "
             "1x1 stride-1 convolution as one hand-written kernel. 0 "
             "(default) disables; 'auto' enables on a single CUDA device; "
             "1 forces on (CPU tensors take the kernels' plain versions).")


def _channel_shape(x, axis: int):
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    return shape


def _stats_mode(stats: Optional[str]) -> bool:
    """True for centered statistics (``stats`` or ``MXNET_BN_STATS``)."""
    if stats is None:
        stats = getenv("MXNET_BN_STATS", "shifted")
    return stats == "centered"


def batch_norm(data, gamma, beta, running_mean, running_var,
               eps: float = 1e-5, momentum: float = 0.9,
               fix_gamma: bool = False, use_global_stats: bool = False,
               axis: int = 1, training: Optional[bool] = None,
               stats: Optional[str] = None, shift=None):
    """BatchNorm forward; returns ``(out, batch_mean, batch_var)``.

    Training (``autograd.is_training()`` unless ``training`` says, and not
    ``use_global_stats``): :func:`.cuda.batch_norm.batch_norm_train`, the
    JAX package's ``_bn_train_core`` and its VJP: batch statistics in f32,
    one sweep about ``shift`` (default: the running mean), or centered with
    ``stats="centered"``; ``out`` in the data's dtype, the statistics in
    the running-stat dtype. The moving-average update is the caller's (the
    gluon layer). Otherwise the running statistics normalise and come back
    as they are."""
    from .cuda.batch_norm import batch_norm_train
    ax = axis % data.ndim
    gg = torch.ones_like(gamma) if fix_gamma else gamma
    train = is_training() if training is None else training
    shape = _channel_shape(data, ax)
    if train and not use_global_stats:
        out, mean, var = batch_norm_train(
            data, gg, beta, running_mean if shift is None else shift, eps,
            _stats_mode(stats), ax)
        return out, mean.to(running_mean.dtype), var.to(running_var.dtype)
    inv = torch.rsqrt(running_var + eps)
    out = (data - running_mean.reshape(shape)) * (inv * gg).reshape(shape) \
        + beta.reshape(shape)
    return out, running_mean, running_var


def conv_fusion_enabled() -> bool:
    """``MXNET_FUSE_BN_CONV``: '0' (default) off, '1' on, 'auto' on when
    exactly one CUDA device is present (the JAX package's 'single-device
    TPU')."""
    val = str(getenv("MXNET_FUSE_BN_CONV", "0")).lower()
    if val == "auto":
        return torch.cuda.is_available() and torch.cuda.device_count() == 1
    return val not in ("0", "false", "off")


def batch_norm_relu_conv1x1(data, gamma, beta, running_mean, running_var,
                            weight, conv_bias=None, eps: float = 1e-5,
                            fix_gamma: bool = False,
                            use_global_stats: bool = False,
                            training: Optional[bool] = None,
                            stats: Optional[str] = None, shift=None,
                            relu: bool = True):
    """``conv1x1(relu(batch_norm(data)))`` through the fused kernels, NCHW.

    The statistics contract of :func:`batch_norm` (axis 1): the batch
    statistics by :func:`.cuda.batch_norm.batch_stats` (the JAX package's
    ``_bn_batch_stats``), then scale ``gamma / sqrt(var + eps)`` and shift
    ``beta - mean * scale`` as torch ops outside the kernels' autograd
    Functions, so gradients reach gamma, beta and the data through the
    statistics. Returns ``(out (N, Co, H, W), batch_mean, batch_var)``."""
    from .cuda.batch_norm import batch_stats
    from .cuda.conv_fused import fused_prologue_conv1x1
    if data.ndim != 4:
        raise MXNetError("batch_norm_relu_conv1x1 expects NCHW data")
    gg = torch.ones_like(gamma) if fix_gamma else gamma
    train = is_training() if training is None else training
    if train and not use_global_stats:
        mean, var = batch_stats(
            data, running_mean if shift is None else shift,
            _stats_mode(stats), 1, eps)
    else:
        mean, var = running_mean.float(), running_var.float()
    scale = gg.float() * torch.rsqrt(var + eps)
    shiftv = beta.float() - mean * scale
    y = fused_prologue_conv1x1(data, weight, scale, shiftv, relu=relu,
                               bias=conv_bias)
    return y, mean.to(running_mean.dtype), var.to(running_var.dtype)


def relu_conv1x1(data, weight, conv_bias=None):
    """``conv1x1(relu(data))`` through the fused kernels (NCHW): the
    bottleneck-epilogue junction."""
    from .cuda.conv_fused import fused_prologue_conv1x1
    if data.ndim != 4:
        raise MXNetError("relu_conv1x1 expects NCHW data")
    return fused_prologue_conv1x1(data, weight, None, None, relu=True,
                                  bias=conv_bias)
