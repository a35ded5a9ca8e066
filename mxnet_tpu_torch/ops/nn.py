"""Neural-network operators.

Counterpart of ``mxnet_tpu/ops/nn.py``, one function for each of its
public names but ``rnn`` (ROADMAP Queue A 9): ``fully_connected`` (weight
layout (num_hidden, in_units)), the activations, the softmax family (with
``temperature`` and ``length``), ``layer_norm``, ``group_norm``,
``instance_norm``, ``rms_norm``, ``l2_normalization``, ``lrn``,
``dropout`` (identity outside training), ``embedding``,
``take_positions``, ``pick``, the sequence operators, ``topk_mask``,
``smooth_l1``, the output operators whose backward injects the loss
gradient (``softmax_output``, the regression outputs, ``make_loss``),
``up_sampling``, ``roi_pooling``, ``ctc_loss``, ``arange_like``, and the
vision subset: ``convolution``, ``deconvolution``, ``pooling``,
``adaptive_avg_pool2d``, ``batch_norm``, ``conv_fusion_enabled``,
``batch_norm_relu_conv1x1`` and ``relu_conv1x1``. Plain functions on
tensors; the matrix products and convolutions go to PyTorch (cuBLAS and
cuDNN on the GPU) as the JAX package left them to XLA, except the
prologue-fused 1x1 convolutions and BatchNorm's training forward and
backward, which run the hand-written kernels of :mod:`.cuda.conv_fused`
and :mod:`.cuda.batch_norm`. Random draws take the framework generator of the
data's device (:mod:`mxnet_tpu_torch.random`), never torch's global one.
An operator runs where its data lies and in its dtype: a dtype torch does
not implement an operator for raises :class:`MXNetError`; nothing is moved
to another device or cast to go round it.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import random as _random
from ..autograd import is_training
from ..base import MXNetError, getenv, register_env

__all__ = [
    "activation", "relu", "leaky_relu", "prelu", "elu", "selu", "gelu",
    "silu", "swish", "mish", "softrelu", "softsign", "hard_sigmoid",
    "hard_swish", "log_sigmoid",
    "softmax", "log_softmax", "masked_softmax", "masked_log_softmax",
    "fully_connected", "convolution", "deconvolution", "pooling",
    "adaptive_avg_pool2d", "batch_norm", "batch_norm_relu_conv1x1",
    "relu_conv1x1", "conv_fusion_enabled", "layer_norm", "group_norm",
    "instance_norm", "rms_norm", "l2_normalization", "lrn",
    "dropout", "embedding", "pick", "take_positions", "sequence_mask",
    "sequence_last", "sequence_reverse", "topk_mask", "smooth_l1",
    "up_sampling", "roi_pooling", "ctc_loss", "softmax_output",
    "linear_regression_output", "mae_regression_output",
    "logistic_regression_output", "make_loss", "arange_like"]


def _dtype_rule(fn):
    """Torch's refusal of a dtype ("not implemented for 'Half'") becomes
    :class:`MXNetError` naming the operator; nothing is cast or moved to
    run it elsewhere."""
    @functools.wraps(fn)
    def op(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if isinstance(e, MXNetError) or "not implemented for" not in \
                    str(e):
                raise
            raise MXNetError(f"npx.{fn.__name__}: {e}") from e
    return op


# activation()'s names; 'gelu' is the tanh form, jax.nn.gelu's default
_ACT_FNS = {"relu": torch.relu, "sigmoid": torch.sigmoid,
            "log_sigmoid": F.logsigmoid, "tanh": torch.tanh,
            "softrelu": F.softplus, "softplus": F.softplus,
            "softsign": F.softsign,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "silu": F.silu, "swish": F.silu, "mish": F.mish,
            "identity": lambda x: x}


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


@_dtype_rule
def leaky_relu(data, slope: float = 0.25, act_type: str = "leaky"):
    """``act_type``: 'leaky' / 'rrelu' (slope ``slope``), 'elu' (alpha
    ``slope``), 'gelu' (the tanh form, as ``jax.nn.gelu``), 'selu'."""
    if act_type in ("leaky", "rrelu"):
        return F.leaky_relu(data, slope)
    if act_type == "elu":
        return elu(data, slope)
    if act_type == "gelu":
        return F.gelu(data, approximate="tanh")
    if act_type == "selu":
        return selu(data)
    raise ValueError(f"unknown leaky_relu act_type {act_type}")


@_dtype_rule
def prelu(data, gamma):
    """``where(x >= 0, x, gamma * x)``, gamma broadcast against the data's
    trailing axes (as the JAX package broadcasts it)."""
    return torch.where(data >= 0, data, gamma * data)


@_dtype_rule
def elu(data, alpha: float = 1.0):
    return F.elu(data, alpha)


@_dtype_rule
def selu(data):
    return F.selu(data)


@_dtype_rule
def silu(data):
    return F.silu(data)


swish = silu


@_dtype_rule
def mish(data):
    return F.mish(data)


@_dtype_rule
def softrelu(data):
    return F.softplus(data)


@_dtype_rule
def softsign(data):
    return F.softsign(data)


@_dtype_rule
def log_sigmoid(data):
    return F.logsigmoid(data)


@_dtype_rule
def hard_sigmoid(data, alpha: float = 0.2, beta: float = 0.5):
    return (alpha * data + beta).clamp(0.0, 1.0)


@_dtype_rule
def hard_swish(data):
    """``x * clip(x / 6 + 0.5, 0, 1)``, the division a product by 1/6 (as
    PyTorch divides by a scalar on the GPU), so that every device takes
    the same side of the derivative's steps at x = -3 and 3."""
    return data * (data * (1.0 / 6.0) + 0.5).clamp(0.0, 1.0)


def layer_norm(data, gamma, beta, axis: int = -1, eps: float = 1e-5):
    x = data.movedim(axis, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return out.movedim(-1, axis)


def _affine(out, gamma, beta=None, axis: int = 1):
    """``out * gamma + beta`` with the vectors along ``axis`` (the result
    promoted as the JAX package promotes it: bf16 data, f32 gamma give
    f32)."""
    shape = [1] * out.ndim
    shape[axis] = out.shape[axis]
    out = out * gamma.reshape(shape)
    return out if beta is None else out + beta.reshape(shape)


def _normalize(x, dims, eps: float):
    """``(x - mean) * rsqrt(var + eps)`` over ``dims`` in x's dtype, the
    variance the mean of squared deviations."""
    mean = x.mean(dim=dims, keepdim=True)
    var = x.var(dim=dims, correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


@_dtype_rule
def rms_norm(data, gamma, axis: int = -1, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * gamma`` along ``axis``."""
    ms = data.square().mean(dim=axis, keepdim=True)
    return _affine(data * torch.rsqrt(ms + eps), gamma, axis=axis % data.ndim)


@_dtype_rule
def group_norm(data, gamma, beta, num_groups: int = 1, eps: float = 1e-5):
    """GroupNorm over channels-first data: statistics a sample and group of
    ``C / num_groups`` channels, then the per-channel affine."""
    N, C = data.shape[:2]
    xg = data.reshape((N, num_groups, C // num_groups) + data.shape[2:])
    out = _normalize(xg, tuple(range(2, xg.ndim)), eps).reshape(data.shape)
    return _affine(out, gamma, beta)


@_dtype_rule
def instance_norm(data, gamma, beta, eps: float = 1e-5):
    """Statistics a sample and channel over the spatial axes."""
    return _affine(_normalize(data, tuple(range(2, data.ndim)), eps), gamma,
                   beta)


@_dtype_rule
def l2_normalization(data, eps: float = 1e-10, mode: str = "instance"):
    """``x / sqrt(sum(x^2) + eps)`` over every axis but the batch
    ('instance'), the channels ('channel') or the spatial axes
    ('spatial')."""
    dims = {"instance": tuple(range(1, data.ndim)), "channel": (1,)}.get(
        mode, tuple(range(2, data.ndim)))
    return data / torch.sqrt(data.square().sum(dim=dims, keepdim=True) + eps)


@_dtype_rule
def lrn(data, alpha: float = 1e-4, beta: float = 0.75, knorm: float = 2.0,
        nsize: int = 5):
    """Local response normalization across channels:
    ``x / (knorm + alpha / nsize * sum(x^2 over nsize channels))^beta``,
    the window centred (odd ``nsize``) and zero past the ends."""
    if nsize % 2 == 0:
        raise MXNetError(f"lrn: nsize must be odd, got {nsize}")
    C, h = data.shape[1], nsize // 2
    sq = data.square()
    pad = sq.new_zeros((sq.shape[0], h) + sq.shape[2:])
    sq = torch.cat([pad, sq, pad], dim=1)
    s = sq.narrow(1, 0, C)
    for i in range(1, nsize):
        s = s + sq.narrow(1, i, C)
    return data / torch.pow(knorm + alpha / nsize * s, beta)


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


# PyTorch's CUDA embedding backward takes a sort-based path above this many
# indices, and that path reads a count back to the host: it cannot run
# inside a CUDA graph. Below it, one deterministic pass on the device.
_EMBED_BWD_CHUNK = 3072


class _Embedding(torch.autograd.Function):
    """``F.embedding`` on the card, with a backward that stays on the
    device and sums each row in f32, deterministically, rounding to the
    weight's dtype once. A table no larger than the gradient (chunks x
    rows <= indices: BERT's token types, 2 rows) takes PyTorch's one-pass
    kernel a chunk of _EMBED_BWD_CHUNK indices, a dense f32 table each; a
    larger one (BERT's 30522 words) one f32 accumulator by
    ``index_put_(accumulate=True)``, which sums a row's repeats serially,
    so a small table of many repeats would be slow (``chip_smoke.py``
    phase 5 times both routes)."""

    @staticmethod
    def forward(ctx, idx, weight):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.dtype = weight.shape[0], weight.dtype
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        n, c = idx.numel(), _EMBED_BWD_CHUNK
        flat, g = idx.reshape(n), dout.reshape(n, -1).float()
        total = torch.zeros((ctx.rows, g.shape[1]), dtype=torch.float32,
                            device=g.device)
        if -(-n // c) * ctx.rows <= n:
            for k in range(0, n, c):
                total.add_(torch.ops.aten.embedding_dense_backward(
                    g[k:k + c], flat[k:k + c], ctx.rows, -1, False))
        else:
            total.index_put_((flat,), g, accumulate=True)
        return None, total.to(ctx.dtype)


def embedding(data, weight, input_dim: Optional[int] = None,
              output_dim: Optional[int] = None, dtype=None,
              sparse_grad: bool = False):
    """Table lookup: out[i...] = weight[data[i...]]. ``dtype`` is accepted
    and unused, as in the JAX package; ``sparse_grad=True`` (a row-sparse
    weight gradient) is not ported. On the card the weight's gradient is
    summed without a device-to-host read (:class:`_Embedding`), so a
    hybridized block's backward can be captured."""
    if sparse_grad:
        raise MXNetError("embedding(sparse_grad=True): row-sparse gradients "
                         "are not ported yet (ROADMAP Queue A 10)")
    if weight.is_cuda and weight.requires_grad and torch.is_grad_enabled():
        return _Embedding.apply(data.long(), weight)
    return F.embedding(data.long(), weight)


def take_positions(data, positions):
    """Gather per-batch sequence positions: (B,T,C),(B,P) -> (B,P,C)."""
    idx = positions.long()[:, :, None].expand(-1, -1, data.shape[-1])
    return torch.gather(data, 1, idx)


@_dtype_rule
def softmax(data, axis: int = -1, temperature: Optional[float] = None,
            length=None):
    """Softmax along ``axis``; with ``length`` (valid lengths, shaped as
    the data's leading axes) the positions past each length are masked
    out, as :func:`masked_softmax` does, and ``temperature`` is not applied
    (the JAX package's rule)."""
    if length is not None:
        return masked_softmax(data, _length_mask(data, length, axis), axis)
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.softmax(data, dim=axis)


@_dtype_rule
def log_softmax(data, axis: int = -1, temperature: Optional[float] = None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


def _length_mask(data, length, axis: int):
    """``arange(L) < length`` along ``axis``, ``length`` broadcast from the
    data's leading axes."""
    L = data.shape[axis]
    shape = [1] * data.ndim
    shape[axis] = L
    ar = torch.arange(L, device=data.device).reshape(shape)
    return ar < length.reshape(tuple(length.shape)
                               + (1,) * (data.ndim - length.ndim))


def _lowest(dtype):
    return torch.finfo(dtype).min if dtype.is_floating_point else -1e9


@_dtype_rule
def masked_softmax(data, mask, axis: int = -1):
    """Softmax over the positions ``mask`` keeps; masked positions give 0
    (a row masked whole gives 0 everywhere)."""
    mask = mask.bool()
    x = torch.where(mask, data, torch.full_like(data, _lowest(data.dtype)))
    out = torch.softmax(x, dim=axis)
    return torch.where(mask, out, torch.zeros_like(out))


@_dtype_rule
def masked_log_softmax(data, mask, axis: int = -1):
    """Log-softmax over the positions ``mask`` keeps; a masked position
    reads the dtype's lowest value less the row's log-sum-exp."""
    x = torch.where(mask.bool(), data,
                    torch.full_like(data, torch.finfo(data.dtype).min))
    return torch.log_softmax(x, dim=axis)


def _fill_value(dtype):
    """What an index past the axis reads (``jnp.take_along_axis``'s fill):
    NaN, the least signed or the greatest unsigned integer, or True."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype.is_signed else \
        torch.iinfo(dtype).max


def _take_along(x, idx, axis: int):
    """``jnp.take_along_axis`` with ``idx`` broadcast to ``x`` but along
    ``axis``: an index in [-L, L) counts from the end when negative, any
    other reads :func:`_fill_value`. Masked on every device, as
    :func:`pick` is."""
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    idx = idx.long().expand(shape)
    inside = (idx >= -n) & (idx < n)
    idx = torch.where(inside, torch.where(idx < 0, idx + n, idx),
                      torch.zeros_like(idx))
    out = torch.gather(x, axis, idx)
    return torch.where(inside, out, torch.full_like(out, _fill_value(
        x.dtype)))


def pick(data, index, axis: int = -1, keepdims: bool = False,
         mode: str = "clip"):
    """``out[i...] = data[i..., index[i...], ...]`` along ``axis``, as the
    JAX package computes it whatever ``mode`` says: an index in [-L, L)
    counts from the end when negative, and any other index reads
    :func:`_fill_value` (NaN for floats). Masked on every device: nothing
    reaches the gather out of range."""
    ax = axis % data.ndim
    out = _take_along(data, index.unsqueeze(ax), ax)
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


_DECONV_FNS = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
               3: F.conv_transpose3d}


@_dtype_rule
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter: int = 0,
                  num_group: int = 1, no_bias: bool = True,
                  layout: str = "NCHW", target_shape=None):
    """Transposed convolution over channels-first data, weight (in,
    out / groups, k...) (MXNet's layout, also PyTorch's), by PyTorch
    (cuDNN on the GPU). The output is ``(in - 1) * stride - 2 * pad +
    dilate * (k - 1) + 1 + adj`` a spatial axis; ``target_shape`` (the
    output's spatial shape) sets ``adj`` instead. ``no_bias`` defaults to
    True, as in the JAX package. Groups are taken (the JAX package refuses
    ``num_group > 1``)."""
    ndim = data.ndim - 2
    if ndim not in _DECONV_FNS or not layout.startswith("NC"):
        raise MXNetError(f"deconvolution: layout {layout!r} with {ndim} "
                         "spatial dims is not supported (channels-first, "
                         "1-3 spatial dims)")
    stride, dilate = _tuple(stride or 1, ndim), _tuple(dilate or 1, ndim)
    pad = _tuple(pad if pad is not None else 0, ndim)
    if target_shape is not None:
        full = [(i - 1) * s - 2 * p + d * (k - 1) + 1 for i, s, p, d, k in
                zip(data.shape[2:], stride, pad, dilate, weight.shape[2:])]
        adj = tuple(t - f for t, f in zip(_tuple(target_shape, ndim), full))
        if any(a < 0 for a in adj):
            raise MXNetError(f"deconvolution: target_shape {target_shape} "
                             f"is smaller than the output {tuple(full)}")
    adj = _tuple(adj if adj is not None else 0, ndim)
    return _DECONV_FNS[ndim](data, weight, None if no_bias else bias, stride,
                             pad, adj, num_group, dilate)


@_dtype_rule
def adaptive_avg_pool2d(data, output_size: Union[int, Tuple[int, int]] = 1,
                        layout: str = "NCHW"):
    """Average pooling to ``output_size``, whose sizes must divide the
    spatial ones (the JAX package's rule)."""
    out = _tuple(output_size, 2)
    h_ax, w_ax = layout.index("H"), layout.index("W")
    H, W = data.shape[h_ax], data.shape[w_ax]
    if H % out[0] or W % out[1]:
        raise ValueError("adaptive pool requires divisible spatial dims")
    x = data.movedim((h_ax, w_ax), (-2, -1))
    y = F.avg_pool2d(x, (H // out[0], W // out[1]))
    return y.movedim((-2, -1), (h_ax, w_ax))


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


# ---------------------------------------------------------------- sequences
def _steps(data, sequence_length, axis: int):
    """(positions (T, N) or (N, T) as ``axis`` is 0 or 1, lengths as
    (1, N) or (N, 1)), broadcastable against each other."""
    ar = torch.arange(data.shape[axis], device=data.device)
    sl = sequence_length
    if axis == 0:
        return ar[:, None], sl[None, :]
    return ar[None, :], sl[:, None]


def _trailing(t, ndim: int):
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.ndim))


@_dtype_rule
def sequence_mask(data, sequence_length=None,
                  use_sequence_length: bool = False, value: float = 0.0,
                  axis: int = 0):
    """Positions at or past each sequence's length set to ``value``; data
    (T, N, ...) for ``axis=0``, else (N, T, ...)."""
    if not use_sequence_length or sequence_length is None:
        return data
    ar, sl = _steps(data, sequence_length, axis)
    mask = _trailing(ar < sl, data.ndim)
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@_dtype_rule
def sequence_last(data, sequence_length=None,
                  use_sequence_length: bool = False, axis: int = 0):
    """Each sequence's last valid step: (N, ...)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    xt = data.movedim(0, 1) if axis == 0 else data
    last = _trailing(sequence_length.long() - 1, xt.ndim)
    return _take_along(xt, last, 1).squeeze(1)


@_dtype_rule
def sequence_reverse(data, sequence_length=None,
                     use_sequence_length: bool = False, axis: int = 0):
    """Each sequence's first ``length`` steps reversed, the rest kept."""
    if not use_sequence_length or sequence_length is None:
        return data.flip(axis)
    ar, sl = _steps(data, sequence_length.long(), axis)
    idx = torch.where(ar < sl, sl - 1 - ar, ar)
    return _take_along(data, _trailing(idx, data.ndim), axis)


@_dtype_rule
def topk_mask(data, k: int, axis: int = -1):
    """True where an element is at least the ``k``-th largest along
    ``axis``."""
    xm = data.movedim(axis, -1)
    thresh = torch.topk(xm, k, dim=-1).values[..., -1:]
    return (xm >= thresh).movedim(-1, axis)


@_dtype_rule
def smooth_l1(data, scalar: float = 1.0):
    """``0.5 * s^2 * x^2`` where ``|x| < 1 / s^2``, else ``|x| - 0.5 /
    s^2``."""
    s2 = scalar * scalar
    ax = data.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * data.square(), ax - 0.5 / s2)


# ------------------------------------------------------ loss-head outputs
# The symbolic API's loss heads: the forward is the prediction, and the
# backward ignores the output's cotangent and injects the loss gradient
# (MXNet's "implicit loss"), as the JAX package's custom VJPs do. The label
# gets no gradient.
class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, label, axis, grad_scale, ignore_label, use_ignore,
                normalization, smooth_alpha):
        ctx.save_for_backward(x, label)
        ctx.hp = (axis, grad_scale, ignore_label, use_ignore, normalization,
                  smooth_alpha)
        return torch.softmax(x, dim=axis)

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        axis, gs, il, use_ignore, nrm, sa = ctx.hp
        prob = torch.softmax(x, dim=axis)
        ncls = x.shape[axis]
        shape = [1] * x.ndim
        shape[axis] = ncls
        oh = (lab.long().unsqueeze(axis) == torch.arange(
            ncls, device=x.device).reshape(shape)).to(x.dtype)
        if sa:
            oh = oh * (1.0 - sa) + sa / (ncls - 1) * (1.0 - oh)
        grad = prob - oh
        valid = None
        if use_ignore:
            valid = (lab != il).to(x.dtype)
            grad = grad * valid.unsqueeze(axis)
        if nrm == "batch":
            grad = grad / x.shape[0]
        elif nrm == "valid":
            cnt = valid.sum() if valid is not None else \
                torch.tensor(float(lab.numel()), device=x.device)
            grad = grad / cnt.clamp_min(1.0)
        return (grad * gs,) + (None,) * 7


@_dtype_rule
def softmax_output(data, label, grad_scale: float = 1.0,
                   ignore_label: float = -1.0, use_ignore: bool = False,
                   normalization: str = "null", multi_output: bool = False,
                   preserve_shape: bool = False, smooth_alpha: float = 0.0,
                   out_grad: bool = False):
    """Softmax forward; the backward is the cross entropy's gradient
    ``softmax - one_hot(label)`` (smoothed by ``smooth_alpha``, zero where
    ``use_ignore`` and the label is ``ignore_label``), divided by the batch
    ('batch') or the valid labels ('valid'), times ``grad_scale``.
    ``multi_output``: softmax over axis 1, a label a position."""
    return _SoftmaxOutput.apply(data, label, 1 if multi_output else -1,
                                grad_scale, ignore_label, use_ignore,
                                normalization, smooth_alpha)


class _RegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, label, kind, grad_scale):
        out = torch.sigmoid(x) if kind == "logistic" else x.view_as(x)
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.gs = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, lab = ctx.saved_tensors
        diff = out - lab.to(out.dtype)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        # MXNet divides by the outputs a batch row (DivNum over num_output)
        nout = max(1, math.prod(out.shape[1:]) if out.ndim > 1 else 1)
        return diff * (ctx.gs / nout), None, None, None


@_dtype_rule
def linear_regression_output(data, label, grad_scale: float = 1.0):
    """out = data; gradient ``out - label`` (the L2 head)."""
    return _RegressionOutput.apply(data, label, "linear", grad_scale)


@_dtype_rule
def mae_regression_output(data, label, grad_scale: float = 1.0):
    """out = data; gradient ``sign(out - label)`` (the L1 head)."""
    return _RegressionOutput.apply(data, label, "mae", grad_scale)


@_dtype_rule
def logistic_regression_output(data, label, grad_scale: float = 1.0):
    """out = sigmoid(data); gradient ``out - label``."""
    return _RegressionOutput.apply(data, label, "logistic", grad_scale)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@_dtype_rule
def make_loss(data, grad_scale: float = 1.0, normalization: str = "null",
              valid_thresh: float = 0.0):
    """Mark ``data`` as a loss: the backward injects ``grad_scale`` (over
    the batch for 'batch'), whatever the incoming cotangent."""
    scale = grad_scale / data.shape[0] if normalization == "batch" \
        else grad_scale
    return _MakeLoss.apply(data, scale)


# ------------------------------------------------- UpSampling, ROIPooling
@_dtype_rule
def up_sampling(data, scale: int = 2, sample_type: str = "nearest",
                num_filter: int = 0):
    """NCHW data enlarged ``scale`` times: 'nearest' repeats each pixel,
    'bilinear' interpolates at half-pixel centres (``jax.image.resize``'s
    'bilinear', which renormalizes the weights at the border, as clamping
    to the edge pixel does)."""
    s = int(scale)
    size = (data.shape[2] * s, data.shape[3] * s)
    if sample_type == "nearest":
        return F.interpolate(data, size=size, mode="nearest")
    if sample_type == "bilinear":
        return F.interpolate(data, size=size, mode="bilinear",
                             align_corners=False)
    raise MXNetError(f"unknown sample_type {sample_type!r}")


@_dtype_rule
def roi_pooling(data, rois, pooled_size, spatial_scale: float = 1.0):
    """Max pooling of each region of interest into ``pooled_size`` bins.

    data (N, C, H, W); rois (R, 5) of [batch_idx, x1, y1, x2, y2] in image
    coordinates, rounded onto the feature map after ``spatial_scale``.
    Returns (R, C, ph, pw); an empty bin gives 0. Every ROI at once: a bin
    is a masked maximum over the ROI's plane, rows first (a loop over the
    ph bin rows), then the pw columns together."""
    ph, pw = (pooled_size, pooled_size) if isinstance(pooled_size, int) \
        else tuple(pooled_size)
    N, C, H, W = data.shape
    dev = data.device
    b = rois[:, 0].long()
    b = torch.where(b < 0, b + N, b).clamp(0, N - 1)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale).int()
                      for i in range(1, 5))

    def per_bin(extent, bins):
        """A ROI's extent over its bins, correctly rounded: PyTorch divides
        by a host scalar on the GPU as a product by its reciprocal, whose
        rounding would move a bin edge that falls on an integer."""
        return extent.clamp_min(1).float() / torch.full(
            (), bins, dtype=torch.float32, device=dev)
    bin_h, bin_w = per_bin(y2 - y1 + 1, ph), per_bin(x2 - x1 + 1, pw)

    def member(n_bins, bin_len, lo, extent):
        """(R, bins, extent): is position p in bin i of each ROI?"""
        i = torch.arange(n_bins, device=dev, dtype=torch.float32)[None, :]
        start = torch.floor(i * bin_len[:, None]).int() + lo[:, None]
        end = torch.ceil((i + 1) * bin_len[:, None]).int() + lo[:, None]
        p = torch.arange(extent, device=dev)[None, None, :]
        return (p >= start[..., None]) & (p < end.clamp_max(extent)[..., None])

    hmask, wmask = member(ph, bin_h, y1, H), member(pw, bin_w, x1, W)
    feats = data[b]                                       # (R, C, H, W)
    neg = torch.tensor(torch.finfo(data.dtype).min, dtype=data.dtype,
                       device=dev)
    rows = []
    for i in range(ph):
        m = torch.where(hmask[:, i][:, None, :, None], feats, neg).amax(2)
        rows.append(torch.where(wmask[:, None], m[:, :, None], neg).amax(-1))
    out = torch.stack(rows, dim=-2)                       # (R, C, ph, pw)
    empty = ~(hmask.any(-1)[:, :, None] & wmask.any(-1)[:, None, :])
    return torch.where(empty[:, None], torch.zeros_like(out), out)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             layout: str = "NTC"):
    """Functional CTC loss: :class:`~mxnet_tpu_torch.gluon.loss.CTCLoss`
    with ``layout``, as in the JAX package."""
    from ..gluon.loss import CTCLoss
    return CTCLoss(layout=layout)(data, label, data_lengths, label_lengths)


def arange_like(data, start: float = 0.0, step: float = 1.0, axis=None):
    """An f32 range shaped like ``data`` (``axis=None``, ravel order), or
    as long as its axis ``axis``, on the data's device."""
    n = data.numel() if axis is None else data.shape[axis]
    r = torch.arange(n, dtype=torch.float32, device=data.device) * step \
        + start
    return r.reshape(data.shape) if axis is None else r
