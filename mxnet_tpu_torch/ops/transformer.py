"""Transformer attention ops.

Counterpart of ``mxnet_tpu/ops/transformer.py`` (``_mask_to_bias``,
``dot_product_attention``, ``multi_head_attention`` and the four
``interleaved_matmul_*`` operators of MXNet's fused-QKV API), with the same
(B, T, C) / (B, T, H, D) layouts and mask-to-bias rules; the interleaved
operators take MXNet's (T, N, 3 * H * D) layout, each head's q, k and v
side by side, and are batched matrix products (cuBLAS on the GPU).
Attention always goes through
:func:`~mxnet_tpu_torch.ops.cuda.attention.flash_attention`: on a CUDA
tensor that is the Hopper kernel, on a CPU tensor its plain version.
There is no length threshold.

As in the JAX package's routing: a boolean mask is not learned, so the
kernel is told ``bias_grad=False`` and skips the O(B*H*T^2) softmax
cotangent; a float mask is learned and gets a gradient. Attention dropout
applies only in training (``autograd.is_training()`` unless the caller
says), with its (2,) int32 kernel seed drawn from the framework generator
of the data's device. ``MXNET_FLASH_BLOCK_K`` is read per call as in the
JAX package and picks the backward's route: the fused single pass when
T <= block_k, the two-pass dq/dkv kernels otherwise.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import random as _random
from ..autograd import is_training
from ..base import getenv, register_env
from .cuda.attention import DEFAULT_BLOCK_K, flash_attention

__all__ = ["dot_product_attention", "multi_head_attention",
           "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt"]

register_env("MXNET_FLASH_BLOCK_K", DEFAULT_BLOCK_K,
             "Flash-attention key-block rows: the backward runs the fused "
             "single pass when Tk <= this, the two-pass kernels otherwise.")


def _flash_block_k() -> int:
    return int(getenv("MXNET_FLASH_BLOCK_K", 0)) or DEFAULT_BLOCK_K


def _mask_to_bias(mask, dtype, batch: int, tq: int, tk: int):
    """Normalize a mask to an additive bias of rank 4 (B/1, H/1, Tq/1, Tk).

    Accepted shapes: (B, Tk) key-padding mask (the canonical BERT
    valid-length mask), (Tq, Tk) score mask, (B, Tq, Tk), or rank-4
    (B/1, H/1, Tq/1, Tk). Boolean True = attend; masked keys get
    ``finfo(dtype).min``.
    """
    if mask.dtype == torch.bool:
        bias = torch.where(
            mask, torch.zeros((), dtype=dtype, device=mask.device),
            torch.full((), torch.finfo(dtype).min, dtype=dtype,
                       device=mask.device))
    else:
        bias = mask
    if bias.ndim == 2:
        if tuple(bias.shape) == (batch, tk) and (batch != tq or tq == tk):
            bias = bias[:, None, None, :]      # key-padding: (B,1,1,Tk)
        else:
            bias = bias[None, None, :, :]      # score mask: (1,1,Tq,Tk)
    elif bias.ndim == 3:
        bias = bias[:, None, :, :]             # (B,1,Tq,Tk)
    return bias


def _attn_seed(device) -> torch.Tensor:
    """(2,) int32 kernel dropout seed from the framework stream."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), dtype=torch.int32,
                         device=device, generator=_random.generator(device))


def dot_product_attention(query, key, value, mask=None,
                          scale: Optional[float] = None,
                          dropout: float = 0.0, causal: bool = False,
                          training: Optional[bool] = None):
    """Scaled dot-product attention over (B, T, H, D) q/k/v; returns
    (B, T, H, D). ``dropout`` applies only in training
    (``autograd.is_training()`` when ``training`` is None)."""
    train = is_training() if training is None else training
    rate = float(dropout) if train else 0.0
    bias = None
    if mask is not None:
        bias = _mask_to_bias(mask, query.dtype, query.shape[0],
                             query.shape[1], key.shape[1])
    return flash_attention(
        query, key, value, scale=scale, causal=causal, bias=bias,
        block_k=_flash_block_k(), dropout=rate,
        dropout_seed=_attn_seed(query.device) if rate > 0 else None,
        bias_grad=mask is not None and mask.dtype != torch.bool)


def multi_head_attention(query, key, value, num_heads: int, mask=None,
                         causal: bool = False, scale: Optional[float] = None,
                         dropout: float = 0.0,
                         training: Optional[bool] = None):
    """(B, T, C) inputs already projected; splits heads, attends, merges.
    The head split is a view: the kernel reads q/k/v where they lie."""
    B, Tq, C = query.shape
    Tk = key.shape[1]
    d = C // num_heads
    qh = query.reshape(B, Tq, num_heads, d)
    kh = key.reshape(B, Tk, num_heads, d)
    vh = value.reshape(B, Tk, num_heads, d)
    out = dot_product_attention(qh, kh, vh, mask=mask, scale=scale,
                                dropout=dropout, causal=causal,
                                training=training)
    return out.reshape(B, Tq, C)


def _heads(x, T: int, N: int, nh: int, d: int):
    """(T, N, nh, d) -> (N * nh, T, d)."""
    return x.permute(1, 2, 0, 3).reshape(N * nh, T, d)


def _merge(out, N: int, nh: int, d: int):
    """(N * nh, T, d) -> (T, N, nh * d)."""
    T = out.shape[1]
    return out.reshape(N, nh, T, d).permute(2, 0, 1, 3).reshape(T, N, nh * d)


def _scaled(q, d: int):
    """``q / sqrt(d)``, the factor computed in q's dtype as the JAX
    package computes it."""
    return q * (1.0 / torch.sqrt(torch.tensor(d, dtype=q.dtype,
                                              device=q.device)))


def interleaved_matmul_selfatt_qk(queries_keys_values, heads: int):
    """Scaled q k^T from the interleaved (T, N, 3 * H * D) projection:
    (N * H, T, T)."""
    T, N, C3 = queries_keys_values.shape
    d = C3 // (3 * heads)
    x = queries_keys_values.reshape(T, N, heads, 3, d)
    q, k = (_heads(x[:, :, :, i], T, N, heads, d) for i in (0, 1))
    return torch.bmm(_scaled(q, d), k.transpose(1, 2))


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads: int):
    """attention · v back to (T, N, H * D)."""
    T, N, C3 = queries_keys_values.shape
    d = C3 // (3 * heads)
    v = _heads(queries_keys_values.reshape(T, N, heads, 3, d)[:, :, :, 2],
               T, N, heads, d)
    return _merge(torch.bmm(attention, v), N, heads, d)


def interleaved_matmul_encdec_qk(queries, keys_values, heads: int):
    """Scaled q k^T of queries (Tq, N, H * D) against the interleaved
    (Tk, N, 2 * H * D) keys and values: (N * H, Tq, Tk)."""
    Tq, N, C = queries.shape
    Tk, d = keys_values.shape[0], C // heads
    q = _heads(queries.reshape(Tq, N, heads, d), Tq, N, heads, d)
    k = _heads(keys_values.reshape(Tk, N, heads, 2, d)[:, :, :, 0], Tk, N,
               heads, d)
    return torch.bmm(_scaled(q, d), k.transpose(1, 2))


def interleaved_matmul_encdec_valatt(keys_values, attention, heads: int):
    """attention · v of the interleaved keys and values: (Tq, N, H * D)."""
    Tk, N, C2 = keys_values.shape
    d = C2 // (2 * heads)
    v = _heads(keys_values.reshape(Tk, N, heads, 2, d)[:, :, :, 1], Tk, N,
               heads, d)
    return _merge(torch.bmm(attention, v), N, heads, d)
