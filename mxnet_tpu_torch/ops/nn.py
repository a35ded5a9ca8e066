"""Neural-network ops used by the BERT model and its loss.

Counterpart of the matching functions in ``mxnet_tpu/ops/nn.py``:
``fully_connected`` (weight layout (num_hidden, in_units)), ``activation``,
``gelu`` (exact erf form unless ``approximate``), ``layer_norm``,
``dropout`` (identity outside training), ``embedding``, ``take_positions``,
``log_softmax`` and ``pick``. Plain functions on tensors; the matrix
products go to PyTorch's GEMM (cuBLAS on the GPU) as the JAX package left
them to XLA. Random draws take the framework generator of the data's
device (:mod:`mxnet_tpu_torch.random`), never torch's global one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import random as _random
from ..autograd import is_training

__all__ = ["fully_connected", "activation", "gelu", "layer_norm", "dropout",
           "embedding", "take_positions", "log_softmax", "pick"]

_ACT_FNS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}


def fully_connected(data, weight, bias=None, num_hidden: Optional[int] = None,
                    no_bias: bool = False, flatten: bool = True):
    """y = x · Wᵀ + b with the reference weight layout (num_hidden, in_units)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


def activation(data, act_type: str = "relu"):
    return _ACT_FNS[act_type](data)


def gelu(data, approximate: bool = False):
    return F.gelu(data, approximate="tanh" if approximate else "none")


def layer_norm(data, gamma, beta, axis: int = -1, eps: float = 1e-5):
    x = data.movedim(axis, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return out.movedim(-1, axis)


def dropout(data, p: float = 0.5, training: Optional[bool] = None):
    """Inverted dropout; identity unless training (``autograd.is_training()``
    when ``training`` is None) and ``p > 0``. The mask draws from the
    framework generator of the data's device."""
    train = is_training() if training is None else training
    if not train or p <= 0.0:
        return data
    keep = torch.rand(data.shape, device=data.device,
                      generator=_random.generator(data.device)) >= p
    return torch.where(keep, data / (1.0 - p), torch.zeros_like(data))


def embedding(data, weight, input_dim: Optional[int] = None,
              output_dim: Optional[int] = None):
    """Table lookup: out[i...] = weight[data[i...]]."""
    return F.embedding(data.long(), weight)


def take_positions(data, positions):
    """Gather per-batch sequence positions: (B,T,C),(B,P) -> (B,P,C)."""
    idx = positions.long()[:, :, None].expand(-1, -1, data.shape[-1])
    return torch.gather(data, 1, idx)


def log_softmax(data, axis: int = -1):
    return torch.log_softmax(data, dim=axis)


def pick(data, index, axis: int = -1, keepdims: bool = False):
    """``out[i...] = data[i..., index[i...], ...]`` along ``axis``."""
    out = torch.gather(data, axis, index.long().unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
