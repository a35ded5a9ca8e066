"""Random sampling (``mx.random`` / ``mx.nd.random``).

Counterpart of ``mxnet_tpu/ndarray/random.py:50-241`` (``seed``, ``uniform``,
``rand``, ``normal``, ``randn``, ``randint``, ``bernoulli``, ``multinomial``,
``shuffle``). Every draw comes from the framework generator of its device,
``mxnet_tpu_torch.random.generator(device)``, never from torch's global
one, so ``seed(n)`` alone makes the streams repeat. The streams are
Philox's, not the JAX package's threefry: the two agree in distribution,
not in bits.

``seed`` and ``generator`` are those of ``mxnet_tpu_torch/random.py``, so
this module serves as ``mx.random`` too.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..context import Context, current_context
from ..random import generator, seed
from .ndarray import NDArray, to_torch_dtype

__all__ = ["seed", "generator", "uniform", "rand", "normal", "randn",
           "randint", "bernoulli", "multinomial", "shuffle"]


def _shape(shape) -> tuple:
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _draw(fn, ctx: Optional[Context]) -> NDArray:
    ctx = ctx or current_context()
    dev = ctx.torch_device
    return NDArray(fn(dev, generator(dev)), ctx=ctx, _wrap=True)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None, **kw):
    """Samples uniform in [low, high)."""
    shp, dt = _shape(shape), to_torch_dtype(dtype)
    return _draw(lambda dev, g: low + (high - low) * torch.rand(
        shp, generator=g, device=dev, dtype=dt), ctx)


def rand(*shape, ctx=None, dtype="float32"):
    return uniform(0.0, 1.0, shape=shape, dtype=dtype, ctx=ctx)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None, **kw):
    shp, dt = _shape(shape), to_torch_dtype(dtype)
    return _draw(lambda dev, g: loc + scale * torch.randn(
        shp, generator=g, device=dev, dtype=dt), ctx)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape=shape, dtype=dtype, ctx=ctx)


def randint(low, high=None, shape=None, dtype="int32", ctx=None, **kw):
    """Integers in [low, high) (``randint(high)`` draws from [0, high))."""
    if high is None:
        low, high = 0, low
    shp, dt = _shape(shape), to_torch_dtype(dtype)
    return _draw(lambda dev, g: torch.randint(
        low, high, shp, generator=g, device=dev, dtype=dt), ctx)


def bernoulli(prob=0.5, shape=None, dtype="float32", ctx=None, **kw):
    shp, dt = _shape(shape), to_torch_dtype(dtype)
    return _draw(lambda dev, g: (torch.rand(
        shp, generator=g, device=dev) < prob).to(dt), ctx)


def multinomial(data, shape=1, get_prob=False, dtype="int32", **kw):
    """Category indices drawn from (rows of) probabilities; with
    ``get_prob=True`` also the log-probability of each draw."""
    probs = data._data.detach() if isinstance(data, NDArray) \
        else torch.as_tensor(data)
    n = shape if isinstance(shape, int) else int(torch.tensor(shape).prod())
    squeeze = isinstance(shape, int) and shape == 1
    logp_all = torch.log_softmax(torch.log(probs.float().clamp_min(1e-38)),
                                 dim=-1)
    rows = logp_all.reshape(-1, logp_all.shape[-1])
    out = torch.multinomial(logp_all.exp().reshape(rows.shape), n,
                            replacement=True,
                            generator=generator(probs.device))
    logp = torch.gather(rows, 1, out)
    if probs.ndim == 1:
        out, logp = out[0], logp[0]
    if squeeze:
        out, logp = out[..., 0], logp[..., 0]
    ctx = data.context if isinstance(data, NDArray) else None
    res = NDArray(out.to(to_torch_dtype(dtype)), ctx=ctx, _wrap=True)
    if get_prob:
        return res, NDArray(logp, ctx=ctx, _wrap=True)
    return res


def shuffle(data: Any) -> NDArray:
    """A random permutation along the first axis (the ``shuffle`` op)."""
    from . import ops
    return ops.shuffle(data)
