"""Parameter — a named, shaped ``torch.nn.Parameter``.

Counterpart of ``mxnet_tpu/gluon/parameter.py:Parameter``, kept thin: the
tensor is an ``nn.Parameter`` (so ``Module.to``/``parameters()`` see it),
and it carries the JAX package's name, its initializer, ``grad_req`` and
the optimizer's ``lr_mult``/``wd_mult``. Shapes must be known at
construction (deferred initialization is not part of the port yet).

Gradients: the parameter is a tensor, so its gradient is torch's ``.grad``
attribute (the JAX package's ``p.grad()`` is ``p.grad`` here, and
``list_grad()`` as there). ``grad_req`` follows MXNet through
:func:`mxnet_tpu_torch.autograd.backward`: ``'write'`` replaces the
gradient on each backward, ``'add'`` accumulates until ``zero_grad()``,
``'null'`` turns the gradient off. ``_fresh_grad`` says a backward wrote
the gradient since the trainer last used it. ``persistent=False`` marks
runtime-only state (BatchNorm's ``stat_shift``) that a parameter file need
not carry (see :func:`mxnet_tpu_torch.convert.load_jax_params`).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as _np
import torch

from ..base import MXNetError

__all__ = ["Parameter", "to_torch_dtype"]

_GRAD_REQS = ("write", "add", "null")


def to_torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16":
        return torch.bfloat16
    return getattr(torch, _np.dtype(dtype).name)


class Parameter(torch.nn.Parameter):
    """A learnable parameter of a Block: ``Parameter(name, shape=...)``."""

    def __new__(cls, name: str = "weight",
                shape: Optional[Union[int, Tuple[int, ...]]] = None,
                dtype: Any = "float32", init: Any = None,
                grad_req: str = "write", lr_mult: float = 1.0,
                wd_mult: float = 1.0, persistent: bool = True) -> "Parameter":
        if isinstance(shape, int):
            shape = (shape,)
        if shape is None or any(int(s) <= 0 for s in shape):
            raise MXNetError(
                f"Parameter {name!r}: shape {shape} is not fully known; "
                "the port needs every shape at construction (pass in_units/"
                "in_channels)")
        data = torch.zeros(tuple(int(s) for s in shape),
                           dtype=to_torch_dtype(dtype))
        self = torch.Tensor._make_subclass(cls, data, grad_req != "null")
        self.mx_name = name
        self.init = init
        self.grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.persistent = persistent
        self.initialized = False
        self._fresh_grad = False
        return self

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in _GRAD_REQS:
            raise ValueError(f"invalid grad_req {req!r}; one of {_GRAD_REQS}")
        self._grad_req = req
        self.requires_grad_(req != "null")
        if req == "null":
            self.grad = None

    def list_grad(self):
        if self._grad_req == "null":
            raise MXNetError(f"Parameter {self.mx_name!r} has "
                             "grad_req='null'; it has no gradient")
        return [self.grad]

    def zero_grad(self) -> None:
        """Set the gradient to zeros (``grad_req='add'`` accumulates from
        there); zeros, not ``grad * 0``, so NaN or Inf does not survive."""
        if self.grad is not None:
            self.grad = torch.zeros_like(self.grad)

    def __repr__(self) -> str:
        return (f"Parameter {self.mx_name} (shape={tuple(self.shape)}, "
                f"dtype={self.dtype})")
