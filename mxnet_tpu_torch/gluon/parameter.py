"""Parameter — a block's named, shaped value, with MXNet's accessors.

Counterpart of ``mxnet_tpu/gluon/parameter.py:Parameter``. MXNet's
``data()`` and ``grad()`` are methods, while PyTorch reads and writes
``.data`` and ``.grad`` as attributes of every tensor, so one object cannot
be both a ``torch.nn.Parameter`` and an MXNet parameter. As the JAX
package's ``Parameter`` owns its array, this one owns a
``torch.nn.Parameter`` (``_var``): a Block registers ``_var`` with
``nn.Module`` under the attribute's name, so ``named_parameters``,
``.to()``, ``state_dict`` and autograd see the tensor, while the attribute
itself (``dense.weight``) is this object. Layers compute with
``p.data()``, the tensor itself (an autograd leaf on the parameter's
device; the port's blocks take and give tensors, not NDArrays).

The accessors follow the JAX package (``:95-280``): ``name``, ``shape``,
``dtype``, ``data(ctx)``, ``list_data()``, ``grad(ctx)``, ``list_grad()``,
``list_ctx()``, ``set_data()``, ``zero_grad()``, ``initialize()``,
``reset_ctx()``, ``cast()``, ``is_initialized``, ``grad_req``,
``lr_mult`` and ``wd_mult``; the constructor takes its arguments
(``differentiable=False`` means ``grad_req='null'``). Shapes must be known
at construction, and gradients are dense: deferred initialization and
``grad_stype='row_sparse'`` raise, naming their ROADMAP Queue A items.

Gradients: ``grad_req`` follows MXNet through
:func:`mxnet_tpu_torch.autograd.backward`: ``'write'`` replaces the
gradient on each backward, ``'add'`` accumulates until ``zero_grad()``,
``'null'`` turns the gradient off. ``_fresh_grad`` says a backward wrote
the gradient since the trainer last used it. ``persistent=False`` marks
runtime-only state (BatchNorm's ``stat_shift``) that a parameter file need
not carry (see :func:`mxnet_tpu_torch.convert.load_jax_params`).
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import numpy as _np
import torch

from ..base import MXNetError
from ..context import Context, as_device

__all__ = ["Parameter", "to_torch_dtype", "context_of", "data_or_none",
           "dedupe_shared"]

_GRAD_REQS = ("write", "add", "null")


def to_torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype == "bfloat16":
        return torch.bfloat16
    return getattr(torch, _np.dtype(dtype).name)


def context_of(device: torch.device) -> Context:
    """The :class:`Context` of a ``torch.device``."""
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)


class Parameter:
    """A learnable parameter of a Block: ``Parameter(name, shape=...)``,
    with the JAX package's argument order."""

    def __init__(self, name: str = "weight", grad_req: str = "write",
                 shape: Optional[Union[int, Tuple[int, ...]]] = None,
                 dtype: Any = "float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init: Any = None,
                 allow_deferred_init: bool = True,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default",
                 persistent: bool = True) -> None:
        if isinstance(shape, int):
            shape = (shape,)
        if shape is None or any(int(s) <= 0 for s in shape):
            raise MXNetError(
                f"Parameter {name!r}: shape {shape} is not fully known; "
                "the port needs every shape at construction (pass in_units/"
                "in_channels): deferred initialization is not ported yet "
                "(ROADMAP Queue A 8)")
        if stype != "default":
            raise ValueError(
                f"Parameter stype={stype!r} is not supported (only "
                "'default'; sparse *gradients* come via grad_stype)")
        if grad_stype == "row_sparse":
            raise MXNetError(f"Parameter {name!r}: row-sparse gradients are "
                             "not ported yet (ROADMAP Queue A 10)")
        if grad_stype != "default":
            raise ValueError(f"invalid grad_stype {grad_stype!r}")
        if not differentiable:
            grad_req = "null"
        self._name = name
        self.init = init
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.persistent = persistent
        self.initialized = False
        self._fresh_grad = False
        self._bind(torch.nn.Parameter(
            torch.zeros(tuple(int(s) for s in shape),
                        dtype=to_torch_dtype(dtype)),
            requires_grad=grad_req != "null"))
        self.grad_req = grad_req

    def _bind(self, var: torch.nn.Parameter) -> None:
        """Own ``var``; autograd finds this parameter from its leaf."""
        self._var = var
        var._mx_param = self

    # ---------------------------------------------------------- properties
    @property
    def name(self) -> str:
        return self._name

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._var.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._var.dtype

    @property
    def device(self) -> torch.device:
        return self._var.device

    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str) -> None:
        if req not in _GRAD_REQS:
            raise ValueError(f"invalid grad_req {req!r}; one of {_GRAD_REQS}")
        self._grad_req = req
        self._var.requires_grad_(req != "null")
        if req == "null":
            self._var.grad = None

    # ----------------------------------------------------------- accessors
    def data(self, ctx: Any = None) -> torch.Tensor:
        """The value: the parameter's own tensor, or a copy on ``ctx``
        when that is another device."""
        if ctx is not None:
            dev = as_device(ctx)
            if dev != self._var.device:
                return self._var.to(dev)
        return self._var

    def list_data(self) -> List[torch.Tensor]:
        return [self.data()]

    def grad(self, ctx: Any = None) -> torch.Tensor:
        """The gradient buffer (zeros before the first backward)."""
        if self._grad_req == "null":
            raise MXNetError(f"Parameter {self._name!r} has grad_req='null'; "
                             "no gradient buffer exists")
        if self._var.grad is None:
            self._var.grad = torch.zeros_like(self._var)
        g = self._var.grad
        if ctx is not None and as_device(ctx) != g.device:
            return g.to(as_device(ctx))
        return g

    def list_grad(self) -> List[torch.Tensor]:
        return [self.grad()]

    def list_ctx(self) -> List[Context]:
        return [context_of(self._var.device)]

    def set_data(self, data: Any) -> None:
        """Replace the value in place (the tensor object, its gradient
        requirement and its device stay; the value's dtype is taken)."""
        if not isinstance(data, torch.Tensor):
            data = getattr(data, "_data", data)   # an NDArray
            data = torch.as_tensor(_np.asarray(data)) \
                if not isinstance(data, torch.Tensor) else data
        if tuple(data.shape) != self.shape:
            raise MXNetError(f"Parameter {self._name!r}: set_data shape "
                             f"{tuple(data.shape)} != declared {self.shape}")
        self._var.data = data.detach().to(self._var.device).clone()
        self.initialized = True

    def zero_grad(self) -> None:
        """Set the gradient to zeros (``grad_req='add'`` accumulates from
        there); zeros, not ``grad * 0``, so NaN or Inf does not survive."""
        if self._var.grad is not None:
            self._var.grad = torch.zeros_like(self._var.grad)

    # ----------------------------------------------------------- lifecycle
    def initialize(self, init: Any = None, ctx: Any = None,
                   default_init: Any = None, force_reinit: bool = False,
                   *, generator: Optional[torch.Generator] = None,
                   device: Any = None) -> None:
        """Fill the value from ``init`` (else the parameter's own
        initializer, else ``default_init``, else ``Uniform()``: the JAX
        package's precedence) on ``ctx`` / ``device`` (the current context,
        ``cuda:0``, when neither is given). Values are drawn from
        ``generator``, by default the framework generator of that device
        (:func:`mxnet_tpu_torch.random.generator`)."""
        from .. import initializer as _init_mod
        from .. import random as _random
        if self.initialized and not force_reinit:
            return
        dev = resolve_device(ctx, device)
        if generator is None:
            generator = _random.generator(dev)
        ini = _init_mod.get(init or self.init or default_init
                            or _init_mod.Uniform())
        with torch.no_grad():
            self._var.data = ini(self.shape, generator, dtype=self.dtype,
                                 device=dev)
        self.initialized = True

    def reset_ctx(self, ctx: Any) -> None:
        """Move the value (and its gradient) to ``ctx``."""
        dev = as_device(ctx)
        with torch.no_grad():
            self._var.data = self._var.data.to(dev)
            if self._var.grad is not None:
                self._var.grad = self._var.grad.to(dev)

    def cast(self, dtype: Any) -> None:
        """Change the value's dtype in place (and the gradient's)."""
        dt = to_torch_dtype(dtype)
        with torch.no_grad():
            self._var.data = self._var.data.to(dt)
            if self._var.grad is not None:
                self._var.grad = self._var.grad.to(dt)

    @property
    def is_initialized(self) -> bool:
        return self.initialized

    def __repr__(self) -> str:
        return (f"Parameter {self._name} (shape={self.shape}, "
                f"dtype={self.dtype})")


def data_or_none(p: Optional[Parameter]) -> Optional[torch.Tensor]:
    """``p.data()``, or None for an absent optional parameter (a layer
    built without a bias)."""
    return None if p is None else p.data()


def resolve_device(ctx: Any = None, device: Any = None) -> torch.device:
    """``ctx`` and ``device`` are one argument under two names (MXNet's and
    the port's); a list of contexts means its first. Neither: the current
    context."""
    if ctx is not None and device is not None:
        raise MXNetError("pass ctx or device, not both (they are the same "
                         "argument)")
    where = ctx if ctx is not None else device
    if isinstance(where, (list, tuple)):
        where = where[0] if where else None
    return as_device(where)


def dedupe_shared(named_params):
    """Keep each Parameter once, under its first name (a tied parameter,
    such as BERT's MLM decoder weight, is optimised and exported once);
    the JAX package's ``dedupe_shared``. Returns (names, params)."""
    names, params, seen = [], [], set()
    for name, p in named_params:
        if id(p) not in seen:
            seen.add(id(p))
            names.append(name)
            params.append(p)
    return names, params
