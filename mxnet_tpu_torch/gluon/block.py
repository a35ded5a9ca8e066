"""Block / HybridBlock as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py`` (``Block``, ``HybridBlock``,
``remat_stack``, ``PreActivation``). ``collect_params()`` returns the JAX
package's dotted names (``encoder.layers.0.attn_qkv.weight``), which are the attribute
paths ``named_parameters`` gives when children and parameters are
assigned as attributes. Training behaviour (dropout) follows the
framework flag of ``autograd.record()`` / ``autograd.train_mode()``, as
in the JAX package, not torch's per-module ``training`` attribute.
``hybridize()`` is accepted and does nothing: PyTorch runs eagerly.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional

import torch

from .. import initializer as _init_mod
from ..context import as_device
from .parameter import Parameter, to_torch_dtype

__all__ = ["Block", "HybridBlock", "remat_stack", "PreActivation"]


class PreActivation:
    """A residual block's output BEFORE its epilogue ReLU, deferred so that
    a consuming 1x1 conv takes the ReLU as its kernel's prologue
    (``ops/cuda/conv_fused.py``). Blocks that understand the deferral set
    ``_consumes_preactivation = True``; every other ``Block.__call__``
    materializes it, so the box never reaches user code."""

    __slots__ = ("z",)

    def __init__(self, z) -> None:
        self.z = z

    def materialize(self):
        return torch.relu(self.z)


def remat_stack(layers, x, *extra, dropout: float = 0.0):
    """Apply ``layers`` in order, passing ``extra`` to each. A plain loop:
    the JAX package's ``MXNET_REMAT`` activation checkpointing is not
    ported yet."""
    for layer in layers:
        x = layer(x, *extra)
    return x


class Block(torch.nn.Module):
    """Base class for all layers and models."""

    def __init__(self, prefix: Optional[str] = None, params: Any = None) -> None:
        super().__init__()
        self.training = False

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if args and isinstance(args[0], PreActivation) \
                and not getattr(type(self), "_consumes_preactivation", False):
            args = (args[0].materialize(),) + args[1:]
        return super().__call__(*args, **kwargs)

    def register_child(self, block: "Block", name: Optional[str] = None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self) -> "OrderedDict[str, Parameter]":
        """All parameters of self and descendants, keyed by attribute path."""
        return OrderedDict(self.named_parameters())

    def initialize(self, init: Any = None, *, generator: torch.Generator,
                   device: Any = None, force_reinit: bool = False) -> "Block":
        """Fill every parameter from ``init`` (else its own initializer,
        else ``Uniform()``, the JAX package's precedence) drawing from
        ``generator``, and move the block to ``device`` (``cuda:0`` by
        default)."""
        dev = as_device(device)
        with torch.no_grad():
            for p in self.collect_params().values():
                if getattr(p, "initialized", False) and not force_reinit:
                    continue
                ini = init or getattr(p, "init", None) or _init_mod.Uniform()
                ini = _init_mod.get(ini)
                p.copy_(ini(p.shape, generator, dtype=p.dtype))
                p.initialized = True
        return self.to(dev)

    def cast(self, dtype: Any) -> "Block":
        return self.to(to_torch_dtype(dtype))

    def hybridize(self, active: bool = True, **kwargs: Any) -> None:
        """Accepted for API parity; the port runs eagerly."""


class HybridBlock(Block):
    """A Block the JAX package can compile; here the same as Block."""
