"""Block / HybridBlock as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py`` (``Block``, ``HybridBlock``,
``remat_stack``, ``PreActivation``). ``collect_params()`` returns the JAX
package's dotted names (``encoder.layers.0.attn_qkv.weight``), which are the attribute
paths ``named_parameters`` gives when children and parameters are
assigned as attributes. Training behaviour (dropout) follows the
framework flag of ``autograd.record()`` / ``autograd.train_mode()``, as
in the JAX package, not torch's per-module ``training`` attribute.
``hybridize()`` is accepted and does nothing: PyTorch runs eagerly.
``save_parameters`` / ``load_parameters`` read and write the JAX package's
``.params`` files (``ndarray_io.py``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional

import torch

from .. import initializer as _init_mod
from ..base import MXNetError
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

    def save_parameters(self, filename: str, deduplicate: bool = False
                        ) -> None:
        """Save every initialized persistent parameter, by its
        ``collect_params()`` name, in the parameter's dtype."""
        from ..ndarray_io import save_params
        save_params(filename, {
            k: p.detach() for k, p in self.collect_params().items()
            if getattr(p, "initialized", True)
            and getattr(p, "persistent", True)})

    def load_parameters(self, filename: str, ctx: Any = None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False,
                        cast_dtype: bool = False) -> "Block":
        """Load a ``.params`` file written by either package. Strict
        unless told otherwise: a persistent parameter missing from the
        file, or a name in the file that the block lacks, raises. Each
        parameter takes the file's value and dtype on its own device
        (the JAX package's ``set_data``). Non-persistent state is not in
        a file: BatchNorm's ``stat_shift`` is rebuilt as zeros, as
        ``convert.load_jax_params`` does, so the next training forward
        takes centered statistics."""
        from ..ndarray_io import read_tensors
        loaded = read_tensors(filename)
        own = self.collect_params()
        persistent = {k for k, p in own.items()
                      if getattr(p, "persistent", True)}
        missing = sorted(persistent - set(loaded))
        if missing and not allow_missing:
            raise MXNetError(f"Parameters {missing} missing in file "
                             f"{filename}")
        extra = sorted(set(loaded) - set(own))
        if extra and not ignore_extra:
            raise MXNetError(f"File {filename} contains extra parameters: "
                             f"{extra}")
        bad = [f"{k}: {tuple(loaded[k].shape)} vs {tuple(p.shape)}"
               for k, p in own.items()
               if k in loaded and tuple(loaded[k].shape) != tuple(p.shape)]
        if bad:
            raise MXNetError(f"load_parameters: shape mismatch: {bad}")
        with torch.no_grad():
            for k, p in own.items():
                if k in loaded:
                    p.data = loaded[k].to(p.device)
                elif k not in persistent:
                    p.zero_()
                else:
                    continue
                p.initialized = True
        return self if ctx is None else self.to(as_device(ctx))


class HybridBlock(Block):
    """A Block the JAX package can compile; here the same as Block."""
