"""Block / HybridBlock as ``torch.nn.Module`` subclasses.

Counterpart of ``mxnet_tpu/gluon/block.py`` (``Block``, ``HybridBlock``,
``_ParamDict``, ``remat_stack``, ``PreActivation``). A
:class:`~.parameter.Parameter` assigned as an attribute stays the attribute
(``dense.weight``), while its tensor is registered with ``nn.Module`` under
the same name, so ``named_parameters``, ``.to()`` and ``state_dict`` see
it; ``.to()`` and ``cast()`` leave every Parameter bound to the live
tensor. ``collect_params(select)`` returns a :class:`ParameterDict` keyed
by the JAX package's dotted names (``encoder.layers.0.attn_qkv.weight``),
in its order (a block's own parameters, then its children's), with the
batch operations of the JAX package's ``_ParamDict``. ``initialize`` takes
MXNet's arguments; without ``ctx`` it places parameters on the current
context (``cuda:0``). Training behaviour (dropout) follows the
framework flag of ``autograd.record()`` / ``autograd.train_mode()``, as
in the JAX package, not torch's per-module ``training`` attribute.
``hybridize()`` is accepted and does nothing: PyTorch runs eagerly.
``save_parameters`` / ``load_parameters`` read and write the JAX package's
``.params`` files (``ndarray_io.py``).
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Optional

import torch

from .. import random as _random
from ..base import MXNetError
from ..context import as_device
from .parameter import Parameter, resolve_device, to_torch_dtype

__all__ = ["Block", "HybridBlock", "ParameterDict", "remat_stack",
           "PreActivation"]


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


class ParameterDict(OrderedDict):
    """Name → :class:`~.parameter.Parameter` with batch operations (the
    JAX package's ``_ParamDict``, MXNet's ``ParameterDict``)."""

    def initialize(self, init: Any = None, ctx: Any = None,
                   force_reinit: bool = False, verbose: bool = False, *,
                   generator: Optional[torch.Generator] = None,
                   device: Any = None) -> None:
        """Initialize every parameter in order, drawing from one
        ``generator`` (by default the framework generator of the
        device)."""
        dev = resolve_device(ctx, device)
        if generator is None:
            generator = _random.generator(dev)
        for p in self.values():
            p.initialize(init, device=dev, force_reinit=force_reinit,
                         generator=generator)

    def zero_grad(self) -> None:
        for p in self.values():
            p.zero_grad()

    def setattr(self, name: str, value: Any) -> None:
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx: Any) -> None:
        for p in self.values():
            p.reset_ctx(ctx)

    def save(self, filename: str) -> None:
        """Write every initialized persistent parameter to a ``.params``
        file, in its dtype."""
        from ..ndarray_io import save_params
        save_params(filename, {k: p.data().detach() for k, p in self.items()
                               if p.initialized and p.persistent})

    def load(self, filename: str, ctx: Any = None,
             allow_missing: bool = False, ignore_extra: bool = False) -> None:
        """Read a ``.params`` file written by either package. Strict
        unless told otherwise, and checked before anything is set: a
        persistent parameter missing from the file, or a name in the file
        that is not here, raises; so does a shape that differs. Each
        parameter takes the file's value and dtype on its own device (on
        ``ctx`` when given). Non-persistent state is not in a file:
        BatchNorm's ``stat_shift`` is rebuilt as zeros, as
        ``convert.load_jax_params`` does, so the next training forward
        takes centered statistics."""
        from ..ndarray_io import read_tensors
        loaded = read_tensors(filename)
        missing = sorted(k for k, p in self.items()
                         if p.persistent and k not in loaded)
        if missing and not allow_missing:
            raise MXNetError(f"Parameters {missing} missing in file "
                             f"{filename}")
        extra = sorted(set(loaded) - set(self))
        if extra and not ignore_extra:
            raise MXNetError(f"File {filename} contains extra parameters: "
                             f"{extra}")
        bad = [f"{k}: {tuple(loaded[k].shape)} vs {p.shape}"
               for k, p in self.items()
               if k in loaded and tuple(loaded[k].shape) != p.shape]
        if bad:
            raise MXNetError(f"load: shape mismatch: {bad}")
        with torch.no_grad():
            for k, p in self.items():
                if k in loaded:
                    p.set_data(loaded[k])
                elif not p.persistent:
                    p.data().zero_()
                    p.initialized = True
                if ctx is not None:
                    p.reset_ctx(ctx)


class Block(torch.nn.Module):
    """Base class for all layers and models."""

    def __init__(self, prefix: Optional[str] = None, params: Any = None) -> None:
        super().__init__()
        object.__setattr__(self, "_reg_params", OrderedDict())
        self.training = False

    def __setattr__(self, name: str, value: Any) -> None:
        regs = self.__dict__.get("_reg_params")
        if isinstance(value, Parameter):
            super().__setattr__(name, value._var)   # nn.Module's registry
            object.__setattr__(self, name, value)   # the attribute
            regs[name] = value
            return
        if regs is not None and name in regs:
            del regs[name]
            del self.__dict__[name]
        super().__setattr__(name, value)

    def _apply(self, fn, recurse: bool = True):
        """``nn.Module._apply`` (``.to()``, ``.float()``, ...), then each
        Parameter re-bound to its tensor, should torch have replaced it."""
        out = super()._apply(fn, recurse)
        for name, p in self._reg_params.items():
            var = self._parameters.get(name)
            if var is not None and var is not p._var:
                p._bind(var)
        return out

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if args and isinstance(args[0], PreActivation) \
                and not getattr(type(self), "_consumes_preactivation", False):
            args = (args[0].materialize(),) + args[1:]
        return super().__call__(*args, **kwargs)

    def register_child(self, block: "Block", name: Optional[str] = None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    def register_parameter(self, name: str, param: Any) -> Any:
        """MXNet's form: register a :class:`~.parameter.Parameter` under
        ``name`` and return it. Anything else (a ``torch.nn.Parameter`` or
        None) takes ``nn.Module``'s."""
        if isinstance(param, Parameter):
            setattr(self, name, param)
            return param
        return super().register_parameter(name, param)

    @property
    def params(self) -> ParameterDict:
        """This block's own parameters (not its children's)."""
        return ParameterDict(self._reg_params)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """All parameters of self and descendants, keyed by attribute path;
        ``select`` keeps the names a regular expression matches (at their
        start, as ``re.match``)."""
        out = ParameterDict()
        self._collect_params(out, "")
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, p) for k, p in out.items()
                                if pat.match(k))
        return out

    def _collect_params(self, out: ParameterDict, prefix: str) -> None:
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for cname, child in self._modules.items():
            if isinstance(child, Block):
                child._collect_params(out, f"{prefix}{cname}.")

    def initialize(self, init: Any = None, ctx: Any = None,
                   verbose: bool = False, force_reinit: bool = False, *,
                   generator: Optional[torch.Generator] = None,
                   device: Any = None) -> "Block":
        """Fill every parameter not yet initialized (all of them with
        ``force_reinit``) from ``init`` (else its own initializer, else
        ``Uniform()``, the JAX package's precedence), drawing from
        ``generator`` (by default the framework generator of the device,
        :func:`mxnet_tpu_torch.random.generator`), and move the block to
        ``ctx`` / ``device``: the same argument under MXNet's name and the
        port's; neither means the current context (``cuda:0``)."""
        dev = resolve_device(ctx, device)
        self.collect_params().initialize(init, dev, force_reinit, verbose,
                                         generator=generator)
        return self.to(dev)

    def cast(self, dtype: Any) -> "Block":
        return self.to(to_torch_dtype(dtype))

    def reset_ctx(self, ctx: Any) -> None:
        """Move every parameter to ``ctx``."""
        self.collect_params().reset_ctx(ctx)

    def summary(self, *inputs: Any) -> str:
        """Print and return a table of every parameter's name, shape and
        size, and their total (the JAX package's ``nn_block_summary``)."""
        lines = [f"{'Layer':<40}{'Output Shape':<24}{'Param #':<12}"]
        total = 0
        for name, p in self.collect_params().items():
            n = 1
            for d in p.shape:
                n *= d
            total += n
            lines.append(f"{name:<40}{str(p.shape):<24}{n:<12}")
        lines.append(f"Total params: {total}")
        out = "\n".join(lines)
        print(out)
        return out

    def hybridize(self, active: bool = True, **kwargs: Any) -> None:
        """Accepted for API parity; the port runs eagerly."""

    def save_parameters(self, filename: str, deduplicate: bool = False
                        ) -> None:
        """Save every initialized persistent parameter, by its
        ``collect_params()`` name, in the parameter's dtype."""
        self.collect_params().save(filename)

    def load_parameters(self, filename: str, ctx: Any = None,
                        allow_missing: bool = False,
                        ignore_extra: bool = False,
                        cast_dtype: bool = False) -> "Block":
        """Load a ``.params`` file written by either package
        (:meth:`ParameterDict.load`)."""
        self.collect_params().load(filename, allow_missing=allow_missing,
                                   ignore_extra=ignore_extra)
        return self if ctx is None else self.to(as_device(ctx))


class HybridBlock(Block):
    """A Block the JAX package can compile; here the same as Block."""
