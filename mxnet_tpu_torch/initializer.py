"""Weight initializers with an explicit ``torch.Generator``.

Counterpart of ``mxnet_tpu/initializer.py`` (``Initializer``, ``Zero``,
``One``, ``Uniform``, ``Normal``, ``Xavier``, the string registry). The
JAX package draws from its global threefry stream; here every draw takes
the caller's generator, on that generator's device, and is then moved to
the parameter's device: a CPU generator gives the same weights whatever the
parameter's device; the framework generator of a device
(:func:`mxnet_tpu_torch.random.generator`, ``Block.initialize``'s default)
draws there.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "Xavier",
           "register", "get"]

_REGISTRY: Dict[str, type] = {}


def register(cls: type) -> type:
    """Register an initializer under its lowercased class name."""
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def get(name: Any) -> "Initializer":
    """Resolve a name/instance to an Initializer."""
    if isinstance(name, Initializer):
        return name
    if isinstance(name, str):
        key = name.lower()
        if key not in _REGISTRY:
            raise ValueError(f"unknown initializer {name!r}; "
                             f"known: {sorted(_REGISTRY)}")
        return _REGISTRY[key]()
    raise TypeError(f"cannot interpret {name!r} as an initializer")


class Initializer:
    """Base initializer; subclasses implement ``_init(shape, generator)``
    returning a float32 tensor on the generator's device."""

    def __call__(self, shape, generator: torch.Generator,
                 dtype: torch.dtype = torch.float32,
                 device: Any = "cpu") -> torch.Tensor:
        return self._init(tuple(shape), generator).to(device=device,
                                                       dtype=dtype)

    def _init(self, shape, generator):
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


@register
class Zero(Initializer):
    def _init(self, shape, generator):
        return torch.zeros(shape)


@register
class One(Initializer):
    def _init(self, shape, generator):
        return torch.ones(shape)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Uniform(Initializer):
    """U(-scale, scale); the reference's default for weights."""

    def __init__(self, scale: float = 0.07) -> None:
        self.scale = scale

    def _init(self, shape, generator):
        return (torch.rand(shape, generator=generator,
                           device=generator.device) * 2 - 1) * self.scale


@register
class Normal(Initializer):
    def __init__(self, sigma: float = 0.01) -> None:
        self.sigma = sigma

    def _init(self, shape, generator):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * self.sigma


@register
class Xavier(Initializer):
    """Xavier/Glorot with the reference's fan computation."""

    def __init__(self, rnd_type: str = "uniform",
                 factor_type: str = "avg", magnitude: float = 3.0) -> None:
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init(self, shape, generator):
        if len(shape) < 2:
            return torch.zeros(shape)
        hw = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in}.get(
            self.factor_type, fan_out)
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return (torch.rand(shape, generator=generator,
                               device=generator.device) * 2 - 1) * scale
        return torch.randn(shape, generator=generator,
                           device=generator.device) * scale
