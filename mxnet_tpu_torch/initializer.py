"""Weight initializers with an explicit ``torch.Generator``.

Counterpart of ``mxnet_tpu/initializer.py`` (``Initializer``, ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``, ``Xavier``,
``MSRAPrelu``, ``LSTMBias``, ``Bilinear``, the string registry). The
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

import numpy as _np
import torch

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "LSTMBias", "Bilinear",
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

    def init_array(self, name: str, arr: Any) -> None:
        """MXNet's legacy form ``init(name, arr)``: fill ``arr`` (an
        NDArray or a tensor) in place, in its dtype and on its device,
        drawing from the framework generator of that device."""
        from .random import generator
        t = getattr(arr, "_data", arr)
        with torch.no_grad():
            t.copy_(self(t.shape, generator(t.device), dtype=t.dtype,
                         device=t.device))

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
class Constant(Initializer):
    def __init__(self, value: float = 0.0) -> None:
        self.value = value

    def _init(self, shape, generator):
        value = torch.from_numpy(_np.asarray(self.value, dtype=_np.float32))
        return torch.broadcast_to(value, shape).clone()


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


def _draw(shape, generator, rand_type: str):
    """U(-1, 1) for 'uniform', else N(0, 1), on the generator's device."""
    if rand_type == "uniform":
        return torch.rand(shape, generator=generator,
                          device=generator.device) * 2 - 1
    return torch.randn(shape, generator=generator, device=generator.device)


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a random (out, in) matrix
    (U(-1, 1) or N(0, 1) entries): U of its SVD when that has the
    weight's shape, else V^T. Rows (or columns) orthonormal to
    ``scale``. The SVD runs in f64: cuSOLVER's f32 SVD of a 1024 x 1024
    matrix leaves its rows orthonormal only to ~2e-4 (LAPACK's f32 to
    ~3e-6), so the f32 factor is the f64 one rounded."""

    def __init__(self, scale: float = 1.414,
                 rand_type: str = "uniform") -> None:
        self.scale = scale
        self.rand_type = rand_type

    def _init(self, shape, generator):
        nout, nin = shape[0], math.prod(shape[1:])
        a = _draw((nout, nin), generator, self.rand_type).double()
        u, _, v = torch.linalg.svd(a, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        return (self.scale * q.reshape(shape)).float()


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


@register
class MSRAPrelu(Xavier):
    """Kaiming He's initialization: Gaussian Xavier with magnitude
    ``2 / (1 + slope^2)``."""

    def __init__(self, factor_type: str = "avg", slope: float = 0.25) -> None:
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register
class LSTMBias(Initializer):
    """Zeros but the forget gate's quarter (the second), ``forget_bias``."""

    def __init__(self, forget_bias: float = 1.0) -> None:
        self.forget_bias = forget_bias

    def _init(self, shape, generator):
        b = torch.zeros(shape)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel for a deconvolution weight (out, in,
    kh, kw), each (kh, kw) plane the same."""

    def _init(self, shape, generator):
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = _np.arange(math.prod(shape))
        x, y = i % shape[3], (i // shape[3]) % shape[2]
        w = (1 - _np.abs(x / f - c)) * (1 - _np.abs(y / f - c))
        return torch.from_numpy(w.astype(_np.float32).reshape(shape))
