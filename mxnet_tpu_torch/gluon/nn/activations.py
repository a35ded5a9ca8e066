"""Activation blocks.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py``: ``Activation``,
``LeakyReLU``, ``PReLU`` (its ``alpha`` a parameter, 0.25 by default),
``ELU``, ``SELU``, ``GELU``, ``Swish`` / ``SiLU``, ``Mish``,
``HardSigmoid`` and ``HardSwish``, each over the ``npx`` operator of its
name.
"""
from __future__ import annotations

from typing import Any

import torch

from ... import npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU", "Mish", "HardSigmoid", "HardSwish"]


class Activation(HybridBlock):
    """Named activation (``Activation('relu'|'sigmoid'|'tanh'|...)``)."""

    def __init__(self, activation: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return npx.activation(x, self._act)

    def extra_repr(self) -> str:
        return self._act


class LeakyReLU(HybridBlock):
    def __init__(self, alpha: float = 0.01, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return npx.leaky_relu(x, slope=self._alpha)

    def extra_repr(self) -> str:
        return f"alpha={self._alpha}"


class PReLU(HybridBlock):
    """Leaky ReLU with a learned slope ``alpha`` of ``in_channels`` values,
    broadcast against the input's trailing axes."""

    def __init__(self, alpha_initializer: Any = "constant",
                 in_channels: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        from ... import initializer
        init = initializer.Constant(0.25) \
            if alpha_initializer == "constant" else alpha_initializer
        self.alpha = Parameter("alpha", shape=(in_channels,), init=init)

    def forward(self, x):
        return npx.prelu(x, self.alpha.data())


class ELU(HybridBlock):
    def __init__(self, alpha: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return npx.elu(x, self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return npx.selu(x)


class GELU(HybridBlock):
    """``approximation``: 'erf' (exact) or any other value for the tanh
    form."""

    def __init__(self, approximation: str = "erf", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._approx = approximation != "erf"

    def forward(self, x):
        return npx.gelu(x, approximate=self._approx)


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        if self._beta == 1.0:
            return npx.silu(x)
        return x * torch.sigmoid(x * self._beta)


SiLU = Swish


class Mish(HybridBlock):
    def forward(self, x):
        return npx.mish(x)


class HardSigmoid(HybridBlock):
    def __init__(self, alpha: float = 0.2, beta: float = 0.5,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._alpha, self._beta = alpha, beta

    def forward(self, x):
        return npx.hard_sigmoid(x, self._alpha, self._beta)


class HardSwish(HybridBlock):
    def forward(self, x):
        return npx.hard_swish(x)
