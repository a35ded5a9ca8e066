"""Basic layers: HybridSequential, Dense, Dropout, LayerNorm, Embedding.

Counterpart of the same classes in
``mxnet_tpu/gluon/nn/basic_layers.py``, with the same parameter names and
layouts (Dense weight is (units, in_units); LayerNorm has gamma/beta).
"""
from __future__ import annotations

from typing import Any, Optional

from ... import npx
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["HybridSequential", "Dense", "Dropout", "LayerNorm", "Embedding"]


class HybridSequential(HybridBlock):
    """Children run in order; they are named "0", "1", ..."""

    def add(self, *blocks: HybridBlock) -> None:
        for b in blocks:
            self.register_child(b)

    def forward(self, x: Any, *args: Any) -> Any:
        for child in self._modules.values():
            x = child(x, *args)
            args = ()
        return x

    def __iter__(self):
        return iter(self._modules.values())


class Dense(HybridBlock):
    """Fully-connected layer: out = act(x·Wᵀ + b)."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 dtype: Any = "float32", weight_initializer: Any = None,
                 bias_initializer: Any = "zeros", in_units: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter("weight", shape=(units, in_units),
                                dtype=dtype, init=weight_initializer)
        self.bias = Parameter("bias", shape=(units,), dtype=dtype,
                              init=bias_initializer) if use_bias else None

    def forward(self, x):
        out = npx.fully_connected(x, self.weight, self.bias,
                                  num_hidden=self._units,
                                  no_bias=self.bias is None,
                                  flatten=self._flatten)
        if self._activation:
            out = npx.activation(out, self._activation)
        return out


class Dropout(HybridBlock):
    """Dropout, active in training (``autograd.record()``)."""

    def __init__(self, rate: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._rate = rate

    def forward(self, x):
        return npx.dropout(x, self._rate)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with gamma/beta."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-5,
                 beta_initializer: Any = "zeros",
                 gamma_initializer: Any = "ones", in_channels: int = 0,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter("gamma", shape=(in_channels,),
                               init=gamma_initializer)
        self.beta = Parameter("beta", shape=(in_channels,),
                              init=beta_initializer)

    def forward(self, x):
        return npx.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class Embedding(HybridBlock):
    """Index → vector lookup table."""

    def __init__(self, input_dim: int, output_dim: int,
                 dtype: Any = "float32", weight_initializer: Any = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter("weight", shape=(input_dim, output_dim),
                                dtype=dtype, init=weight_initializer)

    def forward(self, x):
        return npx.embedding(x, self.weight, input_dim=self._input_dim,
                             output_dim=self._output_dim)
