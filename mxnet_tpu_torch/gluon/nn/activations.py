"""Activation blocks.

Counterpart of ``mxnet_tpu/gluon/nn/activations.py:Activation``.
"""
from __future__ import annotations

from typing import Any

from ... import npx
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """Named activation (``Activation('relu'|'sigmoid'|'tanh')``)."""

    def __init__(self, activation: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._act = activation

    def forward(self, x):
        return npx.activation(x, self._act)

    def extra_repr(self) -> str:
        return self._act
