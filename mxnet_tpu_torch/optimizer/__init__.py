"""Optimizer registry and implementations (``mxnet_tpu/optimizer``)."""
from .optimizer import (SGD, Adam, AdamW, MasterWeightState,  # noqa: F401
                        Optimizer, create, register)

__all__ = ["Optimizer", "MasterWeightState", "register", "create", "SGD",
           "Adam", "AdamW"]
