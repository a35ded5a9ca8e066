"""The framework's random stream: ``seed(n)`` and one generator per device.

Counterpart of ``mxnet_tpu/ndarray/random.py`` (``mx.random.seed`` and the
framework key the ops split from). The JAX package threads one threefry key;
here each device has its own explicit ``torch.Generator``, created from the
last seed on first use, and every random draw of the port (dropout masks,
the attention kernels' dropout seeds) takes one of them. Nothing draws from
torch's global generator, so ``torch.manual_seed`` does not move the port's
streams and ``seed(n)`` alone makes them repeat.

The streams are not the JAX package's: threefry and Philox give different
bits from one seed, so tests feed both packages numpy-made inputs.
"""
from __future__ import annotations

import threading
from typing import Dict, Union

import torch

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_SEED = 0
_GENERATORS: Dict[torch.device, torch.Generator] = {}


def _key(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state: int) -> None:
    """Restart every device's stream from ``seed_state``
    (``mx.random.seed``)."""
    global _SEED
    with _LOCK:
        _SEED = int(seed_state)
        _GENERATORS.clear()


def generator(device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """The framework generator of ``device``, seeded from the last
    :func:`seed` (0 before any) when first asked for."""
    dev = _key(device)
    with _LOCK:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_SEED)
            _GENERATORS[dev] = gen
        return gen
