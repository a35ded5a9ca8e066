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

A hybridized block's CUDA graphs register the generator of their device
(``gluon/block.py``), so each replay draws the next numbers of its stream.
``seed`` replaces the generators; it bumps :func:`epoch`, and a block whose
graphs were captured under an older epoch drops them. :func:`renew`
replaces one device's generator at the same state after a failed capture.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Union

import torch

__all__ = ["seed", "generator", "epoch", "renew"]

_LOCK = threading.Lock()
_SEED = 0
_GENERATORS: Dict[torch.device, torch.Generator] = {}
_EPOCH = [0]


def _key(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(seed_state: int, ctx: Any = "all") -> None:
    """Restart every device's stream from ``seed_state``
    (``mx.random.seed``). ``ctx`` is the JAX package's argument, which
    it ignores: one seed restarts every device there too."""
    global _SEED
    with _LOCK:
        _SEED = int(seed_state)
        _GENERATORS.clear()
        _EPOCH[0] += 1


def epoch() -> int:
    """How many times :func:`seed` has replaced the generators."""
    return _EPOCH[0]


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


def renew(device: Union[str, torch.device]) -> torch.Generator:
    """Replace ``device``'s generator by a new one at the same state and
    bump :func:`epoch`. A CUDA graph whose capture failed part-way leaves
    the generators registered with it in capture mode, where every later
    draw outside a graph raises; the graphs that registered the old
    generator are dropped with the epoch."""
    dev = _key(device)
    with _LOCK:
        old = _GENERATORS.get(dev)
        new = torch.Generator(device=dev)
        try:
            new.set_state(old.get_state())
        except (AttributeError, RuntimeError):
            new.manual_seed(_SEED)
        _GENERATORS[dev] = new
        _EPOCH[0] += 1
        return new
