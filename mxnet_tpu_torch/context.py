"""Device context: ``cpu()`` / ``gpu()`` mapped onto ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``. The default context is
``gpu(0)`` (``cuda:0``). An entry point that is not asked for the CPU and
finds no CUDA device raises :class:`MXNetError`; it never carries on on
the CPU.
"""
from __future__ import annotations

import threading
from typing import Any, Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "tpu", "num_gpus",
           "num_tpus", "current_context", "as_device"]


class Context:
    """A device context, hashable and comparable.

    ``device_type`` is ``'cpu'`` or ``'gpu'`` (``'cuda'`` is an alias);
    ``device_id`` indexes the devices of that type.
    """

    devstr2type = {"cpu": "cpu", "gpu": "gpu", "cuda": "gpu"}

    _default_ctx = threading.local()

    def __init__(self, device_type: str, device_id: int = 0) -> None:
        if device_type not in self.devstr2type:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = self.devstr2type[device_type]
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names (raises when it is a
        GPU and CUDA is absent)."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} needs a CUDA device and none is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self) -> int:
        return hash((self.device_type, self.device_id))

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    def __enter__(self) -> "Context":
        if not hasattr(Context._default_ctx, "stack"):
            Context._default_ctx.stack = []
        Context._default_ctx.stack.append(self)
        return self

    def __exit__(self, *exc: object) -> None:
        Context._default_ctx.stack.pop()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Pinned-memory CPU context: the CPU (torch pins tensors, not
    devices)."""
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The JAX package's accelerator context; the port's is ``gpu``."""
    raise MXNetError("the port runs on CUDA devices and has no TPU context; "
                     "use gpu()")


def num_gpus() -> int:
    """Number of visible CUDA devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_tpus() -> int:
    """The port sees no TPU."""
    return 0


def current_context() -> Context:
    """Innermost ``with ctx:`` scope, else ``gpu(0)``."""
    stack = getattr(Context._default_ctx, "stack", None)
    return stack[-1] if stack else gpu(0)


def as_device(device: Union[None, str, torch.device, Context, Any] = None
              ) -> torch.device:
    """Resolve an entry point's ``device`` argument to a ``torch.device``.

    ``None`` means the current context (``cuda:0`` unless a ``with ctx:``
    scope says otherwise). A CUDA device without CUDA raises."""
    if device is None:
        return current_context().torch_device
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda":
        return Context("gpu", dev.index or 0).torch_device
    if dev.type != "cpu":
        raise MXNetError(f"unsupported device {device!r}; use 'cpu' or "
                         "'cuda:N'")
    return dev
