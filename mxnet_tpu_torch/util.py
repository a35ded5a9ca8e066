"""``set_np`` and friends: numpy semantics, always on.

Counterpart of ``mxnet_tpu/util.py``: an own copy, so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

__all__ = ["set_np", "reset_np", "is_np_shape", "is_np_array", "use_np",
           "np_shape", "np_array"]

_np_shape = True  # numpy semantics are the default and only mode
_np_array = True


def set_np(shape: bool = True, array: bool = True, dtype: bool = False) -> None:
    """Enable numpy semantics (``mx.npx.set_np``). Always on here."""
    global _np_shape, _np_array
    _np_shape, _np_array = shape, array


def reset_np() -> None:
    set_np(True, True)


def is_np_shape() -> bool:
    return _np_shape


def is_np_array() -> bool:
    return _np_array


def use_np(func):
    """Decorator parity shim: numpy semantics are always active."""
    return func


class _Scope:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def np_shape(active: bool = True) -> _Scope:
    return _Scope()


np_array = np_shape
