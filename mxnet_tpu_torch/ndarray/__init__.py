"""``mx.nd`` — the imperative NDArray namespace.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: the NDArray class, every
op of ``ops.py``, ``random``, the op registry and the ``.params`` file
functions. ``mx.np`` (``mxnet_tpu_torch/numpy``) shares the same ops.
Any ``register_op``'ed operator resolves as ``mx.nd.<name>`` (and as
``mx.nd._contrib_<name>``), and ``mx.nd.contrib`` takes both spellings, as
the JAX package's namespace does; its CamelCase aliases and ``Custom``
raise :class:`~mxnet_tpu_torch.base.MXNetError` naming their ROADMAP Queue
A item.
"""
from ..base import unported
from .ndarray import NDArray, waitall
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from . import ops
from . import random
from .register import get_op, invoke, list_ops, register_op
from ..ndarray_io import load, load_params, save, save_params

__all__ = (["NDArray", "waitall", "random", "get_op",
            "list_ops", "register_op", "invoke", "save", "load",
            "save_params", "load_params"] + list(_ops_all))


def _registered(name: str):
    """The registered operator ``name``, spelled plainly or with the
    reference's ``_contrib_`` prefix, or None."""
    plain = name[len("_contrib_"):] if name.startswith("_contrib_") else name
    return get_op(plain) if plain in list_ops() else None


class _ContribNamespace:
    """``mx.nd.contrib``: the registered operators under their plain and
    ``_contrib_`` spellings (``quantize``, ``box_nms``, ...)."""

    def __getattr__(self, name: str):
        fn = _registered(name)
        if fn is None:
            raise AttributeError(f"no contrib op {name!r}")
        setattr(self, name, fn)
        return fn


contrib = _ContribNamespace()


def __getattr__(name: str):
    fn = _registered(name)
    if fn is None:
        return unported(__name__, name)
    globals()[name] = fn
    return fn
