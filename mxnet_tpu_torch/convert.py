"""Move parameters between the JAX package and a port block.

``load_jax_params(block, params)`` takes ``{name: numpy array}`` keyed by
the JAX package's ``collect_params()`` names (for instance what
``{k: p.data().asnumpy() for k, p in net.collect_params().items()}`` gives
there, or weights made from a seed with numpy) and copies each into the
port parameter of the same name. It is strict: a missing, extra or
mis-shaped name raises. ``export_params(block)`` is its inverse: the
block's parameters as f32 numpy arrays under the same names, so that
weights after training steps compare with the JAX package's.

BatchNorm: ``running_mean`` and ``running_var`` are parameters with
``grad_req='null'`` and are carried like any other. ``stat_shift`` (the
previous batch's mean, about which the one-pass training statistics are
taken) is runtime-only state in both packages (``persistent=False``): it is
carried when ``params`` has it, as the JAX package's ``collect_params()``
gives it, so both packages continue from the same state; when ``params``
lacks it, as a parameter file does, it is rebuilt: set to zeros, so the
layer's next training forward is its first (centered) one, as in the JAX
package after a load.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as _np
import torch

from .base import MXNetError
from .gluon.parameter import to_torch_dtype

__all__ = ["load_jax_params", "export_params"]


def load_jax_params(block: Any, params: Dict[str, _np.ndarray],
                    dtype: Optional[Any] = None) -> Any:
    """Copy ``params`` into ``block`` in place (on its device); with
    ``dtype`` the parameters are also cast to it. Returns ``block``."""
    own = block.collect_params()
    rebuilt = [k for k, p in own.items()
               if k not in params and not p.persistent]
    missing = sorted(set(own) - set(params) - set(rebuilt))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError(f"load_jax_params: names do not match; missing "
                         f"{missing}, extra {extra}")
    bad = [f"{k}: {tuple(_np.shape(params[k]))} vs {tuple(p.shape)}"
           for k, p in own.items()
           if k in params and tuple(_np.shape(params[k])) != tuple(p.shape)]
    if bad:
        raise MXNetError(f"load_jax_params: shape mismatch: {bad}")
    with torch.no_grad():
        for k, p in own.items():
            if k in rebuilt:
                p.data().zero_()
            else:
                src = torch.from_numpy(_np.ascontiguousarray(
                    _np.asarray(params[k], dtype=_np.float32)))
                p.data().copy_(src.to(device=p.device, dtype=p.dtype))
            p.initialized = True
    if dtype is not None:
        block.to(to_torch_dtype(dtype))
    return block


def export_params(block: Any) -> Dict[str, _np.ndarray]:
    """``{name: f32 numpy array}`` of every parameter of ``block``, keyed
    by the names :func:`load_jax_params` takes."""
    return {k: p.data().detach().float().cpu().numpy()
            for k, p in block.collect_params().items()}
