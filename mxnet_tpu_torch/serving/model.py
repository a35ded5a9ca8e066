"""ServedModel — one ``predict(arrays) -> arrays`` surface for the server.

Counterpart of ``mxnet_tpu/serving/model.py:ServedModel`` (``from_block``,
``predict``, ``warmup``, ``default_policy``, ``describe``) for a live
block on an explicit device. ``from_block`` hybridizes the block, as the
JAX package does, so on the card each bucket's batch replays a CUDA graph
(``gluon/block.py``), and ``warmup`` captures every bucket before the
server takes traffic. Export artifacts (``from_export``) and the decode
path (``DecodeModel``) are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from ..base import MXNetError
from ..context import as_device
from .batching import BucketPolicy

__all__ = ["ServedModel"]


def _flatten(out: Any) -> List[torch.Tensor]:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flatten(o)]
    return [out]


def _to_numpy(t: torch.Tensor) -> _np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()      # numpy has no bfloat16
    return t.cpu().numpy()


class ServedModel:
    """A loaded inference model: ``predict`` over numpy batch arrays."""

    def __init__(self, fn: Any, input_signature: List[Tuple[Tuple[int, ...],
                                                            Any]],
                 name: str) -> None:
        self._fn = fn
        # per-input (shape_without_batch, dtype) of one request sample
        self.input_signature = input_signature
        self.name = name

    @staticmethod
    def from_block(block: Any,
                   input_signature: Optional[Sequence[Tuple[
                       Tuple[int, ...], Any]]] = None,
                   device: Any = None) -> "ServedModel":
        """Serve a live block on ``device`` (``cuda:0`` by default),
        hybridized (a HybridBlock not hybridized yet is). ``input_signature``
        is per-input (shape_without_batch, dtype); by default the block's
        last hybridized call's, without its batch axis (run it once
        first). The block is moved to the device and put in predict mode;
        each batch runs under ``torch.inference_mode`` on the worker thread
        that executes it."""
        if hasattr(block, "hybridize") and not getattr(block, "_active",
                                                       False):
            block.hybridize()
        if input_signature is None:
            last = getattr(block, "_last_sig", None)
            if last is None:
                raise MXNetError(
                    "from_block needs the input signature: run the block "
                    "once, or pass input_signature=[(sample_shape, "
                    "dtype), ...] (shapes WITHOUT the batch dim)")
            input_signature = [(tuple(s[1:]), d) for s, d in last]
        try:
            sig = [(tuple(s), _np.dtype(d)) for s, d in input_signature]
        except TypeError as e:
            raise MXNetError(f"from_block: an input dtype has no numpy "
                             f"counterpart ({e}); requests are numpy "
                             "arrays") from e
        dev = as_device(device)
        block.to(dev)
        block.eval()

        def fn(arrays: Sequence[_np.ndarray]) -> List[_np.ndarray]:
            xs = [torch.from_numpy(_np.ascontiguousarray(a)).to(dev)
                  for a in arrays]
            with torch.inference_mode():
                out = block(*xs)
            return [_to_numpy(o) for o in _flatten(out)]

        return ServedModel(fn, sig, type(block).__name__)

    def predict(self, arrays: Sequence[_np.ndarray]) -> List[_np.ndarray]:
        """Run one padded batch; returns per-output numpy arrays (axis 0
        = padded batch)."""
        return self._fn(arrays)

    def warmup(self, policy: BucketPolicy) -> int:
        """Run every bucket signature the policy can emit (zeros input)
        twice: a hybridized block's first call of a signature is its
        warm-up and the second captures its graph, as it does for each
        hybridized child of a plain block (an eager block just runs
        again); returns how many signatures were warmed."""
        sigs = policy.warmup_signatures(self.input_signature)
        for sig in sigs:
            for _ in range(2):
                self.predict([_np.zeros(s, d) for s, d in sig])
        return len(sigs)

    def default_policy(self, **kw: Any) -> BucketPolicy:
        return BucketPolicy(**kw)

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name,
                "inputs": [{"sample_shape": list(s), "dtype": str(d)}
                           for s, d in self.input_signature]}
