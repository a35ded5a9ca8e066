"""ServedModel — one ``predict(arrays) -> arrays`` surface for the server.

Counterpart of ``mxnet_tpu/serving/model.py:ServedModel`` (``from_export``,
``from_block``, ``predict``, ``warmup``, ``default_policy``, ``describe``)
on an explicit device:

* ``from_block`` serves a live block. It hybridizes the block, as the JAX
  package does, so on the card each bucket's batch replays a CUDA graph
  (``gluon/block.py``), and ``warmup`` captures every bucket before the
  server takes traffic.
* ``from_export`` serves an artifact of ``HybridBlock.export``: a
  ``torch.export`` program whose arguments are the parameters and the
  inputs, and a ``.params`` file, both checked against their digests
  before anything is deserialised. The program runs eagerly (no CUDA
  graphs): each batch calls the exported graph, whose attention is the
  registered op ``mxnet_tpu_torch::flash_attention_fwd``. An export with
  ``dynamic_batch=True`` serves every batch bucket from one program; a
  static one serves only its traced batch (``fixed_batch``). The port
  cannot load the JAX package's exports (StableHLO), nor the JAX package
  the port's.

Both share the per-bucket accounting of the JAX package: the first
execution of each padded batch signature counts into
``mxnet_serving_bucket_compiles_total{bucket=...}`` (on the port, a
hybridized block's first call of a signature is its warm-up and the
second its CUDA-graph capture: the bucket's "compile"), and each batch's
wall time into ``mxnet_serving_inference_seconds`` with the current trace
id as its exemplar. :meth:`ServedModel.exec_cache_stats` reports the
signatures seen (``size``), the batches that ran a seen one (``hits``)
and the first executions (``misses``). The decode path (``DecodeModel``)
is ROADMAP Queue A 5.
"""
from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from .. import tracing as _tracing
from .._durable import sha256_bytes, sha256_file
from ..base import MXNetError
from ..context import as_device
from .batching import BUCKET_COMPILES, INFER_SECONDS, BucketPolicy

__all__ = ["ServedModel"]

# what HybridBlock.export writes into ``framework``
EXPORT_FRAMEWORK = "mxnet_tpu_torch"


def _flatten(out: Any) -> List[torch.Tensor]:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flatten(o)]
    return [out]


def _to_numpy(t: torch.Tensor) -> _np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()      # numpy has no bfloat16
    return t.cpu().numpy()


def _sig_str(shapes: Sequence[Tuple[int, ...]]) -> str:
    return ";".join("x".join(map(str, s)) for s in shapes)


class ServedModel:
    """A loaded inference model: ``predict`` over numpy batch arrays.

    ``fixed_batch``: the one batch size a static export serves (None for
    any)."""

    def __init__(self, fn: Any, input_signature: List[Tuple[Tuple[int, ...],
                                                            Any]],
                 name: str, fixed_batch: Optional[int] = None) -> None:
        self._fn = fn
        # per-input (shape_without_batch, dtype) of one request sample
        self.input_signature = input_signature
        self.name = name
        self.fixed_batch = fixed_batch
        # the worker threads add while /healthz threads read
        self._seen_lock = threading.Lock()
        self._seen_buckets: set = set()
        self._hits = 0

    @staticmethod
    def from_export(symbol_file: str, param_file: Optional[str] = None,
                    device: Any = None) -> "ServedModel":
        """Load a :meth:`HybridBlock.export` artifact for serving on
        ``device`` (``cuda:0`` by default). The program's and the
        parameters' SHA-256 digests are checked before either is
        deserialised: a truncated or bit-flipped file raises
        :class:`MXNetError` naming it. ``param_file`` defaults to the
        newest ``prefix-NNNN.params`` beside ``prefix-symbol.json``."""
        from ..ndarray_io import read_tensors
        # the op the program names must be registered before it loads
        from ..ops.cuda import attention  # noqa: F401

        with open(symbol_file) as f:
            meta = json.load(f)
        framework = meta.get("framework")
        if framework != EXPORT_FRAMEWORK or "program" not in meta:
            raise MXNetError(
                f"{symbol_file} is an export of framework {framework!r}, "
                f"not of {EXPORT_FRAMEWORK!r}: the port serves only its own "
                "torch.export artifacts (the JAX package's StableHLO "
                "exports load only there); re-export with the port's "
                "HybridBlock.export")
        if param_file is None:
            param_file = _guess_param_file(symbol_file)
        program = base64.b64decode(meta["program"])
        want = meta.get("program_sha256")
        if want is not None:
            got = sha256_bytes(program)
            if got != want:
                raise MXNetError(
                    f"export artifact {symbol_file} failed its program "
                    f"checksum (program_sha256 {want[:12]}…, file "
                    f"digests to {got[:12]}…) — the artifact is "
                    "truncated or garbled; re-export or restore it "
                    "before serving")
        order = meta["param_order"]
        dev = as_device(device)
        params: List[torch.Tensor] = []
        if order:
            if param_file is None:
                raise MXNetError(
                    "this export has parameters — pass the "
                    "prefix-NNNN.params file (or keep it next to the "
                    "symbol json)")
            want = meta.get("params_sha256")
            if want is not None:
                got = sha256_file(param_file)
                if got != want:
                    raise MXNetError(
                        f"export artifact {param_file} failed its "
                        f"checksum (params_sha256 {want[:12]}…, file "
                        f"digests to {got[:12]}…) — the weights are "
                        "truncated or garbled (or not the file this "
                        "symbol json was exported with); re-export or "
                        "restore them before serving")
            loaded = read_tensors(param_file)
            missing = [k for k in order if k not in loaded]
            if missing:
                raise MXNetError(
                    f"{param_file} is missing exported params: {missing}")
            params = [loaded[k].to(dev) for k in order]
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(torch.export.load(io.BytesIO(program)), dev)
        module = ep.module()
        dynamic = bool(meta.get("dynamic_batch"))
        sig = [(tuple(i["shape"][1:]), _np.dtype(i["dtype"]))
               for i in meta["inputs"]]
        fixed = None if dynamic else int(meta["inputs"][0]["shape"][0])

        def fn(arrays: Sequence[_np.ndarray]) -> List[_np.ndarray]:
            xs = [torch.from_numpy(_np.ascontiguousarray(a)).to(dev)
                  for a in arrays]
            with torch.inference_mode():
                out = module(params, *xs)
            return [_to_numpy(o) for o in _flatten(out)]

        name = os.path.basename(symbol_file).replace("-symbol.json", "")
        return ServedModel(fn, sig, name or "export", fixed)

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
        = padded batch). Counts a first-seen batch signature into
        ``mxnet_serving_bucket_compiles_total`` and times the batch."""
        shapes = tuple(tuple(a.shape) for a in arrays)
        with self._seen_lock:
            new = shapes not in self._seen_buckets
            if new:
                self._seen_buckets.add(shapes)
            else:
                self._hits += 1
        if new:
            BUCKET_COMPILES.labels(bucket=_sig_str(shapes)).inc()
        t0 = time.perf_counter()
        out = self._fn(arrays)
        INFER_SECONDS.observe(time.perf_counter() - t0,
                              exemplar=_tracing.current_trace_id())
        return out

    def warmup(self, policy: BucketPolicy) -> int:
        """Run every bucket signature the policy can emit (zeros input)
        twice: a hybridized block's first call of a signature is its
        warm-up and the second captures its graph, as it does for each
        hybridized child of a plain block (an eager block or an exported
        program just runs again); returns how many signatures were
        warmed."""
        sigs = policy.warmup_signatures(self.input_signature)
        for sig in sigs:
            if self.fixed_batch is not None \
                    and sig[0][0][0] != self.fixed_batch:
                raise MXNetError(
                    f"static export serves only batch={self.fixed_batch}; "
                    f"configure BucketPolicy(batch_buckets="
                    f"[{self.fixed_batch}]) (or re-export with "
                    "dynamic_batch=True)")
            for _ in range(2):
                self.predict([_np.zeros(s, d) for s, d in sig])
        return len(sigs)

    def default_policy(self, **kw: Any) -> BucketPolicy:
        """A policy consistent with this model (a static export pins the
        batch bucket to its batch)."""
        if self.fixed_batch is not None and "batch_buckets" not in kw:
            kw["batch_buckets"] = [self.fixed_batch]
        return BucketPolicy(**kw)

    def exec_cache_stats(self) -> Dict[str, int]:
        """Signatures seen (``size``), batches of a seen signature
        (``hits``) and first executions (``misses``)."""
        with self._seen_lock:
            n = len(self._seen_buckets)
            return {"size": n, "hits": self._hits, "misses": n}

    def describe(self) -> Dict[str, Any]:
        with self._seen_lock:
            seen = list(self._seen_buckets)
        return {"name": self.name,
                "inputs": [{"sample_shape": list(s), "dtype": str(d)}
                           for s, d in self.input_signature],
                "fixed_batch": self.fixed_batch,
                "buckets_compiled": sorted(_sig_str(s) for s in seen)}


def _guess_param_file(symbol_file: str) -> Optional[str]:
    """Newest ``prefix-NNNN.params`` next to ``prefix-symbol.json``."""
    if not symbol_file.endswith("-symbol.json"):
        return None
    prefix = symbol_file[:-len("-symbol.json")]
    folder = os.path.dirname(prefix) or "."
    cands = sorted(f for f in os.listdir(folder)
                   if f.startswith(os.path.basename(prefix) + "-")
                   and f.endswith(".params"))
    return os.path.join(folder, cands[-1]) if cands else None

