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
and the first executions (``misses``).

:class:`DecodeModel` is the stateful autoregressive path of the generation
engine (``model.py:260-880``): a prompt pass per prompt bucket on the flash
forward kernel, and a one-token decode step over every slot of a
:class:`~mxnet_tpu_torch.serving.kv_cache.PagedKVCache`, replayed on the
card as one CUDA graph per KV bucket.
"""
from __future__ import annotations

import base64
import contextlib
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
from ..gluon.block import _GRAPH_LOCK
from ..gluon.model_zoo.generation import (METHOD_CODES,  # noqa: F401
                                          _block_prefill, _collect, _embed,
                                          _head, _sample_tokens,
                                          _slot_block_step)
from ..ops.cuda.decode_attention import workspace as _attention_workspace
from .batching import BUCKET_COMPILES, INFER_SECONDS, BucketPolicy

__all__ = ["ServedModel", "DecodeModel", "METHOD_CODES", "load_served"]

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

    The arguments are the JAX package's, in its order: ``fixed_batch`` is
    the one batch size a static export serves (None for any).

    Build with :meth:`from_export`, :meth:`from_block` or the
    path-sniffing :func:`load_served`."""

    def __init__(self, fn: Any, input_signature: List[Tuple[Tuple[int, ...],
                                                            Any]],
                 fixed_batch: Optional[int], name: str) -> None:
        self._fn = fn
        # per-input (shape_without_batch, dtype) of one request sample
        self.input_signature = input_signature
        self.fixed_batch = fixed_batch
        self.name = name
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
        return ServedModel(fn, sig, fixed, name or "export")

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

        return ServedModel(fn, sig, None, type(block).__name__)

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


# ---------------------------------------------------------------------------
# DecodeModel — the stateful autoregressive path (continuous batching)
# ---------------------------------------------------------------------------

class _CaptureGate:
    """Orders the decode graphs' captures against the generation path's
    other work on the card, across the threads of a process. While a
    stream captures, PyTorch refuses a copy between pageable host memory
    and the card on every thread, and a device-wide synchronize ends the
    capture; a restarted replica captures its grid while the survivors
    serve. So a capture (:meth:`exclusive`) waits until no prompt pass,
    step or lane upload (:meth:`shared`, any number at once) runs, and new
    ones wait until it ends. A thread that captures while it holds a
    share gives the share up while it waits. Take the gate before the
    graph lock, never while holding it."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._shares = 0          # threads inside shared()
        self._pending = 0         # captures waiting or running
        self._capturing = False
        self._local = threading.local()

    @contextlib.contextmanager
    def shared(self):
        depth = getattr(self._local, "depth", 0)
        if not depth:
            with self._cond:
                while self._pending:
                    self._cond.wait()
                self._shares += 1
        self._local.depth = depth + 1
        try:
            yield
        finally:
            self._local.depth = depth
            if not depth:
                with self._cond:
                    self._shares -= 1
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        held = getattr(self._local, "depth", 0) > 0
        with self._cond:
            self._shares -= held
            self._pending += 1
            self._cond.notify_all()
            while self._shares or self._capturing:
                self._cond.wait()
            self._capturing = True
        try:
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._pending -= 1
                self._shares += held
                self._cond.notify_all()


_GATE = _CaptureGate()


class _Sampling:
    """Per-slot sampling lanes (seed, counter base, temperature, top_k,
    top_p, method): the host arrays, their device mirrors, and whether any
    lane samples (the host picks the greedy or the mixed graph from it)."""

    __slots__ = ("host", "dev", "mixed")

    def __init__(self, host: Sequence[Any], device: torch.device) -> None:
        kinds = (_np.int64, _np.int64, _np.float32, _np.int64, _np.float32,
                 _np.int64)
        self.host = tuple(_np.asarray(a).astype(k)
                          for a, k in zip(host, kinds))
        with _GATE.shared():
            self.dev = tuple(torch.from_numpy(a).to(device)
                             for a in self.host)
        self.mixed = bool((self.host[5] != 0).any())


class _StepIO:
    """The static inputs every decode graph of one cache reads: tokens of
    each width, positions, the sampling lanes, each bucket's flat slot
    rows and the decode attention kernel's workspace (made before any
    capture, so a replay allocates nothing; only this cache's thread runs
    its steps, one after another). Each replay copies its inputs in
    first."""

    def __init__(self, S: int, device: torch.device) -> None:
        self.S, self.device = S, device
        self.toks: Dict[int, torch.Tensor] = {}
        self.pos = torch.zeros((S,), dtype=torch.int64, device=device)
        z = torch.zeros((S,), dtype=torch.int64, device=device)
        self.samp = [z, z.clone(), torch.ones((S,), device=device),
                     torch.ones_like(z), torch.ones((S,), device=device),
                     z.clone()]
        self.samp_src: Optional[_Sampling] = None
        self.flat: Dict[int, torch.Tensor] = {}
        self.work: Dict[int, Any] = {}

    def tokens(self, width: int) -> torch.Tensor:
        if width not in self.toks:
            self.toks[width] = torch.zeros((self.S, width),
                                           dtype=torch.int64,
                                           device=self.device)
        return self.toks[width]

    def flat_rows(self, L: int) -> torch.Tensor:
        if L not in self.flat:
            self.flat[L] = torch.arange(self.S, dtype=torch.int64,
                                        device=self.device) * L
        return self.flat[L]

    def attention_work(self, L: int, H: int, D: int) -> Any:
        """The decode attention kernel's workspace for bucket ``L`` (None
        on the CPU, whose plain version needs none)."""
        if self.device.type != "cuda":
            return None
        if L not in self.work:
            self.work[L] = _attention_workspace(self.S, H, L, D, self.device)
        return self.work[L]


class DecodeModel:
    """The decode-capable serving path: a stateful ``(cache, tokens,
    positions) -> next tokens`` step over slot rows, plus a prompt pass per
    prompt bucket — the programs the continuous-batching
    :class:`~mxnet_tpu_torch.serving.generation.GenerationEngine` runs.

    Built from a live :class:`~mxnet_tpu_torch.gluon.model_zoo.gpt.GPTModel`
    (:meth:`from_block`); the parameters are read in place and the math is
    the zoo's (``model_zoo.generation``), extended to per-slot positions:

    * :meth:`prefill` and :meth:`prefill_suffix` run eagerly, their
      attention on the flash forward kernel (causal; the suffix pass
      non-causal under the visibility mask as an f32 bias);
    * :meth:`step` (one token per slot), :meth:`verify` (``K1`` chained
      repetitions of exactly the step's computation) and the drafts'
      proposal chains replay on the card one CUDA graph per (bucket,
      width, greedy or mixed sampling), captured over the cache's
      buffers and static inputs (:class:`_StepIO`) the first time each is
      met; :meth:`warmup` captures the whole grid. A capture that fails
      raises. On the CPU each call runs eagerly.

    Compile accounting rides the per-bucket counter of the one-shot path
    (``mxnet_serving_bucket_compiles_total``, labels ``decode:SxL``,
    ``verify:SxLxK1``, ``draft:SxLxk``, ``prefill:Lp``,
    ``prefill_sfx:PbxSb``): a label's first call counts, as in the JAX
    package. :attr:`captures` counts CUDA graph captures.
    """

    def __init__(self, params: Dict[str, Any], num_heads: int,
                 ga: Tuple[Any, Any], max_length: int, name: str) -> None:
        self.params = params
        self.num_heads = int(num_heads)
        self.ga = (bool(ga[0]), float(ga[1]))
        self.max_length = int(max_length)
        self.name = name
        self.vocab_size, self.units = (int(n) for n in
                                       params["embed"].shape)
        self.head_dim = self.units // self.num_heads
        self.n_layers = len(params["blocks"])
        self.dtype = params["blocks"][0]["qkv_w"].dtype
        self.device = params["embed"].device
        self.captures = 0
        self._seen_lock = threading.Lock()
        self._seen: set = set()

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_block(block: Any, device: Any = None) -> "DecodeModel":
        """Build from a live zoo ``GPTModel`` on ``device`` (``cuda:0`` by
        default; ``device="cpu"`` for the CPU): the block is moved there
        and put in predict mode; its weights are read in place."""
        if not hasattr(block, "blocks") or not hasattr(block, "word_embed"):
            raise MXNetError(
                f"DecodeModel serves decoder-only zoo LMs (GPTModel); "
                f"got {type(block).__name__}")
        block.to(as_device(device))
        block.eval()
        params = _collect(block)
        ga = (params.pop("gelu_approx"), params.pop("ln_eps"))
        nh = params.pop("num_heads")
        return DecodeModel(params, nh, ga, block._max_length,
                           type(block).__name__)

    # -- accounting ---------------------------------------------------------
    def _account(self, tag: str) -> None:
        with self._seen_lock:
            new = tag not in self._seen
            if new:
                self._seen.add(tag)
        if new:
            BUCKET_COMPILES.labels(bucket=tag).inc()

    def _observe(self, phase: str, t0: float) -> None:
        from .. import metrics as _metrics
        _metrics.GEN_STEP_SECONDS.labels(phase=phase).observe(
            time.perf_counter() - t0, exemplar=_tracing.current_trace_id())

    def _sync(self) -> None:
        # this thread's stream only: the other replicas' work goes on
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- prompt passes ------------------------------------------------------
    def _padded(self, tokens: Any, bucket_len: int, what: str):
        toks = _np.asarray(tokens, _np.int64).reshape(-1)
        t0 = toks.shape[0]
        if t0 < 1:
            raise MXNetError(f"empty {what}")
        if bucket_len < t0:
            raise MXNetError(
                f"{what} length {t0} exceeds its bucket {bucket_len}")
        padded = _np.zeros((bucket_len,), _np.int64)
        padded[:t0] = toks
        return torch.from_numpy(padded), t0

    def prefill(self, tokens: Any, bucket_len: int
                ) -> Tuple[torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor]]:
        """Run the prompt pass padded to ``bucket_len``; returns
        (last-token logits (V,) on the device, per-layer ks/vs
        (bucket_len, nh, d)). Its attention is the flash forward kernel,
        causal, one launch a layer."""
        toks, t0 = self._padded(tokens, bucket_len, "prompt")
        self._account(f"prefill:{bucket_len}")
        t = time.perf_counter()
        p = self.params
        with _GATE.shared(), torch.inference_mode():
            toks = toks.to(self.device)
            x = p["embed"][toks][None] + p["pos"][:bucket_len][None]
            ks, vs = [], []
            for bp in p["blocks"]:
                x, kh, vh = _block_prefill(bp, x, self.num_heads, self.ga)
                ks.append(kh[0])
                vs.append(vh[0])
            logits = _head(p, x[0, t0 - 1], self.ga[1])
            self._sync()
        self._observe("prefill", t)
        return logits, ks, vs

    def prefill_suffix(self, tokens: Any, prefix_ks: List[torch.Tensor],
                       prefix_vs: List[torch.Tensor], q: int,
                       bucket_len: int
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  List[torch.Tensor]]:
        """The prompt pass over only the SUFFIX ``tokens`` (real positions
        ``q..q+len``) against resident prefix rows (Pb, nh, d) — the
        shared-prefix admission path. Suffix row i sees the real prefix
        rows (< q) and the suffix rows up to itself: that mask, as a
        (1, 1, Sb, Pb + Sb) f32 bias of ``finfo.min``, goes to the flash
        forward with the prefix and suffix rows joined. Returns
        (last-real-token logits (V,), per-layer suffix ks/vs
        (bucket_len, nh, d))."""
        from ..ops.transformer import _mask_to_bias
        toks, t0 = self._padded(tokens, bucket_len, "prompt suffix")
        Pb, Sb, q = int(prefix_ks[0].shape[0]), int(bucket_len), int(q)
        self._account(f"prefill_sfx:{Pb}x{Sb}")
        t = time.perf_counter()
        p = self.params
        with _GATE.shared(), torch.inference_mode():
            toks = toks.to(self.device)
            cols = torch.arange(Pb + Sb, device=self.device)[None, :]
            rows = torch.arange(Sb, device=self.device)[:, None]
            vis = (cols < q) | ((cols >= Pb) & (cols - Pb <= rows))
            bias = _mask_to_bias(vis[None, None], torch.float32, 1, Sb,
                                 Pb + Sb)
            x = p["embed"][toks][None] + p["pos"][q:q + Sb][None]
            ks, vs = [], []
            for bp, pk, pv in zip(p["blocks"], prefix_ks, prefix_vs):
                x, kh, vh = _block_prefill(bp, x, self.num_heads, self.ga,
                                           bias=bias, prefix=(pk, pv))
                ks.append(kh[0])
                vs.append(vh[0])
            logits = _head(p, x[0, t0 - 1], self.ga[1])
            self._sync()
        self._observe("prefill", t)
        return logits, ks, vs

    # -- sampling lanes -----------------------------------------------------
    def greedy_sampling(self, n_slots: int) -> Tuple[_np.ndarray, ...]:
        """All-greedy per-slot sampling vectors (seed, counter base,
        temperature, top_k, top_p, method)."""
        return (_np.zeros((n_slots,), _np.int32),
                _np.zeros((n_slots,), _np.int32),
                _np.ones((n_slots,), _np.float32),
                _np.ones((n_slots,), _np.int32),
                _np.ones((n_slots,), _np.float32),
                _np.zeros((n_slots,), _np.int32))

    def device_sampling(self, sampling: Sequence[_np.ndarray]) -> _Sampling:
        """Device mirrors of the per-slot sampling vectors. The engine
        keeps the result across iterations (the lanes change only at
        admission / retirement): a step copies lanes into its graph's
        inputs only when it is handed another object."""
        return _Sampling(sampling, self.device)

    def select(self, logits: Any, seed: int, counter: int,
               temperature: float, top_k: int, top_p: float,
               method: int) -> int:
        """First-token selection over prefill logits — the single-row twin
        of the in-step sampler (same function, same (seed, counter) key),
        so a sequence's token at index ``i`` is the same whichever pass
        emitted it."""
        with _GATE.shared(), torch.inference_mode():
            lg = torch.as_tensor(logits, device=self.device)[None]

            def one(val, dtype):
                return torch.full((1,), val, dtype=dtype,
                                  device=self.device)

            tok = _sample_tokens(
                lg, one(seed, torch.int64), one(counter, torch.int64),
                one(temperature, torch.float32), one(top_k, torch.int64),
                one(top_p, torch.float32), one(method, torch.int64),
                mixed=int(method) != 0)
            return int(tok[0])

    # -- the decode programs ------------------------------------------------
    def _steps(self, cache: Any, layers: int, n_sub: int, feed: bool,
               mixed: bool, width: int) -> torch.Tensor:
        """``n_sub`` chained one-token steps over every slot of ``cache``
        through the first ``layers`` blocks, reading the static inputs of
        ``cache.io``: sub-step j writes K/V at pos + j and draws under
        counter pos + j - base; ``feed`` feeds each output token back in
        (a draft chain), else column j of the tokens is sub-step j's input
        (verify). Returns (S, n_sub) int64."""
        p, io = self.params, cache.io
        flat = io.flat_rows(cache.bucket)
        work = io.attention_work(cache.bucket, self.num_heads, self.head_dim)
        toks = io.tokens(width)
        seeds, bases, temps, topks, topps, methods = io.samp
        cur = toks[:, 0]
        outs = []
        for j in range(n_sub):
            if not feed:
                cur = toks[:, j]
            pos = io.pos + j
            x = _embed(p, cur, pos)
            for bp, ck, cv in zip(p["blocks"][:layers], cache._k,
                                  cache._v):
                x = _slot_block_step(bp, x, ck, cv, pos, self.num_heads,
                                     self.ga, flat, work)
            cur = _sample_tokens(_head(p, x, self.ga[1]), seeds,
                                 pos - bases, temps, topks, topps, methods,
                                 mixed)
            outs.append(cur)
        return torch.stack(outs, 1)

    def _run(self, cache: Any, kind: str, tokens: _np.ndarray,
             positions: Any, sampling: Any, n_sub: int, feed: bool,
             layers: Optional[int] = None, graph: bool = True
             ) -> _np.ndarray:
        """Copy the inputs into ``cache.io`` and run :meth:`_steps`: on the
        card by replaying its CUDA graph (captured here the first time this
        (kind, bucket, width, layers, mixed) is met), eagerly on the CPU or
        with ``graph=False``."""
        S = cache.max_slots
        layers = self.n_layers if layers is None else int(layers)
        if sampling is None:
            sampling = self.greedy_sampling(S)
        if not isinstance(sampling, _Sampling):
            sampling = self.device_sampling(sampling)
        toks = _np.asarray(tokens, _np.int64).reshape(S, -1)
        width = toks.shape[1]
        pos = _np.asarray(positions, _np.int64).reshape(S)
        with _GATE.shared(), torch.inference_mode():
            if cache.io is None:
                cache.io = _StepIO(S, cache.device)
            io = cache.io
            io.tokens(width).copy_(torch.from_numpy(toks))
            io.pos.copy_(torch.from_numpy(pos))
            if io.samp_src is not sampling:
                for dst, src in zip(io.samp, sampling.dev):
                    dst.copy_(src)
                io.samp_src = sampling
            args = (cache, layers, n_sub, feed, sampling.mixed, width)
            if cache.device.type != "cuda" or not graph:
                return self._steps(*args).cpu().numpy()
            key = (kind, cache.bucket, width, n_sub, feed, layers,
                   sampling.mixed)
            # only this engine's thread touches its cache; the graph lock
            # covers the capture and the replay's launch, not the readback
            entry = cache.graphs.get(key)
            if entry is None:
                with _GATE.exclusive(), _GRAPH_LOCK:
                    entry = cache.graphs[key] = self._capture(key, args)
            with _GRAPH_LOCK:
                entry[0].replay()
            return entry[1].cpu().numpy()

    def _capture(self, key: Tuple[Any, ...], args: Tuple[Any, ...]):
        """One eager run (it initialises the libraries' handles and writes
        exactly what the replay writes), then the capture."""
        self._steps(*args)
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                out = self._steps(*args)
        except Exception as e:
            raise MXNetError(
                f"DecodeModel: capturing the {key[0]} graph for KV bucket "
                f"{key[1]} (width {key[2]}, {key[5]} layers, "
                f"{'mixed' if key[6] else 'greedy'} sampling) failed: "
                f"{type(e).__name__}: {e}") from e
        self.captures += 1
        return g, out

    def step(self, cache: Any, tokens: Any, positions: Any,
             sampling: Optional[Any] = None, graph: bool = True
             ) -> _np.ndarray:
        """One decode iteration over every slot: writes each slot's K/V
        row at its position in place and returns the (S,) int32 next
        tokens (greedy or sampled per slot — ``sampling`` is the (seeds,
        counter bases, temperatures, top_ks, top_ps, methods) vectors or
        :meth:`device_sampling`'s mirror; None means all-greedy).
        ``graph=False`` runs the same computation eagerly on the card."""
        S = cache.max_slots
        self._account(f"decode:{S}x{cache.bucket}")
        t = time.perf_counter()
        out = self._run(cache, "decode", tokens, positions, sampling, 1,
                        True, graph=graph)
        self._observe("decode", t)
        return out[:, 0].astype(_np.int32)

    def verify(self, cache: Any, tokens: Any, positions: Any,
               sampling: Optional[Any] = None, graph: bool = True
               ) -> _np.ndarray:
        """One speculative verification pass over every slot: ``tokens``
        is (S, k+1) — column 0 each slot's last emitted token, columns 1..
        the draft proposals — and the return is the (S, k+1) int32 target
        tokens for those positions, each the bits ``step`` would have
        produced there (K1 repetitions of the step's computation in one
        graph). The cache gains k+1 rows per slot from ``positions``; the
        caller rolls rejected rows back (``cache.truncate``)."""
        S = cache.max_slots
        toks = _np.asarray(tokens, _np.int64)
        if toks.ndim != 2 or toks.shape[0] != S or toks.shape[1] < 2:
            raise MXNetError(
                f"verify wants an (S, k+1) token matrix with k >= 1; "
                f"got shape {toks.shape} for {S} slots")
        self._account(f"verify:{S}x{cache.bucket}x{toks.shape[1]}")
        t = time.perf_counter()
        out = self._run(cache, "verify", toks, positions, sampling,
                        toks.shape[1], False, graph=graph)
        self._observe("verify", t)
        return out.astype(_np.int32)

    def warmup(self, cache: Any, prompt_buckets: Sequence[int],
               suffix_pairs: bool = True) -> int:
        """Run the whole program grid once: a prefill per prompt bucket, a
        suffix prefill per reachable (prefix bucket, suffix bucket) pair,
        the first-token selector, and the decode step per KV bucket with
        all-greedy and with mixed sampling lanes (on the card each of the
        two is captured). Afterwards traffic inside the grids captures
        nothing. Leaves the cache on its smallest bucket, zeroed."""
        n = 0
        for pb in prompt_buckets:
            self.prefill(_np.zeros((1,), _np.int64), int(pb))
            n += 1
        self.select(torch.zeros((self.vocab_size,), dtype=self.dtype),
                    seed=0, counter=0, temperature=1.0, top_k=1,
                    top_p=1.0, method=0)
        n += 1
        if suffix_pairs:
            top = max(int(pb) for pb in prompt_buckets)
            for Pb in prompt_buckets:
                rows = [torch.zeros((int(Pb), self.num_heads,
                                     self.head_dim), dtype=self.dtype,
                                    device=self.device)
                        for _ in range(self.n_layers)]
                for Sb in prompt_buckets:
                    if int(Pb) + int(Sb) > top:
                        # unreachable: entries hold bucket-aligned
                        # prefixes and the admission rule bounds q + Sb
                        # by the top prompt bucket
                        continue
                    self.prefill_suffix(_np.zeros((1,), _np.int64), rows,
                                        rows, q=1, bucket_len=int(Sb))
                    n += 1
        S = cache.max_slots
        zeros = _np.zeros((S,), _np.int64)
        for b in cache.grid:
            # walk the grid directly (not via grow(): warmup must not
            # count as live migrations)
            cache._use(b)
            for lanes in warm_lanes(self, S):
                self.step(cache, zeros, zeros, lanes)
            cache.reset_buffers()
            n += 1
        cache._use(cache.grid[0])
        return n

    def describe(self) -> Dict[str, Any]:
        with self._seen_lock:
            seen = sorted(self._seen)
        return {
            "name": self.name,
            "kind": "decode",
            "vocab_size": int(self.vocab_size),
            "units": int(self.units),
            "layers": self.n_layers,
            "heads": self.num_heads,
            "max_length": self.max_length,
            "dtype": str(self.dtype).replace("torch.", ""),
            "programs_compiled": seen,
        }


def warm_lanes(model: DecodeModel, S: int) -> Tuple[Any, Any]:
    """The two sampling-lane sets warmup runs each program with: all
    greedy, and slot 0 sampling (the greedy and the mixed graph)."""
    greedy = model.greedy_sampling(S)
    mixed = tuple(a.copy() for a in greedy)
    mixed[5][0] = 1
    return model.device_sampling(greedy), model.device_sampling(mixed)


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

def load_served(model: Any, param_file: Optional[str] = None,
                **kw: Any) -> ServedModel:
    """Sniff ``model`` into a :class:`ServedModel` (the JAX package's
    ``load_served``): an export prefix or ``-symbol.json`` path goes to
    :meth:`ServedModel.from_export` (the port's own ``torch.export``
    artifacts; the JAX package's StableHLO exports load only there), a
    Block to :meth:`ServedModel.from_block`; ``kw`` goes to that
    constructor. A Module is not ported (Queue A 15)."""
    if isinstance(model, str):
        sym = model if model.endswith("-symbol.json") \
            else f"{model}-symbol.json"
        return ServedModel.from_export(sym, param_file, **kw)
    if hasattr(model, "params_initialized"):        # Module duck-type
        raise MXNetError("serving a Module (ServedModel.from_module) is not "
                         "ported yet (ROADMAP Queue A 15, the remaining "
                         "surface)")
    if hasattr(model, "collect_params"):            # gluon Block
        return ServedModel.from_block(model, **kw)
    raise MXNetError(f"cannot serve a {type(model).__name__}")
