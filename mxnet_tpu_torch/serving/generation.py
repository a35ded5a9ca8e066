"""Continuous-batching generation engine: resident decode loop,
slot-based KV cache, per-token streaming.

Counterpart of ``mxnet_tpu/serving/generation.py`` (``StreamTimeout``,
``TokenStream``, ``GenRequest``, ``make_recovery_request``,
``GenerationEngine`` and its ``MXNET_GEN_*`` settings) with the same
scheduling, streaming, shedding, prefix-cache, speculation and recovery
rules:

* the decode inner loop is one shape-stable step
  (:meth:`~mxnet_tpu_torch.serving.model.DecodeModel.step`) over every
  slot of a :class:`~mxnet_tpu_torch.serving.kv_cache.PagedKVCache`,
  replayed on the card as one CUDA graph per KV bucket;
* admission happens BETWEEN decode iterations: prefill (the flash forward
  kernel, causal) runs for the newcomers, their KV rows are written into
  free slots, and the next iteration decodes old and new sequences
  together — no resident sequence changes its tokens because of an
  arrival;
* retirement is per step: a sequence that emits EOS or reaches its
  max-tokens budget frees its slot at the end of that iteration;
* tokens stream out as they exist: each iteration's (S,) token readback
  is pushed into per-request :class:`TokenStream` queues.

Overload sheds with :class:`~mxnet_tpu_torch.serving.batching.OverloadError`
(queue full at submit, no slot within the deadline). A fault at the
``serving.execute`` site (phases ``decode`` and ``prefill``) fails only the
sequences in flight at that iteration. Each iteration is an
``engine.iteration`` span linking its requests' traces, with
``engine.draft`` / ``engine.verify`` children on the speculative path; a
prefill is an ``engine.prefill`` span in its request's trace. The JAX
package's hang watchdog around the step (``health.watch_section``) is
ROADMAP Queue A 14.
"""
from __future__ import annotations

import collections
import itertools as _itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as _np

from .. import metrics as _metrics
from .. import tracing as _tracing
from ..base import MXNetError, getenv, register_env
from .batching import REQUESTS_TOTAL, SlotScheduler
from .kv_cache import (PagedKVCache, PrefixCache, prefix_key,
                       round_up_bucket, _shrink_rows)
from .model import DecodeModel, METHOD_CODES, warm_lanes

__all__ = ["GenerationEngine", "GenRequest", "StreamTimeout",
           "TokenStream", "make_recovery_request"]

register_env("MXNET_GEN_MAX_SLOTS", 8,
             "Decode slots in the generation engine: the number of "
             "sequences decoded concurrently by the resident "
             "continuous-batching step (the KV cache allocates this "
             "many rows).")
register_env("MXNET_GEN_MAX_TOKENS", 256,
             "Server-side cap on new tokens per generation request "
             "(a request asking for more is clamped; 0 disables the "
             "cap). Bounds slot hold time, which bounds admission "
             "latency under load.")
register_env("MXNET_GEN_STREAM", 1,
             "Default for per-token HTTP streaming on /v1/generate: 1 "
             "streams each token as a chunk the moment the decode "
             "iteration produces it; 0 answers with the full "
             "completion. Per-request 'stream' overrides.")
register_env("MXNET_GEN_METHOD", "greedy",
             "Default decode method for generation requests that name "
             "none: greedy | sample | top_k | top_p. Sampling runs "
             "inside the decode step (per-slot counter-based keys), so "
             "the method never changes the readback shape.")
register_env("MXNET_GEN_TEMPERATURE", 1.0,
             "Default sampling temperature for generation requests "
             "that name none (must be > 0; greedy ignores it). "
             "Per-request 'temperature' overrides.")
register_env("MXNET_GEN_TOP_K", 40,
             "Default k for top_k decoding when the request names "
             "none (>= 1, clamped to the vocab size). Per-request "
             "'top_k' overrides.")
register_env("MXNET_GEN_TOP_P", 0.9,
             "Default nucleus mass for top_p decoding when the "
             "request names none (0 < top_p <= 1). Per-request "
             "'top_p' overrides.")
register_env("MXNET_GEN_SPEC_MODE", "off",
             "Speculative decoding mode for the generation engine: "
             "'off' (one token per slot per iteration), 'self' (the "
             "target's own bottom MXNET_GEN_SPEC_DRAFT_LAYERS layers "
             "draft), or 'draft' (a separate small model passed to "
             "the engine as draft_model= drafts). Output is "
             "byte-identical to 'off' at the same seed — speculation "
             "only changes how many tokens an iteration emits. "
             "Per-request 'speculative': false opts a request out.")
register_env("MXNET_GEN_SPEC_K", 4,
             "Draft tokens proposed per slot per iteration when "
             "speculative decoding is on (>= 1). The target verifies "
             "k proposals plus its own next token in one pass, so an "
             "iteration emits 1..k+1 tokens per speculative slot.")
register_env("MXNET_GEN_SPEC_DRAFT_LAYERS", 0,
             "Transformer layers the self-speculative draft keeps "
             "from the target model (spec mode 'self'; 0 = half the "
             "target's layers). Fewer layers = cheaper proposals but "
             "lower acceptance.")


class StreamTimeout(MXNetError):
    """``TokenStream.next_token`` gave up waiting (NOT a request
    failure: the sequence may still produce — the HTTP layer uses short
    timeouts to poll for client disconnects while queued)."""


class TokenStream:
    """Per-request token channel: the engine produces, exactly one
    consumer (HTTP handler or in-process caller) drains.

    Iterate for per-token streaming (``for tok in stream``), or call
    :meth:`result` for collect-all.  A failed request raises its error
    from whichever call observes it (structured ``OverloadError`` for
    sheds — HTTP maps those to 429 even mid-stream-setup).

    The stream is the **exactly-once boundary** for recovery: every
    producer-side :meth:`put` carries the token's absolute index, and
    an index the transcript already holds is dropped (a resurrected
    producer replaying the join point), while an index PAST the
    transcript fails the stream loudly (a gap would silently corrupt
    the completion).  Consumers therefore see each index exactly once,
    in order, across any number of worker deaths."""

    def __init__(self) -> None:
        self._buf: Deque[Any] = collections.deque()
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._done = False
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self.finish_reason: Optional[str] = None
        self.tokens: List[int] = []     # producer-side transcript
        # notified on consumer cancel (the scheduler hooks this to
        # evict still-queued requests and free queue budget immediately)
        self._on_cancel: Optional[Any] = None

    # -- producer (engine) --------------------------------------------------
    def put(self, token: int, index: Optional[int] = None) -> None:
        gap: Optional[int] = None
        with self._lock:
            if self._done:
                return
            if index is not None:
                if index < len(self.tokens):
                    # duplicate from a recovered producer: the dedupe
                    # guard earns its keep
                    _metrics.SERVING_STREAM_DUPES_DROPPED.inc()
                    return
                if index > len(self.tokens):
                    gap = index
            if gap is None:
                self.tokens.append(int(token))
                self._buf.append(int(token))
                self._ready.notify_all()
        if gap is not None:
            # outside the lock: fail() retakes it
            self.fail(MXNetError(
                f"token stream gap: producer emitted index {gap} but "
                f"the transcript holds {len(self.tokens)} tokens — a "
                "recovery dropped tokens (exactly-once invariant "
                "violated)"))

    def put_many(self, tokens: Sequence[int], start_index: int) -> None:
        """Append a CONTIGUOUS run of tokens whose first absolute index
        is ``start_index`` — the speculative path's multi-token
        emission.  Per-token semantics are identical to calling
        :meth:`put` in a loop (an index the transcript holds is
        dropped, an index past it fails the stream), but the whole run
        lands under ONE lock pass with one consumer wakeup, so the
        HTTP layer drains it as one chunked write instead of k."""
        gap: Optional[int] = None
        with self._lock:
            if self._done:
                return
            for i, token in enumerate(tokens):
                index = int(start_index) + i
                if index < len(self.tokens):
                    _metrics.SERVING_STREAM_DUPES_DROPPED.inc()
                    continue
                if index > len(self.tokens):
                    gap = index
                    break
                self.tokens.append(int(token))
                self._buf.append(int(token))
            self._ready.notify_all()
        if gap is not None:
            self.fail(MXNetError(
                f"token stream gap: producer emitted index {gap} but "
                f"the transcript holds {len(self.tokens)} tokens — a "
                "recovery dropped tokens (exactly-once invariant "
                "violated)"))

    def close(self, finish_reason: str) -> None:
        with self._lock:
            if self._done:
                return
            self.finish_reason = finish_reason
            self._done = True
            self._ready.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._done:
                return
            self._error = exc
            self.finish_reason = "error"
            self._done = True
            self._ready.notify_all()

    # -- consumer -----------------------------------------------------------
    def cancel(self) -> None:
        """Consumer gave up (client disconnect): a still-queued request
        is evicted immediately (freeing queue budget); a slot-resident
        sequence retires at the next iteration boundary."""
        with self._lock:
            already = self._cancelled or self._done
            self._cancelled = True
            self._done = True
            self._ready.notify_all()
            cb = self._on_cancel
        if cb is not None and not already:
            try:
                cb()
            except Exception:   # noqa: BLE001 - eviction is advisory
                pass

    def is_cancelled(self) -> bool:
        with self._lock:
            return self._cancelled

    @property
    def finished(self) -> bool:
        """Producer-side: the engine closed/failed/cancelled this
        sequence (tokens may still be buffered for the consumer)."""
        with self._lock:
            return self._done

    @property
    def done(self) -> bool:
        """Consumer-side: finished AND fully drained."""
        with self._lock:
            return self._done and not self._buf

    def next_token(self, timeout: float = 60.0) -> Any:
        """The next streamed token, or ``None`` at end-of-stream;
        raises the request's error if it failed."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                if self._buf:
                    return self._buf.popleft()
                if self._done:
                    if self._error is not None:
                        raise self._error
                    return None
                left = deadline - time.monotonic()
                if left <= 0:
                    raise StreamTimeout(
                        "timed out waiting for the next generated "
                        f"token ({timeout}s)")
                self._ready.wait(left)

    def __iter__(self):
        while True:
            t = self.next_token()
            if t is None:
                return
            yield t

    def result(self, timeout: float = 120.0) -> List[int]:
        """Block until the sequence finishes; returns all tokens."""
        deadline = time.monotonic() + timeout
        out: List[int] = []
        while True:
            t = self.next_token(timeout=max(0.001,
                                            deadline - time.monotonic()))
            if t is None:
                return out
            out.append(t)


class GenRequest:
    """One generation request riding the scheduler: prompt, budget,
    stream, timing/slot bookkeeping.

    Recovery reincarnates a request as a NEW ``GenRequest`` carrying
    the SAME :class:`TokenStream`: ``tokens`` becomes the original
    prompt plus every token already emitted, ``max_new_tokens`` the
    remaining budget, and ``offset`` the absolute index of the next
    token — decode is deterministic (greedy by definition; sampling by
    seed: token ``i`` draws under the counter-based key (seed, i) no
    matter which program emits it), so the resurrected sequence is
    token-identical to a fault-free run and the stream's index dedupe
    makes the join exactly-once.  ``orig_prompt`` and
    ``total_new_tokens`` stay absolute so a second death recovers from
    the stream transcript again."""

    __slots__ = ("tokens", "max_new_tokens", "eos_token", "stream",
                 "enqueue_t", "deadline_t", "slot", "emitted",
                 "t_first", "request_id", "orig_prompt",
                 "total_new_tokens", "offset", "recover_t0",
                 "recoveries", "method", "temperature", "top_k",
                 "top_p", "seed", "speculative", "trace")

    _SEQ = _itertools.count(1)

    def __init__(self, tokens: _np.ndarray, max_new_tokens: int,
                 eos_token: Optional[int],
                 deadline_t: Optional[float],
                 stream: Optional[TokenStream] = None,
                 orig_prompt: Optional[_np.ndarray] = None,
                 total_new_tokens: Optional[int] = None,
                 offset: int = 0,
                 method: str = "greedy",
                 temperature: float = 1.0,
                 top_k: int = 40,
                 top_p: float = 0.9,
                 seed: int = 0,
                 speculative: bool = False) -> None:
        self.tokens = tokens
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token = eos_token
        self.method = str(method)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.speculative = bool(speculative)
        self.stream = stream if stream is not None else TokenStream()
        self.enqueue_t = time.monotonic()
        self.deadline_t = deadline_t
        self.slot: Optional[int] = None
        self.emitted = 0
        self.t_first: Optional[float] = None
        self.request_id = next(GenRequest._SEQ)
        self.orig_prompt = orig_prompt if orig_prompt is not None \
            else tokens
        self.total_new_tokens = int(
            total_new_tokens if total_new_tokens is not None
            else max_new_tokens)
        self.offset = int(offset)
        self.recover_t0: Optional[float] = None
        self.recoveries = 0     # resurrections so far (budgeted by the
        #                         server against restart churn)
        # trace context captured at submit; the engine thread attaches
        # it so queue-wait/prefill spans land in the request's trace
        self.trace = _tracing.capture()

    # scheduler duck-type
    def fail(self, exc: BaseException) -> None:
        self.stream.fail(exc)

    def is_cancelled(self) -> bool:
        return self.stream.is_cancelled()


def make_recovery_request(req: GenRequest) -> GenRequest:
    """Reincarnate ``req`` at its stream's current transcript: the
    resubmitted prompt is ``original prompt + tokens already emitted``
    (deterministic decode continues exactly where the dead worker left
    off — greedy trivially, sampling by replaying the request's
    counter-key stream from ``seed`` at the emitted-token offset), the
    budget is what remains, and the SAME stream rides along with its
    index offset advanced.  No deadline: the request was already
    admitted once — shedding it now would drop an accepted stream."""
    emitted = len(req.stream.tokens)
    if emitted:
        prompt = _np.concatenate(
            [_np.asarray(req.orig_prompt, _np.int32),
             _np.asarray(req.stream.tokens, _np.int32)])
    else:
        prompt = _np.asarray(req.orig_prompt, _np.int32)
    remaining = req.total_new_tokens - emitted
    if remaining < 1:
        raise MXNetError(
            f"request {req.request_id} has no remaining budget "
            f"({emitted}/{req.total_new_tokens} emitted) — it should "
            "have been closed, not recovered")
    r = GenRequest(prompt, remaining, req.eos_token, None,
                   stream=req.stream, orig_prompt=req.orig_prompt,
                   total_new_tokens=req.total_new_tokens,
                   offset=emitted, method=req.method,
                   temperature=req.temperature, top_k=req.top_k,
                   top_p=req.top_p, seed=req.seed,
                   speculative=req.speculative)
    r.recover_t0 = time.monotonic()
    r.recoveries = req.recoveries + 1
    r.trace = req.trace      # the resurrection stays in the original
    #                          request's trace (recovery spans included)
    return r


class GenerationEngine:
    """The resident decode loop over a slot table.

    Drive it from one owner thread (``ModelServer``'s generation worker
    in production, the test directly otherwise)::

        eng = GenerationEngine(DecodeModel.from_block(gpt))
        eng.warmup()
        stream = eng.submit(prompt_ids, max_new_tokens=32)
        while eng.run_iteration():   # or let GenerationServer loop
            pass
        print(stream.result())

    ``run_iteration`` is one scheduling quantum: retire finished
    sequences, admit newcomers into freed slots (prefill), then execute
    one decode step over every active slot.  Everything the iteration
    does is recorded in :attr:`iteration_log` (bounded ring) — the
    continuous-batching invariant ("admission changes no resident
    sequence's tokens") is asserted against these per-iteration slot
    logs in CI.
    """

    LOG_KEEP = 4096

    def __init__(self, model: DecodeModel,
                 max_slots: Optional[int] = None,
                 kv_buckets: Optional[Sequence[int]] = None,
                 queue_limit: Optional[int] = None,
                 max_tokens: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 prefix_slots: Optional[int] = None,
                 prefix_cache: Optional[PrefixCache] = None,
                 default_method: Optional[str] = None,
                 default_temperature: Optional[float] = None,
                 default_top_k: Optional[int] = None,
                 default_top_p: Optional[float] = None,
                 spec_mode: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 spec_draft_layers: Optional[int] = None,
                 draft_model: Any = None) -> None:
        self.model = model
        if max_slots is None:
            max_slots = int(getenv("MXNET_GEN_MAX_SLOTS", 8))
        self.max_slots = int(max_slots)
        # server-side sampling defaults (per-request values override);
        # validated HERE so a bad env/CLI default fails at startup,
        # not per-request
        self.default_method = str(
            default_method if default_method is not None
            else getenv("MXNET_GEN_METHOD", "greedy"))
        self.default_temperature = float(
            default_temperature if default_temperature is not None
            else getenv("MXNET_GEN_TEMPERATURE", 1.0))
        self.default_top_k = int(
            default_top_k if default_top_k is not None
            else getenv("MXNET_GEN_TOP_K", 40))
        self.default_top_p = float(
            default_top_p if default_top_p is not None
            else getenv("MXNET_GEN_TOP_P", 0.9))
        self._validate_sampling(self.default_method,
                                self.default_temperature,
                                self.default_top_k,
                                self.default_top_p, seed=0)
        # the position table bounds everything: a position past
        # max_length would silently clamp-gather the embedding, so the
        # cache only ever allocates buckets the model can address
        from .kv_cache import kv_bucket_grid
        full = kv_bucket_grid(kv_buckets)
        self.grid = tuple(b for b in full if b <= model.max_length)
        if not self.grid:
            raise MXNetError(
                f"no KV bucket <= model max_length {model.max_length} "
                f"(grid {full})")
        self.cache = PagedKVCache(
            model.n_layers, model.num_heads, model.head_dim,
            self.max_slots, buckets=self.grid, dtype=model.dtype,
            prefix=prefix_cache, prefix_slots=prefix_slots,
            device=model.device)
        # prompt pad grid: powers of two up to the top usable bucket —
        # mixed prompt lengths land on a handful of prefill programs
        top = self.grid[-1]
        pb, b = [], 8
        while b < top:
            pb.append(b)
            b *= 2
        pb.append(top)
        self.prompt_buckets = tuple(sorted(set(pb)))
        self.scheduler = SlotScheduler(self.max_slots,
                                       queue_limit=queue_limit)
        self.max_tokens_cap = int(
            max_tokens if max_tokens is not None
            else getenv("MXNET_GEN_MAX_TOKENS", 256))
        self._default_deadline_s = (
            float(default_deadline_ms) / 1e3 if default_deadline_ms
            is not None
            else float(getenv("MXNET_SERVING_DEADLINE_MS", 0)) / 1e3)
        # host mirrors of the per-slot step inputs: last token plus the
        # (seed, counter base, temperature, top_k, top_p, method)
        # sampling vectors — inputs of the decode graph.  The lanes
        # change only at admission/retirement, so their device mirrors
        # (_samp_dev) are cached across iterations; the per-token key
        # counter is derived on the device from the positions
        self._last_tok = _np.zeros((self.max_slots,), _np.int32)
        self._samp = model.greedy_sampling(self.max_slots)
        self._samp_dev: Optional[Any] = None
        self._in_admission: List[GenRequest] = []
        self.iteration_log: Deque[Dict[str, Any]] = collections.deque(
            maxlen=self.LOG_KEEP)
        self._iter = 0
        self.warmed = 0
        self._tps_window: Deque[Tuple[float, int]] = collections.deque(
            maxlen=64)
        # worker-death/decode-fault recovery hook: when set (by
        # GenerationServer), sequences hit by a decode-step fault are
        # handed to it for resurrection instead of failed terminally;
        # signature sink(victims: List[GenRequest], exc, site: str)
        self.recovery_sink: Optional[Any] = None
        # speculative decoding: a DraftModel (or None when off).
        # Requests default to speculating whenever a draft exists;
        # per-request speculative=False opts out and mixed iterations
        # ride the verify program together (plain slots just keep only
        # the first verified token)
        self.spec_mode = str(
            spec_mode if spec_mode is not None
            else getenv("MXNET_GEN_SPEC_MODE", "off"))
        self.spec_k = int(
            spec_k if spec_k is not None
            else getenv("MXNET_GEN_SPEC_K", 4))
        spec_layers = int(
            spec_draft_layers if spec_draft_layers is not None
            else getenv("MXNET_GEN_SPEC_DRAFT_LAYERS", 0))
        from .speculation import make_draft
        self._draft = make_draft(
            self.spec_mode, model, self.spec_k, layers=spec_layers,
            draft_model=draft_model, max_slots=self.max_slots,
            buckets=self.grid)
        self._spec_proposed = 0
        self._spec_accepted = 0

    # -- lifecycle ----------------------------------------------------------
    def warmup(self) -> int:
        """Run the whole program grid once — prefill x prompt buckets,
        suffix prefill x (prefix, suffix) bucket pairs, the first-token
        selector, decode x KV buckets with greedy and mixed lanes, every
        bucket's buffer set, and the speculative pair — so steady-state
        traffic captures no graph, whatever the per-request sampling
        parameters or prefixes."""
        self.warmed = self.model.warmup(
            self.cache, self.prompt_buckets,
            suffix_pairs=self.cache.prefix.slots > 0)
        self.warmed += self.cache.warmup_writes(self.prompt_buckets)
        if self._draft is not None:
            self.warmed += self._draft.warmup(self.prompt_buckets)
            self.warmed += self._warmup_spec()
        return self.warmed

    def _warmup_spec(self) -> int:
        """Run the speculative pair — the draft-proposal chain and the
        (k+1)-token verify pass — for every KV bucket, greedy and mixed."""
        S = self.cache.max_slots
        toks = _np.zeros((S,), _np.int32)
        pos = _np.zeros((S,), _np.int32)
        n = 0
        for b in self.cache.grid:
            self.cache._use(b)
            for lanes in warm_lanes(self.model, S):
                drafts = self._draft.propose(self.cache, toks, pos, lanes)
                cand = _np.concatenate(
                    [toks[:, None], _np.asarray(drafts, _np.int32)],
                    axis=1)
                self.model.verify(self.cache, cand, pos, lanes)
            self.cache.reset_buffers()
            n += 2
        self.cache._use(self.cache.grid[0])
        return n

    def close(self) -> None:
        """Fail everything in flight and stop admissions."""
        self.scheduler.close()
        for slot, req in self.scheduler.active().items():
            self.scheduler.release(slot)
            self.cache.free(slot)
            req.fail(MXNetError(
                "generation engine stopped with the sequence still "
                "decoding (shutdown)"))
            _metrics.GEN_RETIREMENTS_TOTAL.labels(reason="error").inc()
        _metrics.GEN_SLOTS_ACTIVE.set(0)

    def evacuate(self) -> Tuple[List[GenRequest], List[GenRequest]]:
        """Strip every request out of the engine WITHOUT failing its
        stream — the worker-death path: the supervisor resurrects them
        on a healthy replica.  Returns ``(queued, resident)``; resident
        entries still carry their emitted-token transcript on their
        streams.  The engine is left empty with zeroed KV buffers (the
        death may have landed mid-step)."""
        queued = [r for r in self.scheduler.drain_queue()
                  if not r.is_cancelled()]
        resident: List[GenRequest] = []
        for slot, req in self.scheduler.active().items():
            self.scheduler.release(slot)
            self.cache.free(slot)
            if req.stream.finished or req.is_cancelled():
                continue
            resident.append(req)
        # a death mid-prefill strands its request in neither queue nor
        # slot table — it is recoverable all the same (a death between
        # activate and the bookkeeping line can leave it in both: dedup)
        for req in self._in_admission:
            if req not in resident and not req.stream.finished \
                    and not req.is_cancelled():
                resident.append(req)
        self._in_admission = []
        self.cache.reset_buffers()
        if self._draft is not None:
            self._draft.evacuate()
        # fresh lanes: stale sampling methods on freed slots would
        # keep steering the step into its sampler branch for nothing
        self._samp = self.model.greedy_sampling(self.max_slots)
        self._samp_dev = None
        _metrics.GEN_SLOTS_ACTIVE.set(0)
        return queued, resident

    # -- request API --------------------------------------------------------
    def _validate_sampling(self, method: str, temperature: float,
                           top_k: int, top_p: float, seed: int) -> int:
        """The zoo's validation rules (``model_zoo.generation``), so
        the HTTP layer's 400s match the in-process API: method must be
        known, temperature > 0, top_k >= 1 (clamped to the vocab),
        0 < top_p <= 1.  Returns the clamped top_k."""
        if method not in METHOD_CODES:
            raise MXNetError(
                f"unknown generation method {method!r} (expected "
                "greedy, sample, top_k, or top_p)")
        if not temperature > 0.0:
            raise MXNetError(
                f"temperature must be > 0, got {temperature}")
        if not 1 <= top_k:
            raise MXNetError(f"top_k must be >= 1, got {top_k}")
        if not 0.0 < top_p <= 1.0:
            raise MXNetError(f"top_p must be in (0, 1], got {top_p}")
        if not -2**31 <= int(seed) < 2**31:
            # the seed rides the step as an int32 lane; an
            # out-of-range value must be the caller's 400, not a
            # mid-admission numpy OverflowError retiring the stream as
            # a server error
            raise MXNetError(
                f"seed must fit int32 (got {seed})")
        return min(int(top_k), int(self.model.vocab_size))

    def submit(self, tokens: Any, max_new_tokens: int = 64,
               eos_token: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               method: Optional[str] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               speculative: Optional[bool] = None) -> TokenStream:
        """Queue one prompt; returns its :class:`TokenStream`.  Sheds
        with :class:`OverloadError` when the admission queue is full;
        rejects (plain ``MXNetError``) prompts whose budget cannot fit
        the KV/position ceiling, or whose sampling parameters are out
        of range — those are the caller's bugs, not load.  Sampling
        (``method`` sample/top_k/top_p with ``temperature``/``top_k``/
        ``top_p``) runs on the device under per-slot counter-PRNG keys
        derived from ``seed``: same seed => same stream, across
        worker-death resurrection included.  ``speculative`` defaults
        to whether the engine has a draft (MXNET_GEN_SPEC_MODE);
        ``False`` opts this request out of drafting, ``True`` on an
        engine without a draft quietly decodes plain — either way the
        token stream is the same bytes."""
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        if toks.size < 1:
            raise MXNetError("empty prompt")
        method = str(method) if method is not None \
            else self.default_method
        temperature = float(temperature) if temperature is not None \
            else self.default_temperature
        top_k = int(top_k) if top_k is not None else self.default_top_k
        top_p = float(top_p) if top_p is not None else self.default_top_p
        seed = int(seed) if seed is not None else 0
        top_k = self._validate_sampling(method, temperature, top_k,
                                        top_p, seed)
        if self.max_tokens_cap > 0:
            max_new_tokens = min(int(max_new_tokens),
                                 self.max_tokens_cap)
        if max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        need = int(toks.size) + int(max_new_tokens)
        if need > self.grid[-1]:
            raise MXNetError(
                f"prompt ({toks.size}) + max_new_tokens "
                f"({max_new_tokens}) needs {need} positions; the top "
                f"KV bucket / model ceiling is {self.grid[-1]} "
                "(raise MXNET_GEN_KV_BUCKETS or shorten the request)")
        if deadline_ms is None and self._default_deadline_s > 0:
            deadline_ms = self._default_deadline_s * 1e3
        deadline_t = (time.monotonic() + deadline_ms / 1e3
                      if deadline_ms else None)
        spec = bool(speculative) if speculative is not None \
            else self._draft is not None
        req = GenRequest(toks, max_new_tokens, eos_token, deadline_t,
                         method=method, temperature=temperature,
                         top_k=top_k, top_p=top_p, seed=seed,
                         speculative=spec)
        # consumer cancel while still queued -> evict NOW (queue budget
        # frees immediately; an abandoned-request flood cannot hold
        # queue_full sheds high until the next admission pass)
        req.stream._on_cancel = lambda: self.scheduler.discard(req)
        self.scheduler.submit(req)      # raises OverloadError on shed
        return req.stream

    def submit_request(self, req: GenRequest, front: bool = False) -> None:
        """Install an already-accepted request (the recovery path):
        bypasses the queue_full shed — the request was admitted once
        and must complete or fail structurally, never re-shed."""
        req.stream._on_cancel = lambda: self.scheduler.discard(req)
        self.scheduler.submit(req, front=front, force=True)

    # -- the scheduling quantum ---------------------------------------------
    def run_iteration(self) -> bool:
        """Retire -> admit -> decode, once.  Returns True when any work
        happened (False = idle: nothing active, nothing admissible)."""
        from .. import faults as _faults

        self._iter += 1
        log: Dict[str, Any] = {"iter": self._iter, "admitted": [],
                               "retired": [], "decoded": []}

        # 1. retire: EOS/max-tokens were marked at the previous decode;
        #    cancelled consumers release their slot here too.  The
        #    producer-side `finished` flag, NOT `done`: a finished
        #    sequence must free its slot even while its consumer is
        #    still draining buffered tokens
        for slot, req in self.scheduler.active().items():
            if req.stream.finished or req.is_cancelled():
                self._retire(slot, req,
                             req.stream.finish_reason or "cancelled")
                log["retired"].append(slot)

        # 2. admit into free slots (prefill, one program per
        #    prompt bucket).  Always visit the queue — with zero free
        #    slots pop_admissions(0) admits nothing but STILL sheds
        #    queued requests whose deadline passed ("no slot freed
        #    within the deadline" is the generation overload signal).
        #    Mid-admission requests ride self._in_admission so a
        #    worker death during prefill still evacuates them (they
        #    are in neither the queue nor the slot table), and the
        #    scheduler's mid-admission count keeps drain polls honest.
        free = self.cache.free_slots()
        pending = self.scheduler.pop_admissions(len(free))
        self._in_admission = list(pending)
        for req in pending:
            try:
                # prefill lands in the REQUEST's trace (attach), not an
                # engine-iteration trace; a failed prefill marks the
                # span errored, which tail-upgrades the whole trace
                with _tracing.attach(req.trace), _tracing.child_span(
                        "engine.prefill", request_id=req.request_id,
                        prompt=int(req.tokens.size)):
                    slot = self._admit(req)
            except Exception as e:   # noqa: BLE001 - a poisoned
                # prompt (or an injected prefill fault) fails ONLY
                # its own request; the engine keeps serving
                req.fail(e)
                REQUESTS_TOTAL.labels(status="error").inc()
                _metrics.GEN_RETIREMENTS_TOTAL.labels(
                    reason="error").inc()
            else:
                log["admitted"].append(slot)
            # NOT in a finally: a BaseException mid-prefill must leave
            # the request visible to evacuate()
            self._in_admission.remove(req)
            self.scheduler.admission_done()

        active = self.scheduler.active()
        _metrics.GEN_SLOTS_ACTIVE.set(len(active))
        if not active:
            self.cache.reset_if_empty()
            if self._draft is not None:
                self._draft.reset_if_empty()
            self.iteration_log.append(log)
            return bool(log["admitted"] or log["retired"])

        # 3. one resident decode step over EVERY active slot.  The
        #    iteration span is its own (head-sampled) trace — one step
        #    serves MANY requests, so it cannot be a child of any one
        #    of them; instead it LINKS every resident request's trace
        #    id, and a request's trace finds "its" decode steps by
        #    searching iteration spans that link it.
        #    When any resident request speculates, the WHOLE iteration
        #    rides the draft+verify pair (one program each): the draft
        #    proposes k tokens per slot, verify scores all k+1
        #    positions in one target pass, and plain slots simply keep
        #    only the first verified token — which is bit-identical to
        #    what the plain step would have produced.
        spec_k = self._draft.k if self._draft is not None else 0
        spec_slots = frozenset(
            s for s, r in active.items()
            if spec_k and getattr(r, "speculative", False))
        use_spec = bool(spec_slots)
        iter_tid = None
        try:
            with _tracing.span("engine.iteration", iter=self._iter,
                               slots=len(active)) as isp:
                iter_tid = _tracing.current_trace_id()
                for _r in active.values():
                    _tr = getattr(_r, "trace", None)
                    if _tr is not None:
                        isp.add_link(_tr.trace_id)
                _faults.maybe_fault("serving.execute", phase="decode",
                                    slots=len(active))
                if use_spec:
                    # verify scatters k rows past every slot's
                    # position: grow for the worst case up front,
                    # capped at the grid top (rows past it belong to
                    # tokens the submit-time budget check proves are
                    # never emitted)
                    self.cache.ensure_capacity(
                        min(self.cache.needed_capacity() + spec_k,
                            self.grid[-1]))
                else:
                    self.cache.ensure_capacity(
                        self.cache.needed_capacity())
                pos = _np.maximum(self.cache.positions,
                                  0).astype(_np.int32)
                if self._samp_dev is None:
                    self._samp_dev = self.model.device_sampling(
                        self._samp)
                if use_spec:
                    with _tracing.child_span(
                            "engine.draft",
                            slots=len(spec_slots), k=spec_k):
                        drafts = self._draft.propose(
                            self.cache, self._last_tok, pos,
                            self._samp_dev)
                    cand = _np.concatenate(
                        [self._last_tok[:, None],
                         _np.asarray(drafts, _np.int32)], axis=1)
                    with _tracing.child_span(
                            "engine.verify", slots=len(active), k=spec_k):
                        ver = self.model.verify(
                            self.cache, cand, pos, self._samp_dev)
                else:
                    next_tok = self.model.step(self.cache,
                                               self._last_tok,
                                               pos, self._samp_dev)
        except Exception as e:   # noqa: BLE001 - an iteration fault
            # hits exactly the sequences IN FLIGHT at this iteration
            # (their kv rows are suspect); queued requests and the
            # engine itself are unaffected
            self.cache.reset_buffers()
            if self._draft is not None:
                self._draft.reset()
            victims: List[GenRequest] = []
            for slot, req in active.items():
                if self.recovery_sink is not None \
                        and not req.stream.finished \
                        and not req.is_cancelled():
                    # managed engine: the sequence is resurrected from
                    # its stream transcript (exactly-once recovery) —
                    # release the slot WITHOUT closing the stream
                    self.scheduler.release(slot)
                    self.cache.free(slot)
                    if self._draft is not None:
                        self._draft.release(slot)
                    if self._samp[5][slot]:
                        self._samp[5][slot] = 0
                        self._samp_dev = None
                    _metrics.GEN_RETIREMENTS_TOTAL.labels(
                        reason="recovered").inc()
                    victims.append(req)
                else:
                    req.fail(e)          # before close(): the consumer
                    #                      must observe the fault, not
                    #                      a clean end-of-stream
                    self._retire(slot, req, "error")
                    REQUESTS_TOTAL.labels(status="error").inc()
                log["retired"].append(slot)
            self.iteration_log.append(log)
            if victims:
                self.recovery_sink(victims, e, "decode")
            return True

        now = time.monotonic()
        n_streamed = 0
        it_proposed = it_accepted = 0
        for slot, req in active.items():
            if use_spec:
                p = int(self.cache.positions[slot])
                row = ver[slot]
                if slot in spec_slots:
                    # accept rule: keep the longest prefix of draft
                    # proposals that MATCH the target's own tokens —
                    # every emitted token is the target's, so the
                    # stream is byte-identical to non-speculative
                    a = 0
                    while a < spec_k \
                            and int(cand[slot, a + 1]) == int(row[a]):
                        a += 1
                    it_proposed += spec_k
                    it_accepted += a
                    _metrics.GEN_SPEC_PROPOSED_TOKENS_TOTAL.inc(spec_k)
                    if a:
                        _metrics.GEN_SPEC_ACCEPTED_TOKENS_TOTAL.inc(a)
                    if spec_k - a:
                        _metrics.GEN_SPEC_REJECTED_TOKENS_TOTAL.inc(
                            spec_k - a)
                    emit_n = a + 1
                else:
                    # plain slot riding a speculative iteration: its
                    # verify column 0 IS the plain step's token
                    emit_n = 1
                emit_n = min(emit_n,
                             req.max_new_tokens - req.emitted)
                emit = [int(row[j]) for j in range(emit_n)]
                if req.eos_token is not None:
                    eos = int(req.eos_token)
                    for j, t in enumerate(emit):
                        if t == eos:
                            del emit[j + 1:]
                            break
                m = len(emit)
                # verify advanced every slot's device rows to p+k+1;
                # adopt them, then roll the rejected/unemitted tail
                # back.  Plain slots just take their one real row —
                # the extra rows were never theirs (bookkeeping, not a
                # rollback)
                if slot in spec_slots and m < spec_k + 1:
                    self.cache.positions[slot] = p + spec_k + 1
                    self.cache.truncate(slot, p + m)
                else:
                    self.cache.positions[slot] = p + m
                if self._draft is not None:
                    self._draft.commit(slot, p + m)
                self._last_tok[slot] = emit[-1]
                _metrics.GEN_SAMPLED_TOKENS_TOTAL.labels(
                    method=req.method).inc(m)
                # ONE lock pass / consumer wakeup for the whole run;
                # absolute indexes ride along as with put
                req.stream.put_many(
                    emit, start_index=req.offset + req.emitted)
                req.emitted += m
                n_streamed += m
                tok = emit[-1]
                if slot in spec_slots:
                    # min-exemplar retention: the histogram keeps the
                    # trace id of the WORST-accepting recent step
                    _metrics.GEN_SPEC_ACCEPTED_PER_STEP.observe(
                        float(m), exemplar=iter_tid)
            else:
                tok = int(next_tok[slot])
                self.cache.positions[slot] += 1
                self._last_tok[slot] = tok
                _metrics.GEN_SAMPLED_TOKENS_TOTAL.labels(
                    method=req.method).inc()
                # absolute index rides along: the stream dedupes
                # replays from recovered producers at this boundary
                req.stream.put(tok, index=req.offset + req.emitted)
                req.emitted += 1
                n_streamed += 1
            log["decoded"].append(slot)
            finished = None
            if req.eos_token is not None and tok == int(req.eos_token):
                finished = "eos"
            elif req.emitted >= req.max_new_tokens:
                finished = "length"
            elif int(self.cache.positions[slot]) >= self.grid[-1]:
                finished = "length"
            if finished:
                # mark done now; the slot frees at the next iteration's
                # retire phase (keeps this loop allocation-free)
                req.stream.close(finished)
        if it_proposed:
            self._spec_proposed += it_proposed
            self._spec_accepted += it_accepted
            _metrics.GEN_SPEC_ACCEPT_RATE.set(
                self._spec_accepted / self._spec_proposed)
        _metrics.GEN_TOKENS_TOTAL.labels(phase="decode").inc(n_streamed)
        _metrics.GEN_ITERATIONS_TOTAL.inc()
        self._tps_window.append((now, n_streamed))
        if len(self._tps_window) >= 2:
            t0, _ = self._tps_window[0]
            span = now - t0
            if span > 0:
                total = sum(n for _, n in self._tps_window) \
                    - self._tps_window[0][1]
                _metrics.GEN_TOKENS_PER_SECOND.set(total / span)
        self.iteration_log.append(log)
        return True

    def _lookup_prefix(self, req: GenRequest) -> Optional[Any]:
        """The longest resident prefix of ``req``'s prompt (pinned —
        the caller unpins), or None.  Candidates are the bucket-aligned
        prefix lengths: the prompt-bucket grid values <= the prompt
        length, longest first.  A whole-prompt entry only counts when
        it carries its prefill logits (nothing left to prefill), and a
        partial prefix only when the padded layout it forces
        (``q + round_up(suffix)`` rows) needs no more capacity than a
        cold prefill's own padded prompt — a SHORT resident prefix
        under a LONG prompt would otherwise pad past the cold layout
        (ballooning the whole cache's bucket, or, past the top bucket,
        hard-failing a request a cold prefill serves fine)."""
        t0 = int(req.tokens.size)
        for q in reversed(self.prompt_buckets):
            if q > t0:
                continue
            key = prefix_key(req.tokens, q)
            e = self.cache.prefix.lookup(key, pin=True)
            if e is None:
                continue
            if e.q == t0:
                if e.logits is None:
                    self.cache.prefix.unpin(key)
                    continue
                return e
            sb = round_up_bucket(t0 - q, self.prompt_buckets)
            if q + sb > round_up_bucket(t0, self.prompt_buckets):
                self.cache.prefix.unpin(key)
                continue        # reuse must never cost more than cold
            return e
        return None

    def _insert_prefix(self, req: GenRequest, ks: Sequence[Any],
                       vs: Sequence[Any], logits: _np.ndarray) -> None:
        """After a cold prefill, park the longest bucket-aligned prefix
        of the prompt in the pinned region (rows sliced off the
        prefill output — a warmable shape-pair program).  When the
        prefix IS the whole prompt, the prefill logits ride along so
        an identical prompt admits with no model call at all."""
        t0 = int(req.tokens.size)
        q = max((b for b in self.prompt_buckets if b <= t0),
                default=None)
        if q is None:
            return
        key = prefix_key(req.tokens, q)
        if self.cache.prefix.lookup(key) is not None:
            if q == t0:
                # the resident entry was cut from a longer prompt and
                # carries no logits; this cold prefill just computed
                # them for exactly this prefix — attach, so identical
                # prompts now admit with no model call
                self.cache.prefix.attach_logits(key, logits)
            return
        # the entry keeps rows of its own, cut to the prefix
        cut = _shrink_rows(list(ks) + list(vs), q)
        pks, pvs = cut[:len(ks)], cut[len(ks):]
        self.cache.prefix.insert(
            key, pks, pvs, q, logits=(logits if q == t0 else None))

    def _admit(self, req: GenRequest) -> int:
        """Install one request in a slot.  A cold prompt runs prefill
        (and parks its bucket-aligned prefix for the next request); a
        prompt whose prefix is resident COPIES the shared rows into
        the slot (one fused row-write over every layer) and prefills only the
        suffix — or nothing at all for an identical prompt.  Either
        way the pass emits the FIRST generated token (TTFT ends
        here)."""
        from .. import faults as _faults
        _faults.maybe_fault("serving.execute", phase="prefill",
                            prompt=int(req.tokens.size))
        slot = self.cache.alloc()
        if slot is None:                     # caller checked free_slots
            raise MXNetError("no free decode slot (admission race)")
        entry = None
        try:
            t0 = int(req.tokens.size)
            cacheable = (self.cache.prefix.slots > 0
                         and t0 >= self.prompt_buckets[0])
            if cacheable:
                entry = self._lookup_prefix(req)
            if entry is not None and entry.q == t0:
                # identical prompt: pure row copy + cached logits —
                # no model invocation on the admission path
                self.cache.write_prompt(slot, entry.ks, entry.vs, t0)
                logits = entry.logits
                _metrics.GEN_PREFIX_HITS_TOTAL.inc()
            elif entry is not None:
                # shared prefix: copy the resident rows, prefill only
                # the suffix against them
                q = entry.q
                sb = round_up_bucket(t0 - q, self.prompt_buckets)
                logits, sks, svs = self.model.prefill_suffix(
                    req.tokens[q:], entry.ks, entry.vs, q, sb)
                self.cache.write_prompt(slot, entry.ks, entry.vs, q)
                self.cache.write_prompt(slot, sks, svs, t0, start=q)
                _metrics.GEN_PREFIX_HITS_TOTAL.inc()
            else:
                pb = round_up_bucket(t0, self.prompt_buckets)
                logits, ks, vs = self.model.prefill(req.tokens, pb)
                self.cache.write_prompt(slot, ks, vs, t0)
                if cacheable:
                    _metrics.GEN_PREFIX_MISSES_TOTAL.inc()
                    self._insert_prefix(req, ks, vs, logits)
            # first token through the same sampler as the step
            # (key = (seed, offset)): one key stream
            # per request no matter which program emits which token
            first = self.model.select(
                logits, req.seed, req.offset, req.temperature,
                req.top_k, req.top_p, METHOD_CODES[req.method])
            if req.speculative and self._draft is not None:
                # the draft follows the same prompt: its cache rows
                # mirror this slot from the first iteration on
                self._draft.admit(slot, req.tokens,
                                  self.prompt_buckets)
        except Exception:
            self.cache.free(slot)
            if self._draft is not None:
                self._draft.release(slot)
            raise
        finally:
            if entry is not None:
                self.cache.prefix.unpin(entry.key)
        self.scheduler.activate(slot, req)
        req.slot = slot
        self._last_tok[slot] = first
        # arm the slot's sampling lane.  The counter base makes the
        # in-program key counter (pos - base) equal the token's
        # absolute stream index: at the request's decode step number e
        # (tokens emitted so far, prefill's included), pos is
        # t0 + e - 1, and the token being drawn is index offset + e —
        # so base = t0 - offset - 1, a per-request constant (for a
        # resurrection, exactly the original prompt length minus one)
        self._samp[0][slot] = req.seed
        self._samp[1][slot] = t0 - req.offset - 1
        self._samp[2][slot] = req.temperature
        self._samp[3][slot] = req.top_k
        self._samp[4][slot] = req.top_p
        self._samp[5][slot] = METHOD_CODES[req.method]
        self._samp_dev = None        # lanes changed: remirror once
        req.t_first = time.monotonic()
        req.stream.put(first, index=req.offset)
        req.emitted = 1
        _metrics.GEN_SAMPLED_TOKENS_TOTAL.labels(
            method=req.method).inc()
        _metrics.GEN_TTFT_SECONDS.observe(
            req.t_first - req.enqueue_t,
            exemplar=req.trace.trace_id if req.trace is not None
            else None)
        _metrics.GEN_TOKENS_TOTAL.labels(phase="prefill").inc()
        _metrics.GEN_ADMISSIONS_TOTAL.inc()
        if req.recover_t0 is not None:
            # recovery ends when the resurrected sequence streams again
            _metrics.SERVING_RECOVERY_SECONDS.observe(
                req.t_first - req.recover_t0)
            req.recover_t0 = None
        if req.eos_token is not None and first == int(req.eos_token):
            req.stream.close("eos")
        elif req.emitted >= req.max_new_tokens:
            req.stream.close("length")
        return slot

    def _retire(self, slot: int, req: GenRequest, reason: str) -> None:
        self.scheduler.release(slot)
        self.cache.free(slot)
        if self._draft is not None:
            self._draft.release(slot)
        if self._samp[5][slot]:
            self._samp[5][slot] = 0      # freed lanes ride greedy
            self._samp_dev = None
        req.stream.close(reason)         # no-op if already closed
        if reason in ("eos", "length"):
            REQUESTS_TOTAL.labels(status="ok").inc()
        _metrics.GEN_RETIREMENTS_TOTAL.labels(reason=reason).inc()

    # -- introspection ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        return {
            "model": self.model.describe(),
            "cache": self.cache.describe(),
            "slots": {"max": self.max_slots,
                      "active": self.scheduler.n_active(),
                      "free": len(self.cache.free_slots())},
            "queue": {"depth": len(self.scheduler),
                      "limit": self.scheduler.queue_limit},
            "prompt_buckets": list(self.prompt_buckets),
            "kv_buckets": list(self.grid),
            "max_tokens_cap": self.max_tokens_cap,
            "warmed_programs": self.warmed,
            "iterations": self._iter,
            "sampling_defaults": {
                "method": self.default_method,
                "temperature": self.default_temperature,
                "top_k": self.default_top_k,
                "top_p": self.default_top_p,
            },
            "prefix_cache": self.cache.prefix.describe(),
            "speculation": (self._draft.describe()
                            if self._draft is not None
                            else {"mode": "off"}),
        }
