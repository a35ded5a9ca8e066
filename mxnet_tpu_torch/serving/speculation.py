"""Speculative decoding: draft models that propose k tokens per slot for
one-pass target verification.

Counterpart of ``mxnet_tpu/serving/speculation.py`` (``DraftModel``,
``SelfSpeculativeDraft``, ``IndependentDraft``, ``make_draft``,
``_chain_steps``). A cheap draft proposes ``k`` tokens per slot, the target
scores all ``k+1`` positions in one pass
(:meth:`~mxnet_tpu_torch.serving.model.DecodeModel.verify`), and the engine
keeps the longest prefix of proposals that match the target's own tokens:
every emitted token is the target's, so the output has the bytes of the
non-speculative engine at the same seed, greedy and sampled alike (the
drafts draw under the same per-slot (seed, counter) keys as the target).

**Rollback.** Verification writes K/V rows for all ``k+1`` positions;
when only ``m <= k`` tokens survive, the engine rewinds the slot with
:meth:`PagedKVCache.truncate` — host bookkeeping counted in
``mxnet_gen_kv_rollbacks_total``.

* :class:`SelfSpeculativeDraft` — the target's own bottom ``n`` layers
  (plus its final norm and tied head) draft. Its chain writes the target
  cache's first ``n`` layer rows at ``pos..pos+k-1`` in place: the verify
  pass that follows writes those rows again with the same bits (the same
  layers on the same inputs), so no extra state exists.
* :class:`IndependentDraft` — a separate small zoo GPT with its own
  :class:`PagedKVCache` mirroring the target's slot ids; each propose runs
  ``k+1`` chained sub-steps so that after truncation the draft cache
  position always equals the target's.

On the card each chain replays a CUDA graph per (bucket, greedy or mixed
lanes), captured at warmup, as the target's step does.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Sequence

import numpy as _np

from ..base import MXNetError
from .kv_cache import PagedKVCache, round_up_bucket
from .model import DecodeModel, warm_lanes

__all__ = ["DraftModel", "SelfSpeculativeDraft", "IndependentDraft",
           "make_draft"]


def _chain_steps(model: DecodeModel, cache: Any, toks: Any, pos: Any,
                 sampling: Any, n_sub: int, layers: Optional[int] = None
                 ) -> _np.ndarray:
    """``n_sub`` chained single-token steps feeding each output token back
    in as the next input — the draft-proposal chain. Sub-step ``j`` writes
    K/V at ``pos + j`` and draws under counter ``pos + j - base``: the key
    the target's verify pass uses for that position, so a draft whose
    logits match the target's proposes the target's own token. Returns
    (S, n_sub) int32."""
    S = cache.max_slots
    model._account(f"draft:{S}x{cache.bucket}x{n_sub}")
    t = time.perf_counter()
    out = model._run(cache, "draft", _np.asarray(toks).reshape(S, 1), pos,
                     sampling, n_sub, True, layers=layers)
    model._observe("draft", t)
    return out.astype(_np.int32)


class DraftModel:
    """The engine-facing draft protocol: :meth:`admit` / :meth:`release`
    bracket a speculative request's residency in a slot; :meth:`propose`
    returns an ``(S, k)`` proposal matrix for every slot; :meth:`commit`
    gives the slot's post-acceptance position; :meth:`evacuate` /
    :meth:`reset` / :meth:`reset_if_empty` mirror the engine's failure and
    idle paths; :meth:`warmup` runs the draft's programs once."""

    mode = "?"
    k = 0

    def admit(self, slot: int, tokens: _np.ndarray,
              prompt_buckets: Sequence[int]) -> None:
        pass

    def release(self, slot: int) -> None:
        pass

    def commit(self, slot: int, position: int) -> None:
        pass

    def evacuate(self) -> None:
        pass

    def reset(self) -> None:
        pass

    def reset_if_empty(self) -> None:
        pass

    def warmup(self, prompt_buckets: Sequence[int]) -> int:
        return 0

    def propose(self, cache: Any, last_tok: _np.ndarray,
                positions: _np.ndarray,
                sampling: Optional[Sequence[Any]] = None) -> _np.ndarray:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"mode": self.mode, "k": self.k}


class SelfSpeculativeDraft(DraftModel):
    """Truncated-layer self-speculation: the target's bottom ``layers``
    blocks + final norm + tied head propose the next ``k`` tokens over the
    target's own cache."""

    mode = "self"

    def __init__(self, model: Any, k: int, layers: int = 0) -> None:
        if not isinstance(model, DecodeModel):
            model = DecodeModel.from_block(model)
        self.model = model
        self.k = int(k)
        if self.k < 1:
            raise MXNetError(f"speculative k must be >= 1, got {k}")
        layers = int(layers)
        if layers == 0:
            layers = max(1, model.n_layers // 2)
        if not 1 <= layers <= model.n_layers:
            raise MXNetError(
                f"self-speculative draft wants 1..{model.n_layers} "
                f"target layers, got {layers}")
        self.layers = layers

    def propose(self, cache: Any, last_tok: _np.ndarray,
                positions: _np.ndarray,
                sampling: Optional[Sequence[Any]] = None) -> _np.ndarray:
        return _chain_steps(self.model, cache, last_tok, positions,
                            sampling, self.k, layers=self.layers)

    def describe(self) -> dict:
        return {"mode": self.mode, "k": self.k, "layers": self.layers,
                "target_layers": self.model.n_layers}


class IndependentDraft(DraftModel):
    """A separate small GPT drafting against its own :class:`PagedKVCache`
    whose slot ids mirror the target's. Every :meth:`propose` runs ``k+1``
    chained sub-steps (the extra one writes the row of the last proposal),
    so the draft cache holds rows for exactly the positions the target
    holds once :meth:`commit` truncates both to the accepted boundary."""

    mode = "draft"

    def __init__(self, model: Any, k: int, max_slots: int,
                 buckets: Optional[Sequence[int]] = None,
                 device: Any = None) -> None:
        if not isinstance(model, DecodeModel):
            model = DecodeModel.from_block(model, device=device)
        self.model = model
        self.k = int(k)
        if self.k < 1:
            raise MXNetError(f"speculative k must be >= 1, got {k}")
        self.cache = PagedKVCache(
            model.n_layers, model.num_heads, model.head_dim,
            int(max_slots), buckets=buckets, dtype=model.dtype,
            prefix_slots=0, device=model.device)
        if self.cache.grid[-1] > model.max_length:
            raise MXNetError(
                f"draft model context {model.max_length} is shorter "
                f"than the KV bucket grid top {self.cache.grid[-1]} — "
                "the draft could not follow a full-length sequence")

    def admit(self, slot: int, tokens: _np.ndarray,
              prompt_buckets: Sequence[int]) -> None:
        toks = _np.asarray(tokens, _np.int32).reshape(-1)
        t0 = toks.shape[0]
        pb = round_up_bucket(t0, prompt_buckets)
        _, ks, vs = self.model.prefill(toks, pb)
        self.cache.write_prompt(slot, ks, vs, t0)

    def release(self, slot: int) -> None:
        self.cache.free(slot)

    def commit(self, slot: int, position: int) -> None:
        if self.cache.positions[slot] < 0:
            return
        dp = int(self.cache.positions[slot])
        # propose wrote rows dp..dp+k; adopt them, then rewind to the
        # target's accepted boundary (== dp+k+1 on full acceptance)
        self.cache.positions[slot] = dp + self.k + 1
        if position < dp + self.k + 1:
            self.cache.truncate(slot, position)

    def evacuate(self) -> None:
        self.cache.positions.fill(-1)
        self.cache.reset_buffers()

    def reset(self) -> None:
        self.cache.reset_buffers()

    def reset_if_empty(self) -> None:
        self.cache.reset_if_empty()

    def warmup(self, prompt_buckets: Sequence[int]) -> int:
        n = 0
        one = _np.zeros((1,), _np.int32)
        for pb in prompt_buckets:
            if pb > self.model.max_length:
                continue
            self.model.prefill(one, int(pb))
            n += 1
        n += self.cache.warmup_writes(prompt_buckets)
        S = self.cache.max_slots
        toks = _np.zeros((S,), _np.int32)
        for b in self.cache.grid:
            self.cache._use(b)
            for lanes in warm_lanes(self.model, S):
                self.propose(None, toks, None, lanes)
            self.cache.reset_buffers()
            n += 1
        self.cache._use(self.cache.grid[0])
        return n

    def propose(self, cache: Any, last_tok: _np.ndarray,
                positions: Optional[_np.ndarray] = None,
                sampling: Optional[Sequence[Any]] = None) -> _np.ndarray:
        # ``cache`` / ``positions`` are the TARGET's — the draft follows
        # its own mirror (equal for every speculative slot; free and
        # non-speculative slots ride at 0 and their proposals are
        # discarded)
        self.cache.ensure_capacity(
            min(self.cache.needed_capacity() + self.k,
                self.cache.grid[-1]))
        pos = _np.maximum(self.cache.positions, 0)
        out = _chain_steps(self.model, self.cache, last_tok, pos, sampling,
                           self.k + 1)
        return out[:, :self.k]

    def describe(self) -> dict:
        return {"mode": self.mode, "k": self.k,
                "draft_model": self.model.describe(),
                "draft_cache": self.cache.describe()}


def make_draft(mode: Optional[str], target: DecodeModel, k: int,
               layers: int = 0, draft_model: Any = None,
               max_slots: int = 0,
               buckets: Optional[Sequence[int]] = None
               ) -> Optional[DraftModel]:
    """Build the draft the engine's spec config asks for (None when
    ``mode`` is off/empty). A draft block is served on the target's
    device."""
    if mode in (None, "", "off"):
        return None
    if mode == "self":
        return SelfSpeculativeDraft(target, k, layers)
    if mode == "draft":
        if draft_model is None:
            raise MXNetError(
                "speculative mode 'draft' needs a draft model "
                "(pass draft_model= to the engine; MXNET_GEN_SPEC_MODE "
                "alone cannot conjure one)")
        d = IndependentDraft(draft_model, k, max_slots, buckets=buckets,
                             device=target.device)
        if d.model.vocab_size != target.vocab_size:
            raise MXNetError(
                f"draft vocab {d.model.vocab_size} != target vocab "
                f"{target.vocab_size} — speculation requires a shared "
                "tokenizer")
        return d
    raise MXNetError(
        f"unknown speculative mode {mode!r} (want off|self|draft)")
