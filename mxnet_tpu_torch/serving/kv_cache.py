"""Slot-based, capacity-bucketed KV cache for continuous-batching decode.

Counterpart of ``mxnet_tpu/serving/kv_cache.py`` (``PagedKVCache``,
``PrefixCache``, ``prefix_key``, ``kv_bucket_grid``, ``round_up_bucket``,
``_shrink_rows``) with the same slot, bucket, rollback and prefix rules:

* **Slots** — per layer a fixed ``(S, L, heads, d)`` K and V buffer,
  ``S = max_slots``. A sequence owns one slot row for its lifetime;
  retirement frees the slot id, and the row's stale contents stay masked
  by the slot's position.
* **Capacity buckets** — ``L`` is drawn from ``MXNET_GEN_KV_BUCKETS``.
  When a live sequence needs a position ``>= L`` the rows move to the next
  bucket (:meth:`PagedKVCache.grow`).
* **Buffers that outlive the graphs** — the decode step replays a CUDA
  graph per bucket (``serving/model.py``), and a graph reads fixed
  addresses. So each bucket owns one buffer set, allocated once and kept:
  ``grow`` copies the rows into the next bucket's set, ``reset_if_empty``
  returns to the smallest bucket's set, and a reset zeroes a set in
  place. Every write is in place; no buffer is replaced.

Positions and occupancy are host-side numpy bookkeeping: the device only
ever sees the fixed-shape buffers plus an ``(S,)`` position vector.
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as _np
import torch

from .. import metrics as _metrics
from ..base import MXNetError, getenv, register_env
from ..context import as_device
from ..gluon.parameter import to_torch_dtype

__all__ = ["PagedKVCache", "PrefixCache", "kv_bucket_grid",
           "round_up_bucket", "prefix_key"]

register_env("MXNET_GEN_KV_BUCKETS", "128,256,512,1024",
             "KV-cache capacity bucket grid for the generation engine "
             "(comma list of padded sequence lengths). The decode step "
             "runs one CUDA graph per bucket; a sequence whose "
             "prompt+new-tokens budget exceeds the top bucket is "
             "rejected at submit.")
register_env("MXNET_GEN_PREFIX_CACHE_SLOTS", 8,
             "Resident entries in the generation engine's shared-prefix "
             "KV cache: bucket-aligned prompt prefixes keep their K/V rows "
             "on the device and admissions copy them into the slot instead "
             "of re-running prefill. LRU eviction past this bound; 0 "
             "disables prefix caching.")


def kv_bucket_grid(buckets: Optional[Sequence[int]] = None
                   ) -> Tuple[int, ...]:
    """The configured KV capacity grid, sorted ascending."""
    if buckets is None:
        raw = str(getenv("MXNET_GEN_KV_BUCKETS", "128,256,512,1024"))
        buckets = [int(b) for b in raw.split(",") if b.strip()]
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] < 1:
        raise MXNetError(f"bad KV bucket grid {buckets!r}")
    return out


def round_up_bucket(n: int, grid: Sequence[int]) -> int:
    """Smallest grid bucket >= n (raises past the top)."""
    for b in grid:
        if b >= n:
            return b
    raise MXNetError(
        f"required capacity {n} exceeds the top KV bucket {grid[-1]}; "
        "reject the request (or raise MXNET_GEN_KV_BUCKETS)")


class PagedKVCache:
    """Per-layer ``(max_slots, L, heads, head_dim)`` K/V buffers on
    ``device`` (``cuda:0`` by default) plus host-side slot bookkeeping.

    ``graphs`` and ``io`` belong to the decode model that drives this
    cache: the CUDA graphs captured over these buffers and their static
    inputs (``serving/model.py``)."""

    def __init__(self, n_layers: int, n_heads: int, head_dim: int,
                 max_slots: int,
                 buckets: Optional[Sequence[int]] = None,
                 dtype: Any = None,
                 prefix_slots: Optional[int] = None,
                 prefix: Optional["PrefixCache"] = None,
                 device: Any = None) -> None:
        from ..gluon.model_zoo.generation import _LRU
        self.grid = kv_bucket_grid(buckets)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.max_slots = int(max_slots)
        if self.max_slots < 1:
            raise MXNetError(f"max_slots must be >= 1, got {max_slots}")
        self.dtype = to_torch_dtype(dtype) if dtype is not None \
            else torch.float32
        self.device = as_device(device)
        self._sets: Dict[int, Tuple[List[torch.Tensor],
                                    List[torch.Tensor]]] = {}
        self.graphs = _LRU()
        self.io: Optional[Any] = None
        self.bucket = self.grid[0]
        self._k: List[torch.Tensor] = []
        self._v: List[torch.Tensor] = []
        self._use(self.bucket)
        # host bookkeeping: next write position per slot (== tokens
        # resident in the row), -1 marks a free slot
        self.positions = _np.full((self.max_slots,), -1, _np.int64)
        # the shared-prefix region; pass ``prefix`` to share one store
        # across engines serving the same model
        self.prefix = prefix if prefix is not None \
            else PrefixCache(prefix_slots)
        _metrics.GEN_KV_BUCKET_LEN.set(self.bucket)

    # -- buffers ------------------------------------------------------------
    def _use(self, L: int) -> None:
        """Make bucket ``L``'s buffer set current (allocated zeroed on its
        first use, then kept for the cache's lifetime)."""
        L = int(L)
        if L not in self._sets:
            shape = (self.max_slots, L, self.n_heads, self.head_dim)
            self._sets[L] = tuple(
                [torch.zeros(shape, dtype=self.dtype, device=self.device)
                 for _ in range(self.n_layers)] for _ in range(2))
        self._k, self._v = self._sets[L]
        self.bucket = L

    def k(self, layer: int) -> torch.Tensor:
        return self._k[layer]

    def v(self, layer: int) -> torch.Tensor:
        return self._v[layer]

    def layers(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's (k, v) buffers of the current bucket. The decode
        step writes them in place, so there is no ``replace``: the JAX
        package swaps in the buffers its donated program returns, while
        here the buffers a graph was captured over stay the cache's."""
        return list(zip(self._k, self._v))

    # -- slots --------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i in range(self.max_slots)
                if self.positions[i] < 0]

    def occupancy(self) -> int:
        return int((self.positions >= 0).sum())

    def alloc(self) -> Optional[int]:
        for i in range(self.max_slots):
            if self.positions[i] < 0:
                self.positions[i] = 0
                return i
        return None

    def free(self, slot: int) -> None:
        self.positions[slot] = -1

    # -- admission write ----------------------------------------------------
    @torch.inference_mode()
    def write_prompt(self, slot: int, ks: Sequence[torch.Tensor],
                     vs: Sequence[torch.Tensor], t0: int,
                     start: int = 0) -> None:
        """Install prefilled rows into ``slot``: ``ks[l]`` / ``vs[l]`` are
        ``(Lp, heads, d)``, placed at positions ``start..start+Lp`` (pad
        rows past the real prompt stay masked until the decode loop
        overwrites them). ``t0`` is the slot's resident-token count after
        the write. Grows the cache first if the rows exceed the bucket."""
        Lp = int(ks[0].shape[0])
        if int(start) + Lp > self.bucket:
            self.grow(round_up_bucket(int(start) + Lp, self.grid))
        end = int(start) + Lp
        for buf, row in zip(self._k + self._v, list(ks) + list(vs)):
            buf[slot, int(start):end].copy_(row)
        self.positions[slot] = int(t0)

    # -- rollback -----------------------------------------------------------
    def truncate(self, slot: int, position: int) -> int:
        """Roll ``slot`` back so ``position`` is its next write index — the
        speculative-decode rejection path. Pure host bookkeeping: rows past
        a slot's position are invisible to the decode attention, and the
        next accepted token's write makes the row bit-identical to one that
        was never speculated into. Returns the number of rows discarded."""
        if not 0 <= int(slot) < self.max_slots:
            raise MXNetError(
                f"truncate: slot {slot} out of range "
                f"(max_slots={self.max_slots})")
        cur = int(self.positions[slot])
        if cur < 0:
            raise MXNetError(f"truncate: slot {slot} is free")
        position = int(position)
        if position < 0 or position > cur:
            raise MXNetError(
                f"truncate: position {position} outside the slot's "
                f"resident range [0, {cur}] — rollback only ever "
                "rewinds (forward motion is the decode loop's job)")
        dropped = cur - position
        if dropped:
            self.positions[slot] = position
            _metrics.GEN_KV_ROLLBACKS_TOTAL.inc()
        return dropped

    # -- capacity -----------------------------------------------------------
    def needed_capacity(self) -> int:
        """Positions the next decode step will write: max live position
        + 1 (0 when idle)."""
        live = self.positions[self.positions >= 0]
        return int(live.max()) + 1 if live.size else 0

    def ensure_capacity(self, pos_needed: int) -> bool:
        """Grow to the bucket covering ``pos_needed`` write positions;
        returns True when a migration happened."""
        if pos_needed <= self.bucket:
            return False
        self.grow(round_up_bucket(pos_needed, self.grid))
        return True

    @torch.inference_mode()
    def grow(self, new_bucket: int) -> None:
        """Move every row into bucket ``new_bucket``'s buffer set (its tail
        zeroed) and make it current."""
        if new_bucket <= self.bucket:
            return
        old, n = self._sets[self.bucket], self.bucket
        self._use(new_bucket)
        for src, dst in zip(old[0] + old[1], self._k + self._v):
            dst[:, :n].copy_(src)
            dst[:, n:].zero_()
        _metrics.GEN_KV_MIGRATIONS_TOTAL.inc()
        _metrics.GEN_KV_BUCKET_LEN.set(new_bucket)

    def warmup_writes(self, prompt_buckets: Sequence[int]) -> int:
        """Allocate every bucket's buffer set before traffic (the JAX
        package compiles its row writes here; the port's are plain copies).
        Returns the number of buffer sets."""
        cur = self.bucket
        for L in self.grid:
            self._use(L)
        self._use(cur)
        return len(self.grid)

    @torch.inference_mode()
    def reset_buffers(self) -> None:
        """Zero the current buffer set in place (after a decode-step
        failure: the rows of the sequences in flight are suspect)."""
        for buf in self._k + self._v:
            buf.zero_()

    def reset_if_empty(self) -> None:
        """Return to the smallest bucket once no sequence is live (only
        then: shrinking under live traffic would thrash)."""
        if self.occupancy() == 0 and self.bucket != self.grid[0]:
            self._use(self.grid[0])
            self.reset_buffers()
            _metrics.GEN_KV_BUCKET_LEN.set(self.bucket)

    def describe(self) -> dict:
        return {
            "max_slots": self.max_slots,
            "bucket": self.bucket,
            "buckets": list(self.grid),
            "occupancy": self.occupancy(),
            "layers": self.n_layers,
            "heads": self.n_heads,
            "head_dim": self.head_dim,
            "dtype": str(self.dtype).replace("torch.", ""),
            "prefix_cache": self.prefix.describe(),
        }


def _shrink_rows(rows: List[torch.Tensor], new_len: int
                 ) -> List[torch.Tensor]:
    """Every (Lp, h, d) row-set of ``rows`` cut to its first ``new_len``
    rows, each in memory of its own (a prefix entry must not pin the
    prefill's whole QKV projection)."""
    return [r[:int(new_len)].clone(memory_format=torch.contiguous_format)
            for r in rows]


# ---------------------------------------------------------------------------
# shared-prefix KV cache (the pinned region)
# ---------------------------------------------------------------------------

class _PrefixEntry:
    """One resident prefix: per-layer K/V rows (Pb, heads, d) on the
    device, the real prefix length ``q`` and — when the prefix IS a whole
    prompt — the prefill's last-token logits, so an identical-prompt
    admission emits its first token without any model call."""

    __slots__ = ("key", "ks", "vs", "q", "bucket", "logits", "refs")

    def __init__(self, key: str, ks: List[Any], vs: List[Any], q: int,
                 logits: Optional[Any]) -> None:
        self.key = key
        self.ks = ks
        self.vs = vs
        self.q = int(q)
        self.bucket = int(ks[0].shape[0])
        self.logits = logits
        self.refs = 0


def prefix_key(tokens: _np.ndarray, q: int) -> str:
    """Content hash of the first ``q`` tokens (int32-canonical)."""
    raw = _np.ascontiguousarray(
        _np.asarray(tokens, _np.int32)[:q]).tobytes()
    return f"{q}:{hashlib.sha1(raw).hexdigest()}"


class PrefixCache:
    """Ref-counted, LRU-bounded store of hot prompt-prefix K/V rows.

    One store may be shared by engines serving the same decode model
    (replicas on one device). Every method is lock-guarded and nothing
    under the lock touches the device; ``refs`` counts admissions
    currently copying from an entry, and eviction only ever removes
    unreferenced entries."""

    def __init__(self, slots: Optional[int] = None) -> None:
        if slots is None:
            slots = int(getenv("MXNET_GEN_PREFIX_CACHE_SLOTS", 8))
        self.slots = max(0, int(slots))
        self._entries: "collections.OrderedDict[str, _PrefixEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, key: str, pin: bool = False
               ) -> Optional[_PrefixEntry]:
        """The entry for ``key`` (refreshing recency), or None.
        ``pin=True`` bumps the refcount — pair with :meth:`unpin`."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            if pin:
                e.refs += 1
            return e

    def unpin(self, key: str) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.refs > 0:
                e.refs -= 1

    def insert(self, key: str, ks: List[Any], vs: List[Any], q: int,
               logits: Optional[Any] = None) -> bool:
        """Install a prefix (an existing key only refreshes recency).
        Evicts LRU unreferenced entries past the ``slots`` bound; returns
        False when the cache is disabled or every resident entry is
        pinned."""
        if self.slots == 0:
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            while len(self._entries) >= self.slots:
                victim = next((k for k, e in self._entries.items()
                               if e.refs == 0), None)
                if victim is None:
                    return False        # everything pinned: skip insert
                del self._entries[victim]
                _metrics.GEN_PREFIX_EVICTIONS_TOTAL.inc()
            self._entries[key] = _PrefixEntry(key, list(ks), list(vs),
                                              q, logits)
            _metrics.GEN_PREFIX_ROWS.set(
                sum(e.bucket for e in self._entries.values()))
            return True

    def attach_logits(self, key: str, logits: Any) -> None:
        """Upgrade a resident entry with whole-prompt prefill logits."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.logits is None:
                e.logits = logits

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
        _metrics.GEN_PREFIX_ROWS.set(0)

    def rows_resident(self) -> int:
        with self._lock:
            return sum(e.bucket for e in self._entries.values())

    def describe(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "entries": len(self._entries),
                "rows": sum(e.bucket for e in self._entries.values()),
                "pinned": sum(1 for e in self._entries.values()
                              if e.refs > 0),
            }
