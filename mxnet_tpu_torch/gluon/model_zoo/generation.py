"""Autoregressive text generation for the GPT family — KV-cache
incremental decoding.

Counterpart of ``mxnet_tpu/gluon/model_zoo/generation.py`` (``generate``,
``beam_search``, ``_select``, ``_collect``, ``_LRU``) and the host-side
oracle the serving engine (``serving/generation.py``) is held against:

* the prompt pass (:func:`_block_prefill`) attends through the port's
  ``flash_attention(..., causal=True)``: on CUDA tensors the Hopper flash
  forward, reading q, k and v as (B, H, T, D) views of the fused QKV
  projection where they lie (no operand copied);
* each decode token (:func:`_slot_block_step`) scatters its K/V row at
  its slot's position and attends through
  :func:`~mxnet_tpu_torch.ops.cuda.decode_attention.decode_attention`
  over the slot's visible rows; the decode loop here runs eagerly, one
  token at a time (the serving engine replays it as CUDA graphs);
* token selection (:func:`_sample_tokens`): greedy argmax, or the
  temperature / top-k / top-p filters of the JAX package followed by a
  Gumbel-max draw under a stateless counter-based key. The JAX package
  draws from ``fold_in(PRNGKey(seed), counter)`` (threefry), which the
  port cannot reproduce bit for bit; the port's draw for vocabulary entry
  ``i`` is word 0 of Philox4x32-10 with key ``(seed, 0x5851F42D)`` and
  counter ``(i, counter, 0, 0)``, as a uniform
  ``((w >> 8) + 0.5) * 2**-24``, and the token is
  ``argmax(filtered / temperature + gumbel(u))``. The same (seed,
  counter, logits) give the same token whatever the slot, the batch or
  the program, and no ``torch.Generator`` moves. ``generate`` draws token
  ``i`` of a sequence under counter ``i``, as the engine does.

The block math mirrors ``GPTBlock.forward`` (the same layer norm, GELU
and scale). Parameters are read in place from the model (``_collect``);
``_LRU`` bounds the serving engine's per-bucket CUDA-graph caches.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as _np
import torch
import torch.nn.functional as F

from ...base import MXNetError
from ...ops.cuda.attention import flash_attention
from ...ops.cuda.attention import philox4x32_10
from ...ops.cuda.decode_attention import decode_attention

__all__ = ["generate", "beam_search"]

METHOD_CODES = {"greedy": 0, "sample": 1, "top_k": 2, "top_p": 3}
# the sampler's second Philox key word (the first is the request's seed)
_SAMPLE_KEY1 = 0x5851F42D
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# parameter extraction (blocks -> a dict of the tensors, read in place)
# ---------------------------------------------------------------------------

def _collect(model) -> Dict[str, Any]:
    blocks: List[Dict[str, torch.Tensor]] = []
    for blk in model.blocks:
        if blk.moe is not None:
            raise MXNetError(
                "generate() does not support MoE blocks yet — decode "
                "routing is not implemented (ROADMAP Queue A 13)")
        blocks.append({
            "ln1_g": blk.ln1.gamma.data(), "ln1_b": blk.ln1.beta.data(),
            "qkv_w": blk.attn_qkv.weight.data(),
            "qkv_b": blk.attn_qkv.bias.data(),
            "out_w": blk.attn_out.weight.data(),
            "out_b": blk.attn_out.bias.data(),
            "ln2_g": blk.ln2.gamma.data(), "ln2_b": blk.ln2.beta.data(),
            "f1_w": blk.ffn1.weight.data(), "f1_b": blk.ffn1.bias.data(),
            "f2_w": blk.ffn2.weight.data(), "f2_b": blk.ffn2.bias.data(),
        })
    first = next(iter(model.blocks))
    return {
        "gelu_approx": any(blk._gelu_approximate
                           for blk in model.blocks),
        "ln_eps": float(first.ln1._epsilon),
        "num_heads": int(first._num_heads),
        "embed": model.word_embed.weight.data(),
        "pos": model.position_weight.data(),
        "lnf_g": model.ln_f.gamma.data(), "lnf_b": model.ln_f.beta.data(),
        "blocks": blocks,
    }


# ---------------------------------------------------------------------------
# block math (mirrors GPTBlock.forward)
# ---------------------------------------------------------------------------

def _ln(x, g, b, eps):
    return F.layer_norm(x, (x.shape[-1],), g, b, eps)


def _ffn_residual(p, x, ga):
    gelu_approx, eps = ga
    h = _ln(x, p["ln2_g"], p["ln2_b"], eps)
    ffn = F.gelu(F.linear(h, p["f1_w"], p["f1_b"]),
                 approximate="tanh" if gelu_approx else "none")
    return x + F.linear(ffn, p["f2_w"], p["f2_b"])


def _qkv(p, x, ga):
    return F.linear(_ln(x, p["ln1_g"], p["ln1_b"], ga[1]), p["qkv_w"],
                    p["qkv_b"])


def _block_prefill(p, x, nh: int, ga, bias=None, prefix=None):
    """Causal pass over (B, T, C) ``x``: returns (x_out, k, v), k and v
    the (B, T, nh, d) rows this pass adds to the cache (views of the QKV
    projection). ``prefix``: (pk, pv) rows (Pb, nh, d) already in the
    cache that the (B = 1) rows attend to under ``bias`` (the suffix pass
    of ``serving.model.DecodeModel.prefill_suffix``), non-causal."""
    B, T, C = x.shape
    d = C // nh
    q, k, v = torch.split(_qkv(p, x, ga), C, dim=-1)
    qh, kh, vh = (t.reshape(B, T, nh, d) for t in (q, k, v))
    if prefix is None:
        out = flash_attention(qh, kh, vh, causal=True)
    else:
        pk, pv = prefix
        out = flash_attention(qh, torch.cat([pk[None], kh], 1),
                              torch.cat([pv[None], vh], 1), bias=bias,
                              bias_grad=False)
    x = x + F.linear(out.reshape(B, T, C), p["out_w"], p["out_b"])
    return _ffn_residual(p, x, ga), kh, vh


def _slot_block_step(p, x, ck, cv, pos, nh: int, ga, flat_rows, work=None):
    """One decode token for every slot: ``x`` (S, C), caches (S, L, nh, d),
    ``pos`` (S,) int64 write positions, ``flat_rows`` (S,) int64 the
    first flat row of each slot (``arange(S) * L``). Slot i writes its K/V
    at its position, then attends over its rows 0..pos[i]. ``work``: the
    decode attention kernel's kept workspace, or None for one a call."""
    S, C = x.shape
    d = C // nh
    L = ck.shape[1]
    q, k, v = torch.split(_qkv(p, x, ga), C, dim=-1)
    # positions past the bucket (a speculative pass at the grid top, whose
    # tokens are never emitted) write the last row
    idx = flat_rows + pos.clamp(max=L - 1)
    ck.view(S * L, nh, d).index_copy_(0, idx, k.reshape(S, nh, d))
    cv.view(S * L, nh, d).index_copy_(0, idx, v.reshape(S, nh, d))
    out = decode_attention(q.reshape(S, nh, d), ck, cv, pos, work=work)
    x = x + F.linear(out.reshape(S, C), p["out_w"], p["out_b"])
    return _ffn_residual(p, x, ga)


def _embed(params, toks, pos):
    """(S,) token ids at (S,) positions -> (S, C)."""
    P = params["pos"].shape[0]
    return params["embed"][toks] + params["pos"][pos.clamp(max=P - 1)]


def _head(params, x, eps):
    return F.linear(_ln(x, params["lnf_g"], params["lnf_b"], eps),
                    params["embed"])


def _prefill(params, tokens, nh, ga):
    """(B, T) tokens -> (last-position logits (B, V), [(k, v)] per layer,
    each (B, T, nh, d))."""
    T = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][:T][None]
    kvs = []
    for p in params["blocks"]:
        x, kh, vh = _block_prefill(p, x, nh, ga)
        kvs.append((kh, vh))
    return _head(params, x[:, -1], ga[1]), kvs


def _forward_step(params, toks, caches, pos, nh, ga, flat_rows):
    """Embed one token per row at ``pos``, run every block against the
    (written in place) caches; returns logits (S, V)."""
    x = _embed(params, toks, pos)
    for p, (ck, cv) in zip(params["blocks"], caches):
        x = _slot_block_step(p, x, ck, cv, pos, nh, ga, flat_rows)
    return _head(params, x, ga[1])


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------

def _filter_logits(scaled, topks, topps, methods):
    """The JAX package's top-k and top-p thresholds on (N, V) f32
    temperature-scaled logits (``_select`` / ``_sample_tokens``): a top_k
    row keeps values >= its k-th largest, a top_p row the smallest
    probability-sorted prefix whose mass reaches top_p (the most probable
    token always kept); filtered entries become -inf."""
    V = scaled.shape[-1]
    # no host scalar is copied in: this runs inside the decode graphs
    neg = torch.full((), float("-inf"), dtype=scaled.dtype,
                     device=scaled.device)
    asc = torch.sort(scaled, dim=-1).values
    kidx = (V - topks).clamp(0, V - 1).to(torch.int64)
    kth_k = torch.gather(asc, 1, kidx[:, None])
    desc = asc.flip(-1)
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < topps[:, None]
    kth_p = torch.where(keep, desc, torch.full_like(desc, float("inf"))
                        ).amin(dim=-1, keepdim=True)
    m = methods[:, None]
    filt = torch.where((m == 2) & (scaled < kth_k), neg, scaled)
    return torch.where((m == 3) & (filt < kth_p), neg, filt)


def _gumbel(seeds, ctrs, V: int):
    """(N, V) f32 Gumbel noise: entry i of row r from Philox4x32-10 with
    key (seeds[r], _SAMPLE_KEY1) and counter (i, ctrs[r], 0, 0)."""
    dev = seeds.device
    c0 = torch.arange(V, dtype=torch.int64, device=dev)[None, :]
    c1 = (ctrs.to(torch.int64) & _U32)[:, None]
    k0 = (seeds.to(torch.int64) & _U32)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w = philox4x32_10(c0, c1, zero, zero, k0,
                      torch.full((), _SAMPLE_KEY1, dtype=torch.int64,
                                 device=dev))[0]
    u = ((w >> 8).to(torch.float32) + 0.5) * (1.0 / 16777216.0)
    return -torch.log(-torch.log(u))


def _sample_tokens(logits, seeds, ctrs, temps, topks, topps, methods,
                   mixed: bool = True):
    """Per-row token selection over (N, V) logits (any float dtype): greedy
    rows (method 0) take the raw argmax; the others the temperature
    scaling, their method's filter and a Gumbel-max draw under
    (seed, counter). ``mixed=False``: every row is greedy (the argmax
    alone runs). Returns (N,) int64."""
    greedy = torch.argmax(logits, dim=-1)
    if not mixed:
        return greedy
    scaled = logits.float() / temps.float().clamp(min=1e-6)[:, None]
    filt = _filter_logits(scaled, topks, topps.float(), methods)
    sampled = torch.argmax(filt + _gumbel(seeds, ctrs, logits.shape[-1]),
                           dim=-1)
    return torch.where(methods == 0, greedy, sampled)


def _select(logits, method: str, temperature: float, top_k: int,
            top_p: float, seed: int, counter: int):
    """(B, V) logits -> (B,) int64 tokens under one method for every row;
    ``counter`` keys the draw (the token's index in its sequence)."""
    if method not in METHOD_CODES:
        raise MXNetError(f"unknown generation method {method!r}")
    B, dev = logits.shape[0], logits.device

    def full(val, dtype):
        return torch.full((B,), val, dtype=dtype, device=dev)

    return _sample_tokens(
        logits, full(seed, torch.int64), full(counter, torch.int64),
        full(temperature, torch.float32), full(top_k, torch.int64),
        full(top_p, torch.float32),
        full(METHOD_CODES[method], torch.int64), mixed=method != "greedy")


class _LRU(dict):
    """Bounded cache: the least recently used entry goes first past
    ``MAX`` (the serving engine's CUDA graphs of one KV cache)."""

    MAX = 32

    def get(self, key, default=None):
        v = super().get(key, default)
        if key in self:                     # refresh recency
            super().__delitem__(key)
            super().__setitem__(key, v)
        return v

    def __setitem__(self, key, value):
        if key in self:
            super().__delitem__(key)
        elif len(self) >= self.MAX:
            super().__delitem__(next(iter(self)))
        super().__setitem__(key, value)


def _prepare(model, tokens, max_new_tokens: int):
    """Shared generate/beam prolog: coerce tokens, validate lengths,
    collect params. Returns (toks (B, T0) int64 tensor on the model's
    device, params, nh, L, ga)."""
    if isinstance(tokens, torch.Tensor):
        toks = tokens.detach().cpu().numpy()
    else:
        toks = _np.asarray(tokens.asnumpy() if hasattr(tokens, "asnumpy")
                           else tokens)
    toks = toks.astype(_np.int64)
    if toks.ndim == 1:
        toks = toks[None, :]
    if max_new_tokens < 1:
        raise MXNetError("max_new_tokens must be >= 1")
    L = toks.shape[1] + max_new_tokens
    if L > model._max_length:
        raise MXNetError(
            f"prompt ({toks.shape[1]}) + new tokens ({max_new_tokens}) "
            f"exceeds max_length {model._max_length}")
    params = _collect(model)
    ga = (params.pop("gelu_approx"), params.pop("ln_eps"))
    nh = params.pop("num_heads")
    dev = params["embed"].device
    return torch.from_numpy(toks).to(dev), params, nh, L, ga


def _caches(kvs, L: int):
    """Per-layer (B, L, nh, d) cache buffers holding the prefill rows."""
    out = []
    for kh, vh in kvs:
        B, T, nh, d = kh.shape
        ck = torch.zeros((B, L, nh, d), dtype=kh.dtype, device=kh.device)
        cv = torch.zeros_like(ck)
        ck[:, :T] = kh
        cv[:, :T] = vh
        out.append((ck, cv))
    return out


@torch.inference_mode()
def generate(model, tokens, max_new_tokens: int, method: str = "greedy",
             temperature: float = 1.0, top_k: int = 40,
             eos_token: Optional[int] = None, seed: int = 0,
             top_p: float = 0.9):
    """Decode ``max_new_tokens`` continuations of ``tokens`` (B, T0).

    ``method``: 'greedy', 'sample', 'top_k', or 'top_p' (nucleus).
    Returns an int32 tensor (B, max_new_tokens) on the CPU. After
    ``eos_token`` (if given) a sequence keeps emitting ``eos_token``."""
    toks, params, nh, L, ga = _prepare(model, tokens, max_new_tokens)
    B, T0 = toks.shape
    eos = -1 if eos_token is None else int(eos_token)
    if method == "top_k":
        V = params["embed"].shape[0]
        if not 1 <= top_k:
            raise MXNetError(f"top_k must be >= 1, got {top_k}")
        top_k = min(int(top_k), V)
    if method == "top_p" and not 0.0 < top_p <= 1.0:
        raise MXNetError(f"top_p must be in (0, 1], got {top_p}")
    if method not in METHOD_CODES:
        raise MXNetError(f"unknown generation method {method!r}")

    logits, kvs = _prefill(params, toks, nh, ga)
    caches = _caches(kvs, L)
    tok = _select(logits, method, temperature, top_k, top_p, seed, 0)
    done = tok == eos
    outs = [tok]
    flat_rows = torch.arange(B, device=toks.device) * L
    for i in range(1, max_new_tokens):
        pos = torch.full((B,), T0 + i - 1, dtype=torch.int64,
                         device=toks.device)
        logits = _forward_step(params, tok, caches, pos, nh, ga, flat_rows)
        nxt = _select(logits, method, temperature, top_k, top_p, seed, i)
        if eos >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            done = done | (nxt == eos)
        outs.append(nxt)
        tok = nxt
    return torch.stack(outs, 1).to(torch.int32).cpu()


@torch.inference_mode()
def beam_search(model, tokens, max_new_tokens: int, beam_size: int = 4,
                eos_token: Optional[int] = None, alpha: float = 1.0):
    """Length-normalized beam search (scores = logprob_sum /
    length^alpha). ``tokens`` (B, T0) -> (sequences (B, beam,
    max_new_tokens) int32, scores (B, beam) f32), beams sorted best-first,
    on the CPU. The caches expand to B*beam rows once and are reordered
    each step by gathers."""
    toks, params, nh, L, ga = _prepare(model, tokens, max_new_tokens)
    B, T0 = toks.shape
    K = int(beam_size)
    if K < 1:
        raise MXNetError(f"beam_size must be >= 1, got {K}")
    eos = -1 if eos_token is None else int(eos_token)
    NEG = -1e30
    dev = toks.device

    logits, kvs = _prefill(params, toks, nh, ga)
    V = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, first = torch.topk(logp, K, dim=-1)              # (B, K)
    caches = [(ck.repeat_interleave(K, 0), cv.repeat_interleave(K, 0))
              for ck, cv in _caches(kvs, L)]
    tok = first.reshape(B * K)
    done = tok == eos
    seqs = torch.zeros((B, K, max_new_tokens), dtype=torch.int64,
                       device=dev)
    seqs[:, :, 0] = first
    flat_rows = torch.arange(B * K, device=dev) * L
    only_eos = torch.full((V,), NEG, device=dev)
    if eos >= 0:
        only_eos[eos] = 0.0
    for i in range(max_new_tokens - 1):
        pos = torch.full((B * K,), T0 + i, dtype=torch.int64, device=dev)
        logits = _forward_step(params, tok, caches, pos, nh, ga, flat_rows)
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, K, V)
        if eos >= 0:
            # a finished beam only extends with eos at no cost
            logp = torch.where(done.reshape(B, K, 1), only_eos, logp)
        cand = (scores[:, :, None] + logp).reshape(B, K * V)
        scores, idx = torch.topk(cand, K, dim=-1)
        beam_src = idx // V
        tok = (idx % V).reshape(B * K)
        gather = (torch.arange(B, device=dev)[:, None] * K
                  + beam_src).reshape(B * K)
        caches = [(ck[gather], cv[gather]) for ck, cv in caches]
        seqs = torch.gather(seqs, 1, beam_src[:, :, None].expand_as(seqs))
        seqs[:, :, i + 1] = tok.reshape(B, K)
        done = done[gather]
        if eos >= 0:
            done = done | (tok == eos)
    if eos >= 0:
        lengths = (torch.cumsum((seqs == eos).long(), dim=-1) == 0
                   ).sum(-1) + 1
        lengths = lengths.clamp(max=max_new_tokens)
    else:
        lengths = torch.full((B, K), max_new_tokens, device=dev)
    norm = scores / (lengths.float() ** alpha)
    order = torch.argsort(-norm, dim=-1, stable=True)
    seqs = torch.gather(seqs, 1, order[:, :, None].expand_as(seqs))
    norm = torch.gather(norm, 1, order)
    return seqs.to(torch.int32).cpu(), norm.cpu()
