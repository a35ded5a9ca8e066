"""KV-cache incremental decoding for the encoder-decoder Transformer.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer_generation.py``
(``translate``, ``beam_translate``, ``_collect``, ``_encode``,
``_dec_step``, ``_prepare``), with the same math and results; the loop
runs eagerly, one token a step, as the port's GPT ``generate`` does
(``generation.py``, whose ``_ln``, ``_qkv``, ``_ffn_residual`` and
``_select`` it reuses):

* the encoder runs once: its self-attention is the port's
  ``flash_attention`` under the source's key-padding bias (on CUDA tensors
  the Hopper flash forward), and each decoder layer's cross-attention keys
  and values are projected once from the memory into contiguous
  (B, Ts, H, D) buffers;
* each step writes its self-attention K/V row at position ``i`` of a
  (B, L, H, D) cache (L = ``max_new_tokens``) and attends through
  :func:`~mxnet_tpu_torch.ops.cuda.decode_attention.decode_attention`
  over rows 0..i; the cross-attention is the same kernel over the
  memory's K/V with ``pos = src_valid_length - 1`` (``Ts - 1`` without
  one), which is the JAX package's source bias exactly: keys at or past
  the valid length are masked. One kernel workspace serves every launch
  of a call;
* a source of valid length 0: the JAX package adds ``finfo(float32).min``
  to every score, so such a row attends uniformly over all Ts keys. The
  flash forward gives a row with no visible key 0, and the decode kernel
  at ``pos = -1`` reads one row, so those rows take the mean of the V
  rows instead (the encoder's, and the memory's in f32, rounded once);
* beam search expands the cross K/V and the valid lengths K times once and
  never reorders them; the self caches are reordered by gather each step.
  Step 0 keeps only beam 0's distribution; scores are normalized by
  ``length ** alpha``; beams come back best-first (a stable sort);
* sampling follows the GPT contract (``generation.py``): token ``i`` is
  drawn under the stateless Philox key (seed, 0x5851F42D) with counter
  ``i``. Greedy tokens equal the JAX package's; sampled ones are
  deterministic by seed but are not the JAX package's bits (threefry).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as _np
import torch
import torch.nn.functional as F

from ...base import MXNetError
from ...ops.cuda.attention import flash_attention
from ...ops.cuda.decode_attention import decode_attention, workspace
from .generation import METHOD_CODES, _ffn_residual, _ln, _qkv, _select

__all__ = ["translate", "beam_translate"]


def _layer_params(lyr) -> Dict[str, torch.Tensor]:
    return {
        "ln1_g": lyr.ln1.gamma.data(), "ln1_b": lyr.ln1.beta.data(),
        "qkv_w": lyr.attn_qkv.weight.data(),
        "qkv_b": lyr.attn_qkv.bias.data(),
        "out_w": lyr.attn_out.weight.data(),
        "out_b": lyr.attn_out.bias.data(),
        "ln2_g": lyr.ln2.gamma.data(), "ln2_b": lyr.ln2.beta.data(),
        "f1_w": lyr.ffn1.weight.data(), "f1_b": lyr.ffn1.bias.data(),
        "f2_w": lyr.ffn2.weight.data(), "f2_b": lyr.ffn2.bias.data(),
    }


def _collect(model) -> Dict[str, Any]:
    """The model's tensors, read in place."""
    dec = []
    for lyr in model.dec_layers:
        p = _layer_params(lyr)
        p.update({
            "lnc_g": lyr.ln_cross.gamma.data(),
            "lnc_b": lyr.ln_cross.beta.data(),
            "cq_w": lyr.cross_q.weight.data(),
            "cq_b": lyr.cross_q.bias.data(),
            "ckv_w": lyr.cross_kv.weight.data(),
            "ckv_b": lyr.cross_kv.bias.data(),
            "co_w": lyr.cross_out.weight.data(),
            "co_b": lyr.cross_out.bias.data(),
        })
        dec.append(p)
    return {
        "src_embed": model.src_embed.weight.data(),
        "tgt_embed": model.tgt_embed.weight.data(),
        "src_pos": model.src_pos.data(), "tgt_pos": model.tgt_pos.data(),
        "encln_g": model.enc_ln.gamma.data(),
        "encln_b": model.enc_ln.beta.data(),
        "decln_g": model.dec_ln.gamma.data(),
        "decln_b": model.dec_ln.beta.data(),
        "enc": [_layer_params(lyr) for lyr in model.enc_layers],
        "dec": dec,
    }


class _Cross:
    """One decoder layer's cross-attention operands: the memory's K and V
    (B, Ts, H, D) contiguous, and, where some source has valid length 0,
    the mean of its V rows (B, H, D)."""

    __slots__ = ("k", "v", "vmean")

    def __init__(self, k, v, vmean) -> None:
        self.k, self.v, self.vmean = k, v, vmean

    def repeat(self, K: int) -> "_Cross":
        return _Cross(self.k.repeat_interleave(K, 0),
                      self.v.repeat_interleave(K, 0),
                      None if self.vmean is None
                      else self.vmean.repeat_interleave(K, 0))


def _encode(params, src, vl, nh: int, ga, any_zero: bool = False):
    """Encoder pass over (B, Ts) ``src`` with (B,) valid lengths ``vl`` (or
    None) on the device: returns one :class:`_Cross` a decoder layer, with
    the V rows' means where ``any_zero`` (some valid length is 0)."""
    B, Ts = src.shape
    x = params["src_embed"][src] + params["src_pos"][:Ts][None]
    C = x.shape[-1]
    d = C // nh
    bias = None
    if vl is not None:
        keep = torch.arange(Ts, device=src.device)[None, :] < vl[:, None]
        bias = torch.where(
            keep, torch.zeros((), dtype=x.dtype, device=x.device),
            torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                       device=x.device))[:, None, None, :]
    for p in params["enc"]:
        q, k, v = torch.split(_qkv(p, x, ga), C, dim=-1)
        vh = v.reshape(B, Ts, nh, d)
        out = flash_attention(q.reshape(B, Ts, nh, d),
                              k.reshape(B, Ts, nh, d), vh, bias=bias,
                              bias_grad=False)
        if any_zero:
            out = torch.where((vl == 0)[:, None, None, None],
                              vh.mean(1, keepdim=True), out)
        x = x + F.linear(out.reshape(B, Ts, C), p["out_w"], p["out_b"])
        x = _ffn_residual(p, x, ga)
    memory = _ln(x, params["encln_g"], params["encln_b"], ga[1])
    cross = []
    for p in params["dec"]:
        k, v = torch.split(F.linear(memory, p["ckv_w"], p["ckv_b"]), C,
                           dim=-1)
        k = k.reshape(B, Ts, nh, d).contiguous()
        v = v.reshape(B, Ts, nh, d).contiguous()
        vmean = v.float().mean(dim=1).to(v.dtype) if any_zero else None
        cross.append(_Cross(k, v, vmean))
    return cross


def _dec_step(params, tok, caches, cross, cpos, zero, i: int, nh: int, ga,
              work):
    """One decode token for every row: ``tok`` (S,), self caches
    (S, L, H, D) per layer written at row ``i``, cross operands per layer
    with their positions ``cpos`` (S,) and zero-length rows ``zero`` (S,)
    bool or None. Returns logits (S, V)."""
    S = tok.shape[0]
    x = params["tgt_embed"][tok] + params["tgt_pos"][i]
    C = x.shape[-1]
    d = C // nh
    pos = torch.full((S,), i, dtype=torch.int64, device=x.device)
    for p, (ck, cv), cr in zip(params["dec"], caches, cross):
        q, k, v = torch.split(_qkv(p, x, ga), C, dim=-1)
        ck[:, i] = k.reshape(S, nh, d)
        cv[:, i] = v.reshape(S, nh, d)
        out = decode_attention(q.reshape(S, nh, d), ck, cv, pos, work=work)
        x = x + F.linear(out.reshape(S, C), p["out_w"], p["out_b"])
        h = _ln(x, p["lnc_g"], p["lnc_b"], ga[1])
        cq = F.linear(h, p["cq_w"], p["cq_b"]).reshape(S, nh, d)
        cout = decode_attention(cq, cr.k, cr.v, cpos, work=work)
        if cr.vmean is not None:
            cout = torch.where(zero[:, None, None], cr.vmean, cout)
        x = x + F.linear(cout.reshape(S, C), p["co_w"], p["co_b"])
        x = _ffn_residual(p, x, ga)
    x = _ln(x, params["decln_g"], params["decln_b"], ga[1])
    return F.linear(x, params["tgt_embed"])


def _host_ints(a) -> _np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    elif hasattr(a, "asnumpy"):
        a = a.asnumpy()
    return _np.asarray(a).astype(_np.int64)


def _prepare(model, src, max_new_tokens: int, src_valid_length):
    """Shared translate/beam prolog: coerce and validate, collect the
    parameters, run the encoder. Returns (B, params, nh, ga, cross, cpos,
    zero, device)."""
    s = _host_ints(src)
    if s.ndim == 1:
        s = s[None, :]
    if max_new_tokens < 1:
        raise MXNetError("max_new_tokens must be >= 1")
    if max_new_tokens > model._max_length:
        raise MXNetError(
            f"max_new_tokens ({max_new_tokens}) exceeds max_length "
            f"{model._max_length}")
    if s.shape[1] > model._max_length:
        raise MXNetError(
            f"source length {s.shape[1]} exceeds max_length "
            f"{model._max_length}")
    first = next(iter(model.dec_layers))
    nh = int(first._num_heads)
    ga = (False, float(first.ln1._epsilon))
    params = _collect(model)
    dev = params["tgt_embed"].device
    B, Ts = s.shape
    vl, any_zero = None, False
    if src_valid_length is not None:
        vl_host = _host_ints(src_valid_length).reshape(B)
        any_zero = bool((vl_host == 0).any())
        vl = torch.from_numpy(vl_host).to(dev)
    cross = _encode(params, torch.from_numpy(s).to(dev), vl, nh, ga,
                    any_zero)
    if vl is None:
        cpos = torch.full((B,), Ts - 1, dtype=torch.int64, device=dev)
        zero = None
    else:
        cpos = (vl - 1).clamp(min=0)
        zero = vl == 0
    return B, params, nh, ga, cross, cpos, zero, dev


def _empty_caches(params, S: int, L: int, nh: int):
    C = params["tgt_embed"].shape[1]
    dt, dev = params["tgt_embed"].dtype, params["tgt_embed"].device
    return [(torch.zeros((S, L, nh, C // nh), dtype=dt, device=dev),
             torch.zeros((S, L, nh, C // nh), dtype=dt, device=dev))
            for _ in params["dec"]]


def _workspace(params, S: int, L: int, Ts: int, nh: int):
    """One decode-kernel workspace for every launch of a call (the self
    caches' L rows and the memory's Ts), or None on the CPU."""
    emb = params["tgt_embed"]
    if not emb.is_cuda:
        return None
    return workspace(S, nh, max(L, Ts), emb.shape[1] // nh, emb.device)


@torch.inference_mode()
def translate(model, src, max_new_tokens: int, bos_token: int,
              eos_token: Optional[int] = None, src_valid_length=None,
              method: str = "greedy", temperature: float = 1.0,
              top_k: int = 40, seed: int = 0, top_p: float = 0.9):
    """Decode target tokens for ``src`` starting from ``bos_token``.
    ``method``: greedy / sample / top_k / top_p (nucleus). After
    ``eos_token`` (if given) a row keeps emitting it. Returns an int32
    tensor (B, max_new_tokens) on the CPU."""
    if method not in METHOD_CODES:
        raise MXNetError(f"unknown generation method {method!r}")
    B, params, nh, ga, cross, cpos, zero, dev = _prepare(
        model, src, max_new_tokens, src_valid_length)
    if method == "top_k":
        if top_k < 1:
            raise MXNetError(f"top_k must be >= 1, got {top_k}")
        top_k = min(int(top_k), params["tgt_embed"].shape[0])
    if method == "top_p" and not 0.0 < top_p <= 1.0:
        raise MXNetError(f"top_p must be in (0, 1], got {top_p}")
    eos = -1 if eos_token is None else int(eos_token)
    L = max_new_tokens
    caches = _empty_caches(params, B, L, nh)
    work = _workspace(params, B, L, cross[0].k.shape[1], nh)
    tok = torch.full((B,), int(bos_token), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    outs: List[torch.Tensor] = []
    for i in range(max_new_tokens):
        logits = _dec_step(params, tok, caches, cross, cpos, zero, i, nh, ga,
                           work)
        nxt = _select(logits, method, temperature, top_k, top_p, seed, i)
        if eos >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            done = done | (nxt == eos)
        outs.append(nxt)
        tok = nxt
    return torch.stack(outs, 1).to(torch.int32).cpu()


@torch.inference_mode()
def beam_translate(model, src, max_new_tokens: int, bos_token: int,
                   beam_size: int = 4, eos_token: Optional[int] = None,
                   src_valid_length=None, alpha: float = 1.0):
    """Length-normalized beam search; returns (sequences (B, beam,
    max_new_tokens) int32, scores (B, beam) f32) best-first, on the
    CPU."""
    B, params, nh, ga, cross, cpos, zero, dev = _prepare(
        model, src, max_new_tokens, src_valid_length)
    K = int(beam_size)
    if K < 1:
        raise MXNetError(f"beam_size must be >= 1, got {K}")
    eos = -1 if eos_token is None else int(eos_token)
    L = max_new_tokens
    NEG = -1e30
    # rows beam-major within a batch element: the cross operands depend only
    # on the element, so a beam permutation never changes them
    cross = [cr.repeat(K) for cr in cross]
    cpos = cpos.repeat_interleave(K)
    zero = None if zero is None else zero.repeat_interleave(K)
    caches = _empty_caches(params, B * K, L, nh)
    work = _workspace(params, B * K, L, cross[0].k.shape[1], nh)
    V = params["tgt_embed"].shape[0]

    # step 0: every beam feeds bos; only beam 0's distribution seeds the K
    # continuations
    tok = torch.full((B * K,), int(bos_token), dtype=torch.int64, device=dev)
    logits = _dec_step(params, tok, caches, cross, cpos, zero, 0, nh, ga,
                       work)
    logp = torch.log_softmax(logits.float().reshape(B, K, V)[:, 0], dim=-1)
    scores, first = torch.topk(logp, K, dim=-1)              # (B, K)
    tok = first.reshape(B * K)
    done = tok == eos
    seqs = torch.zeros((B, K, max_new_tokens), dtype=torch.int64, device=dev)
    seqs[:, :, 0] = first
    only_eos = torch.full((V,), NEG, device=dev)
    if eos >= 0:
        only_eos[eos] = 0.0
    for i in range(1, max_new_tokens):
        logits = _dec_step(params, tok, caches, cross, cpos, zero, i, nh, ga,
                           work)
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
        seqs[:, :, i] = tok.reshape(B, K)
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
