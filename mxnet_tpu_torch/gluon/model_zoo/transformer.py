"""Transformer encoder-decoder — the sequence-to-sequence model family.

Counterpart of ``mxnet_tpu/gluon/model_zoo/transformer.py`` with the same
architecture and parameter names: gluon-nlp's NMT Transformer ("Attention
is All You Need") with pre-LN blocks, an exact GELU FFN, learned
positions (``src_pos``, ``tgt_pos``), a target embedding tied to the
output head, and a source padding mask that flows through the encoder's
self-attention and the decoder's cross-attention.

Every attention goes through ``npx.multi_head_attention``: on CUDA tensors
the Hopper flash forward and backward (encoder self-attention with key
padding, causal decoder self-attention, cross-attention with Tq != Tk
under the source mask), on CPU tensors their plain versions. The source
mask is a (B, 1, 1, Ts) boolean that ``ops/transformer.py:_mask_to_bias``
turns into the ``finfo.min`` key-padding bias, as in the JAX package; a
source of valid length 0 attends uniformly over every key, as the JAX
package's (XLA) attention does (``_source_attention``).

``share_embed=True`` (the default when the vocabularies match) registers
one ``Embedding`` under both ``src_embed`` and ``tgt_embed``:
``collect_params()`` gives both names, bound to one tensor, so
``convert.load_jax_params`` and ``save_parameters`` carry the JAX
package's names, while the ``Trainer`` and a graphed backward take the
tensor once (``parameter.dedupe_shared``).

``translate`` / ``beam_translate`` decode with a KV cache
(``transformer_generation.py``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ... import npx
from ...base import MXNetError
from ..block import HybridBlock
from ..nn import Dense, Embedding, HybridSequential, LayerNorm
from ..parameter import Parameter, resolve_device

__all__ = ["TransformerEncoderLayer", "TransformerDecoderLayer",
           "TransformerModel", "get_transformer"]


def _source_attention(q, k, v, num_heads: int, mask, dropout: float):
    """``npx.multi_head_attention`` under the source mask. A source of
    valid length 0: the JAX package's ``finfo.min`` bias rounds every
    score of the row to one value, so the row attends uniformly (the mean
    of the V rows), while the flash kernels give a row with no visible key
    0; such rows take the mean here (its gradient reaches v alone)."""
    att = npx.multi_head_attention(q, k, v, num_heads, mask=mask,
                                   dropout=dropout)
    if mask is None:
        return att
    empty = ~mask.reshape(mask.shape[0], -1).any(-1)
    return torch.where(empty[:, None, None], v.mean(1, keepdim=True), att)


class TransformerEncoderLayer(HybridBlock):
    """Pre-LN encoder block: self-attention + GELU FFN."""

    def __init__(self, units: int = 512, hidden_size: int = 2048,
                 num_heads: int = 8, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._num_heads = num_heads
        self._units = units
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn_qkv = Dense(3 * units, in_units=units, flatten=False)
        self.attn_out = Dense(units, in_units=units, flatten=False)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn1 = Dense(hidden_size, in_units=units, flatten=False)
        self.ffn2 = Dense(units, in_units=hidden_size, flatten=False)
        self._dropout = dropout

    def forward(self, x, mask=None):
        h = self.ln1(x)
        q, k, v = torch.split(self.attn_qkv(h), self._units, dim=-1)
        att = _source_attention(q, k, v, self._num_heads, mask,
                                self._dropout)
        x = x + npx.dropout(self.attn_out(att), self._dropout)
        ffn = self.ffn2(npx.gelu(self.ffn1(self.ln2(x))))
        return x + npx.dropout(ffn, self._dropout)


class TransformerDecoderLayer(HybridBlock):
    """Pre-LN decoder block: causal self-attention, cross-attention over
    the encoder memory, GELU FFN."""

    def __init__(self, units: int = 512, hidden_size: int = 2048,
                 num_heads: int = 8, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._num_heads = num_heads
        self._units = units
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn_qkv = Dense(3 * units, in_units=units, flatten=False)
        self.attn_out = Dense(units, in_units=units, flatten=False)
        self.ln_cross = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.cross_q = Dense(units, in_units=units, flatten=False)
        self.cross_kv = Dense(2 * units, in_units=units, flatten=False)
        self.cross_out = Dense(units, in_units=units, flatten=False)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn1 = Dense(hidden_size, in_units=units, flatten=False)
        self.ffn2 = Dense(units, in_units=hidden_size, flatten=False)
        self._dropout = dropout

    def forward(self, x, memory, memory_mask=None):
        h = self.ln1(x)
        q, k, v = torch.split(self.attn_qkv(h), self._units, dim=-1)
        att = npx.multi_head_attention(q, k, v, self._num_heads,
                                       causal=True, dropout=self._dropout)
        x = x + npx.dropout(self.attn_out(att), self._dropout)
        cq = self.cross_q(self.ln_cross(x))
        # the kernel reads k and v as strided views of the projection
        ck, cv = torch.split(self.cross_kv(memory), self._units, dim=-1)
        catt = _source_attention(cq, ck, cv, self._num_heads, memory_mask,
                                 self._dropout)
        x = x + npx.dropout(self.cross_out(catt), self._dropout)
        ffn = self.ffn2(npx.gelu(self.ffn1(self.ln2(x))))
        return x + npx.dropout(ffn, self._dropout)


class TransformerModel(HybridBlock):
    """Encoder-decoder Transformer: (src (B, Ts), tgt (B, Tt)) ->
    logits (B, Tt, tgt_vocab)."""

    def __init__(self, src_vocab_size: int = 32000,
                 tgt_vocab_size: Optional[int] = None,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 units: int = 512, hidden_size: int = 2048,
                 num_heads: int = 8, max_length: int = 512,
                 dropout: float = 0.1, share_embed: Optional[bool] = None,
                 layer_norm_eps: float = 1e-5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        tgt_vocab_size = tgt_vocab_size or src_vocab_size
        if share_embed is None:
            share_embed = tgt_vocab_size == src_vocab_size
        if share_embed and tgt_vocab_size != src_vocab_size:
            raise MXNetError("share_embed requires equal vocabularies")
        self._units = units
        self._max_length = max_length
        self._share = share_embed
        self.src_embed = Embedding(src_vocab_size, units)
        self.tgt_embed = self.src_embed if share_embed else \
            Embedding(tgt_vocab_size, units)
        self.src_pos = Parameter("src_pos", shape=(max_length, units),
                                 init="normal")
        self.tgt_pos = Parameter("tgt_pos", shape=(max_length, units),
                                 init="normal")
        self.enc_layers = HybridSequential()
        for _ in range(num_encoder_layers):
            self.enc_layers.add(TransformerEncoderLayer(
                units, hidden_size, num_heads, dropout,
                layer_norm_eps=layer_norm_eps))
        self.enc_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.dec_layers = HybridSequential()
        for _ in range(num_decoder_layers):
            self.dec_layers.add(TransformerDecoderLayer(
                units, hidden_size, num_heads, dropout,
                layer_norm_eps=layer_norm_eps))
        self.dec_ln = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self._dropout = dropout

    # -- pieces -----------------------------------------------------------
    @staticmethod
    def _src_mask(src, src_valid_length):
        """(B, 1, 1, Ts) boolean: key j of row b is kept when j < its valid
        length."""
        if src_valid_length is None:
            return None
        T = src.shape[1]
        vl = src_valid_length.to(device=src.device, dtype=torch.int32)
        keep = torch.arange(T, device=src.device)[None, :] < vl[:, None]
        return keep[:, None, None, :]

    @staticmethod
    def _pos(weight: Parameter, T: int):
        return weight.data()[:T][None]

    def encode(self, src, src_valid_length=None):
        """Source tokens -> encoder memory (B, Ts, units)."""
        if src.shape[1] > self._max_length:
            raise MXNetError(
                f"source length {src.shape[1]} exceeds max_length "
                f"{self._max_length}")
        mask = self._src_mask(src, src_valid_length)
        x = self.src_embed(src) + self._pos(self.src_pos, src.shape[1])
        x = npx.dropout(x, self._dropout)
        for layer in self.enc_layers:
            x = layer(x, mask)
        return self.enc_ln(x)

    def decode(self, tgt, memory, src_valid_length=None, src=None):
        """Teacher-forcing decode: target tokens + memory -> logits."""
        if tgt.shape[1] > self._max_length:
            raise MXNetError(
                f"target length {tgt.shape[1]} exceeds max_length "
                f"{self._max_length}")
        mmask = None
        if src_valid_length is not None:
            # the cross-attention key axis is the SOURCE length
            mmask = self._src_mask(src if src is not None else memory,
                                   src_valid_length)
        x = self.tgt_embed(tgt) + self._pos(self.tgt_pos, tgt.shape[1])
        x = npx.dropout(x, self._dropout)
        for layer in self.dec_layers:
            x = layer(x, memory, mmask)
        # the tied head
        return F.linear(self.dec_ln(x), self.tgt_embed.weight.data())

    def forward(self, src, tgt, src_valid_length=None):
        memory = self.encode(src, src_valid_length)
        return self.decode(tgt, memory, src_valid_length, src=src)

    # -- inference --------------------------------------------------------
    def translate(self, src, max_new_tokens: int, bos_token: int,
                  eos_token: Optional[int] = None,
                  src_valid_length=None, method: str = "greedy",
                  temperature: float = 1.0, top_k: int = 40,
                  seed: int = 0, top_p: float = 0.9):
        """KV-cache incremental decoding from ``bos_token`` (greedy /
        sample / top_k / top_p nucleus). Returns (B, max_new_tokens)
        int32 target tokens on the CPU."""
        from .transformer_generation import translate as _tr
        return _tr(self, src, max_new_tokens, bos_token,
                   eos_token=eos_token, src_valid_length=src_valid_length,
                   method=method, temperature=temperature, top_k=top_k,
                   seed=seed, top_p=top_p)

    def beam_translate(self, src, max_new_tokens: int, bos_token: int,
                       beam_size: int = 4,
                       eos_token: Optional[int] = None,
                       src_valid_length=None, alpha: float = 1.0):
        """Length-normalized beam search over the KV-cache decoder."""
        from .transformer_generation import beam_translate as _bt
        return _bt(self, src, max_new_tokens, bos_token,
                   beam_size=beam_size, eos_token=eos_token,
                   src_valid_length=src_valid_length, alpha=alpha)


_SPECS = {
    # name: (enc_layers, dec_layers, units, hidden, heads)
    "transformer_base": (6, 6, 512, 2048, 8),
    "transformer_big": (6, 6, 1024, 4096, 16),
}


def get_transformer(model_name: str = "transformer_base",
                    src_vocab_size: int = 32000,
                    tgt_vocab_size: Optional[int] = None,
                    device: Any = None, ctx: Any = None,
                    **kwargs: Any) -> TransformerModel:
    """Build a zoo Transformer on ``device`` (``cuda:0`` by default; pass
    ``device="cpu"`` or MXNet's ``ctx=mx.cpu()`` for the CPU: the same
    argument under two names). Parameters are zeros until ``initialize``
    or :func:`~mxnet_tpu_torch.convert.load_jax_params`."""
    if model_name not in _SPECS:
        raise MXNetError(
            f"unknown transformer spec {model_name!r}; choose from "
            f"{sorted(_SPECS)}")
    e, d, u, h, nh = _SPECS[model_name]
    net = TransformerModel(src_vocab_size=src_vocab_size,
                           tgt_vocab_size=tgt_vocab_size,
                           num_encoder_layers=e, num_decoder_layers=d,
                           units=u, hidden_size=h, num_heads=nh, **kwargs)
    return net.to(resolve_device(ctx, device))
