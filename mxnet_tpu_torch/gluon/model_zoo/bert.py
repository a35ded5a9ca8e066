"""BERT — transformer encoder + pretraining heads.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py`` with the same
architecture and parameter names: embeddings (word + position + token
type, layer norm, dropout), N post-LN transformer layers with an exact-GELU
FFN, a tanh pooler, the MLM head whose decoder is tied to the word
embedding, and the NSP classifier. Attention goes through
``npx.multi_head_attention`` with the key-padding mask from
``valid_length`` — the Hopper flash kernels on CUDA tensors. Dropout
(embeddings, attention probabilities, attention output, FFN) is active in
training, that is under ``autograd.record()``, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from ... import npx
from ...base import MXNetError
from ...context import as_device
from ..block import HybridBlock, remat_stack
from ..nn import Dense, Embedding, HybridSequential, LayerNorm
from ..parameter import Parameter

__all__ = ["BERTEncoderLayer", "BERTEncoder", "BERTModel", "get_bert",
           "bert_base", "bert_large"]


class BERTEncoderLayer(HybridBlock):
    """One transformer layer (post-LN like BERT)."""

    def __init__(self, units: int = 768, hidden_size: int = 3072,
                 num_heads: int = 12, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._num_heads = num_heads
        self._units = units
        self.attn_qkv = Dense(3 * units, in_units=units, flatten=False)
        self.attn_out = Dense(units, in_units=units, flatten=False)
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.ffn1 = Dense(hidden_size, in_units=units, flatten=False)
        self.ffn2 = Dense(units, in_units=hidden_size, flatten=False)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self._dropout = dropout

    def forward(self, x, mask=None):
        qkv = self.attn_qkv(x)  # (B, T, 3C)
        q, k, v = torch.split(qkv, self._units, dim=-1)
        att = npx.multi_head_attention(q, k, v, self._num_heads, mask=mask,
                                       dropout=self._dropout)
        att = npx.dropout(self.attn_out(att), self._dropout)
        x = self.ln1(x + att)
        ffn = self.ffn2(npx.gelu(self.ffn1(x)))
        ffn = npx.dropout(ffn, self._dropout)
        return self.ln2(x + ffn)


class BERTEncoder(HybridBlock):
    def __init__(self, num_layers: int = 12, units: int = 768,
                 hidden_size: int = 3072, num_heads: int = 12,
                 max_length: int = 512, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._max_length = max_length
        self._units = units
        self.position_weight = Parameter("position_weight",
                                         shape=(max_length, units),
                                         init="normal")
        self.ln = LayerNorm(in_channels=units, epsilon=layer_norm_eps)
        self._dropout = dropout
        self.layers = HybridSequential()
        for _ in range(num_layers):
            self.layers.add(BERTEncoderLayer(units, hidden_size, num_heads,
                                             dropout,
                                             layer_norm_eps=layer_norm_eps))

    def forward(self, x, mask=None):
        T = x.shape[1]
        x = self.ln(x + self.position_weight.data()[:T][None])
        x = npx.dropout(x, self._dropout)
        return remat_stack(list(self.layers), x, mask, dropout=self._dropout)


class BERTModel(HybridBlock):
    """Full BERT with MLM + NSP heads.

    ``forward(inputs, token_types, valid_length, masked_positions)``:
      - no ``masked_positions``: returns (sequence_output, pooled_output)
      - with ``masked_positions``: additionally returns MLM logits.
    """

    def __init__(self, vocab_size: int = 30522, num_layers: int = 12,
                 units: int = 768, hidden_size: int = 3072,
                 num_heads: int = 12, max_length: int = 512,
                 token_type_vocab_size: int = 2, dropout: float = 0.1,
                 use_pooler: bool = True, use_decoder: bool = True,
                 use_classifier: bool = True,
                 layer_norm_eps: float = 1e-12, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._units = units
        self.word_embed = Embedding(vocab_size, units)
        self.token_type_embed = Embedding(token_type_vocab_size, units)
        self.encoder = BERTEncoder(num_layers, units, hidden_size, num_heads,
                                   max_length, dropout,
                                   layer_norm_eps=layer_norm_eps)
        self.pooler = Dense(units, in_units=units, flatten=False,
                            activation="tanh") if use_pooler else None
        if use_decoder:
            self.mlm_transform = Dense(units, in_units=units, flatten=False)
            self.mlm_ln = LayerNorm(in_channels=units,
                                    epsilon=layer_norm_eps)
            self.mlm_bias = Parameter("mlm_bias", shape=(vocab_size,),
                                      init="zeros")
        else:
            self.mlm_transform = None
        self.classifier = Dense(2, in_units=units) if use_classifier else None

    def _attention_mask(self, inputs, valid_length):
        """(B, 1, 1, Tk) boolean key-padding mask (True = attend)."""
        if valid_length is None:
            return None
        T = inputs.shape[1]
        ar = torch.arange(T, device=inputs.device)
        keep = ar[None, :] < valid_length.to(inputs.device).long()[:, None]
        return keep[:, None, None, :]

    def forward(self, inputs, token_types=None, valid_length=None,
                masked_positions=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        mask = self._attention_mask(inputs, valid_length)
        seq = self.encoder(x, mask)

        outputs: List[Any] = [seq]
        if self.pooler is not None:
            outputs.append(self.pooler(seq[:, 0]))
        if self.mlm_transform is not None and masked_positions is not None:
            gathered = npx.take_positions(seq, masked_positions)
            h = self.mlm_ln(npx.gelu(self.mlm_transform(gathered)))
            logits = torch.matmul(h.reshape(-1, self._units),
                                  self.word_embed.weight.data().t())
            logits = logits + self.mlm_bias.data()
            outputs.append(logits.reshape(gathered.shape[0],
                                          gathered.shape[1], -1))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


_BERT_SPEC = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert(model_name: str = "bert_12_768_12", vocab_size: int = 30522,
             device: Any = None, **kwargs: Any) -> BERTModel:
    """Build a zoo BERT on ``device`` (``cuda:0`` by default; pass
    ``device="cpu"`` for the CPU). Parameters are zeros until
    ``initialize`` or :func:`~mxnet_tpu_torch.convert.load_jax_params`."""
    dev = as_device(device)
    if model_name not in _BERT_SPEC:
        raise MXNetError(f"unknown bert spec {model_name!r}; "
                         f"options: {sorted(_BERT_SPEC)}")
    cfg = dict(_BERT_SPEC[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, **cfg).to(dev)


def bert_base(**kw) -> BERTModel:
    return get_bert("bert_12_768_12", **kw)


def bert_large(**kw) -> BERTModel:
    return get_bert("bert_24_1024_16", **kw)
