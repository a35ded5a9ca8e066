"""GPT — decoder-only causal transformer language model.

Counterpart of ``mxnet_tpu/gluon/model_zoo/gpt.py`` with the same
architecture and parameter names: pre-LN blocks, causal attention through
``npx.multi_head_attention(causal=True)`` (the Hopper flash forward with
``causal=True`` on CUDA tensors, its plain version on the CPU), an exact
(or tanh) GELU FFN, learned positions in ``position_weight`` and an LM
head tied to ``word_embed``. Dropout (embeddings, attention probabilities,
attention output, FFN) is active in training, under ``autograd.record()``.

The routed mixture-of-experts FFN (``moe_experts > 0``) is ROADMAP Queue A
13 (``parallel/moe.py``): asking for it raises.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ... import npx
from ...base import MXNetError
from ...context import as_device
from ..block import HybridBlock, remat_stack
from ..nn import Dense, Embedding, HybridSequential, LayerNorm
from ..parameter import Parameter

__all__ = ["GPTBlock", "GPTModel", "get_gpt", "gpt2_124m"]


class GPTBlock(HybridBlock):
    """One pre-LN causal transformer block."""

    def __init__(self, units: int = 768, hidden_size: int = 3072,
                 num_heads: int = 12, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-5, moe_experts: int = 0,
                 moe_top_k: int = 2, moe_capacity_factor: float = 1.25,
                 moe_router_z_loss: float = 1e-3,
                 gelu_approximate: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if moe_experts > 0:
            raise MXNetError(
                "GPTBlock(moe_experts > 0): the routed mixture-of-experts "
                "FFN (parallel/moe.py) is not ported yet (ROADMAP Queue A "
                "13, the distributed kvstores)")
        self._num_heads = num_heads
        self._units = units
        # GPT-2 proper uses the tanh approximation ("gelu_new"); exact
        # erf GELU is the default, as in the JAX package
        self._gelu_approximate = gelu_approximate
        self.ln1 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.attn_qkv = Dense(3 * units, in_units=units, flatten=False)
        self.attn_out = Dense(units, in_units=units, flatten=False)
        self.ln2 = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self.moe = None
        self.ffn1 = Dense(hidden_size, in_units=units, flatten=False)
        self.ffn2 = Dense(units, in_units=hidden_size, flatten=False)
        self._dropout = dropout

    def forward(self, x):
        h = self.ln1(x)
        qkv = self.attn_qkv(h)
        q, k, v = torch.split(qkv, self._units, dim=-1)
        att = npx.multi_head_attention(q, k, v, self._num_heads,
                                       causal=True, dropout=self._dropout)
        att = npx.dropout(self.attn_out(att), self._dropout)
        x = x + att
        h = self.ln2(x)
        ffn = self.ffn2(npx.gelu(self.ffn1(h),
                                 approximate=self._gelu_approximate))
        return x + npx.dropout(ffn, self._dropout)


class GPTModel(HybridBlock):
    """Decoder-only LM: tokens (B, T) int -> logits (B, T, vocab), the LM
    head weight-tied to ``word_embed``."""

    def __init__(self, vocab_size: int = 50257, num_layers: int = 12,
                 units: int = 768, hidden_size: int = 3072,
                 num_heads: int = 12, max_length: int = 1024,
                 dropout: float = 0.1, moe_every_n: int = 0,
                 moe_experts: int = 8, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 moe_router_z_loss: float = 1e-3,
                 gelu_approximate: bool = False,
                 layer_norm_eps: float = 1e-5,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        self.word_embed = Embedding(vocab_size, units)
        self.position_weight = Parameter(
            "position_weight", shape=(max_length, units), init="normal")
        self.blocks = HybridSequential()
        for i in range(num_layers):
            is_moe = moe_every_n > 0 and (i + 1) % moe_every_n == 0
            self.blocks.add(GPTBlock(units, hidden_size, num_heads,
                                     dropout,
                                     layer_norm_eps=layer_norm_eps,
                                     moe_experts=moe_experts if is_moe
                                     else 0,
                                     moe_top_k=moe_top_k,
                                     moe_capacity_factor=moe_capacity_factor,
                                     moe_router_z_loss=moe_router_z_loss,
                                     gelu_approximate=gelu_approximate))
        self.ln_f = LayerNorm(epsilon=layer_norm_eps, in_channels=units)
        self._dropout = dropout

    def forward(self, tokens):
        T = tokens.shape[1]
        if T > self._max_length:
            raise MXNetError(f"sequence length {T} exceeds max_length "
                             f"{self._max_length}")
        x = self.word_embed(tokens)
        x = x + self.position_weight.data()[:T][None]
        x = npx.dropout(x, self._dropout)
        x = remat_stack(list(self.blocks), x, dropout=self._dropout)
        x = self.ln_f(x)
        # weight-tied LM head: logits = x @ E^T
        return torch.matmul(x, self.word_embed.weight.data().t())

    def generate(self, tokens, max_new_tokens: int,
                 method: str = "greedy", temperature: float = 1.0,
                 top_k: int = 40, eos_token: Optional[int] = None,
                 seed: int = 0, top_p: float = 0.9):
        """KV-cache incremental decoding (greedy / 'sample' / 'top_k' /
        'top_p' nucleus). See ``model_zoo.generation``."""
        from .generation import generate as _gen
        return _gen(self, tokens, max_new_tokens, method=method,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    eos_token=eos_token, seed=seed)

    def beam_search(self, tokens, max_new_tokens: int,
                    beam_size: int = 4,
                    eos_token: Optional[int] = None,
                    alpha: float = 1.0):
        """Length-normalized beam search over the KV-cache decoder
        (gluon-nlp ``BeamSearchSampler`` analog)."""
        from .generation import beam_search as _beam
        return _beam(self, tokens, max_new_tokens, beam_size=beam_size,
                     eos_token=eos_token, alpha=alpha)


_SPECS = {
    # name: (num_layers, units, hidden, heads, max_length)
    "gpt2_124m": (12, 768, 3072, 12, 1024),
    "gpt2_350m": (24, 1024, 4096, 16, 1024),
    "gpt2_774m": (36, 1280, 5120, 20, 1024),
}


def get_gpt(model_name: str = "gpt2_124m", vocab_size: int = 50257,
            dropout: float = 0.1, max_length: Optional[int] = None,
            device: Any = None, **kwargs: Any) -> GPTModel:
    """Build a zoo GPT on ``device`` (``cuda:0`` by default; pass
    ``device="cpu"`` for the CPU). Parameters are zeros until
    ``initialize`` or :func:`~mxnet_tpu_torch.convert.load_jax_params`."""
    if model_name not in _SPECS:
        raise ValueError(
            f"unknown GPT spec {model_name!r}; choose from "
            f"{sorted(_SPECS)}")
    dev = as_device(device)
    L, u, h, nh, ml = _SPECS[model_name]
    return GPTModel(vocab_size=vocab_size, num_layers=L, units=u,
                    hidden_size=h, num_heads=nh,
                    max_length=max_length or ml, dropout=dropout,
                    **kwargs).to(dev)


def gpt2_124m(**kw: Any) -> GPTModel:
    return get_gpt("gpt2_124m", **kw)
