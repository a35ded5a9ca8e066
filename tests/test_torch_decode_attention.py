"""The decode step's attention on CPU tensors against the JAX package's.

The JAX package has no function of its own for the per-slot decode
attention: it is four lines of ``mxnet_tpu/serving/model.py``
``_slot_block_step`` (``:335-343``: the scores einsum over the cache, the
``arange(L) <= pos`` mask, the softmax, the value einsum). This test
reproduces exactly those lines in ``jax.numpy`` (the rest of the block,
the layer norms, projections and the FFN, is not attention) and holds
``decode_attention_reference`` and ``decode_attention`` (the plain version
on the CPU) to them on the same numpy inputs, f32, rtol 1e-5 / atol 1e-6
(summation order only), at head dims 64 and 288 (the card runs 288 on its
wide kernel). Also the placement contract the kernel keeps on the card:
a slot's output has the same bits whatever the bucket L its rows lie in,
its slot index and the other slots (here for the plain version, which
computes each slot over exactly its visible rows)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops.cuda import decode_attention as da

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_decode_attention(q, ck, cv, pos):
    """``_slot_block_step``'s attention (``mxnet_tpu/serving/model.py:
    335-343``) over a written cache: q (S, H, D), ck / cv (S, L, H, D),
    pos (S,); returns (S, H, D)."""
    S, H, d = q.shape
    L = ck.shape[1]
    qh = jnp.asarray(q).reshape(S, 1, H, d)
    ck, cv, pos = jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos)
    scores = jnp.einsum("sqhd,skhd->shqk", qh, ck) / math.sqrt(d)
    visible = jnp.arange(L)[None, :] <= pos[:, None]          # (S, L)
    scores = jnp.where(visible[:, None, None, :], scores,
                       jnp.float32(-jnp.inf).astype(scores.dtype))
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("shqk,skhd->sqhd", probs, cv).reshape(S, H, d)
    return np.asarray(out)


def _inputs(seed, S, L, H, D):
    rng = np.random.RandomState(seed)
    q = rng.normal(0, 1, (S, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (S, L, H, D)).astype(np.float32)
    v = rng.normal(0, 1, (S, L, H, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("D", [64, 288])
def test_decode_attention_matches_the_jax_step(D):
    S, L, H = 4, 96, 3
    q, k, v = _inputs(D, S, L, H, D)
    pos = np.array([0, 17, 63, L - 1], np.int64)
    want = _jax_decode_attention(q, k, v, pos)
    qt, kt, vt, pt = (torch.from_numpy(x) for x in (q, k, v, pos))
    ref = da.decode_attention_reference(qt, kt, vt, pt)
    np.testing.assert_allclose(ref.numpy(), want, **TOL)
    got = da.decode_attention(qt, kt, vt, pt)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    out = torch.empty(S, H, D)
    assert da.decode_attention(qt, kt, vt, pt, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("D", [64, 288])
def test_a_slot_has_the_same_bits_in_any_bucket(D):
    """Rows past a slot's position are never read: the same rows in a
    larger bucket (filled past them with other values), at another slot
    index among other slots, give the same bits."""
    S, L, H = 3, 40, 2
    q, k, v = _inputs(3 + D, S, L, H, D)
    pos = np.array([5, 39, 22], np.int64)
    small = da.decode_attention_reference(*(torch.from_numpy(x)
                                            for x in (q, k, v, pos)))
    rng = np.random.RandomState(9)
    big_k, big_v = (rng.normal(0, 1, (S + 1, 4 * L, H, D)).astype(np.float32)
                    for _ in range(2))
    big_k[1:, :L], big_v[1:, :L] = k, v
    bq = np.concatenate([np.ones((1, H, D), np.float32), q])
    bpos = np.concatenate([[100], pos])
    big = da.decode_attention_reference(*(torch.from_numpy(x) for x in
                                          (bq, big_k, big_v, bpos)))
    assert torch.equal(big[1:], small)
    want = _jax_decode_attention(bq, big_k, big_v, bpos)
    np.testing.assert_allclose(big.numpy(), want, **TOL)
