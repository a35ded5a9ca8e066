"""The 3xTF32 arithmetic of the card's f32 backward kernels, emulated in
plain torch on the CPU, against the JAX package's Pallas backward.

The f32 backward kernels (``csrc/flash_attention_bwd.cu``: the fused pass
``tf::bwd_fused_tf32`` and the pair's dk / dv ``tf::bwd_dkv_tf32`` and
``tf::bwd_dkv_tf32_st``; ``csrc/flash_attention_wide_wg.cu``: the pair's dq
``wwg::wide_dq_tf32`` at every head dim) take every product on the tensor
cores as three TF32 products of split halves: x = hi + lo, hi = x rounded to TF32 (10 mantissa
bits) to nearest, ties away from zero, lo = x - hi, of which the tensor
cores read the top 19 bits (lo truncated to TF32); a product is hi hi' +
hi lo' + lo hi', summed in f32 (``hopper.cuh``: ``tf32_split``). This file
holds that arithmetic, for the tests alone (no path of the port runs it),
applied as the kernels apply it to the backward's formulas: s and dp from
split q, K, dout and V; p and ds in f32; dv, dk and dq from split p, ds,
dout, q and K. Against ``_flash_backward`` in interpret mode, on the same
numpy inputs and the JAX forward's out and lse, at (2, 2, 96, 64) (the
JAX fused kernel, as the card's fused pass), (1, 2, 64, 192) (the JAX
pair at a head dim where the card's pair streams the head dim through its
dk / dv) and (1, 2, 64, 320) (the JAX pair, as the card's wide pair) in
f32 with key padding: dq, dk and dv within
1e-4 relative Frobenius error, the card's f32 tolerance (``REL_BWD``), so
the split costs no more than the order of f32 sums does. The split itself:
exact (hi + lo = x), hi on TF32's grid, rounded to nearest.
"""
import math

import numpy as onp
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas.attention import (
    _flash_backward as jax_flash_bwd, _flash_forward as jax_flash_fwd)

REL = 1e-4
LOW13 = 0x1FFF          # the f32 mantissa bits TF32 drops


def _bits(x):
    """An f32 tensor's bits as int64 values of 0 .. 2**32 - 1."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(b):
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def tf32_split(x):
    """``(hi, lo)`` as the kernels split ``x`` and the tensor cores read
    the halves: hi = x rounded to TF32 to nearest, ties away from zero (add
    half a TF32 unit to the magnitude's bits, clear the 13 low bits); lo =
    x - hi (exact in f32), read truncated to TF32."""
    hi = _from_bits((_bits(x) + 0x1000) & (0xFFFFFFFF ^ LOW13))
    lo = x - hi
    return hi, _from_bits(_bits(lo) & (0xFFFFFFFF ^ LOW13))


def mm3(a, b):
    """a @ b as three TF32 products of the halves, summed in f32."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return ah @ bh + ah @ bl + al @ bh


def backward_3xtf32(q, k, v, bias, out, lse, do, scale, causal):
    """dq, dk, dv of attention over (B, H, T, D) f32 tensors with every
    product in 3xTF32, the rest in f32, as the card's kernels compute
    them (p from the forward's lse, delta = rowsum(dout * out))."""
    s = mm3(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse)
    if causal:
        Tq, Tk = s.shape[-2:]
        keep = torch.ones(Tq, Tk, dtype=torch.bool).tril()
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = mm3(do, v.transpose(-1, -2))
    delta = (do * out).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    return (mm3(ds, k), mm3(ds.transpose(-1, -2), q),
            mm3(p.transpose(-1, -2), do))


def _rel(got, want):
    want = torch.from_numpy(onp.array(want))
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("B,H,T,D,block_k", [(2, 2, 96, 64, 128),
                                             (1, 2, 64, 192, 32),
                                             (1, 2, 64, 320, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_matches_jax_kernel(B, H, T, D, block_k, causal):
    """The 3xTF32 emulation of the backward against the Pallas backward in
    interpret mode (fused at D = 64, the dq/dkv pair at D = 192 and 320),
    key padding ragged over the batch: dq, dk, dv within 1e-4 relative."""
    rng = onp.random.RandomState(T + D)
    q, k, v, do = (rng.normal(0, 1, (B, H, T, D)).astype("float32")
                   for _ in range(4))
    valid = onp.array([T, T // 3][:B])
    keep = onp.arange(T)[None, :] < valid[:, None]
    bias = onp.where(keep, 0.0, onp.finfo(onp.float32).min)
    bias = bias.astype("float32")[:, None, None, :]
    scale = 1.0 / math.sqrt(D)
    j = [jnp.asarray(x) for x in (q, k, v, bias, do)]
    out, lse = jax_flash_fwd(j[0], j[1], j[2], j[3], None, scale, causal, 16,
                             block_k, 0.0, True)
    want = jax_flash_bwd(j[0], j[1], j[2], j[3], None, out, lse, j[4],
                         scale, causal, 16, block_k, 0.0, True,
                         bias_grad=False)
    t = [torch.from_numpy(x) for x in (q, k, v, bias, do)]
    got = backward_3xtf32(t[0], t[1], t[2], t[3],
                          torch.from_numpy(onp.array(out)),
                          torch.from_numpy(onp.array(lse)), t[4], scale,
                          causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[:3]):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert _rel(g, w) <= REL, f"{name}: {_rel(g, w):.3e}"


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """hi + lo = x exactly; hi has no bit below TF32's mantissa and is x
    rounded to nearest, ties away from zero (|x - hi| <= half a TF32 unit
    of x); |lo| <= 2**-11 |x|."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g) * torch.logspace(-3, 3, 4096)
    x = torch.cat([x, torch.tensor([1.0, -1.0, 1 + 2.0 ** -11,
                                    -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11])])
    hi = tf32_split(x)[0]
    lo = x - hi
    assert torch.equal(hi + lo, x)
    assert not (_bits(hi) & LOW13).any()
    assert (lo.abs() <= x.abs() * 2.0 ** -11).all()
    # the ties (1 + 2**-11: half a TF32 unit above 1) round away from zero
    assert hi[-3].item() == 1 + 2.0 ** -10
    assert hi[-2].item() == -(1 + 2.0 ** -10)
    assert hi[-1].item() == 1 + 2 * 2.0 ** -10


def test_mm3_is_f32_accurate_where_one_tf32_product_is_not():
    """A 3xTF32 product of 320-long rows is within 2e-6 relative of the
    f64 product, where one TF32 product (hi hi') misses by about 2**-11."""
    g = torch.Generator().manual_seed(5)
    a, b = (torch.randn(64, 320, generator=g) for _ in range(2))
    exact = a.double() @ b.double().T
    three = mm3(a, b.T).double()
    one = (tf32_split(a)[0] @ tf32_split(b)[0].T).double()

    def rel(x):
        return ((x - exact).norm() / exact.norm()).item()
    assert rel(three) <= 2e-6
    assert rel(one) >= 1e-4
