"""The port's flash attention (mxnet_tpu_torch/ops/cuda/attention.py) on
CPU tensors against the JAX package's Pallas flash kernels run in interpret
mode on the CPU, as tests/test_flash_attention.py runs them: the forward,
and the backward at the head dims above 128 (160, 256, 288).

f32 throughout; tolerance rtol=2e-4, atol=2e-5 (the JAX package's own
flash test): the two differ only in summation order.
"""
import math

import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas.attention import (
    _flash_backward as jax_flash_bwd, _flash_forward as jax_flash_fwd,
    flash_attention as jax_flash)
from mxnet_tpu_torch.ops.cuda import attention as port

TOL = dict(rtol=2e-4, atol=2e-5)
B, H, D = 2, 2, 16


def _inputs(seed, Tq, Tk, bias_kind, d=D):
    rng = onp.random.RandomState(seed)
    q = rng.normal(0, 1, (B, H, Tq, d)).astype("float32")
    k = rng.normal(0, 1, (B, H, Tk, d)).astype("float32")
    v = rng.normal(0, 1, (B, H, Tk, d)).astype("float32")
    bias = None
    if bias_kind == "keypad":
        valid = onp.array([Tk, max(1, Tk // 3)])
        keep = onp.arange(Tk)[None, :] < valid[:, None]
        bias = onp.where(keep, 0.0, onp.finfo(onp.float32).min)
        bias = bias.astype("float32")[:, None, None, :]      # (B,1,1,Tk)
    elif bias_kind == "full":
        bias = rng.normal(0, 1, (1, H, Tq, Tk)).astype("float32")
    return q, k, v, bias


def _jax_forward(q, k, v, bias, causal, block):
    out, lse = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), None,
        1.0 / math.sqrt(q.shape[-1]), causal, block, block, 0.0, True)
    return onp.asarray(out), onp.asarray(lse)


@pytest.mark.parametrize("T,block", [(16, 16), (128, 64), (250, 128)])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_jax_kernel(causal, bias_kind, T, block):
    """out and lse of the plain version vs the Pallas kernel, single- and
    multi-block, ragged at T=250."""
    q, k, v, bias = _inputs(T, T, T, bias_kind)
    want_out, want_lse = _jax_forward(q, k, v, bias, causal, block)
    out, lse = port._flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias),
        1.0 / math.sqrt(D), causal)
    assert out.shape == (B, H, T, D) and lse.shape == (B, H, T, 1)
    onp.testing.assert_allclose(out.numpy(), want_out, **TOL)
    onp.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_at_large_head_dims_matches_jax_kernel(causal,
                                                            bias_kind, d):
    """The head dims the Hopper forward takes above 64 (padded to 128 and
    256 there): the plain version vs the Pallas kernel, T=40 over blocks
    of 16 (ragged)."""
    q, k, v, bias = _inputs(d, 40, 40, bias_kind, d)
    want_out, want_lse = _jax_forward(q, k, v, bias, causal, 16)
    out, lse = port._flash_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias),
        1.0 / math.sqrt(d), causal)
    assert out.shape == (B, H, 40, d)
    onp.testing.assert_allclose(out.numpy(), want_out, **TOL)
    onp.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


@pytest.mark.parametrize("block_k,route", [(64, "fused"), (16, "two_pass")])
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_at_large_head_dims_matches_jax_kernel(
        causal, bias_kind, d, block_k, route):
    """The head dims the Hopper backward takes above 128 (padded to 256
    there, always on the dq/dkv pair): dq, dk, dv (and dbias of the
    learned bias) of the plain backward vs the Pallas backward in
    interpret mode on the same forward residuals, T=40, on both JAX
    routes: the fused pass (Tk <= block_k) and the pair (block_k=16)."""
    T = 40
    q, k, v, bias = _inputs(d + 1, T, T, bias_kind, d)
    do = onp.random.RandomState(d + 2).normal(0, 1, q.shape) \
        .astype("float32")
    scale = 1.0 / math.sqrt(d)
    bias_grad = bias_kind == "full"
    jb = None if bias is None else jnp.asarray(bias)
    out, lse = jax_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jb, None, scale, causal, 16, block_k, 0.0, True)
    want = jax_flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb,
                         None, out, lse, jnp.asarray(do), scale, causal, 16,
                         block_k, 0.0, True, bias_grad=bias_grad)
    got = port._flash_backward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), None,
        torch.from_numpy(onp.array(out)), torch.from_numpy(onp.array(lse)),
        torch.from_numpy(do), scale, causal, block_k, 0.0,
        bias_grad=bias_grad)
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert g.shape == (B, H, T, d)
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), **TOL,
                                    err_msg=name)
    if bias_grad:
        onp.testing.assert_allclose(got[3].numpy(), onp.asarray(want[3]),
                                    **TOL, err_msg="dbias")
    else:
        assert got[3] is None and want[3] is None


@pytest.mark.parametrize("d", [256, 288])
def test_gradient_at_large_head_dims_runs_end_to_end(d):
    """A gradient through flash_attention at D=256 (the card's largest)
    and D=288 (above it: the plain version takes any head dim, as the JAX
    package's backward does) runs on the CPU and equals jax.grad through
    the JAX entry point; causal, key padding, Tq=24."""
    q, k, v, bias = _inputs(d, 24, 24, "keypad", d)
    qt, kt, vt = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    w = onp.random.RandomState(d).normal(0, 1, qt.shape).astype("float32")

    def jloss(q_, k_, v_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=True,
                                 bias=jnp.asarray(bias)) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt))
    ts = [torch.tensor(x, requires_grad=True) for x in (qt, kt, vt)]
    out = port.flash_attention(*ts, causal=True, bias=torch.from_numpy(bias))
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        assert t.grad.shape == (B, 24, H, d)
        onp.testing.assert_allclose(t.grad.numpy(), onp.asarray(g), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad"])
def test_public_entry_tq_ne_tk_matches_jax(causal, bias_kind):
    """flash_attention over (B, T, H, D) with Tq != Tk."""
    Tq, Tk = 40, 72
    q, k, v, bias = _inputs(7, Tq, Tk, bias_kind)
    qt, kt, vt = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    want = onp.asarray(jax_flash(
        jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), causal=causal,
        bias=None if bias is None else jnp.asarray(bias)))
    got = port.flash_attention(
        torch.from_numpy(qt), torch.from_numpy(kt), torch.from_numpy(vt),
        causal=causal, bias=None if bias is None else torch.from_numpy(bias))
    assert got.shape == (B, Tq, H, D)
    onp.testing.assert_allclose(got.numpy(), want, **TOL)


def test_reference_returns_lse_of_its_softmax():
    """lse is the log of the softmax denominator: exp(s - lse) sums to 1."""
    q, k, v, _ = _inputs(3, 24, 24, None)
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    _, lse = port.flash_attention_reference(q, k, torch.from_numpy(v))
    s = q @ k.transpose(-1, -2) / math.sqrt(D)
    torch.testing.assert_close(torch.exp(s - lse).sum(-1),
                               torch.ones(B, H, 24), rtol=1e-5, atol=1e-5)


def test_dropout_raises():
    """Dropout needs its (2,) int32 seed, and a rate in [0, 1)."""
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="dropout_seed"):
        port.flash_attention(x, x, x, dropout=0.1)
    with pytest.raises(ValueError, match="dropout"):
        port.flash_attention(x, x, x, dropout=1.0, dropout_seed=[1, 2])


def test_bad_bias_shape_raises():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="bias"):
        port.flash_attention(x, x, x, bias=torch.zeros(1, 1, 3, 8))


def test_cpu_tensors_never_count_a_launch():
    before = dict(port.launches)
    x = torch.zeros(1, 8, 2, 16, requires_grad=True)
    port.flash_attention(x, x, x, dropout=0.1, dropout_seed=[3, 4]).sum() \
        .backward()
    assert port.launches == before
