"""The port's flash-attention backward and its dropout mask on CPU tensors.

- The plain backward (mxnet_tpu_torch/ops/cuda/attention.py) against the
  JAX package's ``_flash_backward`` run in interpret mode on the CPU, on the
  fused single pass (Tk <= block_k) and the two-pass dq/dkv pair (small
  block_k), causal or not, bias none / key-padding / full learned. f32;
  tolerance rtol=2e-4, atol=2e-5, the JAX package's own flash test's: the
  two differ only in summation order.
- Dropout, whose TPU generator has no CPU form in JAX: the Philox4x32-10
  mask against a scalar pure-Python Philox and the Random123 known answer,
  its keep fraction against binomial bounds, its independence of tile
  shape, and the plain forward and backward against torch autograd through
  the dense formula under the same mask (f32, rtol=1e-5, atol=1e-6:
  summation order only).
- Routing: the card's choice of backward kernels by head dim, Tk and
  block_k (a spy on the launch, no card needed); the faults the port had:
  a float mask is learned and gets a gradient, a boolean mask is not and
  forms no ds; dropout and the kernel
  seed draw only from the framework generator; the kernel build hash covers
  the shared headers; no file of the port imports JAX.
- The fused kernel's dq accumulator (pure Python around the kernel): its
  layout, and the cast back into the (B, T, H, D) layout, against the
  plain backward's dq with each 128-key block's share added in as the
  kernel adds it (f32, rtol=1e-5, atol=1e-6: summation order only).
"""
import ast
import math
import pathlib
import shutil

import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas.attention import (
    _flash_backward as jax_flash_bwd, _flash_forward as jax_flash_fwd,
    flash_attention as jax_flash)
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch.ops import nn as port_nn
from mxnet_tpu_torch.ops import transformer as port_tf
from mxnet_tpu_torch.ops.cuda import attention as port

TOL = dict(rtol=2e-4, atol=2e-5)
DENSE_TOL = dict(rtol=1e-5, atol=1e-6)
B, H, D = 2, 2, 16
REPO = pathlib.Path(__file__).resolve().parent.parent


def _inputs(seed, Tq, Tk, bias_kind):
    rng = onp.random.RandomState(seed)
    q = rng.normal(0, 1, (B, H, Tq, D)).astype("float32")
    k = rng.normal(0, 1, (B, H, Tk, D)).astype("float32")
    v = rng.normal(0, 1, (B, H, Tk, D)).astype("float32")
    do = rng.normal(0, 1, (B, H, Tq, D)).astype("float32")
    bias = None
    if bias_kind == "keypad":
        valid = onp.array([Tk, max(1, Tk // 3)])
        keep = onp.arange(Tk)[None, :] < valid[:, None]
        bias = onp.where(keep, 0.0, onp.finfo(onp.float32).min)
        bias = bias.astype("float32")[:, None, None, :]      # (B,1,1,Tk)
    elif bias_kind == "full":
        bias = rng.normal(0, 1, (1, H, Tq, Tk)).astype("float32")
    return q, k, v, do, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("Tq,Tk,block_k,route", [
    (48, 48, 64, "fused"), (40, 72, 128, "fused"),
    (48, 48, 16, "two_pass"), (40, 72, 32, "two_pass")])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_jax_kernel(causal, bias_kind, Tq, Tk,
                                           block_k, route):
    """dq, dk, dv (and dbias of the learned bias) of the plain backward vs
    the Pallas backward in interpret mode on the same forward residuals."""
    q, k, v, do, bias = _inputs(Tq * 7 + Tk, Tq, Tk, bias_kind)
    scale = 1.0 / math.sqrt(D)
    bias_grad = bias_kind == "full"
    out, lse = jax_flash_fwd(_j(q), _j(k), _j(v), _j(bias), None, scale,
                             causal, 16, block_k, 0.0, True)
    want = jax_flash_bwd(_j(q), _j(k), _j(v), _j(bias), None, out, lse,
                         _j(do), scale, causal, 16, block_k, 0.0, True,
                         bias_grad=bias_grad)
    got = port._flash_backward(
        _t(q), _t(k), _t(v), _t(bias), None, _t(onp.array(out)),
        _t(onp.array(lse)), _t(do), scale, causal, block_k, 0.0,
        bias_grad=bias_grad)
    for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), **TOL,
                                    err_msg=name)
    if bias_grad:
        assert tuple(got[3].shape) == bias.shape
        onp.testing.assert_allclose(got[3].numpy(), onp.asarray(want[3]),
                                    **TOL, err_msg="dbias")
    else:
        assert got[3] is None and want[3] is None


@pytest.mark.parametrize("bias_kind", [None, "full"])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_entry_matches_jax_grad(causal, bias_kind):
    """Gradients of the public flash_attention (B, T, H, D) through the
    port's autograd Function vs jax.grad through the JAX entry point."""
    q, k, v, do, bias = _inputs(11, 40, 40, bias_kind)
    qt, kt, vt, dot = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v, do))

    def jloss(q_, k_, v_, b_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=causal, bias=b_) * dot)

    argn = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    want = jax.grad(jloss, argnums=argn)(_j(qt), _j(kt), _j(vt), _j(bias))
    ts = [torch.tensor(x, requires_grad=True) for x in (qt, kt, vt)]
    tb = None if bias is None else torch.tensor(bias, requires_grad=True)
    out = port.flash_attention(*ts, causal=causal, bias=tb)
    (out * _t(dot)).sum().backward()
    got = [t.grad for t in ts] + ([tb.grad] if tb is not None else [])
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), **TOL)


# ------------------------------------------------------------------ dropout
def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints, as Random123 defines it."""
    M0, M1, W0, W1, U = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, \
        0xFFFFFFFF
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + W0) & U, (k[1] + W1) & U]
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & U, (p0 >> 32) ^ c[3] ^ k[1],
             p0 & U]
    return c


def test_philox_known_answer():
    """Random123's known answer for Philox4x32-10, counter 0 and key 0."""
    assert _philox_scalar((0, 0, 0, 0), (0, 0)) == \
        [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    words = port.philox4x32_10(*(torch.zeros((), dtype=torch.int64),) * 4,
                               torch.tensor(0), torch.tensor(0))
    assert [int(w) for w in words] == \
        [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_dropout_keep_reference_matches_scalar_philox():
    """Every keep bit of a ragged (odd Tq, Tk) mask against the scalar
    Philox: counter (col >> 1, row >> 1, head, batch), word
    ((row & 1) << 1) | (col & 1), key = the seed's two words as uint32."""
    seed = torch.tensor([-7, 123456789], dtype=torch.int32)
    rate, Bm, Hm, Tq, Tk = 0.3, 2, 3, 5, 7
    mask = port.dropout_keep_reference(seed, Bm, Hm, Tq, Tk, rate)
    assert mask.shape == (Bm, Hm, Tq, Tk) and mask.dtype == torch.bool
    key = ((-7) & 0xFFFFFFFF, 123456789)
    thresh = int(rate * 2 ** 32)
    for b in range(Bm):
        for h in range(Hm):
            for r in range(Tq):
                for c in range(Tk):
                    w = _philox_scalar((c >> 1, r >> 1, h, b), key)
                    want = w[((r & 1) << 1) | (c & 1)] >= thresh
                    assert bool(mask[b, h, r, c]) == want, (b, h, r, c)


def test_keep_fraction_within_binomial_bounds():
    seed = torch.tensor([2024, 7], dtype=torch.int32)
    for rate in (0.1, 0.5):
        mask = port.dropout_keep_reference(seed, 2, 3, 128, 128, rate)
        n, kept = mask.numel(), int(mask.sum())
        mean, sd = n * (1 - rate), math.sqrt(n * rate * (1 - rate))
        assert abs(kept - mean) < 6 * sd, (rate, kept, mean)


def test_mask_is_a_function_of_coordinates_not_tile_shape():
    """A mask over a smaller (Tq, Tk) is the corner of the larger one:
    any kernel tiling draws the same bits."""
    seed = torch.tensor([5, 6], dtype=torch.int32)
    big = port.dropout_keep_reference(seed, 2, 2, 70, 130, 0.2)
    small = port.dropout_keep_reference(seed, 2, 2, 33, 65, 0.2)
    assert torch.equal(big[:, :, :33, :65], small)
    other = port.dropout_keep_reference(
        torch.tensor([5, 7], dtype=torch.int32), 2, 2, 70, 130, 0.2)
    assert not torch.equal(big, other)


def _dense(q, k, v, bias, scale, causal, keep, rate):
    """softmax(q k^T * scale + bias) with probability dropout, then v."""
    s = q @ k.transpose(-1, -2) * scale
    if bias is not None:
        s = s + bias
    if causal:
        tri = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~tri, -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(keep, p / (1 - rate), torch.zeros_like(p))
    return p @ v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
def test_plain_dropout_forward_and_backward_equal_dense_autograd(causal,
                                                                 bias_kind):
    """The plain forward with dropout equals the dense formula under
    dropout_keep_reference's mask, and the plain backward equals torch
    autograd of that formula: forward and backward draw one mask."""
    rate, Tq, Tk = 0.25, 37, 53
    q, k, v, do, bias = (_t(x) for x in _inputs(4, Tq, Tk, bias_kind))
    seed = torch.tensor([99, -1], dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    keep = port.dropout_keep_reference(seed, B, H, Tq, Tk, rate)
    leaves = [t.clone().requires_grad_(True)
              for t in (q, k, v) + ((bias,) if bias_kind == "full" else ())]
    want = _dense(*leaves[:3], leaves[3] if bias_kind == "full" else bias,
                  scale, causal, keep, rate)
    want_grads = torch.autograd.grad(want, leaves, do)

    out, lse = port.flash_attention_reference(q, k, v, bias, scale, causal,
                                              seed, rate)
    torch.testing.assert_close(out, want.detach(), **DENSE_TOL)
    dq, dk, dv, ds = port.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal,
        bias_kind == "full")
    got = [dq, dk, dv] + ([ds.sum(0, keepdim=True)] if ds is not None else [])
    for g, w in zip(got, want_grads):
        torch.testing.assert_close(g, w, **DENSE_TOL)


def test_public_entry_dropout_gradients_equal_dense_autograd():
    """The same through flash_attention's autograd Function on (B, T, H, D)
    tensors: the backward reuses the forward's seed."""
    rate, T = 0.1, 45
    q, k, v, do, _ = (_t(x) for x in _inputs(8, T, T, None))
    seed = [31, 41]
    keep = port.dropout_keep_reference(torch.tensor(seed, dtype=torch.int32),
                                       B, H, T, T, rate)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port.flash_attention(*(t.transpose(1, 2) for t in a),
                               dropout=rate, dropout_seed=seed)
    grads = torch.autograd.grad(out.transpose(1, 2), a, do)
    b = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = _dense(*b, None, 1 / math.sqrt(D), False, keep, rate)
    want_grads = torch.autograd.grad(want, b, do)
    torch.testing.assert_close(out.transpose(1, 2), want.detach(),
                               **DENSE_TOL)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, **DENSE_TOL)


# ------------------------------------------------------------ port faults
def test_float_mask_gets_a_gradient_bool_mask_none():
    """A float mask is learned: its gradient is the reduced ds. A boolean
    mask is not: attention is routed with bias_grad=False, so no ds is
    formed and the additive bias made from it gets no gradient."""
    rng = onp.random.RandomState(2)
    T = 24
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, T, H, D))
                                .astype("float32")) for _ in range(3))
    fmask = torch.from_numpy(rng.normal(0, 1, (T, T)).astype("float32"))
    fmask.requires_grad_(True)
    bmask = torch.arange(T)[None, :] < torch.tensor([T, 9])[:, None]
    seen = []
    real = port_tf.flash_attention

    def spy(*args, **kwargs):
        seen.append(kwargs["bias_grad"])
        return real(*args, **kwargs)

    qr = q.clone().requires_grad_(True)
    try:
        port_tf.flash_attention = spy
        port_tf.dot_product_attention(q, k, v, mask=fmask).sum().backward()
        port_tf.dot_product_attention(qr, k, v, mask=bmask).sum().backward()
    finally:
        port_tf.flash_attention = real
    assert seen == [True, False]
    assert fmask.grad is not None and fmask.grad.abs().max() > 0
    assert qr.grad is not None and qr.grad.abs().max() > 0

    # flash_attention itself: bias_grad=False gives a zero bias gradient
    bias = fmask.detach()[None, None].clone().requires_grad_(True)
    port.flash_attention(q, k, v, bias=bias, bias_grad=False).sum() \
        .backward()
    assert bias.grad is not None and bias.grad.abs().max() == 0


def test_block_env_vars_route_the_backward(monkeypatch):
    """MXNET_FLASH_BLOCK_K reaches flash_attention per call, as in the JAX
    package's routing: block_k below T selects the two-pass pair."""
    seen = []
    real = port_tf.flash_attention

    def spy(*args, **kwargs):
        seen.append(kwargs["block_k"])
        return real(*args, **kwargs)

    monkeypatch.setattr(port_tf, "flash_attention", spy)
    q = torch.zeros(1, 40, 2, 8)
    monkeypatch.delenv("MXNET_FLASH_BLOCK_K", raising=False)
    port_tf.dot_product_attention(q, q, q)
    monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "16")
    port_tf.dot_product_attention(q, q, q)
    assert seen == [port.DEFAULT_BLOCK_K, 16]


@pytest.mark.parametrize("D,Tk,block_k,route", [
    (64, 48, 1024, "fused"), (40, 512, 512, "fused"),
    (128, 512, 1024, "fused"), (64, 2048, 1024, "two_pass"),
    (128, 512, 256, "two_pass"), (129, 8, 1024, "two_pass"),
    (160, 48, 1024, "two_pass"), (256, 48, 1024, "two_pass"),
    (256, 2048, 1024, "two_pass"), (288, 48, 1024, "wide"),
    (288, 2048, 1024, "wide"), (512, 48, 1024, "wide"),
    (512, 512, 256, "wide")])
def test_card_backward_route(monkeypatch, D, Tk, block_k, route):
    """The card's routing (pure Python, run here on CPU tensors with the
    kernel launch replaced by a spy): D <= 128 takes the fused pass when
    Tk <= block_k and the dq/dkv pair otherwise, the JAX rule; 128 < D <=
    256 takes the pair at every Tk; D > 256 the wide pair at every Tk,
    with dq in q's dtype and dk, dv in the (B, T, H, D) layout."""
    seen = []

    def spy(name, q, k, v, do, bias, seed, rate, lse, delta, dq, dk, dv,
            ds, scale, causal, fn=None):
        seen.append((name, None if dq is None else dq.dtype,
                     None if dk is None else tuple(dk.shape)))

    monkeypatch.setattr(port, "_launch_bwd", spy)
    Tq = 24
    q = torch.zeros(1, 2, Tq, D, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, Tk, D, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, Tq, 1)
    dq, dk, dv, _ = port._backward_kernels(q, kv, kv, None, None, q, lse, q,
                                           0.125, False, block_k, 0.0, False)
    assert port.backward_route(D, Tk, block_k) == route
    if route == "fused":
        assert seen == [("flash_attention_bwd_fused", torch.float32,
                         (1, 2, Tk, D))]
    else:
        pair = "wide" if route == "wide" else "bwd"
        assert seen == [(f"flash_attention_{pair}_dq", torch.bfloat16, None),
                        (f"flash_attention_{pair}_dkv", None, (1, 2, Tk, D))]
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16
    assert dk.shape == dv.shape == kv.shape
    assert dq.transpose(1, 2).stride(-2) % 8 == 0   # rows TMA can store


@pytest.mark.parametrize("D,name,copies", [
    (64, "flash_attention_fwd", 3), (256, "flash_attention_fwd", 3),
    (288, "flash_attention_wide_fwd", 3),
    (512, "flash_attention_wide_fwd", 3),
    (520, "flash_attention_wide_fwd", 3)])
def test_card_forward_route(monkeypatch, D, name, copies):
    """The card's forward routing (pure Python on CPU tensors, the device
    checks and the launch replaced by spies): up to 256 the tiled kernel
    and, for 16-bit heads above 256, the tiled wide kernel (streaming the
    head dim above 512), which all copy 16-bit operands TMA cannot address
    (rows of D + 1 elements here); the wide kernels counted under the wide
    forward's name."""
    import contextlib
    import types
    launched = []

    def kernel(kname, dtype):
        def fn(*args):
            launched.append((kname, args[11]))        # the head dim
            return 0
        return fn

    monkeypatch.setattr(port, "_kernel", kernel)
    monkeypatch.setattr(port, "_check_operands", lambda q, k, v, extra=(): (
        *q.shape[:3], k.shape[2], q.shape[3]))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    q, k, v = (torch.zeros(1, 2, T, D + 1, dtype=torch.bfloat16)[..., :D]
               for T in (24, 40, 40))
    out, lse = port._fwd_outputs(q)
    before = (port.padded_copies, dict(port.launches))
    port._launch_fwd(q, k, v, None, None, 0.0, out, lse, 0.125, False)
    assert launched == [(name, D)]
    assert port.padded_copies - before[0] == copies
    assert {n: port.launches[n] - before[1][n] for n in port.KERNELS} == {
        n: int(n == name) for n in port.KERNELS}


@pytest.mark.parametrize("D,name,qkv,copies", [
    (64, "flash_attention_bwd_fused", True, 0),
    (32, "flash_attention_bwd_fused", True, 0),
    (65, "flash_attention_bwd_fused", False, 4),
    (100, "flash_attention_bwd_fused", False, 0),
    (64, "flash_attention_bwd_dq", True, 0),
    (65, "flash_attention_bwd_dq", False, 4),
    (65, "flash_attention_bwd_dkv", False, 4)])
def test_card_f32_backward_operands(monkeypatch, D, name, qkv, copies):
    """f32 heads up to 128: the fused pass and the pair (3xTF32 on wgmma)
    read q, k, v and dout by TMA, so each copies f32 operands
    whose rows are not a multiple of 16 bytes (D = 65: q, k, v and dout,
    each counted) and takes BERT's fused-QKV views (q, k, v as slices of
    one (B, T, 3, H, D) projection) as they lie. Pure Python on CPU
    tensors, the launch replaced by a spy that records the pointers the
    kernel would read."""
    import contextlib
    import types
    launched = []

    def kernel(kname, dtype):
        def fn(*args):
            launched.append((kname, args[2:6]))       # q, k, v, dout
            return 0
        return fn

    monkeypatch.setattr(port, "_kernel", kernel)
    monkeypatch.setattr(port, "_check_operands", lambda q, k, v, extra=(): (
        *q.shape[:3], k.shape[2], q.shape[3]))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    T = 40
    if qkv:
        proj = torch.zeros(B, T, 3, H, D)
        q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.zeros(B, H, T, D) for _ in range(3))
    do = torch.zeros(B, T, H, D).transpose(1, 2)
    lse = delta = torch.zeros(B, H, T)
    fused = name == "flash_attention_bwd_fused"
    dq = port.dq_accumulator(B, H, T, D, "cpu") if fused else \
        port._bthd_empty(B, H, T, D, torch.float32, "cpu")
    dk = port._bthd_empty(B, H, T, D, torch.float32, "cpu")
    before = port.padded_copies
    port._launch_bwd(name, q, k, v, do, None, None, 0.0, lse, delta, dq,
                     None if name.endswith("_dq") else dk,
                     None if name.endswith("_dq") else dk, None, 0.125,
                     False)
    assert [n for n, _ in launched] == [name]
    assert port.padded_copies - before == copies
    if copies == 0:
        assert launched[0][1] == tuple(t.data_ptr() for t in (q, k, v, do))


@pytest.mark.parametrize("D,qkv,copies", [
    (64, True, 0), (32, True, 0), (128, True, 0), (256, True, 0),
    (65, False, 3), (1, False, 3), (200, False, 0)])
def test_card_f32_forward_operands(monkeypatch, D, qkv, copies):
    """The f32 forward at every head dim up to 256 is the 3xTF32 kernel of
    the wide source (_source: flash_attention_wide_wg's
    mxt_flash_wide_wg_fwd), which reads q, k, v and writes out by TMA: it
    takes BERT's fused-QKV views (q, k, v as slices of one (B, T, 3, H, D)
    projection) as they lie and copies f32 operands whose rows are not a
    multiple of 16 bytes (D = 1, 65: q, k and v, each counted). Pure
    Python on CPU tensors, the launch replaced by a spy that records the
    source and the pointers the kernel would read."""
    import contextlib
    import types
    launched = []

    def kernel(kname, dtype):
        def fn(*args):
            launched.append((port._source(kname, dtype), args[0], args[1:4],
                             args[11]))
            return 0
        return fn

    monkeypatch.setattr(port, "_kernel", kernel)
    monkeypatch.setattr(port, "_check_operands", lambda q, k, v, extra=(): (
        *q.shape[:3], k.shape[2], q.shape[3]))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    T = 40
    if qkv:
        proj = torch.zeros(B, T, 3, H, D)
        q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.zeros(B, H, T, D) for _ in range(3))
    out, lse = port._fwd_outputs(q)
    before = port.padded_copies
    port._launch_fwd(q, k, v, None, None, 0.0, out, lse, 0.125, False)
    assert len(launched) == 1
    source, dtype_code, ptrs, d = launched[0]
    assert source == ("flash_attention_wide_wg", "mxt_flash_wide_wg_fwd")
    assert (dtype_code, d) == (0, D)
    assert port.padded_copies - before == copies
    if copies == 0:
        assert ptrs == tuple(t.data_ptr() for t in (q, k, v))
    else:
        assert all(p != t.data_ptr() for p, t in zip(ptrs, (q, k, v)))


def test_dropout_draws_only_from_the_framework_generator():
    """Same framework seed, same masks; torch.manual_seed moves nothing."""
    x = torch.ones(4, 64)
    q = torch.randn(1, 16, 2, 8)

    def draw():
        mask = port_nn.dropout(x, 0.5, training=True)
        seed = port_tf._attn_seed(torch.device("cpu"))
        att = port_tf.dot_product_attention(q, q, q, dropout=0.3,
                                            training=True)
        return mask, seed, att

    mx_random.seed(17)
    torch.manual_seed(0)
    first = draw()
    mx_random.seed(17)
    torch.manual_seed(12345)
    second = draw()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    mx_random.seed(18)
    assert not torch.equal(draw()[0], first[0])
    # outside training, dropout is the identity and draws nothing
    state = mx_random.generator("cpu").get_state()
    assert port_nn.dropout(x, 0.5) is x
    assert torch.equal(mx_random.generator("cpu").get_state(), state)


def test_kernel_target_hashes_the_shared_headers(tmp_path, monkeypatch):
    """A changed header (philox.cuh, flash_common.cuh, hopper.cuh, the
    TMA host helpers of tma_host.cuh) names a new library for every
    kernel source, so a stale build is never reused."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC, csrc)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    headers = sorted(h.name for h in csrc.glob("*.cuh"))
    assert {"philox.cuh", "flash_common.cuh", "hopper.cuh",
            "tma_host.cuh"} <= set(headers)
    for header in headers:
        before = {n: _kernels._target(n) for n in _kernels.KERNEL_SOURCES}
        assert before == {n: _kernels._target(n)
                          for n in _kernels.KERNEL_SOURCES}
        (csrc / header).write_text(
            (csrc / header).read_text() + "\n// changed\n")
        after = {n: _kernels._target(n) for n in _kernels.KERNEL_SOURCES}
        for n in _kernels.KERNEL_SOURCES:
            assert after[n] != before[n], (header, n)


@pytest.mark.parametrize("Tq,Tk,D", [(1, 1, 16), (64, 48, 64), (65, 130, 40),
                                     (77, 300, 100), (128, 257, 128)])
def test_dq_accumulator_layout_and_cast_back(Tq, Tk, D):
    """The fused kernel's f32 dq accumulator is (B, H, Tq rounded up to
    64, DP + 8), zeroed and contiguous (DP = 64 for D <= 64, else 128), so
    each 64-row tile is one contiguous run. Adding each 128-key block's
    share of the plain backward's dq into its first Tq rows and D columns,
    with junk in the padding, and casting back gives the plain dq as a
    (B, H, Tq, D) view of a dense (B, Tq, H, D) tensor."""
    rng = onp.random.RandomState(Tq + Tk + D)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, (B, H, T, D))
                                    .astype("float32"))
                   for T in (Tq, Tk, Tk, Tq))
    scale = 1.0 / math.sqrt(D)
    out, lse = port.flash_attention_reference(q, k, v, None, scale, False)
    want = port.flash_attention_backward_reference(
        q, k, v, None, None, 0.0, out, lse, do, scale, False, False)[0]

    acc = port.dq_accumulator(B, H, Tq, D, "cpu")
    dp = 64 if D <= 64 else 128
    rows = -(-Tq // 64) * 64
    assert acc.shape == (B, H, rows, dp + 8) and acc.dtype == torch.float32
    assert not acc.any()
    # contiguous: each 64-row tile of one (batch, head) is one run
    assert acc.stride() == (H * rows * (dp + 8), rows * (dp + 8), dp + 8, 1)

    # the kernel's adds: one share per 128-key block, s, p, ds in f32
    s = q @ k.transpose(-1, -2) * scale
    p = torch.exp(s - lse)
    ds = p * (do @ v.transpose(-1, -2) - (do * out).sum(-1, keepdim=True))
    for k0 in range(0, Tk, 128):
        acc[:, :, :Tq, :D] += ((ds[..., k0:k0 + 128] * scale)
                               @ k[:, :, k0:k0 + 128])
    acc[:, :, Tq:] = float("nan")          # rows past Tq: not dq
    acc[..., D:] = 12345.0                 # columns past D: not dq
    dq = port.dq_from_accumulator(acc, Tq, D, torch.bfloat16)
    assert dq.shape == (B, H, Tq, D) and dq.dtype == torch.bfloat16
    assert dq.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(
        port.dq_from_accumulator(acc, Tq, D, torch.float32), want,
        rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dq.float(), want.to(torch.bfloat16).float(),
                               rtol=1e-2, atol=1e-2)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "mxnet_tpu"), (path, mod)
