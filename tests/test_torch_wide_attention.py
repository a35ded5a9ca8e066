"""Head dims above 256 in the port's flash attention
(mxnet_tpu_torch/ops/cuda/attention.py), on the CPU.

The card's route at a wide head dim is ``head_dim_route``, a pure function
of (D, dtype): 16-bit heads take the tiled wgmma kernels of
``csrc/flash_attention_wide_wg.cu`` for the forward and dq at every D > 256
(streaming the head dim above 512) and of ``csrc/flash_attention_wide_dkv.cu``
for dk / dv up to 512, 16-bit dk / dv above 512 and every f32 kernel the
warp-a-row kernels of ``csrc/flash_attention_wide.cu``. Those
kernels run only on the card (``tests/test_torch_cuda.py``); here the route
is checked at every edge, the backward pair's operands that TMA cannot
address are copied once for both kernels, and the plain versions, which
the card's kernels are held to, are
held to the JAX package's Pallas kernels in interpret mode through its
entry point ``flash_attention`` and ``jax.grad`` of it, at D = 264, 320,
384, 512, 576 and 1024: causal with Tq != Tk, a key-padding bias, and a
learned full bias with its gradient.

f32 throughout; tolerance rtol=2e-4, atol=2e-5 (the JAX package's own
flash test): the two differ only in summation order.
"""
import math

import numpy as onp
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas.attention import flash_attention as jax_flash
from mxnet_tpu_torch.ops.cuda import attention as port

TOL = dict(rtol=2e-4, atol=2e-5)
B, H = 2, 2
WIDE_D = [264, 320, 384, 512, 576, 1024]
# (Tq, Tk, causal, bias): causal with Tq != Tk, key padding, learned full
CASES = {"causal_cross": (24, 40, True, None),
         "keypad": (32, 32, False, "keypad"),
         "full": (24, 40, False, "full")}
HALF = (torch.bfloat16, torch.float16)


# (library, C entry) of each wide kernel on each wide route
WIDE_SOURCES = {
    "wide_wg": {
        "flash_attention_wide_fwd": ("flash_attention_wide_wg",
                                     "mxt_flash_wide_wg_fwd"),
        "flash_attention_wide_dq": ("flash_attention_wide_wg",
                                    "mxt_flash_wide_wg_bwd"),
        "flash_attention_wide_dkv": ("flash_attention_wide_dkv",
                                     "mxt_flash_wide_wg_dkv")},
    "wide_stream": {
        "flash_attention_wide_fwd": ("flash_attention_wide_wg",
                                     "mxt_flash_wide_wg_fwd"),
        "flash_attention_wide_dq": ("flash_attention_wide_wg",
                                    "mxt_flash_wide_wg_bwd"),
        "flash_attention_wide_dkv": ("flash_attention_wide",
                                     "mxt_flash_wide_bwd")},
    "wide_rows": {
        "flash_attention_wide_fwd": ("flash_attention_wide",
                                     "mxt_flash_wide_fwd"),
        "flash_attention_wide_dq": ("flash_attention_wide",
                                    "mxt_flash_wide_bwd"),
        "flash_attention_wide_dkv": ("flash_attention_wide",
                                     "mxt_flash_wide_bwd")}}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [256, 257, 264, 300, 512, 513, 576, 1024,
                               2048])
def test_head_dim_route(D, dtype):
    """Every edge of the route: up to 256 the tiled kernels; 16-bit up to
    512 the tiled wide kernels (wide_fwd and wide_dq from one source,
    wide_dkv from its own), 16-bit above 512 the tiled wide_fwd and wide_dq
    that stream the head dim and the warp-a-row wide_dkv, f32 the
    warp-a-row ones; the route decides the source of each wide kernel and
    whether it reads and writes by TMA (and so may copy operands): every
    tiled kernel does, no warp-a-row one."""
    route = port.head_dim_route(D, dtype)
    if D <= 256:
        want = "tiled"
    elif dtype not in HALF:
        want = "wide_rows"
    else:
        want = "wide_wg" if D <= 512 else "wide_stream"
    assert route == want
    assert port.head_dim_route(D, dtype) == route        # pure
    if route == "tiled":
        assert port._source("flash_attention_fwd", route) == (
            "flash_attention_fwd", "mxt_flash_attention_fwd")
        return
    for name, source in WIDE_SOURCES[route].items():
        assert port._source(name, route) == source, name
        assert port._uses_tma(name, route, dtype) == (
            source[0] != "flash_attention_wide"), name
    assert port.backward_route(D, 48, 1024) == "wide"


@pytest.mark.parametrize("D,dtype,copies", [
    (300, torch.bfloat16, 4), (300, torch.float16, 4),
    (300, torch.float32, 0), (520, torch.bfloat16, 0),
    (320, torch.bfloat16, 0), (36, torch.bfloat16, 4),
    (530, torch.bfloat16, 4), (530, torch.float32, 0)])
def test_pair_operands_copied_once(D, dtype, copies):
    """The backward pair's q, k, v and dout, contiguous (B, H, T, D) views:
    rows of D = 300 (or 36) 16-bit values are not a multiple of 16 bytes, so
    on a route whose kernels read by TMA each is copied once for both
    kernels (counted), into a view TMA can address that holds the same
    values, and the second kernel's own check copies nothing more (at D =
    530 the streamed dq reads by TMA, so the warp-a-row dk / dv gets the
    copies too); f32 (the warp-a-row kernels) and D = 320 or 520 (rows
    TMA can address) take them as they are. No kernel runs here."""
    route = port.head_dim_route(D, dtype)
    pair = ("flash_attention_wide_dq", "flash_attention_wide_dkv") \
        if route != "tiled" else ("flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")
    g = torch.Generator().manual_seed(D)
    ts = tuple(torch.randn(2, 3, T, D, generator=g).to(dtype)
               for T in (24, 40, 40, 24))
    before = port.padded_copies
    got = port._pair_operands(pair, route, ts)
    assert port.padded_copies - before == copies
    for t, u in zip(ts, got):
        assert torch.equal(t, u)
        assert (u is t) == (copies == 0)
        if copies:
            assert port._tma_ready(u)
    again = tuple(port._tma_operand(u) for u in got) if copies else got
    assert port.padded_copies - before == copies
    assert all(a is b for a, b in zip(again, got))


def _inputs(seed, Tq, Tk, bias_kind, d):
    rng = onp.random.RandomState(seed)
    q = rng.normal(0, 1, (B, Tq, H, d)).astype("float32")
    k = rng.normal(0, 1, (B, Tk, H, d)).astype("float32")
    v = rng.normal(0, 1, (B, Tk, H, d)).astype("float32")
    bias = None
    if bias_kind == "keypad":
        valid = onp.array([Tk, max(1, Tk // 3)])
        keep = onp.arange(Tk)[None, :] < valid[:, None]
        bias = onp.where(keep, 0.0, onp.finfo(onp.float32).min)
        bias = bias.astype("float32")[:, None, None, :]      # (B,1,1,Tk)
    elif bias_kind == "full":
        bias = rng.normal(0, 1, (1, H, Tq, Tk)).astype("float32")
    w = rng.normal(0, 1, (B, Tq, H, d)).astype("float32")
    return q, k, v, bias, w


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", WIDE_D)
def test_wide_forward_matches_jax_entry(d, case):
    """The plain forward (the card's kernels' reference) at a wide head
    dim against the JAX package's flash_attention over (B, T, H, D), the
    Pallas forward in interpret mode over blocks of 16 (ragged, several
    key blocks)."""
    Tq, Tk, causal, bias_kind = CASES[case]
    q, k, v, bias, _ = _inputs(d, Tq, Tk, bias_kind, d)
    want = onp.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16,
        bias=None if bias is None else jnp.asarray(bias)))
    before = dict(port.launches)
    got = port.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=16, block_k=16,
        bias=None if bias is None else torch.from_numpy(bias))
    assert got.shape == (B, Tq, H, d)
    assert port.launches == before          # CPU tensors: no kernel
    onp.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", WIDE_D)
def test_wide_gradients_match_jax_grad(d, case):
    """dq, dk, dv (and the learned bias's gradient) of sum(out * w)
    through the port's flash_attention on the CPU (the plain backward, the
    wide pair's reference) against jax.grad through the JAX package's
    entry point, its Pallas backward in interpret mode."""
    Tq, Tk, causal, bias_kind = CASES[case]
    q, k, v, bias, w = _inputs(d + 1, Tq, Tk, bias_kind, d)
    learned = bias_kind == "full"

    def jloss(q_, k_, v_, b_):
        return jnp.sum(jax_flash(q_, k_, v_, causal=causal, block_q=16,
                                 block_k=16, bias=b_,
                                 bias_grad=learned) * w)

    jb = None if bias is None else jnp.asarray(bias)
    argnums = (0, 1, 2, 3) if learned else (0, 1, 2)
    want = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    tb = None
    if bias is not None:
        tb = torch.tensor(bias, requires_grad=learned)
    out = port.flash_attention(*ts, causal=causal, block_q=16, block_k=16,
                               bias=tb, bias_grad=learned)
    (out * torch.from_numpy(w)).sum().backward()
    got = [t.grad for t in ts] + ([tb.grad] if learned else [])
    for name, g, wg in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g is not None and g.shape == wg.shape, name
        onp.testing.assert_allclose(g.numpy(), onp.asarray(wg), **TOL,
                                    err_msg=name)


@pytest.mark.parametrize("d", [300, 320])
def test_wide_plain_backward_is_its_own_formula(d):
    """The plain backward at a wide head dim equals autograd through the
    plain forward (scale and all), so the card's wide kernels and the JAX
    package are held to one function: causal, Tq != Tk, f64 inputs; the
    plain backward computes in f32, so atol=rtol=1e-5 against f64
    autograd."""
    rng = onp.random.RandomState(d)
    q, k, v, g = (torch.tensor(rng.normal(0, 1, s), dtype=torch.float64)
                  for s in ((B, H, 24, d), (B, H, 40, d), (B, H, 40, d),
                            (B, H, 24, d)))
    scale = 1.0 / math.sqrt(d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = port.flash_attention_reference(*leaves, None, scale, True)
    out.backward(g)
    dq, dk, dv, ds = port.flash_attention_backward_reference(
        q, k, v, None, None, 0.0, out.detach(), lse.detach(), g, scale, True,
        False)
    assert ds is None
    for got, leaf in zip((dq, dk, dv), leaves):
        torch.testing.assert_close(got, leaf.grad.float(), rtol=1e-5,
                                   atol=1e-5)
