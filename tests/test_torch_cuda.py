"""The port's CUDA kernels against their plain versions on the GPU.

Marked ``cuda``: each test skips without a CUDA device (the CPU suite has
no ``nvcc`` and no card). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -p no:cacheprovider --noconftest

(``--noconftest``: the suite's conftest configures JAX, which that machine
need not have; this file imports only torch and the port.)

Tolerances: forward, 16-bit inputs against the plain version in f32 on the
same inputs, atol=rtol=2e-2 (the kernel rounds p to 16 bits before p.v and
rounds out once); f32 inputs atol=rtol=1e-4 (summation order); lse
atol=1e-3, rtol=1e-4. Backward, relative Frobenius error of each of dq, dk,
dv and dbias: 2e-2 for 16-bit inputs (p, ds and the outputs rounded to 16
bits), 1e-4 for f32 (summation order, and the fused kernel's dq atomics).
Dropout masks are compared bit for bit through the outputs they make.

The prologue-fused 1x1-conv kernels (fwd, dgrad, wgrad) against their plain
versions, relative Frobenius error of each output: bf16 fwd and wgrad 1e-2
(f(x) and the output rounded to bf16 once each), bf16 dgrad 1e-4 (f32 sums
of exact products), f32 1e-5 (fwd, dgrad) and 1e-4 (wgrad: long sums).

mx.rtc: the user kernels of ``chip_smoke.py`` compiled by NVRTC for sm_90a
against their plain versions: axpy, scale, square and rtc_axpy equal to the
bit (their f32 arithmetic is written with __fmul_rn / __fadd_rn in the
plain version's order); rtc_bias_gelu and rtc_bias_gelu_grad within 1 ulp
in f32 (erff and expf against torch's erf and exp) and relative 2e-2 in
bf16; x.grad through the vjp against torch autograd of the plain forward
(relative 1e-5 in f32, 2e-2 in bf16). Also a launch from a fresh thread,
launches on two streams, more than 48 KB of dynamic shared memory, and
the errors: a CPU NDArray, a non-contiguous or wrongly typed argument, and
a source that does not compile.
"""
import math

import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import attention as attn
from mxnet_tpu_torch.ops.cuda import conv_fused as cf

pytestmark = pytest.mark.cuda

HALF = (torch.bfloat16, torch.float16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda:0")


def _close(got, want, atol, rtol, what):
    err = (got.float() - want).abs()
    assert torch.isfinite(got).all(), what
    assert (err <= atol + rtol * want.abs()).all(), \
        f"{what}: max abs err {err.max().item():.3e}"


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def _bias(kind, B, H, Tq, Tk, dtype, dev, g):
    if kind == "keypad":
        keep = torch.arange(Tk)[None, :] < torch.tensor([Tk, 5])[:B, None]
        bias = torch.where(keep, 0.0, torch.finfo(dtype).min)
        return bias[:, None, None, :].to(dev, dtype)
    if kind == "full":
        return torch.randn((1, H, Tq, Tk), generator=g).to(dev, dtype)
    if kind is not None:
        full = kind[:2] + (Tq, Tk)
        return torch.randn(full, generator=g).to(dev, dtype)
    return None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [32, 40, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape", [None, "keypad", (1, 3, 1, 1),
                                        (2, 1, 1, 1)])
def test_kernel_matches_plain(dev, dtype, D, causal, bias_shape):
    g = torch.Generator().manual_seed(D)
    B, H, Tq, Tk = 2, 3, 77, 131
    q = torch.randn(B, H, Tq, D, generator=g).to(dev, dtype)
    k = torch.randn(B, H, Tk, D, generator=g).to(dev, dtype)
    v = torch.randn(B, H, Tk, D, generator=g).to(dev, dtype)
    bias = _bias(bias_shape, B, H, Tq, Tk, dtype, dev, g)
    scale = 1.0 / math.sqrt(D)
    before = attn.launches["flash_attention_fwd"]
    out, lse = attn._flash_forward(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert attn.launches["flash_attention_fwd"] == before + 1
    ref, ref_lse = attn.flash_attention_reference(
        q.float(), k.float(), v.float(), bias, scale, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    _close(out, ref, tol, tol, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_dropout_mask_is_the_plain_mask(dev, dtype, causal):
    """Dropout 0.1 in the kernel against the plain version with the same
    seed: any differing keep bit would move ``out`` far past the
    tolerance; lse does not see dropout."""
    g = torch.Generator().manual_seed(5)
    B, H, Tq, Tk, D = 2, 3, 77, 131, 64
    q, k, v = (torch.randn(B, H, T, D, generator=g).to(dev, dtype)
               for T in (Tq, Tk, Tk))
    seed = torch.tensor([1234, -99], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, None, scale, causal, seed, 0.1)
    ref, ref_lse = attn.flash_attention_reference(
        q.float(), k.float(), v.float(), None, scale, causal, seed, 0.1)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    _close(out, ref, tol, tol, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")
    nodrop, _ = attn._flash_forward(q, k, v, None, scale, causal)
    assert (out.float() - nodrop.float()).abs().max() > 0.1


def _backward_case(dev, dtype, D, causal, bias_kind, rate, Tq=77, Tk=131,
                   B=2, H=3, seed_val=7):
    g = torch.Generator().manual_seed(seed_val + D)
    q = torch.randn(B, H, Tq, D, generator=g).to(dev, dtype)
    k = torch.randn(B, H, Tk, D, generator=g).to(dev, dtype)
    v = torch.randn(B, H, Tk, D, generator=g).to(dev, dtype)
    do = torch.randn(B, H, Tq, D, generator=g).to(dev, dtype)
    bias = _bias(bias_kind, B, H, Tq, Tk, dtype, dev, g)
    seed = torch.tensor([seed_val, 31337], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, bias, scale, causal, seed, rate)
    return q, k, v, do, bias, seed, scale, out, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [40, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_kernels_match_plain(dev, dtype, D, causal, bias_kind,
                                      route, rate):
    """dq, dk, dv (and dbias for the learned full bias) of the fused
    kernel (block_k >= Tk) or the dq/dkv pair (block_k < Tk) against the
    plain backward on the same inputs and the same dropout mask."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, causal, bias_kind, rate)
    block_k = 1024 if route == "fused" else 64
    names = (["flash_attention_bwd_fused"] if route == "fused" else
             ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    before = {n: attn.launches[n] for n in attn.KERNELS}
    bias_grad = bias_kind == "full"
    dq, dk, dv, db = attn._flash_backward(
        q, k, v, bias, seed, out, lse, do, scale, causal, block_k, rate,
        bias_grad=bias_grad)
    torch.cuda.synchronize()
    for n in attn.KERNELS:
        assert attn.launches[n] == before[n] + (n in names), n
    rq, rk, rv, rds = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal, bias_grad)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        assert _rel(got, want) <= tol, f"{name}: {_rel(got, want):.3e}"
    if bias_grad:
        want = rds.sum(dim=0, keepdim=True)
        assert db.shape == bias.shape
        assert _rel(db, want) <= tol, f"dbias: {_rel(db, want):.3e}"
    else:
        assert db is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_and_two_pass_agree(dev, dtype):
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, 64, False, "keypad", 0.1, Tq=200, Tk=200)
    fused = attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 False, 1024, 0.1)
    two = attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                               False, 64, 0.1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(fused[:3], two[:3]):
        assert _rel(a, b) <= tol


def test_fully_masked_rows_give_zero_dq(dev):
    """A key-padding length of 0 masks whole rows: p = 0 there, and their
    dq rows are 0, not NaN."""
    B, H, T, D = 2, 2, 96, 64
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(B, H, T, D, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    keep = torch.arange(T)[None, :] < torch.tensor([T, 0])[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min)
    bias = bias[:, None, None, :].to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, bias, scale, False)
    for block_k in (1024, 32):
        dq, dk, dv, _ = attn._flash_backward(q, k, v, bias, None, out, lse,
                                             do, scale, False, block_k, 0.0,
                                             bias_grad=False)
        for t in (dq, dk, dv):
            assert torch.isfinite(t).all()
        assert dq[1].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_through_kernels_equals_plain(dev, dtype):
    """q/k/v gradients of flash_attention on the card, through the
    autograd Function and the backward kernels, equal torch autograd
    through the plain forward on the same inputs."""
    g = torch.Generator().manual_seed(11)
    B, T, H, D = 2, 100, 4, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g).to(dev, dtype)
    w = torch.randn(B, T, H, D, generator=g).to(dev)
    keep = torch.arange(T)[None, :] < torch.tensor([T, 61])[:, None]
    mask = torch.where(keep, 0.0, torch.finfo(dtype).min)
    bias = mask[:, None, None, :].to(dev, dtype)

    def grads(fn, x):
        x = x.detach().requires_grad_(True)
        q, k, v = (t.reshape(B, T, H, D) for t in x.split(H * D, dim=-1))
        out = fn(q, k, v)
        (out.float() * w).sum().backward()
        return x.grad

    before = dict(attn.launches)
    got = grads(lambda q, k, v: attn.flash_attention(q, k, v, bias=bias,
                                                     bias_grad=False), qkv)
    assert attn.launches["flash_attention_fwd"] == \
        before["flash_attention_fwd"] + 1
    assert attn.launches["flash_attention_bwd_fused"] == \
        before["flash_attention_bwd_fused"] + 1

    def plain(q, k, v):
        out, _ = attn.flash_attention_reference(
            *(t.transpose(1, 2) for t in (q, k, v)), bias)
        return out.transpose(1, 2)

    want = grads(plain, qkv.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for i in range(3):   # the q, k and v thirds of the fused projection
        sl = slice(i * H * D, (i + 1) * H * D)
        assert got[..., sl].abs().max() > 0
        assert _rel(got[..., sl], want[..., sl]) <= tol, i


def test_kernel_reads_strided_bthd_views(dev):
    """q/k/v as views of one fused (B, T, 3C) projection, as BERT gives
    them: the kernel reads them in place."""
    g = torch.Generator().manual_seed(1)
    B, T, H, D = 3, 100, 4, 64
    qkv = torch.randn(B, T, 3 * H * D, generator=g).to(dev, torch.bfloat16)
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    out = attn.flash_attention(q, k, v)
    ref, _ = attn.flash_attention_reference(
        *(x.transpose(1, 2).float() for x in (q, k, v)))
    _close(out.transpose(1, 2), ref, 2e-2, 2e-2, "out")


def test_kernel_rejects_what_it_does_not_take(dev):
    x = torch.zeros(1, 8, 2, 16, device=dev)
    with pytest.raises(MXNetError, match="dtype"):
        attn.flash_attention(x, x, x.double())
    with pytest.raises(MXNetError, match="head_dim"):
        y = torch.zeros(1, 8, 2, 160, device=dev)
        attn.flash_attention(y, y, y)
    with pytest.raises(MXNetError, match="contiguous"):
        z = torch.zeros(1, 8, 16, 2, device=dev).transpose(-1, -2)
        attn.flash_attention(z, z, z)
    with pytest.raises(MXNetError, match="one CUDA device"):
        attn.flash_attention(x, x, x.cpu())
    with pytest.raises(MXNetError, match="seed"):
        xs = x.transpose(1, 2)
        attn._flash_forward(xs, xs, xs, None, 0.25, False,
                            torch.zeros(2, dtype=torch.int32), 0.1)


# ------------------------------------------------------- conv1x1 kernels
CONV_REL = {torch.bfloat16: {"fwd": 1e-2, "dgrad": 1e-4, "wgrad": 1e-2},
            torch.float32: {"fwd": 1e-5, "dgrad": 1e-5, "wgrad": 1e-4}}


def _conv_case(dev, dtype, N, Ci, Co, M, affine, bias, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, Ci, M, generator=g).to(dev, dtype)
    w = (torch.randn(Co, Ci, generator=g) / math.sqrt(Ci)).to(dev, dtype)
    dy = torch.randn(N, Co, M, generator=g).to(dev, dtype)
    s = (torch.rand(Ci, generator=g) + 0.5).to(dev) if affine else None
    t = (0.2 * torch.randn(Ci, generator=g)).to(dev) if affine else None
    b = (0.1 * torch.randn(Co, generator=g)).to(dev) if bias else None
    return x, w, dy, s, t, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Ci,Co,M", [
    (64, 256, 3136), (128, 512, 784), (256, 1024, 196), (512, 2048, 49),
    (256, 64, 3136), (512, 128, 784), (1024, 256, 196), (2048, 512, 49),
    (45, 77, 53), (72, 40, 4100)])
@pytest.mark.parametrize("affine,relu,bias", [
    (True, True, True), (False, True, True), (True, False, False),
    (False, True, False)])
def test_conv_kernels_match_plain(dev, dtype, Ci, Co, M, affine, relu, bias):
    """ResNet-50's eight junction shapes at N=2, a ragged one and an M >
    4096 one; affine or relu-only, relu off, with and without bias."""
    x, w, dy, s, t, b = _conv_case(dev, dtype, 2, Ci, Co, M, affine, bias)
    before = dict(cf.launches)
    got = {"fwd": cf._fwd(x, s, t, w, relu, b),
           "dgrad": cf._dgrad(x, s, t, w, dy, relu),
           "wgrad": cf._wgrad(x, s, t, dy, relu, dtype)}
    torch.cuda.synchronize()
    assert all(cf.launches[k] == before[k] + 1 for k in cf.KERNELS)
    want = {"fwd": cf.conv1x1_fwd_reference(x, s, t, w, relu, b),
            "dgrad": cf.conv1x1_dgrad_reference(x, s, t, w, dy, relu),
            "wgrad": cf.conv1x1_wgrad_reference(x, s, t, dy, relu, dtype)}
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.isfinite(got[k]).all()
        assert _rel(got[k], want[k]) <= CONV_REL[dtype][k], \
            f"{k}: {_rel(got[k], want[k]):.3e}"


def test_conv_dgrad_mask_is_the_plain_mask(dev):
    """Where x * scale + shift is exactly 0 the ReLU mask is 0, as
    jnp.where(a > 0, ...) gives; dgrad equals the plain version there."""
    x, w, dy, s, t, _ = _conv_case(dev, torch.bfloat16, 2, 64, 64, 128,
                                   True, False)
    t = -s * x[0, :, 0].float()          # a == 0 at m = 0 of sample 0
    da = cf._dgrad(x, s, t, w, dy, True)
    assert (da[0, :, 0] == 0).all()
    want = cf.conv1x1_dgrad_reference(x, s, t, w, dy, True)
    assert _rel(da, want) <= 1e-4


def test_conv_wgrad_is_the_same_from_run_to_run(dev):
    x, _, dy, s, t, _ = _conv_case(dev, torch.bfloat16, 16, 64, 256, 3136,
                                   True, False)
    a = cf._wgrad(x, s, t, dy, True, torch.bfloat16)
    b = cf._wgrad(x, s, t, dy, True, torch.bfloat16)
    assert torch.equal(a, b)


def test_conv_autograd_through_kernels_equals_plain(dev):
    """fused_prologue_conv1x1's gradients on the card equal torch autograd
    through the plain forward on the CPU (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, _, s, t, b = _conv_case(dev, torch.float32, 2, 48, 40, 36, True,
                                  True)

    def grads(where):
        leaves = [v.detach().to(where).requires_grad_(True)
                  for v in (x.reshape(2, 48, 6, 6), w, s, t, b)]
        y = cf.fused_prologue_conv1x1(*leaves[:4], True, leaves[4])
        (torch.sin(y) * 2).sum().backward()
        return [v.grad.cpu() for v in leaves]

    for got, want in zip(grads(dev), grads("cpu")):
        assert _rel(got, want) <= 1e-5


def test_conv_kernels_reject_what_they_do_not_take(dev):
    x, w, dy, s, t, b = _conv_case(dev, torch.bfloat16, 2, 16, 8, 20, True,
                                   True)
    with pytest.raises(MXNetError, match="dtype"):
        cf._fwd(x, s, t, w.float(), True, b)
    with pytest.raises(MXNetError, match="float32"):
        cf._fwd(x, s.half(), t, w, True, b)
    with pytest.raises(MXNetError, match="contiguous"):
        cf._dgrad(x, s, t, w, dy.transpose(1, 2).contiguous()
                  .transpose(1, 2), True)
    with pytest.raises(MXNetError, match="one CUDA device"):
        cf._wgrad(x, s.cpu(), t, dy, True, torch.bfloat16)
    with pytest.raises(MXNetError, match="shapes"):
        cf._fwd(x, s, t, w[:, :8].contiguous(), True, b)


@pytest.mark.parametrize("fuse,want", [("1", 28), ("0", 0)])
def test_resnet50_step_launches_each_conv_kernel_28_times(dev, fuse, want,
                                                          monkeypatch):
    """One ResNet-50 v1 forward and backward (B=2, 64x64, bf16): with the
    knob on, 16 triples and 12 deferred junctions, each one fwd, one dgrad
    and one wgrad launch; with it off, none."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    monkeypatch.setenv("MXNET_FUSE_BN_CONV", fuse)
    net = get_model("resnet50_v1", device=dev)
    net.initialize(generator=torch.Generator().manual_seed(0), device=dev)
    net.cast("bfloat16")
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    before = dict(cf.launches)
    with autograd.record():
        out = net(x.to(dev, torch.bfloat16))
    autograd.backward(out.float().square().mean())
    torch.cuda.synchronize()
    assert {k: cf.launches[k] - before[k] for k in cf.KERNELS} == \
        {k: want for k in cf.KERNELS}
    assert all(torch.isfinite(p.grad).all()
               for p in net.collect_params().values() if p.grad is not None)


# ---------------------------------------------------------------------------
# mx.rtc: NVRTC user kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rtc_k():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return cs.rtc_kernels(rtc)[0]


def _ulps(got, want):
    """Largest |got - want| in ulps of want (f32)."""
    import numpy as np
    g = got.float().cpu().numpy().astype(np.float64)
    w = want.float().cpu().numpy()
    return float((np.abs(g - w) / np.spacing(np.abs(w))).max())


def _grid(n):
    return (cs.rtc_blocks(n), 1, 1), (cs.RTC_THREADS, 1, 1)


def test_rtc_axpy_scale_square_are_exact(dev, rtc_k):
    g = torch.Generator().manual_seed(0)
    x, y = (torch.rand(1000, generator=g).to(dev) * 2 - 1 for _ in range(2))
    with tmx.gpu(0):
        X, Y = tmx.nd.array(x), tmx.nd.array(y)
    n = x.numel()
    out = rtc_k["axpy"].bind([((n,), "float32")], ((n + 127) // 128,),
                             (128,), n=n)(X, Y)
    assert torch.equal(out._data, cs.plain_axpy(x, y))
    sq = rtc_k["square"].bind([((n,), "float32")], ((n + 127) // 128,),
                              (128,), n=n)(X)
    assert torch.equal(sq._data, cs.plain_square(x))
    m = torch.rand(16, 128, generator=g).to(dev)
    sc = rtc_k["scale"].bind([((16, 128), "float32")], (2, 1, 1),
                             (128, 8, 1))(m)
    assert torch.equal(sc._data, cs.plain_scale(m))
    yy = y.clone()
    rtc_k["rtc_axpy"].launch([x, yy, 0.75, n], dev, *_grid(n))
    assert torch.equal(yy, cs.plain_rtc_axpy(x, y, 0.75))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 3072), (37, 129)])
def test_rtc_bias_gelu_matches_plain(dev, rtc_k, dtype, shape):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(shape, generator=g) * 2).to(dev, dtype)
    b = torch.randn(shape[1], generator=g).to(dev, dtype)
    dy = torch.randn(shape, generator=g).to(dev, dtype)
    t = cs.GELU_TYPES[str(dtype).split(".")[-1]]
    n, cols = x.numel(), shape[1]
    y = torch.empty_like(x)
    rtc_k[f"rtc_bias_gelu<{t}>"].launch([x, b, y, n, cols], dev, *_grid(n))
    dx = torch.empty_like(x)
    rtc_k[f"rtc_bias_gelu_grad<{t}>"].launch([x, b, dy, dx, n, cols], dev,
                                              *_grid(n))
    want_y, want_dx = cs.plain_bias_gelu(x, b), cs.plain_bias_gelu_grad(
        x, b, dy)
    if dtype == torch.float32:
        assert _ulps(y, want_y) <= 1 and _ulps(dx, want_dx) <= 1
    else:
        assert _rel(y, want_y) <= 2e-2 and _rel(dx, want_dx) <= 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rtc_bias_gelu_vjp_matches_torch_autograd(dev, rtc_k, dtype, tol):
    g = torch.Generator().manual_seed(2)
    x0 = torch.randn(64, 96, generator=g).to(dev, dtype)
    b0 = torch.randn(96, generator=g).to(dev, dtype)
    with tmx.gpu(0):
        x, b = tmx.nd.array(x0), tmx.nd.array(b0)
    x.attach_grad()
    b.attach_grad()
    gx = x.grad
    with tmx.autograd.record():
        s = cs.rtc_bias_gelu(rtc_k, x, b).sum()
    s.backward()
    assert x.grad is gx
    xt, bt = x0.clone().requires_grad_(), b0.clone().requires_grad_()
    cs.plain_bias_gelu(xt, bt).float().sum().backward()
    assert _rel(x.grad._data, xt.grad) <= tol
    assert _rel(b.grad._data, bt.grad) <= tol


def test_rtc_launch_from_a_fresh_thread(dev, rtc_k):
    import threading
    x = torch.rand(4096, device=dev)
    y = torch.zeros_like(x)
    errors = []

    def work():
        try:
            rtc_k["rtc_axpy"].launch([x, y, 2.0, x.numel()], dev,
                                     *_grid(x.numel()))
            torch.cuda.synchronize(dev)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and not errors
    assert torch.equal(y, cs.plain_rtc_axpy(x, torch.zeros_like(x), 2.0))


def test_rtc_launches_on_two_streams(dev, rtc_k):
    x = torch.rand(1 << 20, device=dev)
    y = torch.zeros_like(x)
    n = x.numel()
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    with torch.cuda.stream(s1):
        rtc_k["rtc_axpy"].launch([x, y, 1.0, n], dev, *_grid(n))
        done = torch.cuda.Event()
        done.record(s1)
    s2.wait_event(done)
    with torch.cuda.stream(s2):
        rtc_k["rtc_axpy"].launch([x, y, 1.0, n], dev, *_grid(n))
    torch.cuda.synchronize(dev)
    assert torch.equal(y, x + x)


def test_rtc_large_dynamic_shared_memory(dev):
    src = r'''
extern "C" __global__ void rev(const float* x, float* o, int n) {
  extern __shared__ float buf[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = buf[n - 1 - i];
}
'''
    k = rtc.CudaModule(src).get_kernel("rev", "const float *x, float *o, "
                                       "int n")
    n = 24 * 1024                  # 96 KB of shared memory
    x = torch.rand(n, device=dev)
    o = torch.empty_like(x)
    k.launch([x, o, n], dev, (1,), (1024,), shared_mem=4 * n)
    torch.cuda.synchronize(dev)
    assert torch.equal(o, x.flip(0))


def test_rtc_errors(dev, rtc_k):
    k = rtc_k["rtc_axpy"]
    x = torch.rand(64, device=dev)
    before = rtc.launches["rtc_axpy"]
    with tmx.cpu():
        cpu_x = tmx.nd.ones((64,))
    with pytest.raises(MXNetError, match="lies on cpu"):
        k.launch([cpu_x, x, 1.0, 64], dev, (1,), (64,))
    with pytest.raises(MXNetError, match="contiguous"):
        k.launch([torch.rand(64, 2, device=dev)[:, 0], x, 1.0, 64], dev,
                 (1,), (64,))
    with pytest.raises(MXNetError, match="wants"):
        k.launch([x.half(), x, 1.0, 64], dev, (1,), (64,))
    assert rtc.launches["rtc_axpy"] == before
    with pytest.raises(MXNetError, match="error"):
        rtc.CudaModule("extern \"C\" __global__ void k(float* x) "
                       "{ x[0] = undefined_name; }")
