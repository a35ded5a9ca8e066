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
bits), 1e-4 for f32 (summation order, and the order of the fused kernel's
dq adds), at head dims 40 to 256 (above 128 always the dq/dkv pair); two
runs of the pair equal to the bit. The f32 fused pass (3xTF32 on wgmma,
``tf::bwd_fused_tf32``) at head dims 1 to 128 (32, 40, 64, 100, 128):
causal, every bias kind, a learned bias, dropout (its mask read back bit
for bit through dv), Tq != Tk and T = 333, within 1e-4 of the plain
version and 1e-5 of the f32 pair, two runs' dq within 1e-6 and dk, dv
equal to the bit, BERT's fused-QKV views read without a copy. The f32
forward (3xTF32 on wgmma, ``wwg::flash_fwd_tf32``) at head dims 1 to 256
(1, 4, 32, 40, 64, 100, 128, 160, 200, 224, 256): causal, every bias
shape, Tq != Tk, one row or one key, dropout, within 1e-4 (lse 1e-3 /
1e-4) of the plain version, two runs equal to the bit, BERT's fused-QKV
views read without a copy, rows of 37 f32 copied. Dropout
masks are compared bit for bit through the outputs they make. Head dims
above 256 (264 to 1280) run the wide
kernels, forward and backward, under the same tolerances, at Tq != Tk,
with bias, causal and dropout (their masks read back bit for bit), two
backward runs equal to the bit; 16-bit heads on the tiled wgmma forward,
dq and dk / dv (streaming the head dim above 512), f32 heads on the 3xTF32
wgmma forward and dq and the warp-a-row dk / dv (out, lse, dq, ds, dk and
dv equal to the bit run to run, operands with rows TMA cannot address
copied and counted, once for the backward pair), as the profiler's kernel
names show.

The prologue-fused 1x1-conv kernels (fwd, dgrad, wgrad) against their plain
versions, relative Frobenius error of each output: 16-bit fwd and bf16
wgrad 1e-2 (f(x) and the output rounded to 16 bits once each), 16-bit
dgrad 1e-4 (f32 sums of exact products), fp16 wgrad 1e-4 (f(x) carried as
two fp16 terms, about f32), f32 1e-5 (fwd, dgrad) and 1e-4 (wgrad: long
sums); dgrad's ReLU mask bit for bit on every copy path.

BatchNorm's four kernels (``bn_stats``, ``bn_apply``, ``bn_bwd_reduce``,
``bn_bwd_apply``) against their plain versions on the same inputs: the
statistics, dg and db within a relative Frobenius error of 1e-5 (f32 sums
in another order; the mean's relative to the batch's standard deviation);
out and dx equal to the bit (the kernels round every
f32 operation as the plain versions do, given the same statistics); two
runs equal to the bit; the two reductions one kernel launch a call and no
memset, at DCGAN's shapes, on the second level, at one image and at one
channel; and the launches of a ResNet-50 step.

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

The multi-tensor update (``csrc/multi_tensor.cu``): SGD with and without
momentum, Adam and AdamW over f32 weights, 16-bit weights with f32 masters
and 16-bit weights alone, with clip_gradient and lr / wd multipliers, in
groups of 1, 4 and all, with every other tensor's views off 16-byte
alignment at ragged sizes, and at other chunk sizes and grids: every
weight, master and state equal to the plain version's bits after three
steps; one launch a layout a step from ``Trainer.step``.

``hybridize()`` as CUDA graphs, on a small BERT (2 layers, units 128, head
dim 64, bf16, dropout 0.1) and a small ResNet: a replayed call's outputs
equal an eager call's bits from the same generator state, and leave the
generator where the eager call does; two replays draw different dropout;
the graphed backward's gradients within a relative Frobenius error of 2e-2
of the eager ones (bf16); ``grad_req='add'`` accumulates; BatchNorm's
running statistics after a replay equal the eager ones; the profiler sees
a replay's kernels; a served model's captured buckets answer as eager; a
capture that cannot be captured raises.

The forward as the registered op ``mxnet_tpu_torch::flash_attention_fwd``:
its out and lse equal to the bit with the launcher's at phase 3's forward
shapes, with and without dropout; a served BERT's replays unchanged by it;
an exported BERT (``HybridBlock.export`` -> ``ServedModel.from_export``)
launching the kernel once a layer, counted by the profiler, within
relative 2e-2 of the live block; an HTTP round trip equal to the bit.

Generation (a 2-layer GPT, units 256, head dim 64): the prefill's flash
forward, causal at B = 1 (T = 128, 512, 1024, bf16), against its plain
version at atol=rtol=2e-2; the shared-prefix suffix pass under its
(1, 1, Sb, Pb + Sb) f32 bias at Pb = 256, Sb = 128 with one real prefix row
(key tiles masked whole) and with 100, finite and within the same
tolerance; the decode attention kernel against its plain version (bf16
2e-2, f32 1e-5) and equal to the bit whatever the bucket its rows lie in,
the slot index or the number of slots, at head dims 64 and 288, and a CUDA
graph of it over a kept workspace equal to eager calls replay after
replay;
the decode step replayed against the same step run eagerly, tokens and KV
rows equal to the bit, greedy and mixed lanes; ``verify`` equal to the bit
to K1 chained ``step``s; and an engine that captured its grid at warmup
capturing nothing during traffic that migrates buckets and samples.
Prompt passes while another thread captures a decode graph on the card (a
replica restarted after a worker's death warming up): each waits on its
own stream only, so the capture, the prompt passes' logits and a
recovery's streams are what they are with nothing else running. A
``ServedModel``'s hybridized block capturing a new signature while another
thread runs prompt passes, and a decode capture while ``predict`` uploads
a batch: neither raises, and each gives what it gives alone.

The encoder-decoder Transformer (2 + 2 layers, units 256, head dim 64):
a bf16 training step's launches (6 flash forwards, 6 fused backwards or 6
of each of the pair at block_k 64, one update); the f32 step against the
CPU's plain path (loss 1e-4 relative, gradients 1e-3 relative Frobenius,
Tq != Tk, a source of valid length 0); f32 ``translate`` and
``beam_translate`` equal to the CPU's tokens (scores 1e-4), the decode
kernel 4 times a token; the hybridized step with and without
``src_valid_length`` (one graph each, the tied embedding bound once). A
2-layer GPT's training step: 2 + 2 launches (or the pair at block_k 128),
and the f32 step against the CPU.

The int8 convolution and product (``csrc/int8_conv.cu``) against their
float64 plain version, to the bit, with and without the int32 bias: conv1's
C = 3 (K = 147), strided 1x1 downsamples, K not a multiple of 32 or 16,
groups, dilation, the 1-d and 3-d layouts, channels-last weights, M < 16,
K = 4608 of -127 x -127 (past f32's 2^24), the FC at batch 1 to 300; a
channels-last input read in place and a contiguous one copied and counted;
a failed launch or build raising with the plain version out of reach. Its
f32 variant (a whole quantized layer: quantize, product, dequantize, relu)
against the unfused operator sequence, to the bit, at the same cases; both
variants at every shape of the int8 ResNet-50 path and four more (every A
route, the split over a cluster), two runs equal; a quantized conv and
Dense captured in a CUDA graph, the replay equal to the eager call. The
NMS kernel's keep mask (``csrc/box_nms.cu``) against its plain version, to
the bit, at N = 1, 63, 64, 65, 300 and 8732, the sweep cut to topk < N,
with and without ``force_suppress``; ``box_nms`` on the card equal to the
CPU's; a failed launch raising. A ResNet-18 v1 through ``quantize_net``:
21 int8 launches a forward, and its hybridized replays equal to the eager
forward to the bit.
"""
import math

import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.cuda import attention as attn
from mxnet_tpu_torch.ops.cuda import batch_norm as bn
from mxnet_tpu_torch.ops.cuda import conv_fused as cf
from mxnet_tpu_torch.ops.cuda import multi_tensor as mt

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
@pytest.mark.parametrize("D", [32, 40, 64, 128, 200, 256])
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
@pytest.mark.parametrize("D", [40, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_kernels_match_plain(dev, dtype, D, causal, bias_kind,
                                      route, rate):
    """dq, dk, dv (and dbias for the learned full bias, from the ds the
    fused or the dq kernel writes) of the fused kernel (block_k >= Tk,
    D <= 128) or the dq/dkv pair (block_k < Tk, or D > 128 at any Tk)
    against the plain backward on the same inputs and the same dropout
    mask."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, causal, bias_kind, rate)
    block_k = 1024 if route == "fused" else 64
    names = (["flash_attention_bwd_fused"]
             if attn.backward_route(D, k.shape[2], block_k) == "fused" else
             ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"])
    assert (names == ["flash_attention_bwd_fused"]) == \
        (route == "fused" and D <= 128)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [40, 64, 128, 32, 100])
def test_fused_and_two_pass_agree(dev, dtype, D):
    """The fused pass and the dq/dkv pair on the same inputs (key padding,
    dropout 0.1): dk, dv from the same walk, dq rounded in other places."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, False, "keypad", 0.1, Tq=200, Tk=200)
    fused = attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 False, 1024, 0.1)
    two = attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                               False, 64, 0.1)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(fused[:3], two[:3]):
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [40, 64, 128, 256])
def test_pair_dropout_masks_are_the_plain_mask(dev, dtype, D):
    """The dropout masks the dkv kernel (through dv) and the dq kernel
    (through the learned bias's ds) draw equal dropout_keep_reference's
    bit for bit (chip_smoke.pair_dropout_masks)."""
    from_dkv, from_dq, want = cs.pair_dropout_masks(torch, attn, dev, dtype,
                                                    D)
    torch.cuda.synchronize()
    assert torch.equal(from_dkv, want)
    assert torch.equal(from_dq, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", [40, 64, 128, 256])
def test_pair_reruns_equal_to_the_bit(dev, dtype, D):
    """The pair writes dq once from registers (no accumulator, no
    atomics): two runs on the same inputs give dq, dk, dv and the learned
    bias's gradient equal to the bit."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, True, "full", 0.1, Tq=300, Tk=300)
    runs = [attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 True, 64, 0.1) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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


def _fused_against_plain(q, k, v, do, bias, seed, scale, out, lse, causal,
                         rate):
    """The fused route (one launch) against the plain backward; returns
    the kernel's (dq, dk, dv)."""
    before = attn.launches["flash_attention_bwd_fused"]
    dq, dk, dv, _ = attn._flash_backward(q, k, v, bias, seed, out, lse, do,
                                         scale, causal, 4096, rate,
                                         bias_grad=False)
    torch.cuda.synchronize()
    assert attn.launches["flash_attention_bwd_fused"] == before + 1
    want = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal, False)
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want[:3]):
        assert got.dtype == q.dtype and torch.isfinite(got).all(), name
        assert _rel(got, w) <= tol, f"{name}: {_rel(got, w):.3e}"
    return dq, dk, dv


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", [(200, 333), (333, 200), (64, 129),
                                   (1, 1), (513, 513)])
def test_fused_backward_ragged_and_cross_lengths(dev, dtype, causal, Tq, Tk):
    """Tk not a multiple of the kernel's key block (128 keys in 16 bits,
    64 in f32) and Tq != Tk (TMA's zero fill and clipping; the caller pads
    nothing), with key padding and dropout 0.1, against the plain
    backward. In f32 at Tq = Tk = 1, dq and dk are 0 (one key: p = 1 and
    out = v, so dp = delta and ds = 0) and both versions give rounding
    noise of dp - delta, whose relative error says nothing: there dv is
    held to the plain version and ds to its rounding bound, |ds| <=
    2**-17 sum|dout v| / (1 - rate) (dp's products and f32 sums and
    delta's f32 sum each within 2**-18 of the sum of their terms'
    magnitudes), so |dq| <= that * scale * |k| and |dk| <= that * scale *
    |q|, element by element."""
    case = _backward_case(dev, dtype, 64, causal, "keypad", 0.1, Tq=Tq,
                          Tk=Tk)
    if dtype == torch.float32 and Tk == 1:
        q, k, v, do, bias, seed, scale, out, lse = case
        dq, dk, dv, _ = attn._flash_backward(q, k, v, bias, seed, out, lse,
                                             do, scale, causal, 4096, 0.1,
                                             bias_grad=False)
        want = attn.flash_attention_backward_reference(
            q, k, v, bias, seed, 0.1, out, lse, do, scale, causal, False)
        assert _rel(dv, want[2]) <= 1e-4
        ds = (do.abs() * v.abs()).sum(-1, keepdim=True) / 0.9 * 2.0 ** -17
        assert (dq.abs() <= ds * scale * k.abs() * 1.001).all()
        assert (dk.abs() <= ds * scale * q.abs() * 1.001).all()
        return
    _fused_against_plain(*case, causal, 0.1)


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
def test_fused_backward_reads_bt3hd_views_without_copies(dev, dtype):
    """q, k, v as views of one (B, T, 3, H, D) projection and dout as a
    view of a (B, T, H, D) gradient: TMA reads them in place, so no
    operand is copied."""
    g = torch.Generator().manual_seed(4)
    B, T, H, D = 2, 200, 4, 64
    qkv = torch.randn(B, T, 3, H, D, generator=g).to(dev, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(B, T, H, D, generator=g).to(dev, dtype).transpose(1, 2)
    seed = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, None, scale, False, seed, 0.1)
    before = attn.padded_copies
    _fused_against_plain(q, k, v, do, None, seed, scale, out, lse, False, 0.1)
    assert attn.padded_copies == before


@pytest.mark.parametrize("layout", ["odd_rows", "unaligned_base"])
def test_fused_backward_copies_what_tma_cannot_address(dev, layout):
    """Rows of 36 16-bit values or a base one element past a 16-byte
    boundary: q, k, v and dout are copied into padded buffers (counted),
    the result equals the plain version's; dk and dv outputs TMA cannot
    write are written to padded buffers and copied back (counted)."""
    g = torch.Generator().manual_seed(9)
    B, H, T = 2, 3, 70
    D = 36 if layout == "odd_rows" else 64
    n = B * H * T * D
    base = torch.randn(4 * n + 1, generator=g).to(dev, torch.bfloat16)
    off = 1 if layout == "unaligned_base" else 0
    q, k, v, do = (base[off + i * n:off + (i + 1) * n].reshape(B, H, T, D)
                   for i in range(4))
    out, lse = attn._flash_forward(q, k, v, None, 0.2, False)
    before = attn.padded_copies
    dq, dk, dv = _fused_against_plain(q, k, v, do, None, None, 0.2, out, lse,
                                      False, 0.0)
    assert attn.padded_copies == before + 4
    dests = [torch.empty(n + 1, dtype=torch.bfloat16,
                         device=dev)[1:].reshape(B, H, T, D) for _ in range(2)]
    acc = attn.dq_accumulator(B, H, T, D, dev)
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    attn._launch_bwd("flash_attention_bwd_fused", q, k, v, do, None, None,
                     0.0, lse.reshape(B, H, T).contiguous(), delta, acc,
                     *dests, None, 0.2, False)
    torch.cuda.synchronize()
    assert attn.padded_copies == before + 4 + 6
    assert torch.equal(dests[0], dk) and torch.equal(dests[1], dv)
    assert _rel(attn.dq_from_accumulator(acc, T, D, torch.bfloat16), dq) \
        <= 1e-2


@pytest.mark.parametrize("D", [32, 40, 64, 100, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", (2, 1, 1, 1), "full"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_fused_backward_matches_plain(dev, D, causal, bias_kind, rate):
    """The f32 fused pass (3xTF32 on wgmma) at every padded head dim (32,
    64, 96, 128 in 32-column panels; D = 40 and 100 zero-filled past D),
    causal, every bias kind (a learned full bias's gradient from the ds it
    writes), dropout 0.1, Tq != Tk: dq, dk, dv within relative 1e-4 of the
    plain backward, one launch of the fused kernel and none other."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, torch.float32, D, causal, bias_kind, rate)
    before = dict(attn.launches)
    bias_grad = bias_kind == "full"
    dq, dk, dv, db = attn._flash_backward(
        q, k, v, bias, seed, out, lse, do, scale, causal, 1024, rate,
        bias_grad=bias_grad)
    torch.cuda.synchronize()
    assert {n: attn.launches[n] - before[n] for n in attn.KERNELS} == {
        n: int(n == "flash_attention_bwd_fused") for n in attn.KERNELS}
    rq, rk, rv, rds = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal, bias_grad)
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        assert _rel(got, want) <= 1e-4, f"{name}: {_rel(got, want):.3e}"
    if bias_grad:
        want = rds.sum(dim=0, keepdim=True)
        assert _rel(db, want) <= 1e-4, f"dbias: {_rel(db, want):.3e}"


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("D", [32, 64, 100, 128])
def test_fused_dropout_mask_is_the_plain_mask(dev, dtype, D):
    """The fused pass's dropout mask (keys as the rows of its walk, one
    Philox call shared by two lanes), read back through dv
    (chip_smoke.fused_dropout_mask), equals dropout_keep_reference's bit
    for bit."""
    got, want = cs.fused_dropout_mask(torch, attn, dev, dtype, D)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("D", [32, 40, 64, 100, 128])
def test_f32_fused_backward_reruns(dev, D):
    """Two f32 fused passes on the same inputs (causal, learned bias,
    dropout 0.1, Tq != Tk): dq, added a key block at a time in a varying
    order, within 1e-6 relative; dk, dv and the bias's ds equal to the
    bit."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, torch.float32, D, True, "full", 0.1, Tq=333, Tk=200)
    runs = [attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 True, 1024, 0.1) for _ in range(2)]
    torch.cuda.synchronize()
    assert _rel(runs[1][0], runs[0][0]) <= 1e-6
    for i in (1, 2, 3):
        assert torch.equal(runs[1][i], runs[0][i]), i


@pytest.mark.parametrize("layout", ["odd_rows", "unaligned_base"])
def test_f32_fused_backward_copies_what_tma_cannot_address(dev, layout):
    """f32 rows of 37 values (148 bytes) or a base one element past a
    16-byte boundary: the f32 fused pass reads q, k, v and dout by TMA, so
    each is copied into a padded buffer (counted) and the result equals
    the plain version's."""
    g = torch.Generator().manual_seed(9)
    B, H, T = 2, 3, 70
    D = 37 if layout == "odd_rows" else 64
    n = B * H * T * D
    base = torch.randn(4 * n + 1, generator=g).to(dev)
    off = 1 if layout == "unaligned_base" else 0
    q, k, v, do = (base[off + i * n:off + (i + 1) * n].reshape(B, H, T, D)
                   for i in range(4))
    out, lse = attn._flash_forward(q, k, v, None, 0.2, False)
    before = attn.padded_copies
    _fused_against_plain(q, k, v, do, None, None, 0.2, out, lse, False, 0.0)
    assert attn.padded_copies == before + 4


def test_fused_backward_fully_masked_key_tile(dev):
    """Key padding of 100 of 300 keys leaves the kernel's second and third
    128-key blocks of batch 1 fully masked: their dk and dv rows are 0 and
    nothing they add moves dq."""
    case = _backward_case(dev, torch.bfloat16, 64, False, None, 0.1, Tq=300,
                          Tk=300)
    keep = torch.arange(300)[None, :] < torch.tensor([300, 100])[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min)
    bias = bias[:, None, None, :].to(dev, torch.bfloat16)
    q, k, v, do, _, seed, scale, _, _ = case
    out, lse = attn._flash_forward(q, k, v, bias, scale, False, seed, 0.1)
    dq, dk, dv = _fused_against_plain(q, k, v, do, bias, seed, scale, out,
                                      lse, False, 0.1)
    assert dk[1, :, 100:].abs().max().item() == 0.0
    assert dv[1, :, 100:].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_backward_reruns_agree_to_rounding(dev, dtype):
    """The fused kernel adds each key block's share of dq in an order that
    changes from run to run: two runs' f32 accumulators agree to 1e-6
    relative (not necessarily bit for bit); dk and dv are equal."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, 64, False, "keypad", 0.1, Tq=512, Tk=512, B=2, H=4)
    B, H, T, D = q.shape
    delta = (do.float() * out.float()).sum(dim=-1).contiguous()
    lse = lse.reshape(B, H, T).contiguous()
    runs = []
    for _ in range(2):
        acc = attn.dq_accumulator(B, H, T, D, dev)
        dk = torch.empty_like(q)
        dv = torch.empty_like(q)
        attn._launch_bwd("flash_attention_bwd_fused", q, k, v, do, bias, seed,
                         0.1, lse, delta, acc, dk, dv, None, scale, False)
        runs.append((acc, dk, dv))
    torch.cuda.synchronize()
    assert _rel(runs[1][0], runs[0][0]) <= 1e-6
    assert torch.equal(runs[1][1], runs[0][1])
    assert torch.equal(runs[1][2], runs[0][2])


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


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("layout", ["odd_rows", "unaligned_base"])
def test_forward_copies_what_tma_cannot_address(dev, dtype, layout):
    """Rows of 36 16-bit values (72 bytes) or 37 f32 ones (148 bytes), or a
    base one element past a 16-byte boundary: the wrapper copies each such
    operand into a padded buffer (counted), the kernel still runs, and the
    result equals the plain version's; the output is written back into the
    caller's view."""
    g = torch.Generator().manual_seed(9)
    B, H, T = 2, 3, 70
    D = (37 if dtype == torch.float32 else 36) if layout == "odd_rows" \
        else 64
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    base = torch.randn(3 * B * H * T * D + 1, generator=g).to(dev, dtype)
    off = 1 if layout == "unaligned_base" else 0
    q, k, v = (base[off + i * B * H * T * D:off + (i + 1) * B * H * T * D]
               .reshape(B, H, T, D) for i in range(3))
    before = (attn.padded_copies, attn.launches["flash_attention_fwd"])
    out, lse = attn._flash_forward(q, k, v, None, 0.2, False)
    torch.cuda.synchronize()
    assert attn.padded_copies == before[0] + 3
    assert attn.launches["flash_attention_fwd"] == before[1] + 1
    ref, ref_lse = attn.flash_attention_reference(
        q.float(), k.float(), v.float(), None, 0.2, False)
    _close(out, ref, tol, tol, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")
    dest = torch.empty(B * H * T * D + 1, dtype=dtype,
                       device=dev)[1:].reshape(B, H, T, D)
    lse2 = torch.empty(B, H, T, 1, device=dev)
    attn._launch_fwd(q, k, v, None, None, 0.0, dest, lse2, 0.2, False)
    torch.cuda.synchronize()
    assert attn.padded_copies == before[0] + 7
    assert torch.equal(dest, out)


# the f32 forward at head dims up to 256: 3xTF32 on wgmma
# (csrc/flash_attention_wide_wg.cu, wwg::flash_fwd_tf32), two consumer
# warpgroups a block up to D = 128, one above, two slices at 193-256
F32_FWD_DS = [1, 4, 32, 40, 64, 100, 128, 160, 200, 224, 256]


def _f32_forward_case(dev, D, Tq, Tk, bias_kind, seed_val=3):
    g = torch.Generator().manual_seed(seed_val + D)
    B, H = 2, 3
    q = torch.randn(B, H, Tq, D, generator=g).to(dev)
    k = torch.randn(B, H, Tk, D, generator=g).to(dev)
    v = torch.randn(B, H, Tk, D, generator=g).to(dev)
    return q, k, v, _bias(bias_kind, B, H, Tq, Tk, torch.float32, dev, g)


@pytest.mark.parametrize("D", F32_FWD_DS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", (1, 3, 1, 1),
                                       (2, 1, 1, 1), "full"])
def test_f32_forward_matches_plain_and_reruns(dev, D, causal, bias_kind):
    """The f32 forward at Tq = 77 != Tk = 131 against the plain version
    (out 1e-4, lse 1e-3 / 1e-4: TOL_F32), one launch counted; a second run
    equal to the bit (no atomics)."""
    q, k, v, bias = _f32_forward_case(dev, D, 77, 131, bias_kind)
    scale = 1.0 / math.sqrt(D)
    before = attn.launches["flash_attention_fwd"]
    out, lse = attn._flash_forward(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert attn.launches["flash_attention_fwd"] == before + 1
    ref, ref_lse = attn.flash_attention_reference(q, k, v, bias, scale,
                                                  causal)
    _close(out, ref, 1e-4, 1e-4, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")
    again = attn._flash_forward(q, k, v, bias, scale, causal)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("D", [200, 224, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
def test_f32_forward_one_slice_matches_plain(dev, D, causal, bias_kind):
    """Head dims 193-256 where the row blocks fill the card (B, H, Tq = 4,
    8, 300: 160 row blocks): one slice of 7 or 8 output panels, no S
    recomputed, against the plain version; two runs equal to the bit."""
    g = torch.Generator().manual_seed(D)
    B, H, Tq, Tk = 4, 8, 300, 333
    q = torch.randn(B, H, Tq, D, generator=g).to(dev)
    k = torch.randn(B, H, Tk, D, generator=g).to(dev)
    v = torch.randn(B, H, Tk, D, generator=g).to(dev)
    bias = _bias(bias_kind, 2, H, Tq, Tk, torch.float32, dev, g)
    if bias is not None and bias.shape[0] == 2:
        bias = bias.repeat(2, 1, 1, 1)
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, bias, scale, causal)
    ref, ref_lse = attn.flash_attention_reference(q, k, v, bias, scale,
                                                  causal)
    _close(out, ref, 1e-4, 1e-4, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")
    again = attn._flash_forward(q, k, v, bias, scale, causal)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("D", [1, 64, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Tq,Tk", [(1, 1), (1, 200), (200, 1), (130, 64)])
def test_f32_forward_at_one_row_or_key(dev, D, causal, Tq, Tk):
    """Tq = Tk = 1, one query row against many keys, many rows against
    one key, and a block's second warpgroup past Tq (Tq = 130: rows 128-129
    of a 128-row block): the f32 forward against the plain version."""
    q, k, v, bias = _f32_forward_case(dev, D, Tq, Tk, "keypad")
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, bias, scale, causal)
    ref, ref_lse = attn.flash_attention_reference(q, k, v, bias, scale,
                                                  causal)
    _close(out, ref, 1e-4, 1e-4, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")


def _f32_forward_instance(D, B, H, Tq):
    """The flash_fwd_tf32 instance an f32 forward launches: two consumer
    warpgroups up to D = 128; above, one slice of the output panels unless
    the row blocks leave SMs idle at D > 192 (two slices then)."""
    if D <= 128:
        return "<2, 1>"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = D <= 192 or -(-Tq // 64) * H * B >= sms
    P = -(-D // 32)
    if one:
        return "<1, 7>" if P >= 7 else "<1, 4>"
    return "<1, 4>" if P == 8 else "<1, 1>"


@pytest.mark.parametrize("D,B,H,Tq", [(32, 2, 3, 77), (200, 2, 3, 77),
                                      (160, 2, 3, 77), (256, 4, 8, 300),
                                      (224, 2, 3, 77)])
def test_f32_forward_runs_the_3xtf32_kernel(dev, D, B, H, Tq):
    """The profiler's records of an f32 forward (after 16 launches of a
    tiny kernel: a session can lose its first records) name the 3xTF32
    kernel's instance of the shape (two consumer warpgroups, one slice of
    the output panels or two) and no FMA kernel."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(D)
    q = torch.randn(B, H, Tq, D, generator=g).to(dev)
    k = torch.randn(B, H, 131, D, generator=g).to(dev)
    primer = torch.zeros(256, dtype=torch.uint8, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.bitwise_not(primer, out=primer)
        attn._flash_forward(q, k, k, None, 0.125, False)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    want = "flash_fwd_tf32" + _f32_forward_instance(D, B, H, Tq)
    assert any(want in n for n in names), names
    assert not any("flash_fwd_f32<" in n for n in names), names


@pytest.mark.parametrize("D", [1, 40, 128, 200, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_forward_dropout_mask_is_the_plain_mask(dev, D, causal):
    """Dropout 0.1 in the f32 forward against the plain version with the
    same seed: a differing keep bit would move out far past 1e-4."""
    q, k, v, bias = _f32_forward_case(dev, D, 77, 131, None)
    seed = torch.tensor([4321, 17], dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(q, k, v, None, scale, causal, seed, 0.1)
    ref, ref_lse = attn.flash_attention_reference(q, k, v, None, scale,
                                                  causal, seed, 0.1)
    _close(out, ref, 1e-4, 1e-4, "out")
    _close(lse, ref_lse, 1e-3, 1e-4, "lse")
    again = attn._flash_forward(q, k, v, None, scale, causal, seed, 0.1)
    assert torch.equal(again[0], out)


@pytest.mark.parametrize("D", [64, 128])
def test_f32_forward_reads_fused_qkv_without_copies(dev, D):
    """BERT's f32 attention: q, k, v as views of one fused (B, T, 3 H D)
    projection, read where they lie (no copy counted), out in the (B, T,
    H, D) layout, against the plain version."""
    g = torch.Generator().manual_seed(D)
    B, T, H = 2, 128, 12
    qkv = torch.randn(B, T, 3 * H * D, generator=g).to(dev)
    q, k, v = (x.reshape(B, T, H, D) for x in qkv.split(H * D, dim=-1))
    valid = torch.tensor([T, 77], device=dev)
    bias = torch.where(torch.arange(T, device=dev)[None, :] < valid[:, None],
                       0.0, -1e9)[:, None, None, :]
    before = (attn.padded_copies, attn.launches["flash_attention_fwd"])
    out = attn.flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    assert attn.padded_copies == before[0]
    assert attn.launches["flash_attention_fwd"] == before[1] + 1
    ref, _ = attn.flash_attention_reference(
        *(x.transpose(1, 2) for x in (q, k, v)), bias)
    _close(out.transpose(1, 2), ref, 1e-4, 1e-4, "out")


def test_kernel_rejects_what_it_does_not_take(dev):
    x = torch.zeros(1, 8, 2, 16, device=dev)
    with pytest.raises(MXNetError, match="dtype"):
        attn.flash_attention(x, x, x.double())
    # a head dim above 256 runs (the wide kernels), forward and backward,
    # and agrees with the plain version
    g = torch.Generator().manual_seed(288)
    y = torch.randn(1, 8, 2, 288, generator=g).to(dev).requires_grad_(True)
    out = attn.flash_attention(y, y, y)
    ref, _ = attn.flash_attention_reference(*(y.detach().transpose(1, 2),) * 3)
    _close(out.transpose(1, 2), ref, 1e-4, 1e-4, "D=288 forward")
    out.sum().backward()
    yr = y.detach().clone().requires_grad_(True)
    want, _ = attn.flash_attention_reference(*(yr.transpose(1, 2),) * 3)
    want.sum().backward()
    assert _rel(y.grad, yr.grad) <= 1e-4
    y = torch.zeros(1, 8, 2, 160, device=dev, requires_grad=True)
    attn.flash_attention(y, y, y).sum().backward()   # the pair takes it
    assert y.grad.shape == y.shape
    with pytest.raises(MXNetError, match="contiguous"):
        z = torch.zeros(1, 8, 16, 2, device=dev).transpose(-1, -2)
        attn.flash_attention(z, z, z)
    with pytest.raises(MXNetError, match="one CUDA device"):
        attn.flash_attention(x, x, x.cpu())
    with pytest.raises(MXNetError, match="seed"):
        xs = x.transpose(1, 2)
        attn._flash_forward(xs, xs, xs, None, 0.25, False,
                            torch.zeros(2, dtype=torch.int32), 0.1)


# ---------------------------------------------- heads wider than 256 (C8)
# 16-bit heads take the tiled wgmma forward and dq
# (csrc/flash_attention_wide_wg.cu) and dk / dv
# (csrc/flash_attention_wide_dkv.cu), all three streaming the head dim above
# 512 (D = 300 through copies TMA can address); f32 heads the 3xTF32
# forward and dq (csrc/flash_attention_wide_wg.cu) and the 3xTF32 dk / dv
# (csrc/flash_attention_bwd.cu, tf::bwd_dkv_tf32_st)
WIDE_DS = [264, 288, 300, 320, 384, 512, 576, 1024]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", WIDE_DS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full", (2, 1, 1, 1)])
def test_wide_forward_matches_plain(dev, dtype, D, causal, bias_kind):
    """The wide forward (D > 256) against the plain version at Tq != Tk:
    out at atol=rtol 2e-2 in 16 bits and 1e-4 in f32, lse 1e-3 / 1e-4 (f32:
    1e-4 / 1e-4, the 3xTF32 forward's products to about f32's)."""
    g = torch.Generator().manual_seed(D)
    B, H, Tq, Tk = 2, 3, 77, 131
    q = torch.randn(B, H, Tq, D, generator=g).to(dev, dtype)
    k, v = (torch.randn(B, H, Tk, D, generator=g).to(dev, dtype)
            for _ in range(2))
    bias = _bias(bias_kind, B, H, Tq, Tk, dtype, dev, g)
    scale = 1.0 / math.sqrt(D)
    before = dict(attn.launches)
    out, lse = attn._flash_forward(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert {n: attn.launches[n] - before[n] for n in attn.KERNELS} == {
        n: int(n == "flash_attention_wide_fwd") for n in attn.KERNELS}
    ref, ref_lse = attn.flash_attention_reference(
        q.float(), k.float(), v.float(), bias, scale, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    _close(out, ref, tol, tol, "out")
    _close(lse, ref_lse, 1e-4 if dtype == torch.float32 else 1e-3, 1e-4,
           "lse")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", WIDE_DS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wide_backward_matches_plain(dev, dtype, D, causal, bias_kind, rate):
    """dq, dk, dv (and a learned bias's gradient from the ds the wide dq
    kernel writes) of the wide pair against the plain backward on the same
    inputs and dropout mask, relative 2e-2 in 16 bits and 1e-4 in f32, at
    Tq != Tk; the forward with dropout against the plain one (a differing
    keep bit would move out past the tolerance); two runs equal to the
    bit."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, causal, bias_kind, rate, Tq=70, Tk=45)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    ref, _ = attn.flash_attention_reference(
        q.float(), k.float(), v.float(), bias, scale, causal, seed, rate)
    _close(out, ref, tol, tol, "out")
    assert attn.backward_route(D, k.shape[2], 1024) == "wide"
    before = dict(attn.launches)
    bias_grad = bias_kind == "full"
    runs = [attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 causal, 1024, rate, bias_grad=bias_grad)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: attn.launches[n] - before[n] for n in attn.KERNELS} == {
        n: 2 * (n in ("flash_attention_wide_dq", "flash_attention_wide_dkv"))
        for n in attn.KERNELS}
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)
    dq, dk, dv, db = runs[0]
    rq, rk, rv, rds = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal, bias_grad)
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        assert _rel(got, want) <= tol, f"{name}: {_rel(got, want):.3e}"
    if bias_grad:
        want = rds.sum(dim=0, keepdim=True)
        assert db.shape == bias.shape
        assert _rel(db, want) <= tol, f"dbias: {_rel(db, want):.3e}"
    else:
        assert db is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("D", WIDE_DS)
def test_wide_dropout_masks_are_the_plain_mask(dev, dtype, D):
    """The wide forward's mask (v the identity over Tk = D keys) and the
    wide pair's (through dv and a learned bias's ds,
    chip_smoke.pair_dropout_masks) equal dropout_keep_reference's bit for
    bit."""
    got, want = cs.wide_mask_probe(torch, dev, attn, dtype, D)
    from_dkv, from_dq, want_pair = cs.pair_dropout_masks(torch, attn, dev,
                                                         dtype, D)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(from_dkv, want_pair)
    assert torch.equal(from_dq, want_pair)


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("D,Tq,Tk", [(264, 333, 200), (384, 130, 257),
                                     (448, 333, 100), (512, 64, 100),
                                     (512, 100, 333), (530, 77, 131),
                                     (640, 200, 96), (1024, 130, 257),
                                     (1280, 70, 130)])
def test_wide_tiled_reruns_equal_to_the_bit(dev, dtype, D, Tq, Tk):
    """Two runs of the tiled wide forward, dq and dk / dv on the same
    inputs give the same bits for out, lse, dq, dk, dv and a learned
    bias's ds (no atomics: each sum runs in one order), causal, ragged
    (Tk > Tq leaves key blocks no query sees: dk and dv 0 there), dropout
    0.1, at the padded head dims 320 to 512 (dk / dv split by slices up to
    384, by roles above) and at 530 to 1280, where all three stream the
    head dim (each slice of an output recomputes the scores; slice 0 writes
    lse and ds; at 1280 the forward streams q too) and dk / dv are the
    tiled kernel's; in f32 the 3xTF32 forward and dq (their slices
    recomputing the scores at every D) beside the 3xTF32 dk / dv (the head
    dim streamed, dv and dk blocks by slices); dk and dv within relative
    2e-2 (f32: 1e-4) of the plain backward."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, True, "full", 0.1, Tq=Tq, Tk=Tk)
    route = attn.head_dim_route(D, dtype)
    assert route == ("wide_f32" if dtype == torch.float32
                     else "wide_wg" if D <= 512 else "wide_stream")
    assert attn._source("flash_attention_wide_dkv", dtype)[0] == (
        "flash_attention_bwd" if dtype == torch.float32
        else "flash_attention_wide_dkv")
    assert attn._source("flash_attention_wide_fwd", dtype)[0] == \
        attn._source("flash_attention_wide_dq", dtype)[0] == \
        "flash_attention_wide_wg"
    again = attn._flash_forward(q, k, v, bias, scale, True, seed, 0.1)
    runs = [attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 True, 1024, 0.1) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    for i in range(4):                                  # dq, dk, dv, dbias
        assert torch.equal(runs[0][i], runs[1][i]), i
    _, rk, rv, _ = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, 0.1, out, lse, do, scale, True, False)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, got, want in (("dk", runs[0][1], rk), ("dv", runs[0][2], rv)):
        assert _rel(got, want) <= tol, f"{name}: {_rel(got, want):.3e}"


@pytest.mark.parametrize("D", [264, 320, 576, 1280])
@pytest.mark.parametrize("causal,bias_kind,rate", [
    (True, "keypad", 0.1), (False, "full", 0.1), (True, None, 0.0)])
def test_f32_wide_dq_matches_plain_and_reruns(dev, D, causal, bias_kind,
                                              rate):
    """The f32 wide dq (3xTF32 on wgmma, wwg::wide_dq_tf32; slices of up to
    six 32-column panels, each recomputing the scores) at D = 264 to 1280,
    Tq != Tk: dq and a learned bias's gradient within relative 1e-4 of the
    plain backward, two runs equal to the bit."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, torch.float32, D, causal, bias_kind, rate, Tq=150, Tk=97)
    bias_grad = bias_kind == "full"
    runs = [attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 causal, 1024, rate, bias_grad=bias_grad)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)
    rq, _, _, rds = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal, bias_grad)
    assert _rel(runs[0][0], rq) <= 1e-4, f"dq: {_rel(runs[0][0], rq):.3e}"
    if bias_grad:
        want = rds.sum(dim=0, keepdim=True)
        assert _rel(runs[0][3], want) <= 1e-4


# the f32 pair on 3xTF32 at every head dim: dq wwg::wide_dq_tf32, dk / dv
# tf::bwd_dkv_tf32 (D <= 128) and tf::bwd_dkv_tf32_st (above)
F32_PAIR_DS = [32, 40, 64, 100, 128, 160, 200, 256, 264, 320, 576, 1280]


def _pair_names(D):
    return (("flash_attention_wide_dq", "flash_attention_wide_dkv") if D > 256
            else ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"))


@pytest.mark.parametrize("D", F32_PAIR_DS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", [None, "keypad", "full"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_f32_pair_matches_plain_and_reruns(dev, D, causal, bias_kind, rate):
    """The f32 dq / dk / dv pair (block_k 64 < Tk; the wide pair above 256)
    at Tq != Tk: dq, dk, dv and a learned bias's gradient (the ds the dq
    kernel writes) within relative 1e-4 of the plain backward on the same
    dropout mask; one launch of each kernel a call; two runs equal to the
    bit (no atomics)."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, torch.float32, D, causal, bias_kind, rate)
    names = _pair_names(D)
    bias_grad = bias_kind == "full"
    before = dict(attn.launches)
    runs = [attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                                 causal, 64, rate, bias_grad=bias_grad)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: attn.launches[n] - before[n] for n in attn.KERNELS} == {
        n: 2 * (n in names) for n in attn.KERNELS}
    for a, b in zip(*runs):
        assert (a is None and b is None) or torch.equal(a, b)
    dq, dk, dv, db = runs[0]
    rq, rk, rv, rds = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, rate, out, lse, do, scale, causal, bias_grad)
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all(), name
        assert _rel(got, want) <= 1e-4, f"{name}: {_rel(got, want):.3e}"
    if bias_grad:
        want = rds.sum(dim=0, keepdim=True)
        assert _rel(db, want) <= 1e-4, f"dbias: {_rel(db, want):.3e}"


@pytest.mark.parametrize("D", [32, 100, 160, 200])
def test_f32_pair_dropout_masks_are_the_plain_mask(dev, D):
    """The masks the f32 dk / dv (through dv) and dq (through a learned
    bias's ds) draw equal dropout_keep_reference's bit for bit, at head
    dims on the walk (32, 100) and on the streamed walk (160, 200)."""
    from_dkv, from_dq, want = cs.pair_dropout_masks(torch, attn, dev,
                                                    torch.float32, D)
    torch.cuda.synchronize()
    assert torch.equal(from_dkv, want)
    assert torch.equal(from_dq, want)


@pytest.mark.parametrize("D", [64, 160, 320])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_pair_at_one_key(dev, D, causal):
    """Tq = Tk = 1 through the f32 pair (block_k 0 forces it at D = 64):
    one key gives p = 1 and out = v, so dp = delta and ds = 0, dq and dk
    are 0 and both versions give rounding noise of dp - delta. So dv is
    held to the plain version and dq, dk to the rounding bound of ds,
    |ds| <= 2**-17 sum|dout v| / (1 - rate), times scale |k| (|q|),
    element by element (test_fused_backward_ragged_and_cross_lengths)."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, torch.float32, D, causal, "keypad", 0.1, Tq=1, Tk=1)
    before = dict(attn.launches)
    dq, dk, dv, _ = attn._flash_backward(q, k, v, bias, seed, out, lse, do,
                                         scale, causal, 0, 0.1,
                                         bias_grad=False)
    torch.cuda.synchronize()
    assert {n: attn.launches[n] - before[n] for n in attn.KERNELS} == {
        n: int(n in _pair_names(D)) for n in attn.KERNELS}
    want = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, 0.1, out, lse, do, scale, causal, False)
    assert _rel(dv, want[2]) <= 1e-4
    ds = (do.abs() * v.abs()).sum(-1, keepdim=True) / 0.9 * 2.0 ** -17
    assert (dq.abs() <= ds * scale * k.abs() * 1.001).all()
    assert (dk.abs() <= ds * scale * q.abs() * 1.001).all()


@pytest.mark.parametrize("D,copies", [(65, 4), (100, 0), (130, 4),
                                      (257, 4), (530, 4), (320, 0)])
def test_f32_pair_copies_what_tma_cannot_address(dev, D, copies):
    """Both kernels of the f32 pair read q, k, v and dout by TMA, so rows
    that are not a multiple of 16 bytes (D not a multiple of 4: 65, 130,
    257, 530) are copied once for both (counted), the rest read in place;
    one launch of each, dq, dk, dv within 1e-4 of the plain backward."""
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, torch.float32, D, False, "keypad", 0.0, Tq=40, Tk=72)
    before = (dict(attn.launches), attn.padded_copies)
    got = attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale,
                               False, 64, 0.0)
    torch.cuda.synchronize()
    assert attn.padded_copies - before[1] == copies
    assert {n: attn.launches[n] - before[0][n] for n in attn.KERNELS} == {
        n: int(n in _pair_names(D)) for n in attn.KERNELS}
    want = attn.flash_attention_backward_reference(
        q, k, v, bias, seed, 0.0, out, lse, do, scale, False, False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= 1e-4, f"{name}: {_rel(g, w):.3e}"


@pytest.mark.parametrize("dtype,D,route,fwd_copies,bwd_copies", [
    (torch.bfloat16, 300, "wide_wg", 3, 4),
    (torch.float16, 320, "wide_wg", 0, 0),
    (torch.float32, 300, "wide_f32", 0, 0),
    (torch.bfloat16, 520, "wide_stream", 0, 0),
    (torch.bfloat16, 530, "wide_stream", 3, 4),
    (torch.float32, 576, "wide_f32", 0, 0),
    (torch.float32, 530, "wide_f32", 3, 4),
    (torch.float32, 257, "wide_f32", 3, 4)])
def test_wide_launch_and_copy_counts(dev, dtype, D, route, fwd_copies,
                                     bwd_copies):
    """Launches and copies of the wide route, contiguous (B, H, T, D)
    operands: a head dim whose rows are not a multiple of 16 bytes (16-bit
    D not a multiple of 8, f32 D not a multiple of 4) gives rows TMA cannot
    address, so the tiled forward (the f32 one too) copies q, k, v and a
    backward pair with a TMA kernel (16-bit, and f32 with its 3xTF32 dq)
    q, k, v and dout, once for both kernels (counted in
    ``padded_copies``). One launch of each wide kernel per call, nothing
    else."""
    assert attn.head_dim_route(D, dtype) == route
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, False, "keypad", 0.0, Tq=40, Tk=72)
    before = (dict(attn.launches), attn.padded_copies)
    out2, _ = attn._flash_forward(q, k, v, bias, scale, False)
    torch.cuda.synchronize()
    assert attn.padded_copies - before[1] == fwd_copies
    assert torch.equal(out2, out)
    mid = (dict(attn.launches), attn.padded_copies)
    attn._flash_backward(q, k, v, bias, seed, out, lse, do, scale, False,
                         1024, 0.0)
    torch.cuda.synchronize()
    assert attn.padded_copies - mid[1] == bwd_copies
    assert {n: attn.launches[n] - before[0][n] for n in attn.KERNELS} == {
        n: int(n.startswith("flash_attention_wide")) for n in attn.KERNELS}


_TILED = (r"wwg::wide_fwd_wg<", r"wwg::wide_dq_wg<", r"wdkv::wide_dkv_wg<")
_STREAMED = (r"wwg::wide_fwd_st<", r"wwg::wide_dq_st<", r"wdkv::wide_dkv_st<")
_F32 = (r"wwg::wide_fwd_tf32\b", r"wwg::wide_dq_tf32\b",
        r"tf::bwd_dkv_tf32_st\b")


@pytest.mark.parametrize("dtype,D,patterns", [
    (torch.bfloat16, 320, _TILED),
    (torch.float32, 320, _F32),
    (torch.bfloat16, 576, _STREAMED),
    (torch.float16, 1024, _STREAMED),
    (torch.bfloat16, 2048, _STREAMED),
    (torch.float32, 576, _F32),
    (torch.float32, 1024, _F32)])
def test_wide_route_runs_its_kernels(dev, dtype, D, patterns):
    """The profiler's kernel names on each wide route, one kernel of each
    of the forward, dq and dk / dv and no other wide one: at D = 320 the
    tiled wgmma kernels for bf16, above 512 the streamed ones for 16 bits
    and for f32 at every D the 3xTF32 forward, dq and dk / dv; no
    warp-a-row kernel (namespace ``wide::``, gone) at any dtype."""
    import re
    from torch.profiler import ProfilerActivity, profile
    q, k, v, do, bias, seed, scale, out, lse = _backward_case(
        dev, dtype, D, True, None, 0.0, Tq=64, Tk=64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.primer()
        attn._flash_forward(q, k, v, None, scale, True)
        attn._flash_backward(q, k, v, None, seed, out, lse, do, scale, True,
                             1024, 0.0)
        torch.cuda.synchronize()
    names = [n for n in cs.kernel_counts(prof)
             if re.search(r"wide|tf32", n)]
    for pattern in patterns:
        assert sum(bool(re.search(pattern, n)) for n in names) == 1, (
            pattern, names)
    assert all(any(re.search(p, n) for p in patterns) for n in names), names
    assert not any(re.search(r"\bwide::", n) for n in names), names


def test_wide_autograd_reads_bthd_views(dev):
    """Heads of 288 from one fused QKV projection through
    ``flash_attention`` under autograd: one launch of each wide kernel,
    no operand copied, the gradient of the projection against the plain
    version's (bf16, relative 2e-2)."""
    g = torch.Generator().manual_seed(11)
    B, T, Hh, Dd = 2, 96, 3, 288
    base = torch.randn(B, T, 3 * Hh * Dd, generator=g).to(dev, torch.bfloat16)
    grads = []
    for kernel in (True, False):
        x = base.clone().requires_grad_(True)
        q, k, v = (t.reshape(B, T, Hh, Dd) for t in x.split(Hh * Dd, -1))
        before = (dict(attn.launches), attn.padded_copies)
        if kernel:
            out = attn.flash_attention(q, k, v, causal=True)
        else:
            out, _ = attn.flash_attention_reference(
                *(t.float().transpose(1, 2) for t in (q, k, v)), causal=True)
            out = out.transpose(1, 2)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        if kernel:
            assert attn.padded_copies == before[1]
            assert {n: attn.launches[n] - before[0][n]
                    for n in attn.KERNELS} == {
                n: int(n.startswith("flash_attention_wide"))
                for n in attn.KERNELS}
        grads.append(x.grad)
    assert _rel(grads[0], grads[1]) <= 2e-2


# ------------------------------------------------------- conv1x1 kernels
CONV_REL = {torch.bfloat16: {"fwd": 1e-2, "dgrad": 1e-4, "wgrad": 1e-2},
            torch.float16: {"fwd": 1e-2, "dgrad": 1e-4, "wgrad": 1e-4},
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


def _backward_match(x, w, dy, s, t, relu, dtype):
    """dgrad and wgrad on the card against their plain versions: f32 sums
    of exact products for dgrad; wgrad at the bf16 limit for bf16 (f(x)
    rounded to bf16 in both) and at the f32 one for fp16 (f(x) kept to
    about 2^-22 as fp16 hi + lo, against f32 f(x) in the plain version)."""
    before = dict(cf.launches)
    got = {"dgrad": cf._dgrad(x, s, t, w, dy, relu),
           "wgrad": cf._wgrad(x, s, t, dy, relu, dtype)}
    torch.cuda.synchronize()
    assert {k: cf.launches[f"conv1x1_{k}"] - before[f"conv1x1_{k}"]
            for k in got} == {"dgrad": 1, "wgrad": 1}
    want = {"dgrad": cf.conv1x1_dgrad_reference(x, s, t, w, dy, relu),
            "wgrad": cf.conv1x1_wgrad_reference(x, s, t, dy, relu, dtype)}
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.isfinite(got[k]).all()
        lim = CONV_REL[dtype][k]
        assert _rel(got[k], want[k]) <= lim, f"{k}: {_rel(got[k], want[k]):.3e}"


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("Ci,Co,M", [(256, 1024, 196), (512, 2048, 49),
                                     (1024, 256, 196), (2048, 512, 49)])
def test_conv_backward_kernels_at_resnet_batch(dev, dtype, Ci, Co, M):
    """dgrad and wgrad at N=128 on the junctions whose rows are not 16-byte
    aligned: dgrad's bulk copies of whole channel runs, wgrad's 8-byte
    cp.async (M=196) or cp.async.bulk runs (M=49)."""
    affine = Ci < Co
    x, w, dy, s, t, _ = _conv_case(dev, dtype, 128, Ci, Co, M, affine, False)
    assert cf.conv1x1_plan("dgrad", 128, Ci, Co, M, dtype)["mode"] == "runs"
    assert cf.conv1x1_plan("wgrad", 128, Ci, Co, M, dtype)["mode"] == \
        ("rows8" if M == 196 else "runs")
    _backward_match(x, w, dy, s, t, True, dtype)


RESNET_JUNCTIONS = [(64, 256, 3136), (128, 512, 784), (256, 1024, 196),
                    (512, 2048, 49), (256, 64, 3136), (512, 128, 784),
                    (1024, 256, 196), (2048, 512, 49)]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("Ci,Co,M", RESNET_JUNCTIONS)
@pytest.mark.parametrize("affine,bias", [(True, True), (True, False),
                                         (False, True), (False, False)])
def test_conv_fwd_and_dgrad_at_resnet_junctions(dev, dtype, Ci, Co, M,
                                                affine, bias):
    """fwd and dgrad on their copy ring at ResNet-50's eight b128
    junctions (TMA rows and stores at M = 3136, 784; bulk runs and the
    threads' stores at 196, 49), affine or relu-only, with and without
    bias; each launch moves its counter by one."""
    x, w, dy, s, t, b = _conv_case(dev, dtype, 128, Ci, Co, M, affine, bias)
    for kind in ("fwd", "dgrad"):
        assert cf.conv1x1_plan(kind, 128, Ci, Co, M, dtype)["mode"] == \
            ("tma" if M % 8 == 0 else "runs")
    before = dict(cf.launches)
    got = {"fwd": cf._fwd(x, s, t, w, True, b),
           "dgrad": cf._dgrad(x, s, t, w, dy, True)}
    torch.cuda.synchronize()
    assert {k: cf.launches[f"conv1x1_{k}"] - before[f"conv1x1_{k}"]
            for k in got} == {"fwd": 1, "dgrad": 1}
    want = {"fwd": cf.conv1x1_fwd_reference(x, s, t, w, True, b),
            "dgrad": cf.conv1x1_dgrad_reference(x, s, t, w, dy, True)}
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.isfinite(got[k]).all()
        assert _rel(got[k], want[k]) <= CONV_REL[dtype][k], \
            f"{k}: {_rel(got[k], want[k]):.3e}"


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("N,Ci,Co,M,mode", [
    (3, 64, 128, 50, "runs"),          # 4-byte rows
    (2, 64, 72, 67, "general"),        # 2-byte rows, M > 64
    (5, 48, 40, 12, "rows8"),          # 8-byte rows
    (4, 72, 136, 23, "runs"),          # runs with ragged channel tiles
    (3, 45, 77, 53, "general"),        # channels not multiples of 8
    (2, 130, 24, 64, "rows16")])       # a second channel tile of 2
def test_conv_backward_kernels_on_every_staging_path(dev, dtype, N, Ci, Co,
                                                     M, mode):
    x, w, dy, s, t, _ = _conv_case(dev, dtype, N, Ci, Co, M, True, False)
    assert cf.conv1x1_plan("wgrad", N, Ci, Co, M, dtype)["mode"] == mode
    for relu in (True, False):
        _backward_match(x, w, dy, s, t, relu, dtype)


def test_conv_backward_kernels_take_an_unaligned_x(dev):
    """x a contiguous slice at an odd storage offset: the general path."""
    N, Ci, Co, M = 2, 64, 128, 196
    x, w, dy, s, t, _ = _conv_case(dev, torch.bfloat16, N, Ci, Co, M, True,
                                   False)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xu = flat[1:].view(N, Ci, M)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 != 0
    assert cf.conv1x1_plan("dgrad", N, Ci, Co, M, x.dtype,
                           cf._align(xu, w, dy))["mode"] == "general"
    _backward_match(xu, w, dy, s, t, True, torch.bfloat16)


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


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("N,Ci,Co,M", [(2, 64, 256, 3136), (2, 128, 64, 784),
                                       (4, 256, 128, 196), (8, 128, 256, 49),
                                       (3, 45, 77, 53)])
def test_conv_dgrad_mask_is_bit_exact_on_every_staging_path(dev, dtype, N,
                                                            Ci, Co, M):
    """With W = dy = 1 every kept sum is Co, exact in f32: dgrad must give
    Co * [x * scale + shift > 0] to the bit on every copy path (TMA rows,
    the mask from the x fill; bulk runs at M = 196 and 49, the mask in the
    threads' stores; the general path)."""
    x, w, dy, s, t, _ = _conv_case(dev, dtype, N, Ci, Co, M, True, False)
    da = cf._dgrad(x, s, t, torch.ones_like(w), torch.ones_like(dy), True)
    keep = cf._prologue(x, s, t, False) > 0
    assert torch.equal(da, keep.float() * Co)


def test_conv_fwd_takes_an_unaligned_x(dev):
    """x a contiguous slice at an odd storage offset: fwd's general path,
    f(x) rounded to bf16 once, the output once."""
    N, Ci, Co, M = 2, 64, 128, 196
    x, w, _, s, t, b = _conv_case(dev, torch.bfloat16, N, Ci, Co, M, True,
                                  True)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    xu = flat[1:].view(N, Ci, M)
    xu.copy_(x)
    assert cf.conv1x1_plan("fwd", N, Ci, Co, M, x.dtype,
                           cf._align(xu, w))["mode"] == "general"
    got = cf._fwd(xu, s, t, w, True, b)
    want = cf.conv1x1_fwd_reference(x, s, t, w, True, b)
    assert _rel(got, want) <= CONV_REL[torch.bfloat16]["fwd"]


@pytest.mark.parametrize("N,Ci,Co,M", [(16, 64, 256, 3136),
                                       (128, 256, 1024, 196),
                                       (128, 512, 2048, 49)])
def test_conv_wgrad_is_the_same_from_run_to_run(dev, N, Ci, Co, M):
    x, _, dy, s, t, _ = _conv_case(dev, torch.bfloat16, N, Ci, Co, M,
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
    grads = [p.data().grad for p in net.collect_params().values()]
    assert all(torch.isfinite(g).all() for g in grads if g is not None)


# ---------------------------------------------------------------------------
# BatchNorm's training kernels
# ---------------------------------------------------------------------------

# ResNet-50's BatchNorm shapes (C, H*W) at 224x224, and the NHWC / 2-d cases
RESNET_BN = [(64, 12544), (64, 3136), (256, 3136), (128, 784), (512, 784),
             (256, 196), (1024, 196), (512, 49), (2048, 49)]


def _bn_case(dev, dtype, outer, C, inner, mean=3.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(outer, C, inner, device=dev, generator=g) * 2 + mean)
    s = x.mean(dim=(0, 2)) + 0.1 * torch.randn(C, device=dev, generator=g)
    return dict(
        x=x.to(dtype), dy=torch.randn(outer, C, inner, device=dev,
                                      generator=g).to(dtype),
        s=s.float(), g=torch.rand(C, device=dev, generator=g) + 0.5,
        b=torch.randn(C, device=dev, generator=g),
        dm=torch.randn(C, device=dev, generator=g),
        dv=torch.randn(C, device=dev, generator=g))


def _bn_check(c):
    x, dy = c["x"], c["dy"]
    for centered in (False, True):
        shift = c["s"] if not centered else \
            bn.bn_stats_reference(x, None, 1e-5)[0]
        got = bn._stats(x, shift, 1e-5, centered)
        want = bn.bn_stats_reference(x, shift, 1e-5, centered)
        # the mean's error relative to the batch's standard deviation
        assert ((got[0] - want[0]).norm() / want[1].sqrt().norm()).item() \
            <= 1e-5, centered
        for name, a, b in zip(("var", "inv"), got[1:], want[1:]):
            assert _rel(a, b) <= 1e-5, (name, centered)
    mean, _, inv = want
    assert torch.equal(bn._apply(x, mean, inv, c["g"], c["b"]),
                       bn.bn_apply_reference(x, mean, inv, c["g"], c["b"]))
    dg, db = bn._bwd_reduce(x, dy, mean, inv)
    dgr, dbr = bn.bn_bwd_reduce_reference(x, dy, mean, inv)
    assert _rel(dg, dgr) <= 1e-5 and _rel(db, dbr) <= 1e-5
    for args in ((dy, inv, c["g"], dgr, dbr, c["dm"], c["dv"]),
                 (dy, inv, c["g"], dgr, dbr, None, None),
                 (None, None, None, None, None, c["dm"], c["dv"])):
        a = (x, args[0], mean) + args[1:]
        assert torch.equal(bn._bwd_apply(*a), bn.bn_bwd_apply_reference(*a))
    # the same from run to run, to the bit
    assert torch.equal(bn._stats(x, c["s"], 1e-5, False)[1],
                       bn._stats(x, c["s"], 1e-5, False)[1])
    assert torch.equal(bn._bwd_reduce(x, dy, mean, inv)[0], dg)


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("C,M", RESNET_BN)
def test_bn_kernels_at_resnet50_shapes(dev, dtype, C, M):
    _bn_check(_bn_case(dev, dtype, 16, C, M))


@pytest.mark.parametrize("dtype", HALF + (torch.float32,))
@pytest.mark.parametrize("outer,C,inner", [
    (8 * 28 * 28, 512, 1),      # NHWC (axis -1)
    (4096, 1024, 1),            # 2-d (N, C)
    (3, 77, 53), (5, 45, 300), (7, 13, 1), (2, 2050, 1), (6, 30, 98),
    (3, 6, 260), (4, 9, 12)])
def test_bn_kernels_nhwc_2d_and_ragged(dev, dtype, outer, C, inner):
    _bn_check(_bn_case(dev, dtype, outer, C, inner))


# the two reductions (bn_reduce_plan): DCGAN's shapes at B = 64 (f32), the
# second level (few channels, large images), one image, one channel
BN_REDUCE_CASES = [
    (64, 512, 16, torch.float32), (64, 256, 64, torch.float32),
    (64, 128, 256, torch.float32), (64, 64, 1024, torch.float32),
    (32, 3, 50176, torch.bfloat16), (16, 16, 12544, torch.float16),
    (1, 7, 300, torch.float32), (1, 64, 49, torch.bfloat16),
    (1, 1, 4096, torch.float32), (64, 1, 1024, torch.float32),
    (256, 1, 12, torch.bfloat16), (4096, 1, 1, torch.float16)]


@pytest.mark.parametrize("outer,C,inner,dtype", BN_REDUCE_CASES)
def test_bn_reductions_one_launch(dev, outer, C, inner, dtype):
    """Each reduction held to its plain version (the four kernels through
    ``_bn_check``); a call launches the reduction kernel once and no
    memset (the profiler's records, after 16 launches of a tiny kernel: a
    session can lose its first records, and one that kept none of the
    kernel's is taken again) and moves its counter by one; a
    third call equals the first to the bit (the second level's counters
    are back at 0)."""
    from torch.profiler import ProfilerActivity, profile
    c = _bn_case(dev, dtype, outer, C, inner)
    _bn_check(c)
    x, dy = c["x"], c["dy"]
    mean, _, inv = bn.bn_stats_reference(x, c["s"], 1e-5)
    calls = {"bn_stats": lambda: bn._stats(x, c["s"], 1e-5, False),
             "bn_bwd_reduce": lambda: bn._bwd_reduce(x, dy, mean, inv)}
    for name, fn in calls.items():
        first = fn()
        for _ in range(3):      # a session that lost the record: again
            before = bn.launches[name]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                cs.primer()
                second = fn()
                torch.cuda.synchronize()
            counts = cs.kernel_counts(prof)
            n = sum(v for k, v in counts.items()
                    if cs.re.search(cs.BN_KERNEL[name], k))
            assert n <= 1, counts
            assert not any("memset" in k.lower() for k in counts), counts
            assert bn.launches[name] == before + 1
            if n == 1:
                break
        assert n == 1, counts
        third = fn()
        for a, b, d in zip(first, second, third):
            assert torch.equal(a, b) and torch.equal(a, d), name
    if (outer, C, inner) in ((32, 3, 50176), (16, 16, 12544),
                             (64, 1, 1024)):
        assert bn._reduce_plan_of(x, dy)["splits"] > 1


def test_bn_second_level_in_two_graphs_on_two_streams(dev):
    """Two hybridized BatchNorm layers at a second-level shape (bf16 (32,
    3, 224 x 224)), each captured in its own graph, replayed on two
    streams at once, twice: each graph holds its own counters, so every
    replay's output equals an eager call of its layer to the bit."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.block import Block
    g = torch.Generator().manual_seed(0)
    xs = [(torch.randn(32, 3, 224, 224, generator=g) * 2 + k).to(
        dev, torch.bfloat16) for k in (0, 1)]
    assert bn._reduce_plan_of(xs[0].view(32, 3, -1))["splits"] > 1
    nets = []
    for x in xs:
        net = nn.BatchNorm(in_channels=3)
        net.initialize(device=dev)
        net.cast("bfloat16")
        net.hybridize()
        for _ in range(2):      # the warm-up (centered), the capture
            with tmx.autograd.record():
                net(x)
        assert sum(1 for v in net._cached_graph.values()
                   if v is not True) == 1
        nets.append(net)
    streams = [torch.cuda.Stream(dev) for _ in nets]
    for _ in range(2):
        torch.cuda.synchronize()
        got = []
        for net, x, s in zip(nets, xs, streams):
            with torch.cuda.stream(s), tmx.autograd.record():
                got.append(net(x).detach().clone())
        torch.cuda.synchronize()
        for net, x, out in zip(nets, xs, got):
            with tmx.autograd.record():
                want = Block.__call__(net, x).detach()
            assert torch.equal(out, want)


def test_bn_kernels_large_mean(dev):
    """An input mean of 100 (std 2): shifted statistics about a shift near
    it, and centered ones."""
    _bn_check(_bn_case(dev, torch.bfloat16, 64, 64, 784, mean=100.0))


def test_bn_autograd_through_kernels_equals_plain(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 24, 7, 7, generator=g) * 2 + 1
    gm, b = torch.rand(24, generator=g) + 0.5, torch.randn(24, generator=g)
    s = torch.randn(24, generator=g)

    def grads(where):
        leaves = [v.to(where).requires_grad_(True) for v in (x, gm, b)]
        out, m, v = bn.batch_norm_train(*leaves, s.to(where), 1e-5, False, 1)
        (torch.sin(out).sum() + m.sum() + (v * 2).sum()).backward()
        return [out.detach().cpu()] + [t.grad.cpu() for t in leaves]

    for got, want in zip(grads(dev), grads("cpu")):
        assert _rel(got, want) <= 1e-5


def test_bn_kernels_reject_what_they_do_not_take(dev):
    c = _bn_case(dev, torch.float32, 2, 8, 10)
    with pytest.raises(MXNetError, match="dtype"):
        bn._stats(c["x"].double(), c["s"], 1e-5, False)
    with pytest.raises(MXNetError, match="dtype"):
        bn.batch_norm_train(c["x"].double().reshape(2, 8, 10), c["g"],
                            c["b"], c["s"])
    with pytest.raises(MXNetError, match="float32"):
        bn._apply(c["x"], c["s"].half(), c["s"], c["g"], c["b"])
    with pytest.raises(MXNetError, match="one CUDA device"):
        bn._bwd_reduce(c["x"], c["dy"], c["s"].cpu(), c["s"])
    with pytest.raises(MXNetError, match="shapes"):
        bn._apply(c["x"], c["s"][:4], c["s"], c["g"], c["b"])


@pytest.mark.parametrize("fuse,want", [
    ("0", {"bn_stats": 53, "bn_apply": 53, "bn_bwd_reduce": 53,
           "bn_bwd_apply": 53}),
    ("1", {"bn_stats": 53, "bn_apply": 37, "bn_bwd_reduce": 37,
           "bn_bwd_apply": 53})])
def test_resnet50_step_launches_each_bn_kernel(dev, fuse, want, monkeypatch):
    """ResNet-50 v1's 53 BatchNorm layers (B=2, 64x64, bf16): the virgin
    first step takes centered statistics (bn_stats twice a layer); the
    next, each layer's statistics, apply and backward once, except that
    the 16 fused junctions take only the statistics and their backward."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    monkeypatch.setenv("MXNET_FUSE_BN_CONV", fuse)
    net = get_model("resnet50_v1", device=dev)
    net.initialize(generator=torch.Generator().manual_seed(0), device=dev)
    net.cast("bfloat16")
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    for step in range(2):
        before = dict(bn.launches)
        with autograd.record():
            out = net(x.to(dev, torch.bfloat16))
        autograd.backward(out.float().square().mean())
        torch.cuda.synchronize()
        moved = {k: bn.launches[k] - before[k] for k in bn.KERNELS}
        expect = dict(want)
        if step == 0:
            expect["bn_stats"] *= 2
        assert moved == expect, step


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


# ---------------------------------------------------- the multi-tensor update
UPDATE_OPTS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "wd": 1e-4}),
    "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-4}),
    "adam": ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
    "adamw": ("adamw", {"learning_rate": 1e-3, "wd": 0.01}),
}
UPDATE_LAYOUTS = {"f32": (torch.float32, False),
                  "bf16_master": (torch.bfloat16, True),
                  "fp16_master": (torch.float16, True),
                  "bf16": (torch.bfloat16, False),
                  "fp16": (torch.float16, False)}


@pytest.mark.parametrize("layout", list(UPDATE_LAYOUTS))
@pytest.mark.parametrize("opt", list(UPDATE_OPTS))
@pytest.mark.parametrize("clip", [None, 0.2])
def test_update_kernel_equals_plain_bits(dev, opt, layout, clip):
    name, kw = UPDATE_OPTS[opt]
    dtype, master = UPDATE_LAYOUTS[layout]
    case = dict(name=f"{opt} {layout} clip {clip}", opt=name,
                kw=dict(kw, clip_gradient=clip), dtype=dtype, master=master,
                agg=4, mults=clip is not None)
    cs.update_check(torch, dev, case, cs.update_shapes("small"))


@pytest.mark.parametrize("agg", [1, 4, 0])
@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_update_kernel_group_sizes(dev, opt, agg):
    name, kw = UPDATE_OPTS[opt]
    case = dict(name=f"{opt} groups of {agg}", opt=name, kw=kw,
                dtype=torch.bfloat16, master=True, agg=agg, mults=True)
    shapes = cs.update_shapes("small") * 3
    cs.update_check(torch, dev, case, shapes)


@pytest.mark.parametrize("layout", list(UPDATE_LAYOUTS))
@pytest.mark.parametrize("opt", list(UPDATE_OPTS))
def test_update_kernel_unaligned_views_and_ragged_tails(dev, opt, layout):
    """Every other tensor's weight, gradient, master and states one
    element off 16-byte alignment (the kernel's scalar accesses), the rest
    aligned (16-byte vectors), at sizes with ragged vector and chunk tails
    and tensors of several chunks: the plain version's bits, one launch a
    step."""
    name, kw = UPDATE_OPTS[opt]
    dtype, master = UPDATE_LAYOUTS[layout]
    case = dict(name=f"{opt} {layout} unaligned", opt=name,
                kw=dict(kw, clip_gradient=0.2), dtype=dtype, master=master,
                agg=4, mults=True, unaligned=True)
    shapes = [(1,), (7,), (8,), (9,), (15,), (16384,), (16385,), (3, 11),
              (40007,), (16, 8), (70000,)]
    cs.update_check(torch, dev, case, shapes)


def test_update_kernel_chunks_and_grid_do_not_change_bits(dev, monkeypatch):
    """The chunk size and the blocks an SM move no bit: each element's
    update is the same function wherever the walk takes it."""
    case = dict(name="adamw chunks", opt="adamw", kw=UPDATE_OPTS["adamw"][1],
                dtype=torch.bfloat16, master=True, agg=4, mults=True,
                unaligned=True)
    shapes = [(5,), (1000,), (40007,), (3, 333)]
    finals = []
    for chunk, per_sm in ((8, 1), (64, 8), (16384, 4), (1 << 20, 2)):
        monkeypatch.setattr(mt, "CHUNK", chunk)
        monkeypatch.setattr(mt, "BLOCKS_PER_SM", per_sm)
        (kern, _), grads = cs.update_sides(torch, dev, case, shapes)
        for step in range(3):
            cs.update_step(kern, grads[step], 4)
        finals.append([t.clone() for t in kern[1]] + [
            t.clone() for st in kern[2] for t in cs.state_tensors(st)])
    for other in finals[1:]:
        assert all(cs.bits_equal(a, b) for a, b in zip(finals[0], other))


def test_trainer_step_launches_one_update_a_group(dev, monkeypatch):
    """The update kernel's launches a trainer step: one a layout, whatever
    the groups (the name is kept from the rule this replaced, one launch a
    group)."""
    from mxnet_tpu_torch.gluon import Trainer, nn
    net = nn.HybridSequential()
    for _ in range(5):
        net.add(nn.Dense(16, in_units=16))
    net.initialize(device=dev)
    net.cast("bfloat16")
    params = net.collect_params()
    # one launch a layout (every weight here bf16 with a master) whatever
    # the groups; aggregation 1 takes the per-parameter path, one a tensor
    for agg, want in ((4, 1), (1, 10), (64, 1)):
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", str(agg))
        tr = Trainer(params, "adamw", {"multi_precision": True})
        assert tr.optimizer.aggregate_num == agg
        x = torch.randn(4, 16, device=dev, dtype=torch.bfloat16)
        with tmx.autograd.record():
            y = net(x)
        tmx.autograd.backward(y)
        before = mt.launches["multi_tensor_update"]
        tr.step(4)
        assert mt.launches["multi_tensor_update"] - before == want


def test_update_kernel_rejects_what_it_does_not_take(dev):
    from mxnet_tpu_torch import optimizer as mo
    opt = mo.create("sgd", learning_rate=0.1, momentum=0.9)
    w = torch.zeros(8, device=dev, dtype=torch.float64)
    with pytest.raises(MXNetError, match="not covered"):
        opt.update(0, w, torch.ones_like(w), opt.create_state(0, w))
    w = torch.zeros(8, 2, device=dev)
    g = torch.ones(2, 8, device=dev).t()
    with pytest.raises(MXNetError, match="contiguous"):
        opt.update(0, w, g, opt.create_state(0, w))
    with pytest.raises(MXNetError, match="one CUDA device"):
        opt.update(0, w, torch.ones(8, 2), opt.create_state(0, w))


# ------------------------------------------------------ hybridize as graphs
BERT_SMALL = dict(vocab_size=1000, num_layers=2, units=128, hidden_size=256,
                  num_heads=2, max_length=128, use_pooler=False,
                  use_classifier=False)


def _small_bert(dev, dropout=0.1):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    params = cs.random_bert_params(
        get_bert("bert_12_768_12", device="cpu", dropout=dropout,
                 **BERT_SMALL), seed=0)
    return load_jax_params(get_bert("bert_12_768_12", device=dev,
                                    dropout=dropout, **BERT_SMALL),
                           params, dtype="bfloat16")


def _mlm(dev, seed=1):
    return [x.to(dev) for x in cs.mlm_batch(torch, 4, 128, 8, seed,
                                            vocab=1000, lo=32)]


def _bits(a, b):
    return all(cs.bits_equal(x, y) for x, y in zip(a, b))


def _warm(net, batch, record=True):
    """The signature's warm-up (eager) and capture calls. The warm-up's
    outputs stay alive through the capture, as a training loop's last
    loss does: their graph holds the parameters' AccumulateGrad nodes,
    made on the default stream."""
    keep = []
    for _ in range(2):
        if record:
            with tmx.autograd.record():
                keep.append(net(*batch[:4]))
        else:
            keep.append(net(*batch[:4]))
    return keep


def test_hybridized_forward_equals_eager_bits(dev):
    from mxnet_tpu_torch.gluon.block import Block
    net, batch = _small_bert(dev), _mlm(dev)
    net.hybridize()
    _warm(net, batch)
    gen = tmx.random.generator(dev)
    start = gen.get_state()
    with tmx.autograd.record():
        graphed = [o.detach() for o in net(*batch[:4])]
    after = gen.get_state()
    gen.set_state(start)
    with tmx.autograd.record():
        eager = [o.detach() for o in Block.__call__(net, *batch[:4])]
    assert torch.equal(gen.get_state(), after)
    assert _bits(graphed, eager)
    with tmx.autograd.record():
        again = [o.detach() for o in net(*batch[:4])]
    assert not torch.equal(again[-1], graphed[-1])  # new dropout bits


@pytest.mark.parametrize("route", ["fused", "pair"])
def test_graphed_backward_matches_eager(dev, route, monkeypatch):
    from mxnet_tpu_torch.gluon.block import Block
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    if route == "pair":
        monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "64")
    net, batch = _small_bert(dev), _mlm(dev)
    loss_fn = SoftmaxCrossEntropyLoss()
    net.hybridize()
    _warm(net, batch)
    gen = tmx.random.generator(dev)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    grads = []
    for call in (net, lambda *a: Block.__call__(net, *a)):
        gen.manual_seed(5)
        with tmx.autograd.record():
            loss = loss_fn(call(*batch[:4])[-1], batch[4])
        tmx.autograd.backward(loss)
        grads.append([p.grad().detach().clone() for p in params])
    for g, e in zip(*grads):
        assert _rel(g, e) <= 2e-2


def test_graphed_grad_req_add_accumulates(dev):
    from mxnet_tpu_torch.gluon.block import Block
    net, batch = _small_bert(dev, dropout=0.0), _mlm(dev)
    net.hybridize()
    _warm(net, batch)
    some = list(net.collect_params().values())[:6]
    for p in some:
        p.grad_req = "add"
    got = []
    for call in (net, lambda *a: Block.__call__(net, *a)):
        for p in some:
            p.zero_grad()
        for _ in range(2):
            with tmx.autograd.record():
                out = call(*batch[:4])[-1]
            tmx.autograd.backward(out.float().sum())
        got.append([p.grad().detach().clone() for p in some])
    for g, e in zip(*got):
        assert _rel(g, e) <= 2e-2
        assert g.abs().sum() > 0


def test_unfreezing_after_capture_gives_the_gradients(dev):
    """Parameters frozen (grad_req 'null') when the graphs were captured,
    then unfrozen: the graphs are dropped and captured again, and a
    replay's backward gives them the eager call's gradients."""
    from mxnet_tpu_torch.gluon.block import Block
    net, batch = _small_bert(dev, dropout=0.0), _mlm(dev)
    some = [p for p in net.collect_params().values()
            if p.grad_req != "null"][:4]
    for p in some:
        p.grad_req = "null"
    net.hybridize()
    _warm(net, batch)
    for p in some:
        p.grad_req = "write"
    got = []
    # graphed: the warm-up again, the capture, a replay; then eager
    for call, n in ((net, 3), (lambda *a: Block.__call__(net, *a), 1)):
        for _ in range(n):
            for p in some:
                p.data().grad = None
            with tmx.autograd.record():
                out = call(*batch[:4])[-1]
            tmx.autograd.backward(out.float().sum())
        got.append([p.data().grad.clone() for p in some])
    for g, e in zip(*got):
        assert g.abs().sum() > 0
        assert _rel(g, e) <= 2e-2


def test_graphed_batchnorm_statistics_equal_eager(dev):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.block import Block
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    params = cs.random_resnet_params(get_model("resnet18_v1", device="cpu",
                                               classes=10), seed=0)
    net = load_jax_params(get_model("resnet18_v1", device=dev, classes=10),
                          params, dtype="bfloat16")
    x = torch.randn(4, 3, 64, 64, device=dev, dtype=torch.bfloat16)
    net.hybridize()
    for _ in range(3):       # the centered step, the warm-up, the capture
        with tmx.autograd.record():
            net(x)
    stats = [p.data() for k, p in net.collect_params().items()
             if k.endswith(("running_mean", "running_var", "stat_shift"))]
    start = [t.clone() for t in stats]
    with tmx.autograd.record():
        graphed = net(x).detach()
    after = [t.clone() for t in stats]
    for t, s in zip(stats, start):
        t.copy_(s)
    with tmx.autograd.record():
        eager = Block.__call__(net, x).detach()
    assert cs.bits_equal(graphed, eager)
    assert _bits(after, stats)
    assert not _bits(after, start)


def test_profiler_counts_replayed_kernels(dev):
    from torch.profiler import ProfilerActivity, profile
    net, batch = _small_bert(dev), _mlm(dev)
    net.hybridize()
    _warm(net, batch, record=False)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        net(*batch[:4])
        torch.cuda.synchronize()
    counts = cs.kernel_counts(prof)
    assert sum(c for k, c in counts.items()
               if cs.re.search(cs.FWD_KERNEL, k)) == 2


def test_capture_failure_raises(dev):
    from mxnet_tpu_torch.gluon import HybridBlock

    class Reads(HybridBlock):
        def forward(self, x):
            return x * float(x.sum().item())

    net = Reads()
    net.hybridize()
    x = torch.ones(4, device=dev)
    net(x)                                   # the warm-up runs eagerly
    with pytest.raises(MXNetError, match="capturing Reads's forward"):
        net(x)


def test_capture_failure_leaves_the_generator_usable(dev):
    """A capture that fails part-way leaves the framework generator it
    registered in capture mode; the block renews it, so dropout draws
    and a later capture still work."""
    import importlib
    from mxnet_tpu_torch.gluon import HybridBlock
    mx_random = importlib.import_module("mxnet_tpu_torch.random")

    class Reads(HybridBlock):
        def forward(self, x):
            return tmx.npx.dropout(x, 0.5, mode="always") \
                * float(x.sum().item())

    class Drops(HybridBlock):
        def forward(self, x):
            return tmx.npx.dropout(x, 0.5, mode="always")

    x = torch.ones(1024, device=dev)
    net = Reads()
    net.hybridize()
    net(x)
    epoch = mx_random.epoch()
    with pytest.raises(MXNetError, match="capturing Reads's forward"):
        net(x)
    assert mx_random.epoch() == epoch + 1
    a = tmx.npx.dropout(x, 0.5, mode="always")
    drops = Drops()
    drops.hybridize()
    outs = [drops(x) for _ in range(4)]    # warm-up, capture, replays
    assert not torch.equal(outs[2], outs[3])
    assert all(bool(((o == 0) | (o == 2)).all()) for o in outs + [a])


def test_served_buckets_answer_as_eager(dev):
    import numpy as onp
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.serving import BucketPolicy, ServedModel

    class Encode(HybridBlock):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, valid_length):
            return self.bert(tokens, None, valid_length)

    net = Encode(_small_bert(dev))
    tok = torch.zeros(1, 128, dtype=torch.int32, device=dev)
    net.hybridize()
    net(tok, torch.full((1,), 128, dtype=torch.int32, device=dev))
    model = ServedModel.from_block(net, device=dev)
    assert model.input_signature == [((128,), onp.dtype("int32")),
                                     ((), onp.dtype("int32"))]
    policy = BucketPolicy(batch_buckets=(1, 2))
    assert model.warmup(policy) == 2
    rng = onp.random.RandomState(0)
    arrays = [rng.randint(0, 1000, (2, 128)).astype("int32"),
              onp.array([100, 17], "int32")]
    graphed = model.predict(arrays)
    net.hybridize(False)
    eager = model.predict(arrays)
    assert all(onp.array_equal(a, b) for a, b in zip(graphed, eager))


def test_warmup_captures_the_children_of_a_plain_block(dev):
    """from_block hybridizes a plain Block's HybridBlock children; warmup
    leaves each bucket captured, so no graph is captured under traffic."""
    from mxnet_tpu_torch.gluon import Block as GluonBlock
    from mxnet_tpu_torch.gluon.block import _Graph
    from mxnet_tpu_torch.serving import BucketPolicy, ServedModel

    class Encode(GluonBlock):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, valid_length):
            return self.bert(tokens, None, valid_length)

    bert = _small_bert(dev)
    model = ServedModel.from_block(Encode(bert), [((128,), "int32"),
                                                  ((), "int32")], device=dev)
    assert bert._active
    assert model.warmup(BucketPolicy(batch_buckets=(1, 2))) == 2
    assert len(bert._cached_graph) == 2
    assert all(isinstance(g, _Graph) for g in bert._cached_graph.values())


def test_replays_from_many_threads_answer_as_one(dev):
    """Eight threads predicting at once through one served block's captured
    buckets (its copy-in, replay and copy-out under one lock) get the
    answers each batch gets alone."""
    import sys
    import threading
    import numpy as onp
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.serving import BucketPolicy, ServedModel

    class Encode(HybridBlock):
        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, valid_length):
            return self.bert(tokens, None, valid_length)

    net = Encode(_small_bert(dev))
    model = ServedModel.from_block(net, [((128,), "int32"), ((), "int32")],
                                   device=dev)
    model.warmup(BucketPolicy(batch_buckets=(1, 2)))
    rng = onp.random.RandomState(3)
    batches = [[rng.randint(0, 1000, (b, 128)).astype("int32"),
                rng.randint(1, 129, (b,)).astype("int32")]
               for b in (1, 2) * 16]
    want = [model.predict(x) for x in batches]
    got = [None] * len(batches)

    def worker(k):
        for i in range(k, len(batches), 8):
            got[i] = model.predict(batches[i])

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    for a, b in zip(got, want):
        assert all(onp.array_equal(x, y) for x, y in zip(a, b))


# ------------------------------------- the registered forward op and serving
@pytest.mark.parametrize("dtype,T,D,rate", [
    (torch.bfloat16, 512, 64, 0.0), (torch.bfloat16, 512, 64, 0.1),
    (torch.float16, 512, 64, 0.0), (torch.bfloat16, 128, 64, 0.0),
    (torch.bfloat16, 512, 128, 0.0), (torch.bfloat16, 512, 256, 0.1),
    (torch.float32, 512, 64, 0.1)])
def test_registered_op_equals_direct_launch_bits(dev, dtype, T, D, rate):
    """``mxnet_tpu_torch::flash_attention_fwd`` against ``_launch_fwd``
    into buffers of the same layout, at phase 3's forward shapes (B=8,
    H=12, the key-padding bias): out and lse equal to the bit, one launch
    each."""
    g = torch.Generator().manual_seed(T + D)
    B, H = 8, 12
    q, k, v = (torch.randn(B, T, H, D, generator=g).to(dev, dtype)
               .transpose(1, 2) for _ in range(3))
    keep = torch.arange(T)[None, :] < torch.randint(16, T + 1, (B,),
                                                    generator=g)[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(dtype).min)[:, None, None, :]
    bias = bias.to(dev, dtype)
    seed = torch.tensor([7, 11], dtype=torch.int32, device=dev) \
        if rate else None
    before = attn.launches["flash_attention_fwd"]
    out, lse = torch.ops.mxnet_tpu_torch.flash_attention_fwd(
        q, k, v, bias, seed, 0.125, False, rate)
    want, want_lse = attn._fwd_outputs(q)
    attn._launch_fwd(q, k, v, bias, seed, rate, want, want_lse, 0.125, False)
    torch.cuda.synchronize()
    assert attn.launches["flash_attention_fwd"] == before + 2
    assert out.stride() == want.stride() and lse.shape == (B, H, T, 1)
    assert cs.bits_equal(out, want) and cs.bits_equal(lse, want_lse)


class _Encode(tmx.gluon.HybridBlock):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, tokens, valid_length):
        return self.bert(tokens, None, valid_length)


def _served(dev):
    import numpy as onp
    from mxnet_tpu_torch.serving import ServedModel
    net = _Encode(_small_bert(dev))
    return net, ServedModel.from_block(net, [((128,), "int32"),
                                             ((), "int32")], device=dev)


def _requests(n, seed=4):
    import numpy as onp
    rng = onp.random.RandomState(seed)
    return [[rng.randint(0, 1000, (b, 128)).astype("int32"),
             rng.randint(1, 129, (b,)).astype("int32")]
            for b in (1, 2, 2, 1)[:n]]


def test_hybridized_bert_replay_unchanged_by_the_registered_op(dev,
                                                              monkeypatch):
    """A served bf16 BERT's replayed buckets answer with the bits of the
    eager forward whose attention calls the launcher directly, not the
    registered op: registering the kernel changed no number."""
    import numpy as onp
    from mxnet_tpu_torch.serving import BucketPolicy
    net, model = _served(dev)
    model.warmup(BucketPolicy(batch_buckets=(1, 2)))
    graphed = [model.predict(x) for x in _requests(4)]

    def direct(q, k, v, bias, scale, causal, seed=None, rate=0.0):
        out, lse = attn._fwd_outputs(q)
        attn._launch_fwd(q, k, v, bias, seed, rate, out, lse, scale, causal)
        return out, lse

    monkeypatch.setattr(attn, "_flash_forward", direct)
    net.hybridize(False)
    eager = [model.predict(x) for x in _requests(4)]
    for a, b in zip(graphed, eager):
        assert all(onp.array_equal(x, y) for x, y in zip(a, b))


def test_exported_program_launches_the_kernel(dev, tmp_path):
    """``export(dynamic_batch=True)`` of a bf16 BERT and ``from_export``:
    each batch launches the forward kernel once a layer (profiler and
    counter), runs no SDPA kernel, and answers as the live block does
    eagerly (relative 2e-2)."""
    import numpy as onp
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving import ServedModel
    net, live = _served(dev)
    net.hybridize(False)
    sym, _ = net.export(str(tmp_path / "bert"),
                        input_signature=[((2, 128), "int32"),
                                         ((2,), "int32")],
                        dynamic_batch=True)
    model = ServedModel.from_export(sym, device=dev)
    for x in _requests(4):
        before = attn.launches["flash_attention_fwd"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cs.primer()   # the records a session may lose (PERF.md §7)
            got = model.predict(x)
            torch.cuda.synchronize()
        counts = cs.kernel_counts(prof)
        assert sum(c for k, c in counts.items()
                   if cs.re.search(cs.FWD_KERNEL, k)) == 2
        assert not any(cs.re.search(cs.SDPA_KERNEL, k) for k in counts)
        assert attn.launches["flash_attention_fwd"] == before + 2
        for a, b in zip(got, live.predict(x)):
            assert a.shape == b.shape
            assert cs.rel_err(a, b) <= 2e-2


def test_http_round_trip_equals_in_process_bits(dev):
    """One request over ``make_http_server`` on 127.0.0.1:0, parsed back to
    f32: the bits the same server answers in process."""
    import numpy as onp
    from mxnet_tpu_torch.serving import BucketPolicy, ModelServer
    _, model = _served(dev)
    tok = onp.random.RandomState(5).randint(0, 1000, 128).astype("int32")
    sample = (tok, onp.int32(77))
    front = cs.HttpFront(ModelServer(model, BucketPolicy(batch_buckets=(1,)),
                                     warmup=True, timeout_ms=1))
    try:
        want = front.server.infer(*sample, timeout=60.0)
        status, _, data = cs.http_call(front.port, "POST", "/v1/inference",
                                       cs.instance(sample))
    finally:
        front.close()
    assert status == 200
    got = onp.asarray(cs.json.loads(data)["predictions"][0], "float32")
    assert got.shape == want.shape and onp.array_equal(got, want)


# ------------------------------------------------------------ generation
def _gen_net(dev, dtype=torch.bfloat16, layers=2, seed=0):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    net = GPTModel(vocab_size=1000, num_layers=layers, units=256,
                   hidden_size=512, num_heads=4, max_length=1024,
                   dropout=0.0)
    load_jax_params(net, cs.random_gpt_params(net, seed))
    return net.to(dev, dtype).eval()


@pytest.mark.parametrize("T", [128, 512, 1024])
def test_prefill_flash_forward_causal_b1(dev, T):
    g = torch.Generator().manual_seed(T)
    qkv = torch.randn(1, T, 3 * 12 * 64, generator=g).to(dev, torch.bfloat16)
    q, k, v = (t.reshape(1, T, 12, 64) for t in qkv.split(768, -1))
    before = attn.launches["flash_attention_fwd"]
    copies = attn.padded_copies
    got = attn.flash_attention(q, k, v, causal=True)
    assert attn.launches["flash_attention_fwd"] == before + 1
    assert attn.padded_copies == copies
    ref, _ = attn.flash_attention_reference(
        *(t.transpose(1, 2).float() for t in (q, k, v)), causal=True)
    _close(got, ref.transpose(1, 2), 2e-2, 2e-2, f"causal T={T}")


@pytest.mark.parametrize("qlen", [1, 100])
def test_suffix_pass_bias_with_whole_masked_tiles(dev, qlen):
    from mxnet_tpu_torch.ops.transformer import _mask_to_bias
    Pb, Sb = 256, 128
    g = torch.Generator().manual_seed(qlen)
    q, k, v = (torch.randn(1, T, 12, 64, generator=g).to(dev, torch.bfloat16)
               for T in (Sb, Pb + Sb, Pb + Sb))
    cols = torch.arange(Pb + Sb, device=dev)[None, :]
    rows = torch.arange(Sb, device=dev)[:, None]
    vis = (cols < qlen) | ((cols >= Pb) & (cols - Pb <= rows))
    bias = _mask_to_bias(vis[None, None], torch.float32, 1, Sb, Pb + Sb)
    got = attn.flash_attention(q, k, v, bias=bias, bias_grad=False)
    assert torch.isfinite(got).all()
    ref, _ = attn.flash_attention_reference(
        *(t.transpose(1, 2).float() for t in (q, k, v)), bias=bias)
    _close(got, ref.transpose(1, 2), 2e-2, 2e-2, f"suffix q={qlen}")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_decode_attention_kernel(dev, dtype, tol):
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    S, H, D = 8, 12, 64
    g = torch.Generator().manual_seed(3)
    pos = torch.tensor([0, 5, 127, 128, 300, 511, 700, 1023], device=dev)
    q = torch.randn(S, 3 * H * D, generator=g).to(dev, dtype)[:, :H * D]
    k, v = (torch.randn(S, 1024, H, D, generator=g).to(dev, dtype)
            for _ in range(2))
    before = da.launches["decode_attention"]
    got = da.decode_attention(q.reshape(S, H, D), k, v, pos)
    assert da.launches["decode_attention"] == before + 1
    want = da.decode_attention_reference(q.reshape(S, H, D).cpu(), k.cpu(),
                                         v.cpu(), pos.cpu())
    _close(got.cpu(), want.float(), tol, tol, f"decode {dtype}")
    # the same rows in a larger bucket: the same bits
    k2, v2 = (torch.zeros(S, 2048, H, D, device=dev, dtype=dtype)
              for _ in range(2))
    k2[:, :1024], v2[:, :1024] = k, v
    k2[:, 1024:].normal_()
    again = da.decode_attention(q.reshape(S, H, D), k2, v2, pos)
    assert torch.equal(again, got)
    with pytest.raises(MXNetError, match="int64"):
        da.decode_attention(q.reshape(S, H, D), k, v, pos.int())


@pytest.mark.parametrize("D", [64, 288])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
def test_decode_attention_placement_and_replay(dev, D, dtype, tol):
    """At head dims 64 and 288: against the plain version; a slot's bits
    the same in buckets 128 and 1024, at another slot index and among
    fewer slots; a CUDA graph of the call over a kept workspace replayed
    after its inputs change equal to the eager call's bits, replay after
    replay (the tickets go back to 0)."""
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    S, H = 8, 4
    g = torch.Generator().manual_seed(D)
    q = torch.randn(S, H, D, generator=g).to(dev, dtype)
    k, v = (torch.randn(S, 1024, H, D, generator=g).to(dev, dtype)
            for _ in range(2))
    short = torch.tensor([0, 1, 63, 64, 65, 100, 126, 127], device=dev)
    got = da.decode_attention(q, k, v, short)
    want = da.decode_attention_reference(q.cpu(), k.cpu(), v.cpu(),
                                         short.cpu())
    _close(got.cpu(), want.float(), tol, tol, f"decode D={D}")
    small = da.decode_attention(q, k[:, :128].contiguous(),
                                v[:, :128].contiguous(), short)
    assert torch.equal(small, got)
    perm = torch.tensor([5, 2, 7, 0, 3, 6, 1, 4], device=dev)
    moved = da.decode_attention(q[perm], k[perm], v[perm], short[perm])
    assert torch.equal(moved, got[perm])
    few = da.decode_attention(q[2:5], k[2:5], v[2:5], short[2:5])
    assert torch.equal(few, got[2:5])

    pos = torch.tensor([0, 5, 127, 128, 300, 511, 700, 1023], device=dev)
    work = da.workspace(S, H, 1024, D, dev)
    out = torch.empty(S, H, D, device=dev, dtype=dtype)
    before = da.launches["decode_attention"]
    da.decode_attention(q, k, v, pos, out=out, work=work)     # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        da.decode_attention(q, k, v, pos, out=out, work=work)
    for step in range(3):
        pos.copy_(torch.tensor([3, 40, 129, 255, 256, 600, 899, 1000 - step],
                               device=dev) - step)
        k.normal_()
        graph.replay()
        torch.cuda.synchronize()
        eager = da.decode_attention(q, k, v, pos)
        assert torch.equal(out, eager), step
    assert torch.equal(work.tickets, torch.zeros_like(work.tickets))
    assert da.launches["decode_attention"] == before + 2 + 3


def _gen_cache(model, dev, S=4, buckets=(128, 256)):
    import numpy as onp
    from mxnet_tpu_torch.serving import PagedKVCache
    cache = PagedKVCache(model.n_layers, model.num_heads, model.head_dim,
                         S, buckets=buckets, dtype=model.dtype, device=dev)
    rng = onp.random.RandomState(1)
    for t0 in (9, 40, 100, 17)[:S]:
        _, ks, vs = model.prefill(rng.randint(0, 1000, t0), 128)
        cache.write_prompt(cache.alloc(), ks, vs, t0)
    return cache


def _snapshot(cache):
    return [t.clone() for t in cache._k + cache._v]


def _restore(cache, snap):
    for t, s in zip(cache._k + cache._v, snap):
        t.copy_(s)


@pytest.mark.parametrize("mixed", [False, True])
def test_decode_step_replay_equals_eager_bits(dev, mixed):
    import numpy as onp
    from mxnet_tpu_torch.serving import DecodeModel
    model = DecodeModel.from_block(_gen_net(dev), device=dev)
    cache = _gen_cache(model, dev)
    lanes = model.greedy_sampling(4)
    if mixed:
        lanes[5][:] = (0, 1, 2, 3)
        lanes[0][:] = (5, 6, 7, 8)
        lanes[3][:] = 7
        lanes[4][:] = 0.8
    toks = onp.array([3, 30, 300, 999])
    pos = cache.positions.copy()
    snap = _snapshot(cache)
    eager = model.step(cache, toks, pos, lanes, graph=False)
    after_eager = _snapshot(cache)
    _restore(cache, snap)
    graphed = model.step(cache, toks, pos, lanes)
    assert model.captures == 1
    assert onp.array_equal(eager, graphed)
    assert all(torch.equal(a, b) for a, b in zip(after_eager,
                                                 _snapshot(cache)))


def test_verify_equals_chained_steps_bits(dev):
    import numpy as onp
    from mxnet_tpu_torch.serving import DecodeModel
    model = DecodeModel.from_block(_gen_net(dev), device=dev)
    cache = _gen_cache(model, dev)
    lanes = model.greedy_sampling(4)
    lanes[5][:] = (0, 1, 0, 3)
    lanes[3][:] = 5
    lanes[4][:] = 0.9
    snap, pos0 = _snapshot(cache), cache.positions.copy()
    cur, outs = onp.array([1, 2, 3, 4]), []
    for j in range(4):
        cur = model.step(cache, cur, pos0 + j, lanes)
        outs.append(cur)
    steps = onp.stack(outs, 1)
    after_steps = _snapshot(cache)
    _restore(cache, snap)
    cand = onp.concatenate([[[1], [2], [3], [4]], steps[:, :3]], 1)
    ver = model.verify(cache, cand, pos0, lanes)
    assert onp.array_equal(ver, steps)
    assert all(torch.equal(a, b) for a, b in zip(after_steps,
                                                 _snapshot(cache)))


def test_engine_captures_nothing_after_warmup(dev):
    import numpy as onp
    from mxnet_tpu_torch import metrics
    from mxnet_tpu_torch.serving import DecodeModel, GenerationEngine
    model = DecodeModel.from_block(_gen_net(dev), device=dev)
    eng = GenerationEngine(model, max_slots=4, kv_buckets=(128, 256),
                           max_tokens=200, spec_mode="self", spec_k=3,
                           spec_draft_layers=1)
    eng.warmup()
    captured = model.captures
    assert captured == 12   # (step, verify, draft) x 2 buckets x 2 lanes
    labels = model.describe()["programs_compiled"]
    c0 = [metrics.value("mxnet_serving_bucket_compiles_total", bucket=t)
          for t in labels]
    rng = onp.random.RandomState(2)
    streams = [eng.submit(rng.randint(0, 1000, 100), max_new_tokens=120),
               eng.submit(rng.randint(0, 1000, 20), max_new_tokens=40,
                          method="top_p", seed=4),
               eng.submit(rng.randint(0, 1000, 60), max_new_tokens=30,
                          speculative=False)]
    while not all(s.finished for s in streams):
        eng.run_iteration()
    assert [len(s.result(timeout=10)) for s in streams] == [120, 40, 30]
    assert eng.cache.bucket == 256
    assert model.captures == captured
    assert model.describe()["programs_compiled"] == labels
    assert [metrics.value("mxnet_serving_bucket_compiles_total", bucket=t)
            for t in labels] == c0




def _hold_capture(model, monkeypatch):
    """Patch ``model`` so that the first graph capture it makes stops,
    inside the capture, until the test sets ``released``. Returns
    (capturing, released) events."""
    import threading
    capturing, released = threading.Event(), threading.Event()
    steps = model._steps

    def held_steps(*a):
        out = steps(*a)
        if torch.cuda.is_current_stream_capturing() \
                and not released.is_set():
            capturing.set()
            released.wait(120)
        return out

    monkeypatch.setattr(model, "_steps", held_steps)
    return capturing, released


def _while_held(capturing, released, capture, work):
    """Run ``capture`` on a thread until its capture is held, then ``work``
    on another; release the capture after a second. Returns whether
    ``work`` was still waiting then, and what each raised."""
    import threading
    errors = {}

    def run(name, fn):
        try:
            fn()
        except Exception as e:   # noqa: BLE001 - returned to the test
            errors[name] = e

    tc = threading.Thread(target=run, args=("capture", capture))
    tc.start()
    tw = threading.Thread(target=run, args=("work", work))
    try:
        assert capturing.wait(120), "the capture never began"
        tw.start()
        tw.join(1.0)
        waited = tw.is_alive()
    finally:
        released.set()
        tc.join(120)
        if tw.ident is not None:
            tw.join(120)
    return waited, errors


def test_prompt_passes_wait_for_another_threads_capture(dev, monkeypatch):
    import numpy as onp
    from mxnet_tpu_torch.serving import DecodeModel
    net = _gen_net(dev)
    survivor = DecodeModel.from_block(net, device=dev)
    fresh = DecodeModel.from_block(net, device=dev)
    rng = onp.random.RandomState(5)
    prompts = [rng.randint(0, 1000, n) for n in (9, 100, 300)]
    rows = [torch.randn(256, 4, 64, device=dev).to(torch.bfloat16)
            for _ in range(2)]

    def passes():
        return ([survivor.prefill(p, 512)[0] for p in prompts],
                survivor.prefill_suffix(prompts[0], rows, rows, q=100,
                                        bucket_len=128)[0],
                survivor.select(survivor.prefill(prompts[1], 128)[0],
                                seed=3, counter=0, temperature=0.8,
                                top_k=50, top_p=0.9, method=3))

    alone = passes()
    cache = _gen_cache(fresh, dev)
    toks, pos = onp.array([3, 30, 300, 999]), cache.positions.copy()
    snap = _snapshot(cache)
    eager = fresh.step(cache, toks, pos, graph=False)
    _restore(cache, snap)
    capturing, released = _hold_capture(fresh, monkeypatch)
    got = {}
    waited, errors = _while_held(
        capturing, released,
        lambda: got.update(step=fresh.step(cache, toks, pos)),
        lambda: got.update(passes=passes()))
    assert waited, "a prompt pass ran while another thread captured"
    assert not errors and fresh.captures == 1
    assert onp.array_equal(got["step"], eager)
    during = got["passes"]
    assert all(torch.equal(a, b) for a, b in zip(alone[0], during[0]))
    assert torch.equal(alone[1], during[1]) and alone[2] == during[2]


def test_recovery_waits_for_a_restarted_engines_capture(dev, monkeypatch):
    import numpy as onp
    from mxnet_tpu_torch.serving import (DecodeModel, GenerationEngine,
                                         make_recovery_request)
    model = DecodeModel.from_block(_gen_net(dev), device=dev)

    def engine():
        eng = GenerationEngine(model, max_slots=2, kv_buckets=(128, 256),
                               max_tokens=200)
        eng.warmup()
        return eng

    def finish(eng, streams):
        for _ in range(200):
            if all(s.finished for s in streams):
                break
            eng.run_iteration()
        return [s.result(timeout=10) for s in streams]

    rng = onp.random.RandomState(7)
    prompts = [rng.randint(0, 1000, n) for n in (40, 90)]
    kws = [{}, dict(method="sample", temperature=0.9, seed=5)]
    survivor = engine()
    clean = finish(survivor, [survivor.submit(p, max_new_tokens=30, **kw)
                              for p, kw in zip(prompts, kws)])
    dying = engine()
    streams = [dying.submit(p, max_new_tokens=30, **kw)
               for p, kw in zip(prompts, kws)]
    for _ in range(12):
        dying.run_iteration()
    _, resident = dying.evacuate()
    assert len(resident) == 2
    assert all(0 < len(r.stream.tokens) < 30 for r in resident)
    captures = model.captures
    capturing, released = _hold_capture(model, monkeypatch)

    def recover():
        for req in resident:
            survivor.submit_request(make_recovery_request(req), front=True)
        survivor.run_iteration()     # the recovery's prompt passes

    waited, errors = _while_held(capturing, released, engine, recover)
    assert waited, "the recovery ran while the restart captured"
    assert not errors and model.captures == captures + 4
    assert finish(survivor, streams) == clean


# ------------------------------------------- captures beside served traffic
class _HeldBlock(tmx.gluon.HybridBlock):
    """A Dense whose forward, while its stream captures, waits until the
    test sets ``released``: a ``ModelServer``'s block capturing a new
    signature."""

    def __init__(self, capturing, released):
        super().__init__()
        self.dense = tmx.gluon.nn.Dense(64, in_units=64, flatten=False)
        self._events = (capturing, released)

    def forward(self, x):
        y = self.dense(x)
        capturing, released = self._events
        if torch.cuda.is_current_stream_capturing() \
                and not released.is_set():
            capturing.set()
            released.wait(120)
        return y


def test_prompt_passes_beside_a_served_blocks_capture(dev):
    """A hybridized block served by ``ServedModel`` (a ``ModelServer``'s
    worker) captures a new signature while another thread runs a
    ``GenerationServer``'s prompt passes (host-to-card uploads): neither
    raises, and each gives what it gives alone."""
    import threading
    import numpy as onp
    from mxnet_tpu_torch.serving import DecodeModel, ServedModel
    capturing, released = threading.Event(), threading.Event()
    blk = _HeldBlock(capturing, released)
    blk.initialize(device=dev)
    served = ServedModel.from_block(blk, [((64,), onp.float32)], device=dev)
    x = onp.random.RandomState(0).randn(2, 64).astype("float32")
    model = DecodeModel.from_block(_gen_net(dev), device=dev)
    rng = onp.random.RandomState(5)
    prompts = [rng.randint(0, 1000, n) for n in (9, 100, 300)]
    alone = [model.prefill(p, 512)[0] for p in prompts]
    got = {}

    def serve():
        # a server's worker: the signature's eager warm-up, then its
        # capture, on one thread (the capture needs that thread's cuBLAS
        # handle made beforehand)
        got["eager"] = served.predict([x])[0]
        got["answer"] = served.predict([x])[0]

    _, errors = _while_held(
        capturing, released, serve,
        lambda: got.update(passes=[model.prefill(p, 512)[0]
                                   for p in prompts]))
    assert not errors, errors
    assert sum(1 for g in blk._cached_graph.values() if g is not True) == 1
    assert onp.array_equal(got["answer"], got["eager"])
    assert all(torch.equal(a, b) for a, b in zip(alone, got["passes"]))


def test_served_predict_beside_a_decode_capture(dev, monkeypatch):
    """The reverse: a decode graph's capture while ``ServedModel.predict``
    uploads a batch and reads its answer back: neither raises, and each
    gives what it gives alone."""
    import numpy as onp
    from mxnet_tpu_torch.serving import DecodeModel, ServedModel
    fresh = DecodeModel.from_block(_gen_net(dev), device=dev)
    cache = _gen_cache(fresh, dev)
    toks, pos = onp.array([3, 30, 300, 999]), cache.positions.copy()
    snap = _snapshot(cache)
    eager = fresh.step(cache, toks, pos, graph=False)
    _restore(cache, snap)
    blk = tmx.gluon.nn.Dense(64, in_units=64, flatten=False)
    blk.initialize(device=dev)
    served = ServedModel.from_block(blk, [((64,), onp.float32)], device=dev)
    x = onp.random.RandomState(1).randn(3, 64).astype("float32")
    alone = served.predict([x])[0]
    served.predict([x])                     # captured: later calls replay
    capturing, released = _hold_capture(fresh, monkeypatch)
    got = {}
    _, errors = _while_held(
        capturing, released,
        lambda: got.update(step=fresh.step(cache, toks, pos)),
        lambda: got.update(answer=served.predict([x])[0]))
    assert not errors, errors
    assert fresh.captures == 1 and onp.array_equal(got["step"], eager)
    assert onp.array_equal(got["answer"], alone)


# ------------------------------------- the encoder-decoder Transformer, GPT
def _s2s_net(dev, dtype=torch.float32, dropout=0.0, seed=0):
    """A 2 + 2 layer Transformer, units 256, head dim 64, vocab 1000, with
    chip_smoke's random weights, on ``dev``; and the weights."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerModel
    net = TransformerModel(src_vocab_size=1000, num_encoder_layers=2,
                           num_decoder_layers=2, units=256, hidden_size=512,
                           num_heads=4, max_length=256, dropout=dropout)
    params = cs.random_transformer_params(net, seed)
    return load_jax_params(net.to(dev), params, dtype=dtype), params


def _train_step(net, batch, trainer, lm=False):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    loss_fn = SoftmaxCrossEntropyLoss(axis=-1)
    with autograd.record():
        out = net(batch[0]) if lm else net(batch[0], batch[1], batch[3])
        loss = loss_fn(out, batch[1] if lm else batch[2])
    autograd.backward(loss)
    trainer.step(batch[0].shape[0])
    return loss


@pytest.mark.parametrize("block_k", [None, 64])
def test_transformer_training_step_launches(dev, monkeypatch, block_k):
    """One bf16 step (dropout 0.1): 6 flash forwards (2 encoder, 2 causal
    decoder, 2 cross) and 6 fused backwards, or at block_k 64 < T the
    dq/dkv pair 6 times each; one update launch; no operand copied."""
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    if block_k:
        monkeypatch.setenv("MXNET_FLASH_BLOCK_K", str(block_k))
    net, _ = _s2s_net(dev, torch.bfloat16, dropout=0.1)
    batch = [x.to(dev) for x in cs.seq2seq_batch(torch, 4, 128, 96, 1,
                                                 vocab=1000)]
    tr = Trainer(net.collect_params(), "adam",
                 {"learning_rate": 1e-4, "multi_precision": True})
    before = dict(attn.launches, **mt.launches, **da.launches)
    copies = attn.padded_copies
    loss = _train_step(net, batch, tr)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in
             dict(attn.launches, **mt.launches, **da.launches).items()}
    bwd = {"flash_attention_bwd_fused": 6} if not block_k else {
        "flash_attention_bwd_dq": 6, "flash_attention_bwd_dkv": 6}
    want = dict(flash_attention_fwd=6, multi_tensor_update=1, **bwd)
    assert moved == {k: want.get(k, 0) for k in moved}
    assert attn.padded_copies == copies
    assert torch.isfinite(loss.float()).all() and loss.shape == (4,)


def test_transformer_f32_step_matches_cpu(dev):
    """One f32 Adam step at Ts=24, Tt=16 (Tq != Tk in the cross-attention)
    with one source of valid length 0: loss within 1e-4 relative, every
    gradient within 1e-3 relative Frobenius of the CPU's plain path."""
    from mxnet_tpu_torch.gluon import Trainer
    batch = cs.seq2seq_batch(torch, 3, 24, 16, 2, lo=10, vocab=1000)
    batch[3][1] = 0
    out = []
    for where in ("cpu", dev):
        net, _ = _s2s_net(where)
        tr = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-4})
        loss = _train_step(net, [x.to(where) for x in batch], tr)
        out.append((loss.detach().cpu(), {k: p.grad().detach().cpu() for
                                          k, p in
                                          net.collect_params().items()}))
    (lc, gc), (lg, gg) = out
    assert ((lg - lc).abs() / lc.abs()).max() <= 1e-4
    for k in gc:
        assert cs.rel(gg[k], gc[k]) <= 1e-3, k


def test_transformer_translate_on_the_card(dev):
    """f32 greedy ``translate`` and ``beam_translate`` equal to the port's
    CPU path, a source of valid length 0 among them; the encoder's 2 flash
    forwards and 4 decode-attention launches a token; bf16 tokens finite
    and in range."""
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    g = torch.Generator().manual_seed(3)
    src = torch.randint(1, 1000, (3, 40), generator=g)
    vl = torch.tensor([40, 0, 17])
    cpu, params = _s2s_net("cpu")
    card, _ = _s2s_net(dev)
    want = cpu.translate(src, 12, 1, src_valid_length=vl)
    before = dict(attn.launches, **da.launches)
    got = card.translate(src.to(dev), 12, 1, src_valid_length=vl.to(dev))
    assert attn.launches["flash_attention_fwd"] - \
        before["flash_attention_fwd"] == 2
    assert da.launches["decode_attention"] - before["decode_attention"] \
        == 4 * 12
    assert torch.equal(got, want)
    ws, wc = cpu.beam_translate(src, 10, 1, beam_size=3, eos_token=7,
                                src_valid_length=vl)
    gs, gc = card.beam_translate(src.to(dev), 10, 1, beam_size=3,
                                 eos_token=7, src_valid_length=vl.to(dev))
    assert torch.equal(gs, ws)
    torch.testing.assert_close(gc, wc, rtol=1e-4, atol=1e-4)
    half, _ = _s2s_net(dev, torch.bfloat16)
    toks = half.translate(src.to(dev), 12, 1, src_valid_length=vl.to(dev))
    assert toks.shape == (3, 12) and int(toks.min()) >= 0 \
        and int(toks.max()) < 1000


def test_transformer_hybridized_step_replays(dev):
    """The hybridized bf16 step with and without ``src_valid_length``: the
    second call of each signature captures and the third replays, with
    the tied embedding bound once; losses finite and falling."""
    from mxnet_tpu_torch.gluon import Trainer
    net, _ = _s2s_net(dev, torch.bfloat16, dropout=0.1)
    batch = [x.to(dev) for x in cs.seq2seq_batch(torch, 4, 64, 48, 5,
                                                 vocab=1000)]
    tr = Trainer(net.collect_params(), "adam",
                 {"learning_rate": 1e-3, "multi_precision": True})
    net.hybridize()
    losses = [float(_train_step(net, batch, tr).float().mean())
              for _ in range(4)]
    no_vl = batch[:3] + [None]
    losses += [float(_train_step(net, no_vl, tr).float().mean())
               for _ in range(3)]
    graphs = [g for g in net._cached_graph.values() if g is not True]
    assert len(graphs) == 2
    assert all(len(g.params) == len(net.collect_params()) - 1
               for g in graphs)
    assert all(math.isfinite(v) for v in losses) and losses[3] < losses[0]


@pytest.mark.parametrize("block_k", [None, 128])
def test_gpt_training_step_launches(dev, monkeypatch, block_k):
    """A 2-layer GPT (units 256, head dim 64) bf16 AdamW step at B=2,
    T=256: 2 causal flash forwards and 2 fused backwards, or at block_k
    128 < T the pair; one update launch; then the f32 step against the
    CPU."""
    from mxnet_tpu_torch.gluon import Trainer
    if block_k:
        monkeypatch.setenv("MXNET_FLASH_BLOCK_K", str(block_k))
    net = _gen_net(dev).train()
    batch = [x.to(dev) for x in cs.lm_batch(torch, 2, 256, 3, vocab=1000)]
    tr = Trainer(net.collect_params(), "adamw",
                 {"learning_rate": 1e-4, "multi_precision": True})
    before = dict(attn.launches, **mt.launches)
    loss = _train_step(net, batch, tr, lm=True)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in
             dict(attn.launches, **mt.launches).items()}
    bwd = {"flash_attention_bwd_fused": 2} if not block_k else {
        "flash_attention_bwd_dq": 2, "flash_attention_bwd_dkv": 2}
    want = dict(flash_attention_fwd=2, multi_tensor_update=1, **bwd)
    assert moved == {k: want.get(k, 0) for k in moved}
    assert torch.isfinite(loss.float()).all()
    out = []
    small = [x.cpu()[:, :128] for x in batch]
    for where in ("cpu", dev):
        n = _gen_net(where, torch.float32)
        t = Trainer(n.collect_params(), "adamw", {"learning_rate": 1e-4})
        lv = _train_step(n, [x.to(where) for x in small], t, lm=True)
        out.append((lv.detach().cpu(), {k: p.grad().detach().cpu() for k, p
                                        in n.collect_params().items()}))
    (lc, gc), (lg, gg) = out
    assert ((lg - lc).abs() / lc.abs()).max() <= 1e-4
    for k in gc:
        assert cs.rel(gg[k], gc[k]) <= 1e-3, k


# ------------------------------------------------- int8 convolution, NMS
from mxnet_tpu_torch.ops.cuda import box_nms as nms  # noqa: E402
from mxnet_tpu_torch.ops.cuda import int8_conv as i8  # noqa: E402

# (layout, data shape, weight shape, stride, pad, dilate, groups): ResNet-50's
# conv1 (C = 3, K = 147), a strided 1x1 downsample, a 3x3 and a 1x1 that a
# block of 128 output channels takes; K not a multiple of 32 or 16; groups,
# dilation; the 1-d and 3-d layouts; channels-last weights; M < 16
INT8_CASES = [
    ("NCHW", (2, 3, 40, 40), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    ("NCHW", (2, 256, 14, 14), (512, 256, 1, 1), (2, 2), (0, 0), (1, 1), 1),
    ("NCHW", (2, 64, 14, 14), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ("NCHW", (3, 48, 9, 9), (200, 48, 1, 1), (1, 1), (0, 0), (1, 1), 1),
    ("NCHW", (2, 40, 9, 9), (24, 40, 1, 1), (1, 1), (0, 0), (1, 1), 1),
    ("NCHW", (2, 64, 11, 11), (96, 16, 3, 3), (1, 2), (2, 1), (2, 1), 4),
    ("NCHW", (2, 6, 8, 8), (9, 2, 3, 3), (1, 1), (1, 1), (1, 1), 3),
    ("NHWC", (2, 9, 9, 32), (3, 3, 32, 48), (2, 2), (1, 1), (1, 1), 1),
    ("NCW", (3, 32, 50), (20, 32, 5), (2,), (2,), (1,), 1),
    ("NWC", (2, 37, 24), (3, 12, 30), (1,), (1,), (3,), 2),
    ("NCDHW", (2, 16, 5, 6, 7), (8, 16, 3, 3, 3), (1, 1, 2), (1, 1, 1),
     (1, 1, 1), 1),
    ("NDHWC", (1, 4, 5, 6, 32), (2, 2, 2, 16, 40), (1, 2, 1), (0, 1, 1),
     (2, 1, 1), 2),
    ("NCHW", (1, 16, 3, 3), (8, 16, 1, 1), (1, 1), (0, 0), (1, 1), 1),
]


def _i8(shape, g, dev):
    return torch.randint(-127, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_conv_matches_plain(dev, case, with_bias):
    """The int8 kernel equals its float64 plain version to the bit (and is
    launched once a call)."""
    layout, xs, ws, stride, pad, dilate, groups = case
    g = torch.Generator().manual_seed(len(xs) * 7 + groups)
    x, w = _i8(xs, g, dev), _i8(ws, g, dev)
    O = ws[0] if layout.startswith("NC") else ws[-1]
    b = torch.randint(-2 ** 20, 2 ** 20, (O,), generator=g,
                      dtype=torch.int32).to(dev) if with_bias else None
    before = i8.launches["int8_conv"]
    got = i8.conv(x, w, b, stride, pad, dilate, groups, layout)
    torch.cuda.synchronize()
    assert i8.launches["int8_conv"] == before + 1
    want = i8.conv_reference(x, w, b, stride, pad, dilate, groups, layout)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


# every int8 shape of a quantized ResNet-50 v1 forward at B = 64, 224x224
# (layout, data, weight, stride, pad, dilate, groups): conv1 (the element
# route, (c, kh, kw) order), the 1x1 stride-1 ones (A by TMA), the
# strided 1x1 and the 3x3 ones (16-byte pieces), the FC (split over a
# cluster); then the four shapes off the path that chip_smoke.py times
RESNET50_INT8 = [("NCHW", (64, 3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3),
                  (1, 1), 1)] + [
    ("NCHW", (64, c, h, h), (o, c, k, k), (s, s), (k // 2, k // 2), (1, 1),
     1) for c, h, o, k, s in (
        (64, 56, 64, 1, 1), (64, 56, 64, 3, 1), (64, 56, 256, 1, 1),
        (256, 56, 64, 1, 1), (256, 56, 128, 1, 2), (128, 28, 128, 3, 1),
        (128, 28, 512, 1, 1), (256, 56, 512, 1, 2), (512, 28, 128, 1, 1),
        (512, 28, 256, 1, 2), (256, 14, 256, 3, 1), (256, 14, 1024, 1, 1),
        (512, 28, 1024, 1, 2), (1024, 14, 256, 1, 1),
        (1024, 14, 512, 1, 2), (512, 7, 512, 3, 1), (512, 7, 2048, 1, 1),
        (1024, 14, 2048, 1, 2), (2048, 7, 512, 1, 1))] + [
    ("FC", (64, 2048), (1000, 2048), None, None, None, 1)] + [
    c[1:] for c in cs.INT8_EXTRA]


def _int8_case(case, dev, f32: bool, seed: int):
    """Inputs of one shape: int8 data, or f32 data of which x * scale is
    exact and spans +-200 with many halves k + 1/2 (round half to even,
    the clamp at +-127); the weight, an int32 bias, the scale and step."""
    layout, xs, ws = case[:3]
    g = torch.Generator().manual_seed(seed)
    w = _i8(ws, g, dev)
    O = ws[0] if layout.startswith("NC") or layout == "FC" else ws[-1]
    b = torch.randint(-2 ** 20, 2 ** 20, (O,), generator=g,
                      dtype=torch.int32).to(dev)
    if not f32:
        return _i8(xs, g, dev), w, b, None, None
    halves = torch.randint(-400, 401, xs, generator=g).float() / 2
    x = (halves + torch.rand(xs, generator=g).round() * 0.25) * 0.5
    scale = torch.full((), 2.0, device=dev)          # x * scale exact
    step = torch.full((), 3.0517578125e-05 * 1.1, device=dev)
    return x.to(dev), w, b, scale, step


def _int8_call(case, x, w, b, scale, step, relu, plain):
    layout, _, _, stride, pad, dilate, groups = case
    fc = layout == "FC"
    if scale is None:
        if fc:
            fn = i8.fully_connected_reference if plain else i8.fully_connected
            return fn(x, w, b)
        fn = i8.conv_reference if plain else i8.conv
        return fn(x, w, b, stride, pad, dilate, groups, layout)
    if fc:
        fn = i8.fully_connected_f32_reference if plain \
            else i8.fully_connected_f32
        return fn(x, w, b, scale, step, relu)
    fn = i8.conv_f32_reference if plain else i8.conv_f32
    return fn(x, w, b, scale, step, stride, pad, dilate, groups, layout,
              relu)


@pytest.mark.parametrize("case", RESNET50_INT8,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
@pytest.mark.parametrize("variant", ["int8", "f32", "f32_relu"])
def test_int8_kernel_at_resnet50_shapes(dev, case, variant):
    """Both variants of the kernel equal their plain versions to the bit at
    every shape of the int8 ResNet-50 path and the four extra ones (every
    route, split over a cluster or not), the launch counter rising once a
    call, and two runs equal."""
    f32 = variant != "int8"
    x, w, b, scale, step = _int8_case(case, dev, f32, len(case[1]) * 5 +
                                      case[2][0])
    if case[0].startswith("NC") and x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)  # as the path
    if case[1][1] == 3:
        x = x.contiguous()                    # conv1's image: NCHW, as is
    relu = variant == "f32_relu"
    before = sum(i8.launches.values())
    got = _int8_call(case, x, w, b, scale, step, relu, False)
    torch.cuda.synchronize()
    assert sum(i8.launches.values()) == before + 1
    again = _int8_call(case, x, w, b, scale, step, relu, False)
    want = _int8_call(case, x, w, b, scale, step, relu, True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(again, got)


@pytest.mark.parametrize("case", INT8_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("relu", [False, True])
def test_int8_f32_variant_matches_plain(dev, case, relu):
    """The f32 variant (a whole quantized layer) equals its plain version,
    the unfused operator sequence, to the bit at every layout, stride,
    padding, dilation and group count of the int8 cases."""
    x, w, b, scale, step = _int8_case(case, dev, True, 17 + len(case[1]))
    before = sum(i8.launches.values())
    got = _int8_call(case, x, w, b, scale, step, relu, False)
    torch.cuda.synchronize()
    assert sum(i8.launches.values()) == before + 1
    want = _int8_call(case, x, w, b, scale, step, relu, True)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_int8_layer_graph_replay_equals_eager(dev):
    """A quantized Dense and a 3x3 convolution layer (f32 variant, packed
    weights, cached constants) captured in one CUDA graph: the replay
    equals the eager call to the bit, and the eager call launches the
    kernel once a layer."""
    from mxnet_tpu_torch.contrib.quantization import (QuantizedConv,
                                                      QuantizedDense)
    from mxnet_tpu_torch.gluon import nn
    torch.manual_seed(7)
    conv = nn.Conv2D(48, 3, padding=1, in_channels=32, activation="relu")
    dense = nn.Dense(10, in_units=48 * 8 * 8)
    for blk in (conv, dense):
        blk.initialize(device=dev)
    qc = QuantizedConv(conv, (-2.0, 2.5))
    qd = QuantizedDense(dense, (0.0, 3.0))
    x = torch.randn(4, 32, 8, 8, device=dev)
    with torch.no_grad():
        before = i8.launches["int8_conv_f32"]
        eager = qd(qc(x))
        torch.cuda.synchronize()
        assert i8.launches["int8_conv_f32"] - before == 2
        graph = torch.cuda.CUDAGraph()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            qd(qc(x))
            torch.cuda.synchronize()
            with torch.cuda.graph(graph):
                out = qd(qc(x))
        torch.cuda.current_stream().wait_stream(s)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_int8_conv_worst_case_sum_is_exact(dev):
    """K = 4608 (ResNet-50's 3x3x512) of -127 x -127: every output is
    K * 127^2 = 74322432, past f32's 2^24, exact."""
    x = torch.full((1, 512, 3, 3), -127, dtype=torch.int8, device=dev)
    w = torch.full((128, 512, 3, 3), -127, dtype=torch.int8, device=dev)
    got = i8.conv(x, w, None, (1, 1), (0, 0), (1, 1), 1, "NCHW")
    assert torch.equal(got, torch.full_like(got, 4608 * 127 * 127))


@pytest.mark.parametrize("M,K,N", [(2, 2048, 1000), (64, 2048, 1000),
                                   (5, 147, 33), (1, 16, 8), (300, 96, 130)])
def test_int8_fully_connected_matches_plain(dev, M, K, N):
    g = torch.Generator().manual_seed(M + K + N)
    x, w = _i8((M, K), g, dev), _i8((N, K), g, dev)
    b = torch.randint(-9999, 9999, (N,), generator=g, dtype=torch.int32).to(dev)
    assert torch.equal(i8.fully_connected(x, w, b),
                       i8.fully_connected_reference(x, w, b))


def test_int8_conv_reads_channels_last_without_a_copy(dev):
    """A channels-first input whose memory is channels-last (what the kernel
    writes) is read in place; a contiguous NCHW one is copied and counted,
    as is a 3x3 OIHW weight; a 1x1 weight is not."""
    g = torch.Generator().manual_seed(3)
    x = _i8((2, 32, 8, 8), g, dev)
    w1, w3 = _i8((16, 32, 1, 1), g, dev), _i8((16, 32, 3, 3), g, dev)
    cl = x.contiguous(memory_format=torch.channels_last)
    for xin, w, want in ((cl, w1, (0, 0)), (x, w1, (1, 0)), (cl, w3, (0, 1))):
        before = dict(i8.copies)
        y = i8.conv(xin, w, None, (1, 1), (1, 1) if w is w3 else (0, 0),
                    (1, 1), 1, "NCHW")
        assert (i8.copies["input"] - before["input"],
                i8.copies["weight"] - before["weight"]) == want
        assert y.permute(0, 2, 3, 1).is_contiguous()


def test_int8_conv_raises_and_never_falls_back(dev, monkeypatch):
    """A failed launch and a failed build raise MXNetError; an operand the
    kernel does not take raises; nothing runs the plain version."""
    g = torch.Generator().manual_seed(4)
    x, w = _i8((1, 16, 4, 4), g, dev), _i8((8, 16, 1, 1), g, dev)
    args = ((1, 1), (0, 0), (1, 1), 1, "NCHW")
    monkeypatch.setattr(i8, "conv_reference", None)
    monkeypatch.setattr(i8, "_kernel", lambda: (lambda *a: 98))
    with pytest.raises(MXNetError, match="CUDA error 98"):
        i8.conv(x, w, None, *args)

    def no_build():
        raise MXNetError("nvcc failed")
    monkeypatch.setattr(i8, "_kernel", no_build)
    with pytest.raises(MXNetError, match="nvcc failed"):
        i8.fully_connected(x.reshape(1, -1)[:, :16], w.reshape(8, 16))
    with pytest.raises(MXNetError, match="int8"):
        i8.conv(x.float(), w, None, *args)
    with pytest.raises(MXNetError, match="bias"):
        i8.conv(x, w, torch.zeros(8, device=dev), *args)


def _nms_inputs(B, N, g, dev, classes=3):
    xy = torch.rand(B, N, 2, generator=g)
    wh = torch.rand(B, N, 2, generator=g) * 0.25 + 0.01
    boxes = torch.cat([xy, xy + wh], -1)
    cls = torch.randint(0, classes, (B, N), generator=g).float()
    valid = torch.rand(B, N, generator=g) > 0.1
    return boxes.to(dev), cls.to(dev), valid.to(dev)


@pytest.mark.parametrize("B,N,n", [(2, 1, 1), (2, 63, 63), (2, 64, 64),
                                   (3, 65, 65), (1, 8732, 8732),
                                   (4, 8732, 400), (2, 300, 100)])
@pytest.mark.parametrize("force", [False, True])
def test_nms_keep_matches_plain(dev, B, N, n, force):
    """The NMS kernel's keep mask equals its plain version's to the bit,
    the sweep restricted to the first n rows (topk) where n < N."""
    g = torch.Generator().manual_seed(N + n)
    boxes, cls, valid = _nms_inputs(B, N, g, dev)
    valid[:, n:] = False
    before = nms.launches["box_nms"]
    got = nms.nms_keep(boxes[:, :n], cls[:, :n], valid, 0.45, force)
    torch.cuda.synchronize()
    assert nms.launches["box_nms"] == before + 1
    want = nms.nms_keep_reference(boxes[:, :n], cls[:, :n], valid, 0.45,
                                  force)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(valid.sum()) or N < 64


def test_box_nms_on_the_card_equals_the_cpu(dev):
    """``box_nms`` with classes, topk and out_format on the card against
    the same call on the CPU: the same rows (the IoUs are the same f32
    operations)."""
    from mxnet_tpu_torch.ops import boxes as ob
    g = torch.Generator().manual_seed(9)
    boxes, cls, _ = _nms_inputs(2, 500, g, "cpu")
    score = torch.rand(2, 500, generator=g)
    data = torch.cat([cls[..., None], score[..., None], boxes], -1)
    for kw in (dict(), dict(topk=100, out_format="center"),
               dict(force_suppress=True, valid_thresh=0.3)):
        got = ob.box_nms(data.to(dev), overlap_thresh=0.4, id_index=0, **kw)
        want = ob.box_nms(data, overlap_thresh=0.4, id_index=0, **kw)
        assert torch.equal(got.cpu(), want), kw


def test_nms_raises_and_never_falls_back(dev, monkeypatch):
    g = torch.Generator().manual_seed(5)
    boxes, cls, valid = _nms_inputs(1, 10, g, dev)
    monkeypatch.setattr(nms, "nms_keep_reference", None)
    monkeypatch.setattr(nms, "_kernel", lambda: (lambda *a: 98))
    with pytest.raises(MXNetError, match="CUDA error 98"):
        nms.nms_keep(boxes, cls, valid, 0.5, False)
    with pytest.raises(MXNetError, match="f32"):
        nms.nms_keep(boxes.half(), cls, valid, 0.5, False)


def test_quantized_resnet_graph_capture(dev):
    """A ResNet-18 v1 (10 classes) quantized by ``quantize_net``: every
    convolution and the Dense layer launch the int8 kernel once a forward,
    and a hybridized call (warm-up, capture, replay) equals the eager
    forward to the bit."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.block import Block
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    params = cs.random_resnet_params(get_model("resnet18_v1", device="cpu",
                                               classes=10), seed=1)
    net = load_jax_params(get_model("resnet18_v1", device=dev, classes=10),
                          params)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(4, 3, 64, 64, generator=g).to(dev)
    quantize_net(net, calib_data=[x], calib_mode="naive")
    with torch.no_grad():
        before = dict(i8.launches)
        eager = Block.__call__(net, x)
        torch.cuda.synchronize()
        # 20 convolutions and the Dense layer, each on the f32-in variant
        assert {k: i8.launches[k] - before[k] for k in before} == {
            "int8_conv": 0, "int8_conv_f32": 21}
        net.hybridize()
        outs = [net(x) for _ in range(3)]
    assert all(torch.equal(o, eager) for o in outs)
    assert torch.isfinite(eager).all()
