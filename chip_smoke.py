#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one GPU
    python3 chip_smoke.py --only kernels   # phases 1-3 (build + kernel checks)
    python3 chip_smoke.py --only rtc       # phases 1 and 7 (mx.nd + mx.rtc)

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: every CUDA source of the port from ``mxnet_tpu_torch/csrc``, one
   ``nvcc`` each, all started together; registers and spills per kernel;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the served and the trained BERT-base give it: the forward with
   and without dropout (its dropout mask read back and compared bit for
   bit), the fused backward, the two-pass dq/dkv pair (at the training
   shape and at T=2048 causal), a learned (1, H, T, T) bias with its
   reduced gradient, f32 for each, and fused against two-pass on the same
   inputs; each timed with CUDA events beside its bound, its plain version
   and a PyTorch library call (yardstick only). Then the three
   prologue-fused 1x1-conv kernels (fwd, dgrad, wgrad) against their plain
   versions at ResNet-50's eight b128 junction shapes in bf16 (each timed
   beside its bound, its plain version and cuDNN: ``F.conv2d``,
   ``torch.nn.grad.conv2d_input``, ``conv2d_weight``), the same shapes in
   f32 at N=8 with the other affine/bias variant, a ragged small shape
   with relu off, and an M > 4096 wgrad case;
4. BERT-base (12 layers, units 768, 12 heads, vocab 30522) with weights
   made from a seed, bf16 on ``cuda:0``, served by ``ModelServer`` with
   length buckets: 16 concurrent requests; the forward kernel must launch
   12 times per executed batch, and answers must match the same weights
   run in f32 on the CPU through the plain path;
5. BERT-base MLM training through ``autograd.record`` / ``backward`` /
   ``Trainer.step`` with AdamW (multi-precision), bf16, B=8, T=512, 76
   masked positions, dropout 0.1: 10 steps on the fused backward, then 2
   with ``MXNET_FLASH_BLOCK_K=256`` on the two-pass pair; every step must
   launch the forward kernel 12 times and the backward kernels 12 times
   each, and the loss must fall; step time, tokens/s and a profiler
   breakdown; then one f32 step on the card against the same step on the
   CPU (plain path);
6. ResNet-50 v1 (classes 1000, full width and depth) with weights made
   from a seed, bf16 with f32 masters (``multi_precision``), B=128,
   224x224 synthetic data as ``bench.py`` makes it, SGD lr 0.1 momentum
   0.9, ``MXNET_FUSE_BN_CONV=1``: 10 steps of ``autograd.record`` ->
   ``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``Trainer.step(128)``;
   every step must launch each conv kernel 28 times (16 BatchNorm-relu-conv
   triples, 12 deferred relu-conv junctions) and the loss must fall; step
   time, img/s and a profiler breakdown; the same 10 steps with
   ``MXNET_FUSE_BN_CONV=0`` (cuDNN only) from the same weights; an
   eval-mode forward with the kernels against the unfused one; one f32 SGD
   step on the card (TF32 off) against the same step on the CPU;
7. the imperative path and mx.rtc: NVRTC's and the driver's versions; the
   user kernel sources of ``RTC_SOURCES`` compiled by NVRTC for sm_90a
   (each timed); a handful of ``mx.np`` ops on (4096, 3072) arrays on
   ``cuda:0`` against the same ops on the CPU; the main path (launch counts
   from 0): ``x.attach_grad()``, ``autograd.record()``, ``rtc_bias_gelu``
   (GELU(x + b) over BERT-base's FFN activation, bf16 and f32), ``sum``,
   ``backward`` (its vjp launches ``rtc_bias_gelu_grad``), ``x.grad``
   against torch autograd of the plain version and the same object as
   before; ``rtc_axpy`` in place; test_rtc.py's axpy, scale and square
   through ``bind``; then each kernel against its plain version, timed
   beside its bound, its plain version and a library call; the errors that
   must raise (a CPU NDArray, a non-contiguous argument, a wrong dtype, a
   source that does not compile); and BERT-base bf16
   ``save_parameters`` -> ``load_parameters`` into a fresh ``get_bert``
   answering bit-identically;
8. one ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of ``mxnet_tpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# tolerances of phase 3 (kernel vs its plain version, same inputs):
# forward, bf16/fp16 against the plain version in f32 on the same (rounded)
# inputs: the kernel rounds p to 16 bits before p.v and rounds out once
TOL_HALF = dict(atol=2e-2, rtol=2e-2)
# f32 against f32: summation order only
TOL_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_LSE = dict(atol=1e-3, rtol=1e-4)
# backward, relative Frobenius error of each of dq, dk, dv, dbias: the
# 16-bit kernels round p and ds to 16 bits before their products; f32 only
# reorders sums (and the fused kernel adds dq with atomics)
REL_BWD = {"bfloat16": 2e-2, "float16": 2e-2, "float32": 1e-4}
# fused against two-pass on the same inputs: dk, dv come from the same
# code; dq differs by where it is rounded and the atomics' order
REL_AGREE = {"bfloat16": 1e-2, "float32": 1e-5}
# phase 4: bf16 BERT-base on the card against f32 on the CPU, relative
# Frobenius error of each answer (12 layers of bf16 rounding)
TOL_BERT_REL = 5e-2
# phase 5, f32 on the card (TF32 off) against f32 on the CPU
TOL_TRAIN_LOSS_REL = 1e-4
TOL_TRAIN_GRAD_REL = 1e-3
# phase 3, the conv kernels: relative Frobenius error of each output against
# its plain version on the same inputs. bf16: fwd and wgrad round f(x) and
# their output to bf16 once each (the plain version rounds f(x) the same
# way, so only the output's rounding and the sum order differ); dgrad
# writes f32 sums of exact products of bf16 values. f32: sum order only
# (wgrad sums up to N*M = 401,408 products per output)
REL_CONV = {"bfloat16": {"conv1x1_fwd": 1e-2, "conv1x1_dgrad": 1e-4,
                         "conv1x1_wgrad": 1e-2},
            "float32": {"conv1x1_fwd": 1e-5, "conv1x1_dgrad": 1e-5,
                        "conv1x1_wgrad": 1e-4}}
# phase 6: eval-mode ResNet-50 logits in bf16, fused against unfused on the
# card (the fused apply rounds once in f32, the unfused BatchNorm computes
# in bf16; 53 layers of such rounding)
TOL_RESNET_EVAL_REL = 5e-2
# phase 6, the f32 step card vs CPU: the loss as phase 5. The gradients are
# looser: the port's own f32 step on the CPU is off a float64 evaluation
# of the same step by ~1.2e-2 (median over tensors) and ~1.7e-2 (worst),
# with or without the fused kernels (B=8, 112x112, random weights; phase 6
# measures it in every run): the stage-4 BatchNorms (8 samples x 4x4
# positions) project out most of the average pool's per-sample-constant
# gradient and amplify f32 rounding. About three times the worst of that
# is allowed per tensor.
TOL_RESNET_GRAD_REL = 5e-2
# the gradients of the conv biases that feed a BatchNorm are 0 in exact
# arithmetic (the BatchNorm subtracts the mean) and rounding noise in both
# runs: they are held to an absolute bound
TOL_RESNET_NOISE_ABS = 1e-4

KERNEL_INFO = {
    "flash_attention_fwd": ("mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
                            "mxnet_tpu/ops/pallas/attention.py:129"),
    "flash_attention_bwd_fused": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/attention.py:419"),
    "flash_attention_bwd_dq": ("mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                               "mxnet_tpu/ops/pallas/attention.py:344"),
    "flash_attention_bwd_dkv": (
        "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
        "mxnet_tpu/ops/pallas/attention.py:524"),
    "conv1x1_fwd": ("mxnet_tpu_torch/csrc/conv_fused.cu",
                    "mxnet_tpu/ops/pallas/conv_fused.py:122"),
    "conv1x1_dgrad": ("mxnet_tpu_torch/csrc/conv_fused.cu",
                      "mxnet_tpu/ops/pallas/conv_fused.py:217"),
    "conv1x1_wgrad": ("mxnet_tpu_torch/csrc/conv_fused.cu",
                      "mxnet_tpu/ops/pallas/conv_fused.py:306"),
}
ATTN_KERNELS = tuple(KERNEL_INFO)[:4]
CONV_KERNELS = tuple(KERNEL_INFO)[4:]
# BERT-base attention at the trained and served shapes
B_MAIN, H, D, T_MAIN = 8, 12, 64, 512
# ResNet-50's 1x1 junctions at b128, 224x224: (kind, Ci, Co, M); "triple"
# is (bn2, relu, conv3) of a bottleneck (affine prologue), "relu_conv" the
# deferred epilogue ReLU into the next block's conv1 (relu-only); both
# convs carry a bias
CONV_JUNCTIONS = [("triple", 64, 256, 3136), ("triple", 128, 512, 784),
                  ("triple", 256, 1024, 196), ("triple", 512, 2048, 49),
                  ("relu_conv", 256, 64, 3136), ("relu_conv", 512, 128, 784),
                  ("relu_conv", 1024, 256, 196), ("relu_conv", 2048, 512, 49)]
B_RESNET, IMG_RESNET = 128, 224

# ----------------------------------------------------------- mx.rtc (phase 7)
# User kernels for mx.rtc: CUDA C++ that NVRTC compiles for sm_90a at run
# time, each with its plain PyTorch version below (tests/test_torch_rtc.py
# and tests/test_torch_cuda.py use both). axpy, scale and square transcribe
# the three PallasModule kernels of tests/test_rtc.py; rtc_axpy is upstream
# MXNet's canonical mx.rtc example (y += alpha * x, in place); rtc_bias_gelu
# is GELU(x + b) in the erf form (mxnet_tpu/ops/nn.py:124) over BERT-base's
# FFN activation, and rtc_bias_gelu_grad its gradient dy * (Phi(u) + u *
# phi(u)). f32 arithmetic is written with __fmul_rn / __fadd_rn, which are
# never contracted into an FMA, in the order the plain version computes it.
RTC_SOURCES = {
    "axpy": r'''
extern "C" __global__ void axpy(const float* x, const float* y, float* o,
                                int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = __fadd_rn(__fmul_rn(2.0f, x[i]), y[i]);
}
''',
    "scale": r'''
// 128 columns; each block takes 8 rows: blockDim (128, 8)
extern "C" __global__ void scale(const float* x, float* o) {
  int row = blockIdx.x * blockDim.y + threadIdx.y;
  int i = row * blockDim.x + threadIdx.x;
  o[i] = __fmul_rn(x[i], 3.0f);
}
''',
    "square": r'''
extern "C" __global__ void square(const float* x, float* o, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = __fmul_rn(x[i], x[i]);
}
''',
    "rtc_axpy": r'''
extern "C" __global__ void rtc_axpy(const float* x, float* y, float alpha,
                                    int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    y[i] = __fadd_rn(y[i], __fmul_rn(alpha, x[i]));
}
''',
    "rtc_bias_gelu": r'''
#include <cuda_bf16.h>
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
// u = x + b, rounded to T as the plain version's (x + b) is
template <typename T> __device__ __forceinline__ float bias_add(T x, T b) {
  return to_f(from_f<T>(__fadd_rn(to_f(x), to_f(b))));
}
__device__ __forceinline__ float erf_term(float u) {  // 1 + erf(u / sqrt 2)
  return __fadd_rn(1.0f, erff(__fmul_rn(u, 0.70710678118654752f)));
}
// rows x cols, b over the columns; grid-stride over the n elements
template <typename T>
__global__ void rtc_bias_gelu(const T* x, const T* b, T* y, int n,
                              int cols) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float u = bias_add(x[i], b[i % cols]);
    y[i] = from_f<T>(__fmul_rn(__fmul_rn(0.5f, u), erf_term(u)));
  }
}
template <typename T>
__global__ void rtc_bias_gelu_grad(const T* x, const T* b, const T* dy,
                                   T* dx, int n, int cols) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float u = bias_add(x[i], b[i % cols]);
    float cdf = __fmul_rn(0.5f, erf_term(u));
    float pdf = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, u), u)),
                          0.3989422804014327f);
    dx[i] = from_f<T>(__fmul_rn(to_f(dy[i]),
                                __fadd_rn(cdf, __fmul_rn(u, pdf))));
  }
}
''',
}
GELU_TYPES = {"bfloat16": "__nv_bfloat16", "float32": "float"}
RTC_EXPORTS = {"rtc_bias_gelu": tuple(
    f"{k}<{c}>" for k in ("rtc_bias_gelu", "rtc_bias_gelu_grad")
    for c in GELU_TYPES.values())}
RTC_SIGNATURES = {
    "axpy": "const float *x, const float *y, float *o, int n",
    "scale": "const float *x, float *o",
    "square": "const float *x, float *o, int n",
    "rtc_axpy": "const float *x, float *y, float alpha, int n",
}
for _t in GELU_TYPES.values():
    RTC_SIGNATURES[f"rtc_bias_gelu<{_t}>"] = (
        f"const {_t} *x, const {_t} *b, {_t} *y, int n, int cols")
    RTC_SIGNATURES[f"rtc_bias_gelu_grad<{_t}>"] = (
        f"const {_t} *x, const {_t} *b, const {_t} *dy, {_t} *dx, int n, "
        "int cols")
RTC_KERNELS = ("axpy", "scale", "square", "rtc_axpy", "rtc_bias_gelu",
               "rtc_bias_gelu_grad")
SQRT1_2, INV_SQRT_2PI = 0.7071067811865476, 0.3989422804014327
# BERT-base's FFN activation in phase 7: B*T = 8*512 rows, 3072 columns
RTC_ROWS, RTC_COLS = 8 * 512, 3072
RTC_THREADS = 256


def plain_axpy(x, y):
    return 2.0 * x + y


def plain_scale(x):
    return x * 3.0


def plain_square(x):
    return x * x


def plain_rtc_axpy(x, y, alpha):
    return y + alpha * x


def plain_bias_gelu(x, b):
    import torch
    u = (x + b).float()
    return (0.5 * u * (1 + torch.erf(u * SQRT1_2))).to(x.dtype)


def plain_bias_gelu_grad(x, b, dy):
    import torch
    u = (x + b).float()
    cdf = 0.5 * (1 + torch.erf(u * SQRT1_2))
    pdf = torch.exp(-0.5 * u * u) * INV_SQRT_2PI
    return (dy.float() * (cdf + u * pdf)).to(x.dtype)


def rtc_blocks(n: int) -> int:
    """Blocks of a grid-stride launch over n elements: enough for 16
    blocks of 256 threads on each of the card's 132 SMs."""
    return max(1, min((n + RTC_THREADS - 1) // RTC_THREADS, 132 * 16))


def rtc_kernels(rtc):
    """Compile the user sources (one NVRTC program each). Returns
    ({kernel name: CudaKernel}, {source: compile seconds})."""
    kernels, seconds = {}, {}
    for src, code in RTC_SOURCES.items():
        t0 = time.perf_counter()
        mod = rtc.CudaModule(code, exports=RTC_EXPORTS.get(src, ()))
        seconds[src] = time.perf_counter() - t0
        for name, sig in RTC_SIGNATURES.items():
            if name.split("<")[0] in (src, src + "_grad"):
                kernels[name] = mod.get_kernel(name, sig)
    return kernels, seconds


def rtc_bias_gelu(kernels, x, b):
    """GELU(x + b) of NDArrays x (rows, cols) and b (cols,) through the
    bound rtc_bias_gelu kernel; its vjp launches rtc_bias_gelu_grad for dx
    and sums dx over the rows for db."""
    import torch
    ctype = GELU_TYPES[str(x.dtype)]
    fwd = kernels[f"rtc_bias_gelu<{ctype}>"]
    bwd = kernels[f"rtc_bias_gelu_grad<{ctype}>"]
    n, cols = x.size, x.shape[-1]
    grid, block = (rtc_blocks(n), 1, 1), (RTC_THREADS, 1, 1)

    def vjp(cot, xt, bt):
        dx = torch.empty_like(xt)
        bwd.launch([xt, bt, cot.contiguous(), dx, n, cols], xt.device, grid,
                   block)
        return [dx, dx.float().reshape(-1, cols).sum(0).to(bt.dtype)]

    return fwd.bind([(x.shape, str(x.dtype))], grid, block, vjp=vjp, n=n,
                    cols=cols)(x, b)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else f"nvidia-smi gave nothing (rc={out.returncode})"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def cuda_time_ms(fn, iters: int = 0, warmup: int = 3) -> float:
    """Mean ms of ``fn`` by CUDA events over ``iters`` back-to-back calls
    (0: as many as fit in ~0.2 s, between 3 and 50)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not iters:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        iters = int(min(50, max(3, 200.0 / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10):
    """Device time per call of ``fn``: its kernels' device time summed by
    torch.profiler over ``iters`` calls, or None when the profiler saw no
    device time. A library call such as ``torch.autograd.grad`` spends
    more time dispatching on the host than its kernels take, so
    back-to-back CUDA events would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(kernel_times(prof).values())
    return total / iters if total > 0 else None


def kernel_times(prof):
    """{kernel name: device ms} of a torch.profiler run."""
    out = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3
    return out


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def score_pairs(B, Tq, valid, causal):
    """(query, key) pairs this run's data needs: keys past a row's valid
    length, or above the causal diagonal, need no work."""
    if causal:
        return sum(sum(min(r + 1, valid[b]) for r in range(Tq))
                   for b in range(B))
    return Tq * sum(valid)


def bound(flops, nbytes, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound_ms(B, H, Tq, D, valid, dtype_name, elem, causal, bias):
    """Least time for one forward: each input read once, each output
    written once, and the products this run's data needs."""
    pairs = score_pairs(B, Tq, valid, causal)
    keys = sum(valid)                       # valid keys summed over batch
    nbytes = elem * H * D * (2 * B * Tq + 2 * keys)     # q, out; k, v
    nbytes += 4 * B * H * Tq                            # lse
    if bias is not None:
        nbytes += 4 * bias.numel()
    return bound(4.0 * H * D * pairs, nbytes, dtype_name)


def backward_bound_ms(kind, B, H, Tq, Tk, D, valid, dtype_name, elem,
                      causal, bias, want_ds):
    """Least time for one backward kernel (``fused``, ``dq``, ``dkv``) or
    the whole entry (``entry``: the fused work plus reading ``out`` for
    delta): q, k, v and dout read once (k, v only up to the valid
    lengths), lse and delta once, each output written once in q's dtype
    (the fused kernel's f32 dq buffer is a cost of its design, not of the
    function, so it is not counted); the products this run's data needs,
    2*D flops each per (query, key) pair: five for the fused pass, three
    for dq (s, dp, ds k), four for dk/dv (s, dp, p^T dout, ds^T q)."""
    pairs = score_pairs(B, Tq, valid, causal)
    keys = sum(valid)
    products = {"fused": 5, "entry": 5, "dq": 3, "dkv": 4}[kind]
    rows = B * H * Tq * D
    nbytes = elem * (2 * rows + 2 * H * D * keys)       # q, dout; k, v
    nbytes += 2 * 4 * B * H * Tq                        # lse, delta
    if bias is not None:
        nbytes += 4 * bias.numel()
    kv_out = 2 * elem * B * H * Tk * D                  # dk, dv
    nbytes += {"fused": elem * rows + kv_out,           # dq
               "entry": elem * 2 * rows + kv_out,       # out read; dq
               "dq": elem * rows, "dkv": kv_out}[kind]
    if want_ds and kind in ("fused", "dq", "entry"):
        nbytes += 4 * B * H * Tq * Tk
    return bound(2.0 * products * H * D * pairs, nbytes, dtype_name)


def rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm()
            / want.norm().clamp_min(1e-30)).item()


def rel_np(got, want) -> float:
    """Relative Frobenius error of numpy arrays."""
    import numpy as np
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def qkv_views(torch, dev, B, T, dt, gen):
    """q, k, v as (B, H, T, D) views of one (B, T, 3 * H * D) tensor, the
    layout BERT's fused projection gives the kernels."""
    qkv = torch.randn((B, T, 3 * H * D), generator=gen).to(dev, dt)
    return tuple(t.reshape(B, T, H, D).transpose(1, 2)
                 for t in qkv.split(H * D, dim=-1))


def keypad_bias(torch, dev, valid, T, dt):
    from mxnet_tpu_torch.ops.transformer import _mask_to_bias
    vl = torch.tensor(valid, device=dev)
    keep = torch.arange(T, device=dev)[None, :] < vl[:, None]
    return _mask_to_bias(keep[:, None, None, :], dt, len(valid), T, T)


def check_close(name, label, got, want, tol):
    if not bool(got.isfinite().all()):
        fail(f"{name}: {label} has non-finite values")
    err = (got.float() - want.float()).abs()
    lim = tol["atol"] + tol["rtol"] * want.float().abs()
    if (err > lim).any():
        fail(f"{name}: {label} max abs err {err.max().item():.3e} beyond "
             f"atol={tol['atol']} rtol={tol['rtol']}")
    return err.max().item()


def library_backward_ms(torch, q, k, v, bias, do, scale, causal, rate,
                        learned):
    """torch.autograd.grad through F.scaled_dot_product_attention at the
    same shape, device time (backward only; a yardstick, never used by
    the port)."""
    import torch.nn.functional as F
    try:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        mask = bias
        if bias is not None and learned:
            mask = bias.detach().requires_grad_(True)
            leaves.append(mask)
        out = F.scaled_dot_product_attention(
            *leaves[:3], attn_mask=mask, dropout_p=rate, is_causal=causal,
            scale=scale)
        return device_ms(lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True))
    except Exception as e:  # noqa: BLE001 - a yardstick only: reported
        print(f"phase 3:   library call unavailable here ({e!r:.120})",
              flush=True)
        return None


# ------------------------------------------------------------------ phase 2
def print_ptxas(kname, log_path) -> None:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output."""
    if not log_path.exists():
        return
    entries, cur = {}, None
    for line in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            entries.setdefault(cur, {})
        elif cur and "spill stores" in line:
            entries[cur]["spills"] = line.strip()
        elif cur and "Used" in line and "registers" in line:
            entries[cur]["regs"] = re.search(r"Used (\d+) registers",
                                             line).group(1)
    names = list(entries)
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names),
                             capture_output=True, text=True).stdout
        pretty = [n.replace("(anonymous namespace)::", "").split("(")[0]
                  .removeprefix("void ")
                  for n in out.splitlines()]
        if len(pretty) == len(names):
            names = pretty
    for pretty, (mangled, e) in zip(names, entries.items()):
        print(f"phase 2: {kname}: {pretty}: {e.get('regs', '?')} registers, "
              f"{e.get('spills', 'spills not reported')}", flush=True)


# ------------------------------------------------------------------ phase 3
def forward_checks(torch, dev, gen, attn):
    """Forward kernel against its plain version; dropout mask read back."""
    import torch.nn.functional as F
    cases = [
        dict(name="bf16 T=128 key-padding", T=128, dt=torch.bfloat16,
             causal=False, bias="keypad", B=B_MAIN, rate=0.0),
        dict(name="bf16 T=512 key-padding", T=512, dt=torch.bfloat16,
             causal=False, bias="keypad", B=B_MAIN, rate=0.0),
        dict(name="bf16 T=250 causal ragged", T=250, dt=torch.bfloat16,
             causal=True, bias=None, B=B_MAIN, rate=0.0),
        dict(name="f32 T=200 full bias", T=200, dt=torch.float32,
             causal=False, bias="full", B=2, rate=0.0),
        dict(name="bf16 T=512 key-padding dropout 0.1", T=512,
             dt=torch.bfloat16, causal=False, bias="keypad", B=B_MAIN,
             rate=0.1),
        dict(name="f32 T=512 key-padding dropout 0.1", T=512,
             dt=torch.float32, causal=False, bias="keypad", B=2, rate=0.1),
    ]
    res, worst = {}, 0.0
    seed = torch.tensor([20240, -17], dtype=torch.int32, device=dev)
    for c in cases:
        Bc, T, dt = c["B"], c["T"], c["dt"]
        valid = [T, T // 2, T // 3, 1, T - 7, T // 4, 17, T][:Bc] \
            if c["bias"] == "keypad" else [T] * Bc
        qh, kh, vh = qkv_views(torch, dev, Bc, T, dt, gen)
        bias = None
        if c["bias"] == "keypad":
            bias = keypad_bias(torch, dev, valid, T, dt)
        elif c["bias"] == "full":
            bias = torch.randn((1, H, T, T), generator=gen).to(dev, dt)
        rate = c["rate"]
        sd = seed if rate > 0 else None
        scale = 1.0 / math.sqrt(D)
        before = dict(attn.launches)
        out, lse = attn._flash_forward(qh, kh, vh, bias, scale, c["causal"],
                                       sd, rate)
        out_bthd = attn.flash_attention(
            qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
            scale=scale, causal=c["causal"], bias=bias, dropout=rate,
            dropout_seed=sd)
        torch.cuda.synchronize()
        moved = attn.launches["flash_attention_fwd"] - \
            before["flash_attention_fwd"]
        if moved != 2:
            fail(f"{c['name']}: forward counter moved by {moved}, expected 2")
        ref, ref_lse = attn.flash_attention_reference(
            qh.float(), kh.float(), vh.float(), bias, scale, c["causal"],
            sd, rate)
        tol = TOL_F32 if dt == torch.float32 else TOL_HALF
        err = check_close(c["name"], "out", out, ref, tol)
        check_close(c["name"], "out (B,T,H,D)", out_bthd.transpose(1, 2),
                    ref, tol)
        check_close(c["name"], "lse", lse, ref_lse, TOL_LSE)
        worst = max(worst, err)
        ms = cuda_time_ms(lambda: attn._flash_forward(
            qh, kh, vh, bias, scale, c["causal"], sd, rate))
        plain_ms = cuda_time_ms(lambda: attn.flash_attention_reference(
            qh, kh, vh, bias, scale, c["causal"], sd, rate))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias, scale=scale, is_causal=c["causal"],
            dropout_p=rate))
        dtn = str(dt).split(".")[-1]
        bnd, by = attention_bound_ms(Bc, H, T, D, valid, dtn,
                                     dt.itemsize, c["causal"], bias)
        print(f"phase 3: forward {c['name']}: max abs err {err:.3e} (out), "
              f"lse ok; kernel {ms:.4f} ms, bound {bnd:.4f} ms ({by}), plain "
              f"{plain_ms:.4f} ms, sdpa {fmt_ms(lib_ms)} (device)", flush=True)
        if c["name"] == "bf16 T=512 key-padding":
            # the served path's shape: the kernel's row of the result line
            res = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bnd, bound_by=by)
    for dt in (torch.bfloat16, torch.float32):
        dropout_mask_probe(torch, dev, attn, dt, seed)
    res["max_abs_err"] = worst
    return res


def dropout_mask_probe(torch, dev, attn, dt, seed, rate=0.1):
    """Read the forward kernel's dropout mask back bit for bit: with q = k
    = 0 every unmasked key has p = 1/128, and v = one-hot(key % 128) puts
    key j's kept-or-dropped probability alone into column j % 128. A
    key-padding bias leaves 128 keys unmasked per call; four calls cover
    512 keys. The mask must equal dropout_keep_reference's exactly."""
    B, T, W = B_MAIN, T_MAIN, 128
    zeros = torch.zeros((B, H, T, W), dtype=dt, device=dev)
    onehot = torch.eye(W, dtype=dt, device=dev).repeat(T // W, 1)
    v = onehot[None, None].expand(B, H, T, W)
    got = torch.zeros((B, H, T, T), dtype=torch.bool, device=dev)
    for grp in range(T // W):
        live = (torch.arange(T, device=dev) // W) == grp
        bias = torch.where(live, 0.0, torch.finfo(dt).min).to(dt)
        out, _ = attn._flash_forward(zeros, zeros, v, bias[None, None, None],
                                     1.0, False, seed, rate)
        got[..., grp * W:(grp + 1) * W] = out > 0
    want = attn.dropout_keep_reference(seed, B, H, T, T, rate)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        n = int((got != want).sum())
        fail(f"forward {dt} dropout mask differs from dropout_keep_reference "
             f"in {n} of {want.numel()} bits")
    print(f"phase 3: forward {str(dt).split('.')[-1]} dropout {rate} mask = "
          f"dropout_keep_reference bit for bit over ({B}, {H}, {T}, {T}); "
          f"kept {want.float().mean().item():.5f}", flush=True)


def backward_case(torch, dev, gen, attn, B, T, dt, causal, bias_kind, rate,
                  valid=None):
    qh, kh, vh = qkv_views(torch, dev, B, T, dt, gen)
    valid = valid or [T] * B
    bias = None
    if bias_kind == "keypad":
        bias = keypad_bias(torch, dev, valid, T, dt)
    elif bias_kind == "full":
        bias = torch.randn((1, H, T, T), generator=gen).to(dev, dt)
    do = torch.randn((B, T, H, D), generator=gen).to(dev, dt).transpose(1, 2)
    seed = torch.tensor([977, 31337], dtype=torch.int32, device=dev) \
        if rate > 0 else None
    scale = 1.0 / math.sqrt(D)
    out, lse = attn._flash_forward(qh, kh, vh, bias, scale, causal, seed,
                                   rate)
    return dict(q=qh, k=kh, v=vh, do=do, bias=bias, seed=seed, out=out,
                lse=lse, scale=scale, causal=causal, rate=rate, valid=valid,
                B=B, T=T, dt=dt, learned=bias_kind == "full")


def run_backward(attn, c, block_k):
    return attn._flash_backward(
        c["q"], c["k"], c["v"], c["bias"], c["seed"], c["out"], c["lse"],
        c["do"], c["scale"], c["causal"], block_k, c["rate"],
        bias_grad=c["learned"])


def backward_check(torch, attn, name, c, block_k, errs):
    """One backward call against the plain version; returns its outputs."""
    route = ["flash_attention_bwd_fused"] if c["T"] <= block_k else \
        ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
    before = dict(attn.launches)
    got = run_backward(attn, c, block_k)
    torch.cuda.synchronize()
    for n in attn.KERNELS[1:]:
        if attn.launches[n] - before[n] != (n in route):
            fail(f"{name}: {n} launched {attn.launches[n] - before[n]} "
                 f"times, expected {int(n in route)}")
    want = attn.flash_attention_backward_reference(
        c["q"], c["k"], c["v"], c["bias"], c["seed"], c["rate"], c["out"],
        c["lse"], c["do"], c["scale"], c["causal"], c["learned"])
    dtn = str(c["dt"]).split(".")[-1]
    lim = REL_BWD[dtn]
    parts = []
    for label, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        if not bool(g.isfinite().all()) or g.dtype != c["dt"]:
            fail(f"{name}: {label} non-finite or of dtype {g.dtype}")
        r = rel(g, w)
        if r > lim:
            fail(f"{name}: {label} relative error {r:.3e} > {lim}")
        abs_err = (g.float() - w).abs().max().item()
        owner = route[0] if len(route) == 1 else \
            ("flash_attention_bwd_dq" if label == "dq"
             else "flash_attention_bwd_dkv")
        errs[owner] = max(errs.get(owner, 0.0), abs_err)
        parts.append(f"{label} {r:.2e}")
    if c["learned"]:
        red = tuple(ax for ax, n in enumerate(c["bias"].shape[:3]) if n == 1)
        wb = want[3].sum(dim=red, keepdim=True)
        if got[3] is None or got[3].shape != c["bias"].shape:
            fail(f"{name}: dbias missing or of the wrong shape")
        r = rel(got[3], wb)
        if r > lim:
            fail(f"{name}: dbias relative error {r:.3e} > {lim}")
        parts.append(f"dbias {r:.2e}")
    elif got[3] is not None:
        fail(f"{name}: a dbias came back for a bias that is not learned")
    ms = cuda_time_ms(lambda: run_backward(attn, c, block_k))
    plain_ms = cuda_time_ms(lambda: attn.flash_attention_backward_reference(
        c["q"], c["k"], c["v"], c["bias"], c["seed"], c["rate"], c["out"],
        c["lse"], c["do"], c["scale"], c["causal"], c["learned"]))
    lib_ms = library_backward_ms(torch, c["q"], c["k"], c["v"], c["bias"],
                                 c["do"], c["scale"], c["causal"], c["rate"],
                                 c["learned"])
    bnd, by = backward_bound_ms(
        "entry", c["B"], H, c["T"], c["T"], D, c["valid"], dtn,
        c["dt"].itemsize, c["causal"], c["bias"], c["learned"])
    print(f"phase 3: backward {name}: relative error {', '.join(parts)} "
          f"(limit {lim}); entry {ms:.4f} ms, bound {bnd:.4f} ms ({by}), "
          f"plain {plain_ms:.4f} ms, sdpa backward {fmt_ms(lib_ms)} "
          f"(device)", flush=True)
    return got


def kernel_only_ms(torch, attn, c, name):
    """One backward kernel alone, launched again and again on buffers made
    once (the entry's delta, zeroing and casts excluded)."""
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    B, Hh, Tq, Dd = q.shape
    Tk = k.shape[2]
    delta = (do.float() * c["out"].float()).sum(dim=-1).contiguous()
    lse = c["lse"].reshape(B, Hh, Tq).contiguous()
    bias = None if c["bias"] is None else c["bias"].float()
    dev = q.device
    dk = torch.empty((B, Tk, Hh, Dd), dtype=k.dtype,
                     device=dev).transpose(1, 2)
    dv = torch.empty_like(dk)
    if name == "flash_attention_bwd_fused":
        dq = torch.zeros((B, Tq, Hh, Dd), dtype=torch.float32,
                         device=dev).transpose(1, 2)
        outs = (dq, dk, dv)
    elif name == "flash_attention_bwd_dq":
        outs = (torch.empty((B, Tq, Hh, Dd), dtype=q.dtype,
                            device=dev).transpose(1, 2), None, None)
    else:
        outs = (None, dk, dv)
    return cuda_time_ms(lambda: attn._launch_bwd(
        name, q, k, v, do, bias, c["seed"], c["rate"], lse, delta, *outs,
        None, c["scale"], c["causal"]))


def backward_checks(torch, dev, gen, attn):
    """The three backward kernels against the plain backward."""
    T = T_MAIN
    rng_valid = [T, T // 2, T // 3, 1, T - 7, T // 4, 17, T]  # as served
    errs, rows = {}, {}

    def mk(*args, **kwargs):
        return backward_case(torch, dev, gen, attn, *args, **kwargs)

    # the training shape: fused, without and with dropout
    c0 = mk(B_MAIN, T_MAIN, torch.bfloat16, False, "keypad", 0.0,
            valid=rng_valid)
    backward_check(torch, attn, "bf16 T=512 key-padding fused", c0, 1024,
                   errs)
    c1 = mk(B_MAIN, T_MAIN, torch.bfloat16, False, "keypad", 0.1,
            valid=rng_valid)
    fused = backward_check(torch, attn,
                           "bf16 T=512 key-padding dropout 0.1 fused", c1,
                           1024, errs)
    two = backward_check(torch, attn,
                         "bf16 T=512 key-padding dropout 0.1 two-pass "
                         "(block_k=256)", c1, 256, errs)
    agree(torch, "bf16 T=512 dropout 0.1", fused, two, "bfloat16")
    # the kernels alone at the training shape (dropout 0.1): result line
    for name, kind in (("flash_attention_bwd_fused", "fused"),
                       ("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        ms = kernel_only_ms(torch, attn, c1, name)
        bnd, by = backward_bound_ms(kind, B_MAIN, H, T_MAIN, T_MAIN, D,
                                    rng_valid, "bfloat16", 2, False,
                                    c1["bias"], False)
        rows[name] = dict(ms=ms, bound_ms=bnd, bound_by=by)
        print(f"phase 3: {name} alone, B={B_MAIN} H={H} T={T_MAIN} D={D} "
              f"bf16 key-padding dropout 0.1: {ms:.4f} ms, bound {bnd:.4f} "
              f"ms ({by})", flush=True)
    plain_ms = cuda_time_ms(lambda: attn.flash_attention_backward_reference(
        c1["q"], c1["k"], c1["v"], c1["bias"], c1["seed"], c1["rate"],
        c1["out"], c1["lse"], c1["do"], c1["scale"], False, False))
    lib_ms = library_backward_ms(torch, c1["q"], c1["k"], c1["v"],
                                 c1["bias"], c1["do"], c1["scale"], False,
                                 0.1, False)
    for r in rows.values():
        r.update(plain_ms=plain_ms, library_ms=lib_ms)
    del c0, c1, fused, two
    # long sequence: the two-pass pair by the default block_k, causal
    c = mk(2, 2048, torch.bfloat16, True, None, 0.0)
    backward_check(torch, attn, "bf16 T=2048 causal two-pass", c, 1024,
                   errs)
    # a learned (1, H, T, T) bias and its reduced gradient
    c = mk(4, T_MAIN, torch.bfloat16, False, "full", 0.1)
    backward_check(torch, attn, "bf16 T=512 learned bias dropout 0.1 fused",
                   c, 1024, errs)
    backward_check(torch, attn, "bf16 T=512 learned bias dropout 0.1 "
                   "two-pass (block_k=128)", c, 128, errs)
    # f32 for each
    c = mk(2, T_MAIN, torch.float32, False, "keypad", 0.1,
           valid=rng_valid[:2])
    fused = backward_check(torch, attn, "f32 T=512 key-padding dropout 0.1 "
                           "fused", c, 1024, errs)
    two = backward_check(torch, attn, "f32 T=512 key-padding dropout 0.1 "
                         "two-pass (block_k=256)", c, 256, errs)
    agree(torch, "f32 T=512 dropout 0.1", fused, two, "float32")
    c = mk(1, 2048, torch.float32, True, None, 0.0)
    backward_check(torch, attn, "f32 T=2048 causal two-pass", c, 1024, errs)
    c = mk(2, 256, torch.float32, False, "full", 0.0)
    backward_check(torch, attn, "f32 T=256 learned bias fused", c, 1024,
                   errs)
    for name, r in rows.items():
        r["max_abs_err"] = errs.get(name, 0.0)
    return rows


def agree(torch, name, fused, two, dtn):
    parts = []
    for label, a, b in zip(("dq", "dk", "dv"), fused[:3], two[:3]):
        r = rel(a, b)
        if r > REL_AGREE[dtn]:
            fail(f"{name}: fused and two-pass {label} differ by {r:.3e} "
                 f"> {REL_AGREE[dtn]}")
        parts.append(f"{label} {r:.2e}")
    print(f"phase 3: {name}: fused vs two-pass relative difference "
          f"{', '.join(parts)} (limit {REL_AGREE[dtn]})", flush=True)


def conv_bound_ms(name, N, Ci, Co, M, dtn, elem, affine, bias):
    """Least time for one conv kernel: x (and dy) read once, W, the scale
    and shift and the bias read once, the output written once (y in x's
    dtype, da in f32, dW in W's dtype); 2*N*Co*Ci*M flops."""
    x, dy_or_y, w = elem * N * Ci * M, elem * N * Co * M, elem * Co * Ci
    nbytes = x + dy_or_y + w + (8 * Ci if affine else 0)
    if name == "conv1x1_fwd":
        nbytes += 4 * Co if bias else 0
    elif name == "conv1x1_dgrad":
        nbytes += 4 * N * Ci * M
    return bound(2.0 * N * Co * Ci * M, nbytes, dtn)


def conv_case(torch, dev, gen, N, Ci, Co, M, dt, affine, bias):
    """x, W, dy in ``dt`` and f32 scale, shift, bias, drawn on the card from
    ``gen``, scale and shift as a BatchNorm gives them (about half of f(x)
    > 0)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(N, Ci, M).to(dt)
    w = (randn(Co, Ci) / math.sqrt(Ci)).to(dt)
    dy = randn(N, Co, M).to(dt)
    scale = shift = b = None
    if affine:
        scale = torch.rand((Ci,), generator=gen, device=dev) + 0.5
        shift = 0.2 * randn(Ci)
    if bias:
        b = 0.1 * randn(Co)
    return x, w, dy, scale, shift, b


def library_conv_ms(torch, name, x, w, dy, scale, shift, relu, b, hw):
    """cuDNN at the same shape, by CUDA events (a yardstick, never used by
    the port): F.conv2d on the already-activated input, conv2d_input,
    conv2d_weight."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.conv_fused import _prologue
    N, Ci, M = x.shape
    Co = w.shape[0]
    h4 = _prologue(x, scale, shift, relu).to(x.dtype).reshape(N, Ci, *hw)
    w4 = w.reshape(Co, Ci, 1, 1)
    dy4 = dy.reshape(N, Co, *hw)
    try:
        if name == "conv1x1_fwd":
            return cuda_time_ms(lambda: F.conv2d(h4, w4, b.to(x.dtype)
                                                 if b is not None else None))
        if name == "conv1x1_dgrad":
            return cuda_time_ms(lambda: torch.nn.grad.conv2d_input(
                h4.shape, w4, dy4))
        return cuda_time_ms(lambda: torch.nn.grad.conv2d_weight(
            h4, w4.shape, dy4))
    except Exception as e:  # noqa: BLE001 - a yardstick only: reported
        print(f"phase 3:   library call unavailable here ({e!r:.120})",
              flush=True)
        return None


def conv_check(torch, cf, label, case, relu, errs, timed=False, hw=None):
    """The three conv kernels on one case against their plain versions;
    each launch must move its counter by one. Returns {kernel: row} when
    ``timed``."""
    x, w, dy, scale, shift, b = case
    N, Ci, M = x.shape
    Co = w.shape[0]
    dtn = str(x.dtype).split(".")[-1]
    calls = {
        "conv1x1_fwd": (lambda: cf._fwd(x, scale, shift, w, relu, b),
                        lambda: cf.conv1x1_fwd_reference(x, scale, shift, w,
                                                         relu, b)),
        "conv1x1_dgrad": (lambda: cf._dgrad(x, scale, shift, w, dy, relu),
                          lambda: cf.conv1x1_dgrad_reference(
                              x, scale, shift, w, dy, relu)),
        "conv1x1_wgrad": (lambda: cf._wgrad(x, scale, shift, dy, relu,
                                            w.dtype),
                          lambda: cf.conv1x1_wgrad_reference(
                              x, scale, shift, dy, relu, w.dtype)),
    }
    rows, parts = {}, []
    for name, (kern, plain) in calls.items():
        before = cf.launches[name]
        got = kern()
        torch.cuda.synchronize()
        if cf.launches[name] != before + 1:
            fail(f"{label}: {name} counter moved by "
                 f"{cf.launches[name] - before}, expected 1")
        want = plain()
        want_dtype = torch.float32 if name == "conv1x1_dgrad" else x.dtype
        if got.dtype != want_dtype or got.shape != want.shape \
                or not bool(got.isfinite().all()):
            fail(f"{label}: {name} gave {got.dtype} {tuple(got.shape)} or "
                 "non-finite values")
        r = rel(got, want)
        lim = REL_CONV[dtn][name]
        if r > lim:
            fail(f"{label}: {name} relative error {r:.3e} > {lim}")
        errs[name] = max(errs.get(name, 0.0),
                         (got.float() - want.float()).abs().max().item())
        parts.append(f"{name.split('_')[1]} {r:.2e}")
        if timed:
            ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain)
            lib_ms = library_conv_ms(torch, name, x, w, dy, scale, shift,
                                     relu, b, hw)
            bnd, by = conv_bound_ms(name, N, Ci, Co, M, dtn, x.dtype.itemsize,
                                    scale is not None, b is not None)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bnd, bound_by=by)
            print(f"phase 3: {name} {label}: kernel {ms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by}), plain {plain_ms:.4f} ms, cuDNN "
                  f"{fmt_ms(lib_ms)}", flush=True)
    print(f"phase 3: conv {label}: relative error {', '.join(parts)}",
          flush=True)
    return rows


def conv_checks(torch, dev):
    """The conv kernels at ResNet-50's junctions and the edge cases."""
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    gen = torch.Generator(device=dev).manual_seed(1)
    errs, rows = {}, {}
    for kind, Ci, Co, M in CONV_JUNCTIONS:
        side = int(round(math.sqrt(M)))
        affine = kind == "triple"
        label = (f"bf16 {kind} N={B_RESNET} {Ci}->{Co} M={M} "
                 f"({'affine' if affine else 'relu-only'}, bias)")
        case = conv_case(torch, dev, gen, B_RESNET, Ci, Co, M,
                         torch.bfloat16, affine, True)
        got = conv_check(torch, cf, label, case, True, errs, timed=True,
                         hw=(side, side))
        if (kind, Ci, Co, M) == CONV_JUNCTIONS[0]:
            rows = got          # the result line's row: the stage-1 triple
        del case
    for kind, Ci, Co, M in CONV_JUNCTIONS:
        affine = kind != "triple"     # the other variant, without bias
        conv_check(torch, cf, f"f32 N=8 {Ci}->{Co} M={M} "
                   f"({'affine' if affine else 'relu-only'}, no bias)",
                   conv_case(torch, dev, gen, 8, Ci, Co, M, torch.float32,
                             affine, False), True, errs)
    for dt in (torch.bfloat16, torch.float32):
        dtn = str(dt).split(".")[-1]
        conv_check(torch, cf, f"{dtn} ragged N=3 45->77 M=53 (affine, "
                   "bias, relu off)",
                   conv_case(torch, dev, gen, 3, 45, 77, 53, dt, True, True),
                   False, errs)
        conv_check(torch, cf, f"{dtn} ragged N=3 45->77 M=53 (relu-only)",
                   conv_case(torch, dev, gen, 3, 45, 77, 53, dt, False,
                             False), True, errs)
        conv_check(torch, cf, f"{dtn} M=4100 > 4096 N=2 72->40 (affine)",
                   conv_case(torch, dev, gen, 2, 72, 40, 4100, dt, True,
                             False), True, errs)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    torch.cuda.empty_cache()
    return rows


def phase_kernels(torch, dev):
    """Phase 3: every kernel against its plain version."""
    from mxnet_tpu_torch.ops.cuda import attention as attn
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {"flash_attention_fwd": forward_checks(torch, dev, gen, attn)}
    rows.update(backward_checks(torch, dev, gen, attn))
    rows.update(conv_checks(torch, dev))
    print(f"phase 3: every kernel agrees with its plain version; card: "
          f"{smi_line()}", flush=True)
    return rows


# ------------------------------------------------------------------ phase 4
def random_bert_params(block, seed: int):
    """numpy weights for every parameter of ``block``, from ``seed``:
    N(0, 0.02) matrices and biases, LayerNorm gamma near 1."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        arr = rng.standard_normal(shape).astype(np.float32) * 0.02
        if name.endswith("gamma"):
            arr += 1.0
        out[name] = arr
    return out


def reset_counts(mod) -> None:
    for name in mod.KERNELS:
        mod.launches[name] = 0


# kernel-name patterns (re.search) of each group of a breakdown
ATTN_GROUPS = {"flash forward": r"flash_fwd", "flash backward": r"bwd_"}
CONV_GROUPS = {"conv1x1 fwd": r"(?<!flash_)fwd_(mma<|f32\b)",
               "conv1x1 dgrad": r"dgrad_(mma<|f32\b)",
               "conv1x1 wgrad": r"wgrad_(mma<|f32\b|reduce<)"}


def device_breakdown(prof, wall_ms, label, groups=None):
    """Device time per kernel from a torch.profiler run, the device's idle
    share over ``wall_ms`` and the share of each group of kernels (names
    matching the group's pattern). Returns (busy ms, idle share)."""
    per_kernel = kernel_times(prof)
    busy = sum(per_kernel.values())
    if busy <= 0:
        print(f"{label}: per-kernel device time: not measured (the profiler "
              "recorded no device time)", flush=True)
        return None, None
    shares = []
    for g, pat in (groups or ATTN_GROUPS).items():
        t = sum(v for k, v in per_kernel.items() if re.search(pat, k))
        shares.append(f"{g} {t:.3f} ms = {t / busy:.3f}")
    print(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms (idle "
          f"share {max(0.0, 1 - busy / wall_ms):.3f}); "
          f"{'; '.join(shares)} of busy", flush=True)
    for name, v in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{label}:   {v:8.3f} ms  {v / busy:6.3f}  {name[:90]}",
              flush=True)
    return busy, max(0.0, 1 - busy / wall_ms)


def forward_breakdown(torch, net, dev, B=8, T=512):
    """One direct bf16 forward of the served block at the top bucket:
    its time by CUDA events, and the device time per kernel from
    torch.profiler. The launch counters are restored afterwards."""
    from mxnet_tpu_torch.ops.cuda import attention as attn
    saved = dict(attn.launches)
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, 30522, (B, T), generator=gen).to(dev)
    vl = torch.randint(16, T + 1, (B,), generator=gen).to(dev)
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: net(tok, vl), iters=10, warmup=3)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net(tok, vl)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    attn.launches.update(saved)
    print(f"phase 4: direct forward B={B} T={T} bf16: {ms:.3f} ms "
          f"(CUDA events, mean of 10); card: {smi_line()}", flush=True)
    device_breakdown(prof, wall_ms, "phase 4: profiled forward")


def phase_bert(torch, dev):
    """Phase 4: BERT-base served on the card. Returns the forward kernel's
    launches in the serving run."""
    import numpy as np
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.serving import BucketPolicy, ModelServer, ServedModel

    class Encode(HybridBlock):
        """(tokens, valid_length) -> (sequence output, pooled output)."""

        def __init__(self, bert):
            super().__init__()
            self.bert = bert

        def forward(self, tokens, valid_length):
            return self.bert(tokens, None, valid_length)

    def bert_on_cpu():
        return get_bert("bert_12_768_12", vocab_size=30522, max_length=512,
                        dropout=0.1, device="cpu")

    t0 = time.perf_counter()
    cpu_bert = bert_on_cpu()
    params = random_bert_params(cpu_bert, seed=0)
    cpu_net = Encode(load_jax_params(cpu_bert, params))
    gpu_net = Encode(load_jax_params(bert_on_cpu(), params)).cast(
        torch.bfloat16)
    n_params = sum(p.numel() for p in gpu_net.parameters())
    print(f"phase 4: BERT-base built ({n_params} parameters, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    sig = [((512,), np.int32), ((), np.int32)]
    model = ServedModel.from_block(gpu_net, input_signature=sig, device=dev)
    policy = BucketPolicy(batch_buckets=(1, 2, 4, 8), pad_axis=0,
                          length_buckets=(128, 512))
    t0 = time.perf_counter()
    server = ModelServer(model, policy=policy, warmup=True, timeout_ms=5)
    print(f"phase 4: warmup {server.warmed} buckets in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.RandomState(1)
    lengths = [int(x) for x in rng.randint(16, 513, size=16)]
    lengths[0], lengths[1] = 16, 512
    samples = [(rng.randint(0, 30522, size=L).astype(np.int32),
                np.int32(L)) for L in lengths]
    lat = [0.0] * len(samples)
    results = [None] * len(samples)
    errors = []

    def client(i):
        try:
            t = time.perf_counter()
            results[i] = server.infer(*samples[i], timeout=300.0)
            lat[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 - reported below, fatal
            errors.append(f"request {i}: {e!r}")

    with server:
        reset_counts(attn)
        batches0 = server.stats["batches"]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(samples))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        counts = dict(attn.launches)
        batches = server.stats["batches"] - batches0
    if errors:
        fail("; ".join(errors))
    launches = counts["flash_attention_fwd"]
    if batches < 1 or launches != 12 * batches:
        fail(f"forward kernel launched {launches} times for {batches} "
             "batches; expected 12 per batch")
    if any(counts[n] for n in attn.KERNELS[1:]):
        fail(f"serving launched a backward kernel: {counts}")
    for (tok, L), res in zip(samples, results):
        seq, pooled = res
        if seq.shape != (L, 768) or pooled.shape != (768,) \
                or not (np.isfinite(seq).all() and np.isfinite(pooled).all()):
            fail(f"answer for length {L}: shapes {seq.shape}, "
                 f"{pooled.shape} or non-finite values")
    check = [0, 1, 2, 3, 4]
    worst = 0.0
    with torch.inference_mode():
        for i in check:
            tok, L = samples[i]
            ref_seq, ref_pooled = cpu_net(
                torch.from_numpy(tok[None].astype(np.int64)),
                torch.tensor([int(L)]))
            for got, want in ((results[i][0], ref_seq[0]),
                              (results[i][1], ref_pooled[0])):
                want = want.numpy()
                r = float(np.linalg.norm(got - want)
                          / max(np.linalg.norm(want), 1e-30))
                worst = max(worst, r)
                if r > TOL_BERT_REL:
                    fail(f"answer for length {L} off the CPU f32 forward: "
                         f"relative error {r:.3e} > {TOL_BERT_REL}")
    forward_breakdown(torch, gpu_net, dev)
    lat_ms = sorted(x * 1e3 for x in lat)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(math.ceil(0.99 * len(lat_ms))) - 1)]
    print(f"phase 4: {len(samples)} requests in {wall:.3f} s "
          f"({len(samples) / wall:.2f} req/s), {batches} batches, "
          f"{launches} forward launches, latency p50 {p50:.1f} ms p99 "
          f"{p99:.1f} ms; {len(check)} answers vs CPU f32: worst relative "
          f"error {worst:.3e}; card: {smi_line()}", flush=True)
    return counts


# ------------------------------------------------------------------ phase 5
def mlm_batch(torch, B, T, P, seed, vocab=30522, lo=None):
    """Tokens, token types, valid lengths, masked positions (distinct, all
    inside the valid length) and labels, from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    valid = rng.randint(lo or T // 4, T + 1, size=B)
    tok = rng.randint(0, vocab, (B, T))
    typ = rng.randint(0, 2, (B, T))
    pos = np.stack([rng.choice(int(v), P, replace=False) for v in valid])
    lab = rng.randint(0, vocab, (B, P))
    return [torch.from_numpy(np.asarray(x, dtype=np.int64))
            for x in (tok, typ, valid, pos, lab)]


def train_step(torch, autograd, net, loss_fn, trainer, batch):
    tok, typ, vl, pos, lab = batch
    with autograd.record():
        logits = net(tok, typ, vl, pos)[-1]
        loss = loss_fn(logits, lab)
    autograd.backward(loss)
    trainer.step(tok.shape[0])
    return loss


def phase_train(torch, dev):
    """Phase 5: BERT-base MLM training on the card. Returns the launch
    counts of the training run."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    from mxnet_tpu_torch.ops.cuda import attention as attn

    cfg = dict(vocab_size=30522, max_length=512, use_pooler=False,
               use_classifier=False)
    t0 = time.perf_counter()
    params = random_bert_params(
        get_bert("bert_12_768_12", device="cpu", dropout=0.1, **cfg), seed=0)
    net = load_jax_params(
        get_bert("bert_12_768_12", device=dev, dropout=0.1, **cfg), params,
        dtype="bfloat16")
    loss_fn = SoftmaxCrossEntropyLoss(axis=-1)
    trainer = Trainer(net.collect_params(), "adamw",
                      {"learning_rate": 1e-4, "multi_precision": True})
    B, T, P = B_MAIN, T_MAIN, 76
    batch = [x.to(dev) for x in mlm_batch(torch, B, T, P, seed=1, lo=128)]
    valid_tokens = int(batch[2].sum())
    print(f"phase 5: BERT-base MLM bf16 on {dev} built in "
          f"{time.perf_counter() - t0:.1f} s; B={B} T={T} masked {P}, valid "
          f"lengths {batch[2].tolist()}", flush=True)

    mx_random.seed(0)
    os.environ.pop("MXNET_FLASH_BLOCK_K", None)
    plan = [("fused", 10), ("two-pass", 2)]
    losses, times = {}, {}
    reset_counts(attn)                      # the main path starts here
    for route, n_steps in plan:
        if route == "two-pass":
            # the two-pass dq/dkv kernels: key blocks of 256 < T
            os.environ["MXNET_FLASH_BLOCK_K"] = "256"
        want = {"flash_attention_fwd": 12}
        want.update({"flash_attention_bwd_fused": 12} if route == "fused"
                    else {"flash_attention_bwd_dq": 12,
                          "flash_attention_bwd_dkv": 12})
        losses[route], times[route] = [], []
        for step in range(n_steps):
            before = dict(attn.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = train_step(torch, autograd, net, loss_fn, trainer, batch)
            torch.cuda.synchronize()
            times[route].append(time.perf_counter() - t)
            moved = {n: attn.launches[n] - before[n] for n in attn.KERNELS}
            if moved != {n: want.get(n, 0) for n in attn.KERNELS}:
                fail(f"{route} step {step}: kernel launches {moved}, "
                     f"expected {want}")
            lval = loss.float().mean().item()
            if not math.isfinite(lval) or tuple(loss.shape) != (B,):
                fail(f"{route} step {step}: loss {lval} of shape "
                     f"{tuple(loss.shape)}")
            losses[route].append(lval)
    os.environ.pop("MXNET_FLASH_BLOCK_K", None)
    counts = dict(attn.launches)            # ... and ends here
    first, last = losses["fused"][0], losses["fused"][-1]
    if not last < first:
        fail(f"the loss did not fall over 10 steps: {losses['fused']}")
    fused_ms = 1e3 * sum(times["fused"][2:]) / len(times["fused"][2:])
    two_ms = 1e3 * sum(times["two-pass"]) / len(times["two-pass"])
    print(f"phase 5: losses (fused) {[round(x, 4) for x in losses['fused']]}"
          f", (two-pass) {[round(x, 4) for x in losses['two-pass']]}",
          flush=True)
    print(f"phase 5: launches in the training run {counts}", flush=True)
    print(f"phase 5: step {fused_ms:.3f} ms (mean of steps 3-10, host "
          f"clock to synchronize), {B * T / fused_ms * 1e3:.0f} tokens/s "
          f"({valid_tokens / fused_ms * 1e3:.0f} valid tokens/s); two-pass "
          f"route {two_ms:.3f} ms (mean of 2); card: {smi_line()}",
          flush=True)

    # where the time goes in one fused step (counters restored after)
    from torch.profiler import ProfilerActivity, profile
    saved = dict(attn.launches)
    train_step(torch, autograd, net, loss_fn, trainer, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train_step(torch, autograd, net, loss_fn, trainer, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device_breakdown(prof, wall_ms, "phase 5: profiled step")
    # the step's three parts by host clock, each ended by a synchronize
    tok, typ, vl, pos, lab = batch
    split = {"forward+loss": 0.0, "backward": 0.0, "trainer.step": 0.0}
    walk_ms = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(tok, typ, vl, pos)[-1], lab)
        torch.cuda.synchronize()
        # the graph walk backward() makes for grad_req, timed alone
        tw = time.perf_counter()
        autograd._leaves([loss])
        walk_ms += (time.perf_counter() - tw) * 1e3 / 3
        t1 = time.perf_counter()
        autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(B)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(split, (t1 - t, t2 - t1, t3 - t2)):
            split[k] += dt * 1e3 / 3
    attn.launches.update(saved)
    print("phase 5: step parts (mean of 3, host clock): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; the backward's grad_req graph walk alone {walk_ms:.3f} ms",
        flush=True)
    del net, trainer
    torch.cuda.empty_cache()
    train_parity(torch, dev, params, cfg)
    return counts, fused_ms


def train_parity(torch, dev, params, cfg):
    """One f32 step, dropout 0, B=2, T=128: the card (kernels) against the
    CPU (plain path), loss and every parameter's gradient."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    from mxnet_tpu_torch.ops.cuda import attention as attn

    batch = mlm_batch(torch, 2, 128, 19, seed=2, lo=32)
    out = {}
    for where in ("cpu", dev):
        net = load_jax_params(
            get_bert("bert_12_768_12", device=where, dropout=0.0, **cfg),
            params)
        trainer = Trainer(net.collect_params(), "adamw",
                          {"learning_rate": 1e-4})
        before = dict(attn.launches)
        loss = train_step(torch, autograd, net, SoftmaxCrossEntropyLoss(),
                          trainer, [x.to(where) for x in batch])
        grads = {k: p.grad.detach().cpu() for k, p in
                 net.collect_params().items()}
        moved = attn.launches["flash_attention_bwd_fused"] - \
            before["flash_attention_bwd_fused"]
        if (where != "cpu") != (moved == 12):
            fail(f"parity step on {where}: {moved} fused backward launches")
        out[str(where)] = (loss.detach().cpu(), grads,
                           {k: p.detach().cpu() for k, p in
                            net.collect_params().items()})
    (lc, gc, wc), (lg, gg, wg) = out["cpu"], out[str(dev)]
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    if loss_rel > TOL_TRAIN_LOSS_REL:
        fail(f"f32 step: loss on the card {lg.tolist()} vs the CPU "
             f"{lc.tolist()}: relative {loss_rel:.3e} > {TOL_TRAIN_LOSS_REL}")
    grad_rel = max((rel(gg[k], gc[k]), k) for k in gc)
    if grad_rel[0] > TOL_TRAIN_GRAD_REL:
        fail(f"f32 step: gradient of {grad_rel[1]} off the CPU's by "
             f"{grad_rel[0]:.3e} > {TOL_TRAIN_GRAD_REL}")
    w_rel = max(rel(wg[k], wc[k]) for k in wc)
    print(f"phase 5: f32 step B=2 T=128 card vs CPU: loss relative "
          f"{loss_rel:.3e} (limit {TOL_TRAIN_LOSS_REL}), worst gradient "
          f"relative Frobenius {grad_rel[0]:.3e} ({grad_rel[1]}; limit "
          f"{TOL_TRAIN_GRAD_REL}), weights after the step {w_rel:.3e}",
          flush=True)


# ------------------------------------------------------------------ phase 6
def random_resnet_params(block, seed: int, zero_last_gamma: bool = True):
    """numpy weights for every parameter of ``block``, from ``seed``: conv
    weights He-normal (std sqrt(2 / fan_in)), the classifier N(0, 0.01),
    biases 0; BatchNorm gamma 1, except (``zero_last_gamma``) the last
    BatchNorm of each residual body (gamma 0: each block starts as its
    shortcut, Goyal et al. 2017,
    the initialization under which SGD at lr 0.1 and momentum 0.9 trains
    from the first step; with gamma 1 everywhere the loss of phase 6
    diverged after three steps), beta 0, running mean 0, var 1, and a zero
    stat-shift buffer (the first training step takes centered
    statistics)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            arr = rng.standard_normal(shape).astype(np.float32) \
                * np.float32(math.sqrt(2.0 / fan_in))
        elif leaf == "weight":
            arr = rng.standard_normal(shape).astype(np.float32) * 0.01
        elif zero_last_gamma and name.endswith("body.7.gamma"):
            arr = np.zeros(shape, np.float32)
        elif leaf in ("gamma", "running_var"):
            arr = np.ones(shape, np.float32)
        else:
            arr = np.zeros(shape, np.float32)
        out[name] = arr
    return out


def resnet_step(autograd, net, loss_fn, trainer, x, y):
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss


def resnet_steps(torch, autograd, net, loss_fn, trainer, x, y, n, want,
                 label):
    """``n`` training steps; every step must launch each kernel of
    ``want`` as often as it says, and nothing else. Returns (losses,
    seconds per step)."""
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    counters = [attn.launches, cf.launches]
    losses, times = [], []
    for step in range(n):
        before = [dict(c) for c in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = resnet_step(autograd, net, loss_fn, trainer, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        moved = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c}
        if moved != {k: want.get(k, 0) for k in moved}:
            fail(f"{label} step {step}: kernel launches {moved}, expected "
                 f"{want}")
        lval = loss.float().mean().item()
        if not math.isfinite(lval) or tuple(loss.shape) != (x.shape[0],):
            fail(f"{label} step {step}: loss {lval} of shape "
                 f"{tuple(loss.shape)}")
        losses.append(lval)
    return losses, times


def phase_resnet(torch, dev):
    """Phase 6: ResNet-50 v1 training on the card with the fused conv
    kernels, then without them, an eval forward both ways, and an f32 step
    against the CPU. Returns the conv kernels' launches of the main
    (fused) run."""
    import numpy as np
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf

    t0 = time.perf_counter()
    params = random_resnet_params(get_model("resnet50_v1", device="cpu"),
                                  seed=0)
    net = load_jax_params(get_model("resnet50_v1", device=dev), params,
                          dtype="bfloat16")
    loss_fn = SoftmaxCrossEntropyLoss()
    B = B_RESNET
    rng = np.random.RandomState(0)      # bench.py's synthetic batch
    x = torch.from_numpy(rng.uniform(-1, 1, (B, 3, IMG_RESNET, IMG_RESNET))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, 1000, (B,)).astype(np.int64)).to(dev)
    n_params = sum(p.numel() for k, p in net.collect_params().items()
                   if p.grad_req != "null")
    print(f"phase 6: ResNet-50 v1 bf16 on {dev} built in "
          f"{time.perf_counter() - t0:.1f} s ({n_params} trained "
          f"parameters); B={B}, {IMG_RESNET}x{IMG_RESNET}; SGD lr 0.1 momentum 0.9, "
          "multi_precision (f32 masters)", flush=True)

    def trainer():
        return Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9,
                        "multi_precision": True})

    fused_want = {k: 28 for k in CONV_KERNELS}
    os.environ["MXNET_FUSE_BN_CONV"] = "1"
    tr = trainer()
    reset_counts(attn)
    reset_counts(cf)                    # the main path starts here
    losses, times = resnet_steps(torch, autograd, net, loss_fn, tr, x, y, 10,
                                 fused_want, "fused")
    counts = {k: cf.launches[k] for k in CONV_KERNELS}   # ... and ends here
    if any(attn.launches[k] for k in ATTN_KERNELS):
        fail(f"ResNet-50 launched attention kernels: {attn.launches}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over 10 steps: {losses}")
    fused_ms = 1e3 * sum(times[2:]) / len(times[2:])
    print(f"phase 6: losses (fused) {[round(v, 4) for v in losses]}",
          flush=True)
    print(f"phase 6: launches in the training run {counts} (28 per step "
          "each: 16 triples + 12 deferred junctions)", flush=True)
    print(f"phase 6: fused step {fused_ms:.3f} ms (mean of steps 3-10, "
          f"host clock to synchronize), {B / fused_ms * 1e3:.1f} img/s; "
          f"card: {smi_line()}", flush=True)

    # where the time goes in one fused step (counters restored after)
    from torch.profiler import ProfilerActivity, profile
    saved = dict(cf.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        resnet_step(autograd, net, loss_fn, tr, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device_breakdown(prof, wall_ms, "phase 6: profiled fused step",
                     CONV_GROUPS)
    cf.launches.update(saved)

    # the same 10 steps from the same weights on the cuDNN-only chain
    os.environ["MXNET_FUSE_BN_CONV"] = "0"
    load_jax_params(net, params)
    tr = trainer()
    u_losses, u_times = resnet_steps(torch, autograd, net, loss_fn, tr, x, y,
                                     10, {}, "unfused")
    unfused_ms = 1e3 * sum(u_times[2:]) / len(u_times[2:])
    drift = max(abs(a - b) for a, b in zip(losses, u_losses))
    print(f"phase 6: losses (unfused) {[round(v, 4) for v in u_losses]}; "
          f"largest difference from the fused run's {drift:.4f}", flush=True)
    print(f"phase 6: unfused step {unfused_ms:.3f} ms, "
          f"{B / unfused_ms * 1e3:.1f} img/s; fused / unfused step time "
          f"{fused_ms / unfused_ms:.3f}; card: {smi_line()}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        resnet_step(autograd, net, loss_fn, tr, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device_breakdown(prof, wall_ms, "phase 6: profiled unfused step",
                     CONV_GROUPS)

    # eval mode (running statistics): the kernels against the unfused chain
    outs = {}
    with torch.no_grad():
        for knob in ("1", "0"):
            os.environ["MXNET_FUSE_BN_CONV"] = knob
            before = dict(cf.launches)
            outs[knob] = net(x).float()
            torch.cuda.synchronize()
            moved = {k: cf.launches[k] - before[k] for k in CONV_KERNELS}
            want = {"conv1x1_fwd": 28 if knob == "1" else 0,
                    "conv1x1_dgrad": 0, "conv1x1_wgrad": 0}
            if moved != want:
                fail(f"eval forward (fusion {knob}): launches {moved}, "
                     f"expected {want}")
    if not bool(outs["1"].isfinite().all()):
        fail("eval forward with the kernels: non-finite logits")
    r = rel(outs["1"], outs["0"])
    if r > TOL_RESNET_EVAL_REL:
        fail(f"eval forward: fused logits off the unfused ones by {r:.3e} "
             f"> {TOL_RESNET_EVAL_REL}")
    print(f"phase 6: eval forward B={B} bf16, fused vs unfused logits: "
          f"relative Frobenius {r:.3e} (limit {TOL_RESNET_EVAL_REL})",
          flush=True)
    del net, tr, outs, x
    torch.cuda.empty_cache()
    resnet_parity(torch, dev)
    os.environ.pop("MXNET_FUSE_BN_CONV", None)
    return counts


def resnet_parity(torch, dev):
    """One f32 SGD step, B=8, 112x112, fusion on: the card (kernels, TF32
    off) against the CPU (plain versions); loss and every gradient. Every
    gamma starts at 1 here, so every junction has a gradient to check. The
    same step in float64 on the CPU measures how far f32 rounding alone
    moves the gradients."""
    import numpy as np
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf

    os.environ["MXNET_FUSE_BN_CONV"] = "1"
    params = random_resnet_params(get_model("resnet50_v1", device="cpu"),
                                  seed=1, zero_last_gamma=False)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 3, 112, 112))
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, (8,)).astype(np.int64))
    def step(where, f64=False):
        net = load_jax_params(get_model("resnet50_v1", device=where), params)
        tr = Trainer(net.collect_params(), "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9})
        before = dict(cf.launches)
        xs = x.to(where)
        float_ = torch.Tensor.float
        if f64:
            # the port computes in f32 through Tensor.float(); rebound here,
            # every op of this step runs in float64
            net.to(torch.float64)
            xs = xs.double()
            torch.Tensor.float = lambda t: t.to(torch.float64)
        try:
            loss = resnet_step(autograd, net, SoftmaxCrossEntropyLoss(), tr,
                               xs, y.to(where))
        finally:
            torch.Tensor.float = float_
        moved = {k: cf.launches[k] - before[k] for k in CONV_KERNELS}
        if moved != {k: (0 if where == "cpu" else 28) for k in CONV_KERNELS}:
            fail(f"f32 parity step on {where}: conv launches {moved}")
        return (loss.detach().cpu(),
                {k: p.grad.detach().cpu().double() for k, p in
                 net.collect_params().items() if p.grad_req != "null"})

    out = {"cpu": step("cpu"), "card": step(dev), "f64": step("cpu", True)}
    (lc, gc), (lg, gg), (_, g64) = out["cpu"], out["card"], out["f64"]
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    if loss_rel > TOL_TRAIN_LOSS_REL:
        fail(f"ResNet f32 step: loss on the card {lg.tolist()} vs the CPU "
             f"{lc.tolist()}: relative {loss_rel:.3e} > {TOL_TRAIN_LOSS_REL}")
    noise = [k for k in gc if k.endswith(("body.0.bias", "body.6.bias"))]
    rels = sorted((rel(gg[k], gc[k]), k) for k in gc if k not in noise)
    grad_rel, median = rels[-1], rels[len(rels) // 2][0]
    if grad_rel[0] > TOL_RESNET_GRAD_REL:
        fail(f"ResNet f32 step: gradient of {grad_rel[1]} off the CPU's by "
             f"{grad_rel[0]:.3e} > {TOL_RESNET_GRAD_REL}")
    ref = sorted(rel(gc[k], g64[k]) for k in gc if k not in noise)
    noise_abs = max((gg[k] - gc[k]).abs().max().item() for k in noise)
    if noise_abs > TOL_RESNET_NOISE_ABS:
        fail(f"ResNet f32 step: a pre-BatchNorm conv bias gradient differs "
             f"by {noise_abs:.3e} > {TOL_RESNET_NOISE_ABS}")
    print(f"phase 6: f32 step B=8 112x112 card vs CPU: loss relative "
          f"{loss_rel:.3e} (limit {TOL_TRAIN_LOSS_REL}), gradient relative "
          f"Frobenius median {median:.3e}, worst {grad_rel[0]:.3e} "
          f"({grad_rel[1]}; limit {TOL_RESNET_GRAD_REL}), classifier "
          f"{rel(gg['output.weight'], gc['output.weight']):.3e}, "
          f"pre-BatchNorm conv bias gradients within "
          f"{noise_abs:.3e} (limit {TOL_RESNET_NOISE_ABS}); the CPU's f32 "
          f"gradients against the same step in float64: median "
          f"{ref[len(ref) // 2]:.3e}, worst {ref[-1]:.3e}", flush=True)


# ------------------------------------------------------------------ phase 7
# phase 7 tolerances: the mx.np ops on the card against the same ops on the
# CPU (elementwise and moves: one f32 rounding each way; sums: order)
TOL_NP_REL = 1e-5
# x.grad through rtc_bias_gelu's vjp against torch autograd of the plain
# forward on the card: bf16 rounds u, y and dx to bf16 in both, in other
# places; f32 differs by erff/expf against torch's erf/exp (<= 1 ulp) and
# the order of db's sum
TOL_RTC_GRAD = {"bfloat16": 2e-2, "float32": 1e-5}
# the kernels against their plain versions: axpy and scale exact; square,
# rtc_axpy and the f32 GELU kernels within 1 ulp; the bf16 GELU kernels
# relative 2e-2 (one bf16 rounding of u and of the output)
RTC_ULPS = 1
TOL_RTC_BF16 = 2e-2


def ulps(got, want) -> float:
    """Largest |got - want| in ulps of want (f32 tensors)."""
    import numpy as np
    g = got.float().cpu().numpy().astype(np.float64)
    w = want.float().cpu().numpy()
    return float((np.abs(g - w) / np.spacing(np.abs(w))).max())


def rtc_counts(rtc):
    """Launches per phase-7 kernel name (template instances summed)."""
    return {k: sum(v for n, v in rtc.launches.items()
                   if n.split("<")[0] == k) for k in RTC_KERNELS}


def np_ops_check(torch, mx, dev):
    """A handful of mx.np ops on (4096, 3072) arrays on the card against
    the same ops on the CPU."""
    import numpy as np
    rng = np.random.RandomState(7)
    a_np = rng.standard_normal((RTC_ROWS, RTC_COLS)).astype(np.float32)
    b_np = rng.standard_normal((RTC_ROWS, RTC_COLS)).astype(np.float32)
    ops = {
        "a*2+b": lambda np_, a, b: a * 2 + b,
        "exp(a).mean(1)": lambda np_, a, b: np_.exp(a).mean(axis=1),
        "sum(a*b, 0)": lambda np_, a, b: np_.sum(a * b, axis=0),
        "matmul": lambda np_, a, b: np_.matmul(a[:512], b[:512].T),
        "a[::2, 5:9]": lambda np_, a, b: a[::2, 5:9],
        "argmax(a, 1)": lambda np_, a, b: np_.argmax(a, axis=1),
        "where(a>0, a, b)": lambda np_, a, b: np_.where(a > 0, a, b),
        "transpose+reshape": lambda np_, a, b: np_.transpose(a).reshape(
            -1, 1024),
    }
    worst = 0.0
    for name, fn in ops.items():
        outs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                a, b = mx.np.array(a_np), mx.np.array(b_np)
                outs.append(fn(mx.np, a, b))
        got, want = outs
        torch.cuda.synchronize()
        if got.context != mx.gpu(0) or want.context != mx.cpu():
            fail(f"phase 7: mx.np {name} ran on {got.context}/{want.context}")
        if str(got.dtype) != str(want.dtype) or got.shape != want.shape:
            fail(f"phase 7: mx.np {name}: {got.dtype}{got.shape} on the card "
                 f"vs {want.dtype}{want.shape} on the CPU")
        r = rel_np(got.asnumpy(), want.asnumpy())
        worst = max(worst, r)
        if r > TOL_NP_REL:
            fail(f"phase 7: mx.np {name} off the CPU by {r:.3e} "
                 f"> {TOL_NP_REL}")
    print(f"phase 7: {len(ops)} mx.np ops at ({RTC_ROWS}, {RTC_COLS}) on "
          f"{dev} agree with the CPU (worst relative {worst:.3e})",
          flush=True)


def rtc_main_path(torch, mx, rtc, kernels, dev):
    """The imperative path through the rtc kernels: a GELU(x + b) layer of
    BERT-base's FFN under autograd (bf16 and f32), MXNet's canonical
    y += alpha * x in place, and test_rtc.py's three kernels through
    bind, the square one with a vjp. Synchronizes after each step, so
    that a fault is pinned to its kernel."""
    import numpy as np
    rng = np.random.RandomState(11)
    x_np = rng.standard_normal((RTC_ROWS, RTC_COLS)).astype(np.float32)
    b_np = rng.standard_normal((RTC_COLS,)).astype(np.float32)
    for dtype in ("bfloat16", "float32"):
        with mx.gpu(0):
            x = mx.np.array(x_np, dtype=dtype)
            b = mx.np.array(b_np, dtype=dtype)
        x.attach_grad()
        b.attach_grad()
        grad_obj = x.grad
        with mx.autograd.record():
            y = rtc_bias_gelu(kernels, x, b)
            s = y.sum()
        s.backward()
        torch.cuda.synchronize()
        if x.grad is not grad_obj:
            fail("phase 7: x.grad is not the same object after backward")
        xt = x._data.detach().clone().requires_grad_()
        bt = b._data.detach().clone().requires_grad_()
        plain_bias_gelu(xt, bt).sum().backward()
        rx, rb = rel(x.grad._data, xt.grad), rel(b.grad._data, bt.grad)
        if not (rx <= TOL_RTC_GRAD[dtype] and rb <= TOL_RTC_GRAD[dtype]):
            fail(f"phase 7: rtc_bias_gelu {dtype} gradients off torch "
                 f"autograd of the plain version: x {rx:.3e}, b {rb:.3e} "
                 f"(limit {TOL_RTC_GRAD[dtype]})")
        print(f"phase 7: record -> rtc_bias_gelu {dtype} ({RTC_ROWS}, "
              f"{RTC_COLS}) -> sum -> backward: x.grad relative error "
              f"{rx:.3e}, b.grad {rb:.3e} against torch autograd (limit "
              f"{TOL_RTC_GRAD[dtype]}); x.grad is the same object", flush=True)
    with mx.gpu(0):
        xa, ya = mx.np.array(x_np), mx.np.array(x_np[::-1])
    want = plain_rtc_axpy(xa._data, ya._data, 0.5)
    kernels["rtc_axpy"].launch([xa, ya, 0.5, xa.size], mx.gpu(0),
                               (rtc_blocks(xa.size), 1, 1),
                               (RTC_THREADS, 1, 1))
    torch.cuda.synchronize()
    if not torch.equal(ya._data, want):
        fail("phase 7: rtc_axpy (in place) differs from y + alpha * x")
    # test_rtc.py's three kernels, at its shapes
    with mx.gpu(0):
        v = mx.np.array(rng.uniform(-1, 1, (64,)).astype(np.float32))
        w = mx.np.array(rng.uniform(-1, 1, (64,)).astype(np.float32))
        m = mx.np.array(rng.uniform(-1, 1, (16, 128)).astype(np.float32))
        q = mx.np.array(np.linspace(-1, 1, 16).astype(np.float32))
    out = kernels["axpy"].bind([((64,), "float32")], (1,), (64,), n=64)(v, w)
    torch.cuda.synchronize()
    sc = kernels["scale"].bind([((16, 128), "float32")], (2, 1, 1),
                               (128, 8, 1))(m)
    torch.cuda.synchronize()
    sq = kernels["square"].bind([((16,), "float32")], (1,), (16,), n=16,
                                vjp=lambda cot, t: [cot * 2.0 * t])
    q.attach_grad()
    with mx.autograd.record():
        r = sq(q)
    r.backward()
    torch.cuda.synchronize()
    if not (torch.equal(out._data, plain_axpy(v._data, w._data))
            and torch.equal(sc._data, plain_scale(m._data))
            and torch.equal(r._data, plain_square(q._data))
            and torch.equal(q.grad._data, 2.0 * q._data)):
        fail("phase 7: a test_rtc.py kernel differs from its plain version")
    print("phase 7: rtc_axpy in place, axpy, scale (2 blocks of 8x128) and "
          "square (with vjp, backward) equal their plain versions",
          flush=True)


def rtc_kernel_rows(torch, rtc, kernels, dev):
    """Each phase-7 kernel against its plain version at the main path's
    shapes, its device time (CUDA events, L2 flushed before each call)
    beside its bound, its plain version's and a PyTorch library call's (a
    yardstick the port never calls). Launches made here are not
    counted."""
    import torch.nn.functional as F
    saved = dict(rtc.launches)
    g = torch.Generator().manual_seed(5)
    rows = {}

    def row(name, got, want, exact, run, plain, library, nbytes, flops,
            dtn):
        if exact and not torch.equal(got, want):
            fail(f"phase 7: {name} is not equal to its plain version")
        if not exact and dtn == "float32" and ulps(got, want) > RTC_ULPS:
            fail(f"phase 7: {name} is {ulps(got, want):.1f} ulp off its "
                 f"plain version (limit {RTC_ULPS})")
        if dtn == "bfloat16" and rel(got, want) > TOL_RTC_BF16:
            fail(f"phase 7: {name} relative error {rel(got, want):.3e} > "
                 f"{TOL_RTC_BF16}")
        err = (got.float() - want.float()).abs().max().item()
        b_ms, b_by = bound(flops, nbytes, "float32")
        rows[name] = dict(max_abs_err=err, ms=dev_ms(run),
                          plain_ms=dev_ms(plain), library_ms=dev_ms(library),
                          bound_ms=b_ms, bound_by=b_by)
        print(f"phase 7: {name}: max abs err {err:.3e}; device time, L2 "
              f"flushed: kernel "
              f"{rows[name]['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"plain {rows[name]['plain_ms']:.4f} ms, library "
              f"{rows[name]['library_ms']:.4f} ms; back-to-back launches "
              f"{cuda_time_ms(run):.4f} ms each (CUDA events: the host's "
              f"launch path where it is the longer); card: {smi_line()}",
              flush=True)

    flush = torch.empty(256 * 2 ** 20, device=dev)    # 1 GiB, 20x the L2

    def dev_ms(fn, iters=10):
        """Device time per call with the L2 cache flushed before each:
        these kernels stream tensors of 25-50 MB, which back-to-back calls
        would find partly in L2. Each call is enqueued behind the flush
        (~0.3 ms of device work, longer than the host takes to launch the
        call), so its CUDA events bracket its device work, not the host's
        launch path."""
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(iters):
            flush.zero_()
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def launcher(name, args, n, grid=None, block=None):
        k = kernels[name]
        grid = grid or (rtc_blocks(n), 1, 1)
        block = block or (RTC_THREADS, 1, 1)
        return lambda: k.launch(args, dev, grid, block)

    # test_rtc.py's kernels at their shapes
    v, w = (torch.rand(64, generator=g).to(dev) for _ in range(2))
    o = torch.empty_like(v)
    run = launcher("axpy", [v, w, o, 64], 64, (1,), (64,))
    run()
    row("axpy", o, plain_axpy(v, w), True, run, lambda: plain_axpy(v, w),
        lambda: torch.add(w, v, alpha=2.0), 3 * 4 * 64, 2 * 64, "float32")
    m = torch.rand(16, 128, generator=g).to(dev)
    o = torch.empty_like(m)
    run = launcher("scale", [m, o], 0, (2, 1, 1), (128, 8, 1))
    run()
    row("scale", o, plain_scale(m), True, run, lambda: plain_scale(m),
        lambda: torch.mul(m, 3.0), 2 * 4 * m.numel(), m.numel(), "float32")
    q = torch.rand(16, generator=g).to(dev)
    o = torch.empty_like(q)
    run = launcher("square", [q, o, 16], 16, (1,), (16,))
    run()
    row("square", o, plain_square(q), False, run, lambda: plain_square(q),
        lambda: torch.square(q), 2 * 4 * 16, 16, "float32")
    # the (4096, 3072) kernels of the main path
    n = RTC_ROWS * RTC_COLS
    x = torch.randn(RTC_ROWS, RTC_COLS, generator=g).to(dev)
    y0 = torch.randn(RTC_ROWS, RTC_COLS, generator=g).to(dev)
    y = y0.clone()
    kernels["rtc_axpy"].launch([x, y, 0.5, n], dev, (rtc_blocks(n), 1, 1),
                               (RTC_THREADS, 1, 1))
    ya = y0.clone()
    row("rtc_axpy", y, plain_rtc_axpy(x, y0, 0.5), False,
        launcher("rtc_axpy", [x, ya, 0.5, n], n),
        lambda: plain_rtc_axpy(x, ya, 0.5),
        lambda: torch.add(ya, x, alpha=0.5), 3 * 4 * n, 2 * n, "float32")
    for dtn in ("float32", "bfloat16"):
        dt = getattr(torch, dtn)
        t = GELU_TYPES[dtn]
        xg = (torch.randn(RTC_ROWS, RTC_COLS, generator=g) * 2).to(dev, dt)
        bg = torch.randn(RTC_COLS, generator=g).to(dev, dt)
        dy = torch.randn(RTC_ROWS, RTC_COLS, generator=g).to(dev, dt)
        yg, dx = torch.empty_like(xg), torch.empty_like(xg)
        fwd = launcher(f"rtc_bias_gelu<{t}>", [xg, bg, yg, n, RTC_COLS], n)
        bwd = launcher(f"rtc_bias_gelu_grad<{t}>",
                       [xg, bg, dy, dx, n, RTC_COLS], n)
        fwd()
        bwd()
        esz = xg.element_size()
        u = xg + bg
        suffix = "" if dtn == "bfloat16" else " f32"
        row("rtc_bias_gelu" + suffix, yg, plain_bias_gelu(xg, bg), False,
            fwd, lambda: plain_bias_gelu(xg, bg), lambda: F.gelu(xg + bg),
            2 * esz * n + esz * RTC_COLS, 6 * n, dtn)
        row("rtc_bias_gelu_grad" + suffix, dx, plain_bias_gelu_grad(
            xg, bg, dy), False, bwd, lambda: plain_bias_gelu_grad(xg, bg, dy),
            lambda: torch.ops.aten.gelu_backward(dy, u),
            3 * esz * n + esz * RTC_COLS, 11 * n, dtn)
    torch.cuda.synchronize()
    rtc.launches.clear()
    rtc.launches.update(saved)
    return rows


def rtc_negative_checks(torch, mx, rtc, kernels, dev):
    """Each of these must raise MXNetError."""
    from mxnet_tpu_torch.base import MXNetError
    k = kernels["rtc_axpy"]
    x = torch.rand(256, device=dev)
    with mx.cpu():
        cpu_x = mx.np.ones((256,))
    cases = {
        "a CPU NDArray": lambda: k.launch([cpu_x, x, 1.0, 256], mx.gpu(0),
                                          (1,), (256,)),
        "a non-contiguous argument": lambda: k.launch(
            [torch.rand(256, 2, device=dev)[:, 0], x, 1.0, 256], dev, (1,),
            (256,)),
        "a dtype that does not match": lambda: k.launch(
            [x.double(), x, 1.0, 256], dev, (1,), (256,)),
        "a source that does not compile": lambda: rtc.CudaModule(
            'extern "C" __global__ void k(float* x) { x[0] = nope; }'),
    }
    for what, fn in cases.items():
        try:
            fn()
        except MXNetError as e:
            if what.startswith("a source") and "nope" not in str(e):
                fail(f"phase 7: {what}: the message lacks NVRTC's log: {e}")
            continue
        fail(f"phase 7: {what} did not raise MXNetError")
    print(f"phase 7: {len(cases)} negative checks raise MXNetError "
          f"({', '.join(cases)})", flush=True)


def params_round_trip(torch, dev):
    """BERT-base with phase 4's seeded weights, bf16 on the card:
    save_parameters, load_parameters into a fresh get_bert, and the eval
    forward must be bit-identical."""
    import tempfile
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert

    def fresh():
        return get_bert("bert_12_768_12", vocab_size=30522, max_length=512,
                        dropout=0.1, device=dev)
    net = fresh()
    load_jax_params(net, random_bert_params(net, seed=0)).cast(torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, 30522, (4, 512), generator=gen).to(dev)
    vl = torch.tensor([512, 300, 77, 1], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert_base.params")
        t0 = time.perf_counter()
        net.save_parameters(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        other = fresh()
        t0 = time.perf_counter()
        other.load_parameters(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    with torch.inference_mode():
        a, b = net(tok, None, vl), other(tok, None, vl)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(a, b)):
        fail("phase 7: BERT-base after save_parameters -> load_parameters "
             "does not answer bit-identically")
    print(f"phase 7: BERT-base bf16 save_parameters -> load_parameters: "
          f"{size} bytes, save {save_s:.3f} s, load {load_s:.3f} s; eval "
          f"forward B=4 T=512 bit-identical", flush=True)


def phase_rtc(torch, dev):
    """Phase 7: the imperative path and mx.rtc. Returns (kernel rows,
    launches on the main path)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _nvrtc, rtc
    print(f"phase 7: NVRTC {'.'.join(map(str, _nvrtc.nvrtc_version()))}, "
          f"CUDA driver {_nvrtc.driver_version()}, -I "
          f"{_nvrtc.include_dirs()}", flush=True)
    kernels, seconds = rtc_kernels(rtc)
    print("phase 7: NVRTC compiled " + ", ".join(
        f"{k} {v:.2f} s" for k, v in seconds.items()), flush=True)
    np_ops_check(torch, mx, dev)
    rtc.launches.update({k: 0 for k in rtc.launches})
    rtc_main_path(torch, mx, rtc, kernels, dev)
    counts = rtc_counts(rtc)
    print(f"phase 7: launches on the main path {counts}", flush=True)
    missing = [k for k, v in counts.items() if not v]
    if missing:
        fail(f"phase 7: kernels never launched on the main path: {missing}")
    rows = rtc_kernel_rows(torch, rtc, kernels, dev)
    rtc_negative_checks(torch, mx, rtc, kernels, dev)
    params_round_trip(torch, dev)
    print(f"phase 7: every rtc kernel agrees with its plain version; card: "
          f"{smi_line()}", flush=True)
    return rows, counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels", "rtc"], default=None,
                    help="kernels: stop after the kernel checks (phases "
                    "1-3); rtc: phases 1 and 7 only")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mxnet_tpu_torch  # noqa: F401
        from mxnet_tpu_torch import _kernels
    except ImportError as e:
        fail(f"mxnet_tpu_torch not found beside this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"phase 1: device {name}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = torch.device("cuda:0")

    entries = []
    if args.only != "rtc":
        # phase 2
        t0 = time.perf_counter()
        built = _kernels.build_all()
        print(f"phase 2: built {sorted(built)} in "
              f"{time.perf_counter() - t0:.1f} s "
              f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})",
              flush=True)
        for kname in built:
            print_ptxas(kname, _kernels._target(kname).with_suffix(".log"))

        # phase 3
        rows = phase_kernels(torch, dev)

        launches = {n: None for n in KERNEL_INFO}
        if args.only is None:
            serve = phase_bert(torch, dev)
            train, _ = phase_train(torch, dev)
            launches.update({n: serve[n] + train[n] for n in ATTN_KERNELS})
            missing = [n for n in ATTN_KERNELS if not train[n]]
            if missing:
                fail(f"kernels never launched on the training path: "
                     f"{missing}")
            resnet = phase_resnet(torch, dev)
            launches.update(resnet)
            missing = [n for n in CONV_KERNELS if not resnet[n]]
            if missing:
                fail(f"kernels never launched on the ResNet-50 path: "
                     f"{missing}")
        entries += [dict(name=n, route="cuda", source=KERNEL_INFO[n][0],
                         replaces=KERNEL_INFO[n][1], launches=launches[n],
                         **rows[n]) for n in KERNEL_INFO]

    if args.only in (None, "rtc"):
        # phase 7
        rtc_rows, rtc_launches = phase_rtc(torch, dev)
        entries += [dict(name=n, route="cuda-nvrtc",
                         source="chip_smoke.py (user source)",
                         replaces="mxnet_tpu/rtc.py:89 PallasModule.get_kernel",
                         launches=rtc_launches[n], **rtc_rows[n])
                    for n in RTC_KERNELS]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
