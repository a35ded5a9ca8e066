#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``mxnet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, one GPU
    python3 chip_smoke.py --only kernels   # phases 1-3 (build + kernel checks)
    python3 chip_smoke.py --only rtc       # phases 1 and 7 (mx.nd + mx.rtc)
    python3 chip_smoke.py --only generate  # phases 1, 2 and 8 (GPT-2 generation)
    python3 chip_smoke.py --only seq2seq   # phases 1, 2 and 9 (the Transformer)
    python3 chip_smoke.py --only gpt-train # phases 1, 2 and 10 (GPT-2 training)
    python3 chip_smoke.py --only layers    # phases 1, 2 and 11 (DCGAN, layers)
    python3 chip_smoke.py --only quant     # phases 1, 2 and 12 (int8, SSD boxes)
    python3 chip_smoke.py --probe-fwd      # ... and the flash forward probe
    python3 chip_smoke.py --probe-bwd      # ... and the fused backward probe
    python3 chip_smoke.py --probe-conv     # ... and the conv fwd / dgrad probe
    python3 chip_smoke.py --only quant --probe-int8  # ... the int8 kernel's

Phases, each fatal on failure (non-zero exit, no result line):

1. device: the card's name and ``nvidia-smi`` name and power limit, and
   MXNet's ``Dense(...).initialize()`` with no arguments landing on
   ``cuda:0``;
2. build: every CUDA source of the port from ``mxnet_tpu_torch/csrc`` (the
   attention kernels, the wide ones for head dims above 256 among them,
   the conv and BatchNorm kernels, the multi-tensor update and the decode
   attention), one ``nvcc`` each, all started together; registers and
   spills per kernel;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the served and the trained BERT-base give it: the forward at
   head dims 64, 128 and 256, ragged and cross-length (Tq != Tk) shapes,
   causal, each bias broadcast, bf16, fp16 and f32, the fused-QKV strided
   layout and one layout TMA cannot address (its operands copied and
   counted), with and without dropout (its dropout mask read back and
   compared bit for bit in bf16, fp16 and f32), timed by device time
   beside the mma.sync kernel it replaced; the fused backward and the
   two-pass dq/dkv pair (at the training shape, at T=2048 causal and at
   head dim 256, where the pair is the route at every T), a learned
   (1, H, T, T) bias with its reduced gradient, fp16, causal and ragged
   (T=333), head dims 40, 128 and 256, f32 for each route, fused against
   two-pass on the same inputs, no operand of BERT's fused-QKV layout
   copied, two runs of the fused kernel whose f32 dq accumulators agree to
   rounding (dk, dv to the bit), two runs of the pair equal to the bit,
   and the pair's dropout masks read back bit for bit at head dims 40, 64,
   128 and 256 in bf16, fp16 and f32; each kernel timed by device time
   (torch.profiler; CUDA events beside it) and each entry by the device
   time of all its kernels (delta, zeroing, the kernel, the cast; for the
   pair delta, dq, dkv), beside its bound, its plain version and a PyTorch
   library call (yardstick only). The f32 kernels (``F32_TIMED``: BERT-base's
   (8, 12, 512, 64) key padding, GPT-2 training's (8, 12, 1024, 64)
   causal and (4, 8, 1024, 256) key padding: the 3xTF32 forward
   ``wwg::flash_fwd_tf32``, the 3xTF32
   fused pass (D <= 128) and the 3xTF32 pair, dq ``wwg::wide_dq_tf32`` and
   dk / dv ``tf::bwd_dkv_tf32`` / ``tf::bwd_dkv_tf32_st``, whose profiler
   records must name them) are timed beside their bound at the f32 FMA
   peak, their products' time as 3xTF32 on the tensor cores, the plain
   versions and SDPA's f32 calls. Then the wide kernels
   (head dims above
   256: ``wide_fwd``, ``wide_dq`` and ``wide_dkv``, the tiled wgmma
   kernels of ``flash_attention_wide_wg.cu`` (forward and dq at every
   16-bit head dim, streaming the head dim above 512; the 3xTF32 forward
   and dq at every f32 one) and ``flash_attention_wide_dkv.cu`` (16-bit
   dk / dv, streaming above 512) and the 3xTF32 f32 dk / dv of
   ``flash_attention_bwd.cu``) against their
   plain versions in ``WIDE_CASES`` (D = 264 to 1280; bias none, key
   padding and learned; causal; Tq != Tk; dropout; bf16, fp16, f32), two
   runs of the forward and of the backward equal to the bit, the copies
   of rows TMA cannot address counted (D = 300, 530; f32 530), on the
   streamed and the f32 routes the profiler's records showing the route's
   own three kernels and no other wide one, their dropout masks read back
   bit for bit at D = 288, 384, 512 and 576; their path: ``flash_attention``
   at (2, 512, 4, 288) and (8, 1024,
   8, 320) bf16 from one fused QKV projection, forward and backward under
   autograd with the counts from 0 (one launch of each kernel a shape, no
   operand copied), the profiler's kernel names showing the tiled forward,
   dq and dk / dv; and each ``WIDE_TIMED`` shape ((2, 4, 512, 288),
   (4, 8, 1024, 512), (2, 4, 512, 576) and (4, 8, 1024, 1024) with key
   padding, (8, 8, 1024, 320) with key padding and causal)
   against the plain versions, each kernel timed there by device time
   beside its bound, the plain version and SDPA's memory-efficient
   backend (the only one that takes such heads); the f32 forward, dq and
   dk / dv (``WIDE_F32_TIMED``: (2, 4, 512, 320), (8, 8, 1024, 320) and
   (2, 4, 512, 576) with key padding) checked and timed beside their FMA
   bounds, their products' time as 3xTF32, the plain versions and SDPA's
   f32 forward and whole backward. Then the three
   prologue-fused 1x1-conv kernels (fwd, dgrad, wgrad) against their plain
   versions at ResNet-50's eight b128 junction shapes in bf16 (each timed
   by device time beside its bound, its plain version and cuDNN:
   ``F.conv2d``, ``torch.nn.grad.conv2d_input``, ``conv2d_weight``, and by
   CUDA events beside the kernels it replaced (PR 3's fwd, PR 3's and PR
   5's dgrad); dgrad's ReLU mask compared bit for bit through a launch
   with W = dy = 1, wgrad run twice and compared to the bit, each
   junction's three plans printed, and the three kernels' totals per
   ResNet-50 step, the junctions weighted by how often they occur),
   the same shapes in f32 at N=8 with the other affine/bias variant, two
   fp16 junctions (wgrad at the f32 limit: f(x) kept as two fp16 terms), a
   ragged small shape with relu off, and an M > 4096 wgrad case; then
   BatchNorm's four training kernels (bn_stats, bn_apply, bn_bwd_reduce,
   bn_bwd_apply) against their plain versions at ResNet-50's nine
   BatchNorm shapes at N=128 in bf16, fp16 and f32, an NHWC (axis -1) and
   a 2-d case, an input mean of 100 (shifted and centered statistics),
   ragged shapes (one image and one channel among them) and a shape on
   the reductions' second level (few channels, large images), each twice
   and equal to the bit, each reduction one kernel record and no memset
   a call by the profiler, the ResNet-50 shapes' reduction plans one
   level; the bf16 shapes timed by
   device time beside the bound, the plain version, PyTorch's native
   batch-norm kernels (the library call of each) and cuDNN's training
   ``F.batch_norm`` forward and backward, and their totals per ResNet-50
   step, the shapes weighted by their layer counts; then the trainer's
   multi-tensor update against its plain version (the eager per-parameter
   update) in every case of ``UPDATE_CASES``: BERT-base's 154 tensors in
   bf16 with f32 masters under AdamW in groups of 4, 1 and all,
   ResNet-50's 193 in bf16 with masters under SGD with momentum 0.9,
   f32 without masters under SGD, Adam and AdamW, fp16 with masters,
   bf16 without, with clip_gradient and lr / wd multipliers, two cases
   with every other tensor's views off 16-byte alignment: three steps
   each, every weight, master and state equal to the bit, one launch a
   step (every tensor of a case shares one layout); the BERT-base and
   ResNet-50 cases timed by device time beside the bound, the plain
   version, ``torch._fused_adamw_`` / ``_fused_sgd_`` (yardsticks the
   port never calls) and the replaced kernel's time (one launch a group);
   with
   ``--probe-fwd``, the flash forward against builds of it with the
   softmax, the copies or the P V product cut out; with ``--probe-bwd``,
   the fused backward against builds of it with dropout's Philox, the dq
   product and reduce-add, or the exponentials cut out; with
   ``--probe-conv``, conv fwd and dgrad against builds of them with the
   copies, the products or the epilogue cut out, at the eight junctions;
4. BERT-base (12 layers, units 768, 12 heads, vocab 30522) with weights
   made from a seed, bf16 on ``cuda:0``, served by ``ModelServer`` with
   length buckets through ``ServedModel.from_block``, which hybridizes the
   block and takes its signature from one direct call: 16 concurrent
   requests to an eager server and to one whose warm-up captured every
   bucket as a CUDA graph (req/s, p50 / p99 each); the forward kernel
   must launch 12 times per executed batch (the eager server's counter;
   the profiler for both; the graph server's counter must not move: every
   batch a replay) with no operand copied for TMA; the 16 requests sent
   again one at a time must get the same bits from both servers, and
   answers must match the same weights run in f32 on the CPU through the
   plain path; a direct forward timed eager and replayed; then the serving
   front (``http_run``, ``drain_and_breaker``, ``export_run``): a graph
   server behind ``make_http_server`` on 127.0.0.1:0 answers the 16
   requests sent together from threads with ``http.client`` (req/s, p50 /
   p99; the forward kernel 12 a batch by the profiler, none by the
   counter, no SDPA kernel, no operand copied for TMA; each answer within
   TOL_HTTP_BATCHED_REL of the in-process answer alone), then each alone,
   parsed back to f32 and equal to the in-process graph server's bits; a
   ``traceparent`` continued into ``/v1/traces``; ``/metrics`` counting
   every answered request; the JSON encoding of one T=512 answer timed
   alone; ``/healthz`` 200, and after ``start_drain()`` 503 draining with
   ``/livez`` 200, a POST 429 draining and ``await_drained()`` True; a
   second server with ``max_restarts=0`` whose ``serving.worker`` fault
   trips the breaker (``/healthz`` 503 degraded) until ``reset_breaker()``
   (200, and a request answered with the same bits); and
   ``export(..., dynamic_batch=True)`` of the same bf16 BERT-base,
   ``ServedModel.from_export`` of its files with no block built, a
   ``ModelServer`` over it answering the 16 requests (req/s, p50 / p99,
   the forward kernel 12 a batch by the profiler and the counter, no
   SDPA, within TOL_EXPORT_REL of ``from_block``'s answers, and whether
   equal to the bit) and a bit-flipped ``.params`` refused by its
   checksum. The kernels line counts the forward's launches of the eager
   server, the HTTP run (replays: 0 by the counter) and the export run;
5. BERT-base MLM training through ``autograd.record`` / ``backward`` /
   ``Trainer.step`` with AdamW (multi-precision), bf16, B=8, T=512, 76
   masked positions, dropout 0.1: 10 steps on the fused backward, then 2
   with ``MXNET_FLASH_BLOCK_K=256`` on the two-pass pair; every step must
   launch the forward kernel 12 times and the backward kernels 12 times
   each, no operand may be copied for TMA, and the loss must fall; step
   time, tokens/s and a profiler breakdown with the device busy time and
   the backward kernels' part of it beside the mma.sync backward's (the
   kernel the fused one replaced, PERF.md), and the same for one
   two-pass step; the step's parts (forward+loss, backward, trainer.step)
   with each parameter updated alone and in groups of 4; then the net
   hybridized, from the same weights and generator state: 10 steps (the
   first the eager warm-up, its loss equal to the eager run's first; the
   second captures the forward and backward graphs), step time, tokens/s,
   device busy and idle share, a replayed step's kernels counted by the
   profiler equal to what the launch counters say an eager step launches
   (``step_kernel_counts``), its parts; a replayed call against
   an eager one (``Block.__call__``) from the same generator state on the
   fused route and on the two-pass pair: outputs with dropout 0.1 and the
   generator's state after equal to the bit, gradients within
   TOL_GRAPH_GRAD_REL (and whether equal to the bit), two replays drawing
   different dropout, ``grad_req='add'`` accumulating; then one f32 step
   on the card against the same step on the CPU (plain path), on the
   fused pass and on the 3xTF32 pair (``MXNET_FLASH_BLOCK_K=64`` below T;
   ``F32_ROUTES``; the profiler's records show the 3xTF32 forward, 12
   launches a step, and no f32 FMA kernel);
6. ResNet-50 v1 (classes 1000, full width and depth) with weights made
   from a seed, bf16 with f32 masters (``multi_precision``), B=128,
   224x224 synthetic data as ``bench.py`` makes it, SGD lr 0.1 momentum
   0.9, ``MXNET_FUSE_BN_CONV=1``: 10 steps of ``autograd.record`` ->
   ``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``Trainer.step(128)``;
   every step must launch each conv kernel 28 times (16 BatchNorm-relu-conv
   triples, 12 deferred relu-conv junctions) and the BatchNorm kernels
   53 / 37 / 37 / 53 times (the first step's centered statistics: bn_stats
   twice a layer), and the loss must fall; step time, img/s and a
   profiler breakdown (conv and batch-norm groups) with the peak device
   memory; the same 10 steps with ``MXNET_FUSE_BN_CONV=0`` (cuDNN convs,
   53 launches of each BatchNorm kernel a step) from the same weights; the
   fused step's parts with each parameter updated alone and in groups of
   4; an eval-mode forward with the kernels against the unfused one; the
   net hybridized, fused and unfused, 10 steps each from the same weights
   (the first, centered step eager, the second captured): step time,
   img/s, busy and idle share, the conv and BatchNorm kernels of a
   replayed step counted by the profiler equal to the eager step's, the
   parts, and a replayed call against an eager one (outputs and the
   BatchNorm statistics after it equal to the bit, gradients as phase 5);
   one f32 SGD step on the card (TF32 off) against the same step on the
   CPU;
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
8. (run after phase 6, before phase 7) GPT-2 124M generation at full width
   and depth, bf16, weights from a seed (matrices N(0, 1/fan_in):
   ``random_gpt_params``): a full forward at B=1, T=1024 (12 causal flash
   forward launches, no SDPA kernel, no operand copied, logits against f32
   on the CPU); ``GenerationServer(GenerationEngine(DecodeModel.from_block
   (net), max_slots=8), warmup=True)`` over KV buckets 128-1024 (greedy and
   mixed decode graphs captured per bucket); the main path, 16 concurrent
   requests in process under the profiler (prompts 16-512, 64-256 new
   tokens, 12 greedy and 4 sampled: launches counted there, the flash
   forward's by its counter, 12 an admission, the decode attention's
   replays by the profiler); the same 16 again in process and over HTTP
   (streamed), every prefill cold, streams equal to the main run's; no
   capture and no ``decode:*`` / ``prefill:*`` compile after warmup; each
   greedy token within ``GREEDY_MARGIN`` of its row's maximum in a
   teacher-forced full forward, no greedy stream constant; the decode
   step at S=8, L=128 and 1024 eager against replayed (tokens and KV rows
   equal to the bit, host ms each); self (k=4) and 2-layer-draft
   speculation, streams byte-identical to the plain run; in f32 (TF32
   off), three greedy prompts token for token against the f32 plain path
   on the CPU, a shared 256-token prefix (hits, streams equal to the prefix cache off) and two
   replicas with a ``serving.worker`` fault mid-stream over HTTP (streams
   token-identical, indexes contiguous, recoveries counted); then the
   flash forward at the prefill's shapes and the suffix pass, and the
   decode attention kernel, each against its plain version, timed beside
   its bound and a library call (the decode kernel with L2 flushed before
   each call and back to back, beside the replaced two-kernel version's
   time; a slot's bits
   equal in buckets 128 and 1024 and at another slot index; head dim 288
   within TOL_HALF);
9. (after phase 8) the encoder-decoder Transformer, ``transformer_base``
   (6 + 6 layers, 512 units, FFN 2048, 8 heads, shared vocabulary 32000,
   tied embedding), bf16 with f32 masters, weights from a seed
   (``random_transformer_params``) through ``load_jax_params``: Adam at lr
   1e-4, dropout 0.1, B=32 pairs of Ts = Tt = 128 with source valid
   lengths 32-128, ``autograd.record`` -> ``net(src, tgt_in, valid)`` ->
   ``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``Trainer.step``: 10
   eager steps, each launching the flash forward and the fused backward 18
   times (6 encoder, 6 causal decoder, 6 cross) and the update kernel
   once, nothing else of the port, no operand copied; one step at
   ``MXNET_FLASH_BLOCK_K=64`` (the dq/dkv pair, 18 each); the loss falls;
   step ms, tokens/s, busy and idle share, peak memory, no library
   attention kernel in the profile; 10 hybridized steps from the same
   weights and generator state (a replayed step's kernels by the profiler
   equal to the launch counters' eager step); one f32 step (B=2, Ts=24,
   Tt=16) against the CPU; then ``translate``: 8 sources of lengths 16-128
   padded to 128, 64 greedy tokens, 6 flash forwards and 768
   decode-attention launches (12 a token) by the counters, the decode
   kernel and no library attention in a profiled call, each token within GREEDY_MARGIN of its
   row's maximum in a teacher-forced bf16 ``decode``, ms a token and
   tokens/s; ``beam_translate`` at K=4 (scores best-first, the best no
   lower than K=1's); in f32 three sources (one of valid length 0) token
   for token against the port's CPU path; then the flash forward, fused
   backward and pair at the training shapes (key padding and causal) and
   the decode attention at translate's shapes against their plain
   versions, timed beside bound, plain and a library call, and the update
   over transformer_base's parameters;
10. GPT-2 124M trained (``get_gpt("gpt2_124m", vocab_size=50257,
   dropout=0.0, max_length=1024)``, ``bench.py:557``'s configuration),
   bf16 with f32 masters, AdamW lr 1e-4, B=8, T=1024: as phase 9, 12 + 12
   launches a step, the pair at ``MXNET_FLASH_BLOCK_K=512``, the f32 step
   at B=2, T=128, and the kernels at (8, 12, 1024, 64) causal;
11. (after phase 10, before phase 7) the Gluon layers, losses,
   initializers and ``npx`` operators, driven by MXNet's Gluon DCGAN
   (``example/gluon/dc_gan/dcgan.py``: nz 100, ngf = ndf = 64, 64x64,
   ``nn.Sequential`` of ``Conv2DTranspose`` / ``Conv2D``, ``BatchNorm``,
   relu / tanh / ``LeakyReLU(0.2)``, ``SigmoidBCELoss``, two Adam trainers
   at lr 2e-4, beta1 0.5; convolutions N(0, 0.02) from a seed; synthetic
   images in [-1, 1]): one iteration (D on a real batch and on
   ``G(z).detach()``, ``trainerD.step``, G through D, ``trainerG.step``) at
   B = 8 in f32 (TF32 off) on the card against the same on the CPU (losses
   TOL_DCGAN_LOSS_REL, every gradient TOL_DCGAN_GRAD_REL); the main path,
   10 iterations at B = 64, f32, the launch counts from 0 and asserted an
   iteration (BatchNorm's kernels 17 / 17 / 13 / 13, the first iteration's
   centered statistics 7 more ``bn_stats``, the update kernel 2), losses
   finite, every trained parameter moved, iteration ms and img/s, busy and
   idle share of one primed profiled iteration, peak memory and the TF32
   settings; BatchNorm's kernels at DCGAN's four shapes against their
   plain versions (the reductions' plans one level, one launch and no
   memset a call), timed with L2 flushed and totalled per iteration, and
   the update over the generator's and the discriminator's parameters;
   the initializers drawing on the card;
   then the sweep: every operator, layer and loss of Queue A 6 at a size
   its users run (BERT-base's FFN activation, its scores, ResNet-50's and
   AlexNet's and SSD's and Fast R-CNN's tensors, DCGAN's transposed
   convolutions, CTC at T = 400) forward and gradient on the card against
   the CPU (on a smaller batch where the CPU would take long) within
   TOL_SWEEP / TOL_SWEEP_LONG, bf16 against f32 within TOL_SWEEP_BF16 where
   the op takes bf16, each timed forward and forward+backward by device
   time (the median of three profiler sessions);
12. (after phase 11, before phase 7) int8 inference and SSD's box
   operators. The main path is upstream MXNet's ``example/quantization``
   flow: ``resnet50_v1`` (1000 classes, f32 weights from a seed through
   ``load_jax_params``) quantized by ``contrib.quantization.quantize_net``
   with naive calibration on 10 batches of 32 synthetic images, forwards
   at B = 64, 224x224: 54 int8 kernel launches a forward by the counters
   (53 convolutions and the Dense layer, each a whole quantized layer on
   the kernel's f32-in variant) with ``MXNET_FUSE_BN_CONV`` on and off (the
   fused bf16 conv kernels never), operand copies a forward printed and no
   weight repacked (each layer packs its own once), no cuDNN convolution or
   cuBLAS product in a primed profiled forward, two eager runs and three
   replays of the hybridized net equal to the bit; the logits against the
   f32 net (relative Frobenius error, top-1 agreement), then entropy
   calibration on 2 batches the same way; the card against the port's
   CPU int8 net at B = 2 with the card's ranges (the int8 weights equal,
   the logits within TOL_QUANT_CPU_REL); ms a forward eager and replayed,
   img/s, busy and idle share and peak memory of the f32, int8 and bf16
   nets; the int8 kernel at each distinct shape of the path and at a
   grouped, a dilated, a 1-d and a 3-d one, both variants (int8 in, int32
   out; f32 in, f32 out) equal to their plain versions to the bit, each
   timed beside its bound (the input elements the convolution reads,
   4 bytes each for the f32 variant) and its plain version, the f32
   variant beside the unfused operators it replaces (``quantize_v2``,
   the int8 product, ``dequantize``), and ``torch._int_mm`` where one
   product computes the shape; with ``--probe-int8``, both variants at
   those shapes, conv1, three 3x3 ones and a strided 1x1 against builds
   of the kernel with A's copies, the products, the epilogue's stores or
   parts of them cut out, in three rounds. Then the quantized operators
   as MXNet's symbolic int8 graphs call them (``quantize_v2``, each
   convolution ``quantized_conv`` and ``requantize``, ``quantized_act``,
   ``dequantize``) through a ResNet-50 bottleneck at B = 64, their own
   path for the int8-in variant's launches, on the card against the CPU
   to the bit. Then SSD-300's
   box operators at its own shapes (8732 anchors from ``multibox_prior``
   over six feature maps; ``multibox_target`` at B = 32, 21 classes, 64
   label rows, negative mining 3; ``multibox_detection`` at threshold
   0.01, NMS 0.45, top 400; ``box_iou`` and ``bipartite_matching``) on the
   card against the CPU, each timed (the median of three profiler
   sessions), and the NMS kernel's keep mask equal to its plain version's
   at the detection's shape and over all 8732 anchors of an image;
13. one ``{"kernels": [...]}`` line (the attention, update and decode
   launches counting phases 9 and 10's main paths too, BatchNorm's and the
   update's phase 11's, the int8 (both variants) and NMS kernels'
   phase 12's; with
   ``--only seq2seq`` / ``gpt-train`` / ``layers`` / ``quant`` the path's
   kernels alone, their rows measured at its shapes), the card line, and
   as the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of ``mxnet_tpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
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
REL_AGREE = {"bfloat16": 1e-2, "float16": 1e-2, "float32": 1e-5}
# two runs of the fused backward on the same inputs: dq's key tiles are
# summed in f32 in an order that changes from run to run (dk, dv do not)
REL_RERUN = 1e-6
# phase 4: bf16 BERT-base on the card against f32 on the CPU, relative
# Frobenius error of each answer (12 layers of bf16 rounding)
TOL_BERT_REL = 5e-2
# phase 4: the exported BERT-base against from_block's graph server on the
# card, relative Frobenius error of each answer (both bf16; the export pads
# every request to 512, the graph server to 128 or 512)
TOL_EXPORT_REL = 2e-2
# phase 4: the 16 HTTP requests sent together against the same requests
# answered alone in process (a batch's GEMMs may sum in another order than
# a batch of one's)
TOL_HTTP_BATCHED_REL = 2e-2
# PyTorch's own attention kernels (SDPA's flash, memory-efficient and math
# paths): none may run on the served or exported path
SDPA_KERNEL = r"pytorch_flash|fmha|efficient_attention|attention_kernel"
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
            # fp16 wgrad carries f(x) as fp16 hi + lo, about f32, like
            # the JAX kernel's f32 f(x); fwd rounds f(x) once as bf16 does
            "float16": {"conv1x1_fwd": 1e-2, "conv1x1_dgrad": 1e-4,
                        "conv1x1_wgrad": 1e-4},
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
    # BatchNorm's training VJP: the JAX package leaves it to XLA (no Pallas
    # kernel), so these name the lines of the function each kernel computes
    "bn_stats": ("mxnet_tpu_torch/csrc/batch_norm.cu",
                 "mxnet_tpu/ops/nn.py:528 (_bn_train_math, XLA)"),
    "bn_apply": ("mxnet_tpu_torch/csrc/batch_norm.cu",
                 "mxnet_tpu/ops/nn.py:534 (_bn_train_math, XLA)"),
    "bn_bwd_reduce": ("mxnet_tpu_torch/csrc/batch_norm.cu",
                      "mxnet_tpu/ops/nn.py:560 (_bn_train_bwd, XLA)"),
    "bn_bwd_apply": ("mxnet_tpu_torch/csrc/batch_norm.cu",
                     "mxnet_tpu/ops/nn.py:563 (_bn_train_bwd, XLA)"),
    # the trainer's grouped update: XLA in the JAX package (no Pallas
    # kernel), so this names the function it computes
    "multi_tensor_update": ("mxnet_tpu_torch/csrc/multi_tensor.cu",
                            "mxnet_tpu/gluon/trainer.py:833 (_fused_update, "
                            "XLA)"),
    # the flash kernels at head dims above 256 (the tiled ones take up to
    # 256): the same three Pallas kernels as rows 1, 3 and 4. 16-bit heads
    # take the tiled wide forward, dq and dk / dv at every D (streaming the
    # head dim above 512); f32 heads the 3xTF32 forward and dq
    # (wwg::wide_fwd_tf32, wwg::wide_dq_tf32) and the 3xTF32 dk / dv of
    # flash_attention_bwd.cu (tf::bwd_dkv_tf32_st)
    "flash_attention_wide_fwd": (
        "mxnet_tpu_torch/csrc/flash_attention_wide_wg.cu",
        "mxnet_tpu/ops/pallas/attention.py:129"),
    "flash_attention_wide_dq": (
        "mxnet_tpu_torch/csrc/flash_attention_wide_wg.cu",
        "mxnet_tpu/ops/pallas/attention.py:344"),
    "flash_attention_wide_dkv": (
        "mxnet_tpu_torch/csrc/flash_attention_wide_dkv.cu",
        "mxnet_tpu/ops/pallas/attention.py:524"),
}
ATTN_KERNELS = tuple(KERNEL_INFO)[:4]
# the mma.sync forward this redesign replaced, at the same shapes (PERF.md
# section 6, row 1, PRs 1-2): printed beside the new kernel's times
OLD_FWD_MS = {"bf16 T=512 key-padding": 0.1247,
              "bf16 T=512 key-padding dropout 0.1": 0.1527}
# --probe-fwd: the forward rebuilt with one part cut out
FWD_CUTS = {"softmax cut": "MXT_FWD_CUT=1", "copies cut": "MXT_FWD_CUT=2",
            "P.V cut": "MXT_FWD_CUT=3"}
FWD_KERNEL = r"flash_fwd_(wgmma|f32)"   # the forward's kernel names
# the backward kernels' names (re.search), for device time by torch.profiler
BWD_KERNEL = {"flash_attention_bwd_fused": r"bwd_fused_wg",
              "flash_attention_bwd_dq": r"bwd_dq_wg",
              "flash_attention_bwd_dkv": r"bwd_dkv_wg"}
# the mma.sync pair this redesign replaced: device time a launch at rows
# 3-4's shape (PERF.md section 6, final run PR 8)
OLD_PAIR_MS = {"flash_attention_bwd_dq": 0.2340,
               "flash_attention_bwd_dkv": 0.2282}
# the mma.sync fused backward this redesign replaced: its device time a
# launch in a BERT training step (PERF.md section 5)
OLD_FUSED_BWD_MS = 0.307
# the BERT training step's device busy time and its backward kernels' part
# with the mma.sync fused backward (PERF.md section 5)
MMA_SYNC_STEP_MS = (21.678, 3.679)
# --probe-bwd: the fused backward rebuilt with one part cut out
BWD_CUTS = {"Philox cut": "MXT_BWD_CUT=1", "dq product and add cut":
            "MXT_BWD_CUT=2", "exponentials cut": "MXT_BWD_CUT=3"}
CONV_KERNELS = tuple(KERNEL_INFO)[4:7]
# the kernels fwd and dgrad replaced, at CONV_JUNCTIONS (PERF.md section 6,
# CUDA events back to back, H100 80GB HBM3 at 700 W): PR 3's mma.sync fwd
# and dgrad, PR 5's wgmma dgrad; printed beside the new kernels' times
OLD_CONV_MS = {
    "conv1x1_fwd": {"PR 3": (0.2795, 0.2301, 0.4007, 0.3996, 0.1816, 0.1719,
                             0.3418, 0.3334)},
    "conv1x1_dgrad": {"PR 5": (0.3830, 0.1781, 0.2093, 0.1603, 0.5295,
                               0.3296, 0.2813, 0.1970),
                      "PR 3": (0.2255, 0.1624, 0.4947, 0.4912, 0.5496,
                               0.3064, 0.4717, 0.4790)}}
# --probe-int8: the int8 kernel rebuilt with one part cut out
INT8_CUTS = {"A copies cut": "MXT_I8_CUT=3", "products cut": "MXT_I8_CUT=1",
             "stores cut": "MXT_I8_CUT=2", "TMA stores cut": "MXT_I8_CUT=5",
             "TMA stores and fence cut": "MXT_I8_CUT=6",
             "TMA stores and staging writes cut": "MXT_I8_CUT=7"}
# --probe-int8's rounds: every build timed once a round, in turns
INT8_PROBE_ROUNDS = 3
# --probe-conv: fwd and dgrad rebuilt with one part cut out
CONV_CUTS = {"copies cut": "MXT_CONV_CUT=1", "products cut": "MXT_CONV_CUT=2",
             "epilogue cut": "MXT_CONV_CUT=3"}
# the conv kernels' names (re.search), for device time by torch.profiler
CONV_KERNEL = {"conv1x1_fwd": r"(?<!flash_)fwd_(tma|fma)<",
               "conv1x1_dgrad": r"dgrad_(tma|fma)<",
               "conv1x1_wgrad": r"wgrad_(rows|runs|f32|reduce)\b"}
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
# how often each junction occurs in one ResNet-50 v1 step (3/4/6/3
# bottlenecks; the first block of a stage has no deferred ReLU before it)
CONV_COUNTS = (3, 4, 6, 3, 2, 3, 5, 2)
B_RESNET, IMG_RESNET = 128, 224
# the ResNet-50 step's device busy time fused / unfused before the conv
# fwd / dgrad redesign (PERF.md section 5)
OLD_CONV_RESNET_BUSY_MS = (159.831, 151.030)
# ... and before BatchNorm's kernels, with eager f32 BatchNorm (PERF.md
# section 5)
EAGER_BN_RESNET_BUSY_MS = (150.355, 151.473)
BN_KERNELS = tuple(KERNEL_INFO)[7:11]
UPDATE_KERNELS = ("multi_tensor_update",)
WIDE_KERNELS = tuple(KERNEL_INFO)[12:15]
# the update kernel's launches a training step at aggregation 4: one a
# layout, and every trained tensor is bf16 with an f32 master (one layout):
# BERT-base's 154 tensors in 39 groups, ResNet-50 v1's 193 in 49
UPDATE_STEP = {"bert": 1, "resnet": 1}
# the wide kernels' names (re.search), for device time by torch.profiler,
# by the source of each (attn._source): the tiled ones (wwg::wide_fwd_wg,
# wwg::wide_dq_wg, wdkv::wide_dkv_wg), the streamed ones above 512
# (wwg::wide_fwd_st, wwg::wide_dq_st, wdkv::wide_dkv_st), the f32 forward
# and dq (wwg::wide_fwd_tf32, wwg::wide_dq_tf32) or the f32 dk / dv
# (tf::bwd_dkv_tf32_st)
WIDE_SOURCE_KERNEL = {
    "flash_attention_wide_wg": {
        "flash_attention_wide_fwd": r"wide_fwd_(wg<|st<|tf32\b)",
        "flash_attention_wide_dq": r"wide_dq_(wg<|st<|tf32\b)"},
    "flash_attention_wide_dkv": {
        "flash_attention_wide_dkv": r"wide_dkv_(wg|st)<"},
    "flash_attention_bwd": {
        "flash_attention_wide_dkv": r"bwd_dkv_tf32_st\b"}}
# the kernels each wide route runs (forward, dq, dk / dv, as WIDE_KERNELS),
# by the profiler's names; no other wide or 3xTF32 kernel may run on it
ROUTE_KERNELS = {
    "wide_wg": (r"wide_fwd_wg<", r"wide_dq_wg<", r"wide_dkv_wg<"),
    "wide_stream": (r"wide_fwd_st<", r"wide_dq_st<", r"wide_dkv_st<"),
    "wide_f32": (r"wide_fwd_tf32\b", r"wide_dq_tf32\b",
                 r"bwd_dkv_tf32_st\b")}
# the names of the kernels a route audit reads: the wide ones and the
# 3xTF32 ones
AUDITED = r"wide|tf32"
# the wide kernels' path (phase 3): attention over heads of 288 and 320
# through the user's entry point, forward and backward under autograd, bf16
WIDE_PATHS = (dict(B=2, T=512, H=4, D=288), dict(B=8, T=1024, H=8, D=320))
# BatchNorm's kernels' names (re.search), for device time by torch.profiler
BN_KERNEL = {"bn_stats": r"reduce_kernel<[^>]*, 0>",
             "bn_apply": r"apply_kernel<[^>]*, 0>",
             "bn_bwd_reduce": r"reduce_kernel<[^>]*, 1>",
             "bn_bwd_apply": r"apply_kernel<[^>]*, 1>"}
# ResNet-50 v1's 53 BatchNorm layers at 224x224: (C, H*W, layers), and the
# 16 of them (bn2 of each bottleneck) that MXNET_FUSE_BN_CONV=1 fuses into
# the next 1x1 conv, which then launch only bn_stats and bn_bwd_apply
BN_SHAPES = ((64, 12544, 1), (64, 3136, 6), (256, 3136, 4), (128, 784, 8),
             (512, 784, 5), (256, 196, 12), (1024, 196, 7), (512, 49, 6),
             (2048, 49, 4))
BN_FUSED = {(64, 3136): 3, (128, 784): 4, (256, 196): 6, (512, 49): 3}
# (outer, C, inner) of phase 3's case on the reductions' second level
BN_SECOND = (32, 3, 50176)
# a ResNet-50 step's BatchNorm launches, fused and unfused; the virgin
# first step takes centered statistics, two bn_stats sweeps a layer
BN_STEP = {"1": {"bn_stats": 53, "bn_apply": 37, "bn_bwd_reduce": 37,
                 "bn_bwd_apply": 53},
           "0": {k: 53 for k in BN_KERNELS}}
# phase 3, BatchNorm's kernels against their plain versions: statistics, dg
# and db relative Frobenius (f32 sums in another order; the mean's error
# relative to the batch's standard deviation, as a mean near 0 has no
# relative error of its own); out and dx within
# one ulp of their 16-bit dtype (the kernels round each f32 operation as
# the plain versions do) and relative 1e-5 in f32
TOL_BN_REL = 1e-5
TOL_BN_ULPS = 1

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
    fn()
    return profiled_ms(fn, iters, lambda name: True)


# a tiny kernel launched first in each timing session and never counted
# (its name holds "bitwise_not", as the L2 flush's does): a torch.profiler
# session in a process that ran earlier sessions can lose the records of its
# first launches (PERF.md §5), which would otherwise be the timed kernel's
# and read low
PRIMER_LAUNCHES = 16


def primer() -> None:
    import torch
    buf = torch.zeros(256, dtype=torch.uint8, device="cuda")
    for _ in range(PRIMER_LAUNCHES):
        torch.bitwise_not(buf, out=buf)


def profiled_ms(fn, iters, keep):
    """Device time per call of ``fn``'s kernels whose names ``keep``
    accepts, summed by torch.profiler over ``iters`` calls after the
    session's :func:`primer`; a session that records no device time (one
    in ~20 does) is repeated once; None when both record none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(v for k, v in kernel_times(prof).items()
                    if keep(k) and "bitwise_not" not in k)
        if total > 0:
            return total / iters
    return None


def launch_ms(fn, iters, keep, per_call: int = 1, warmup: int = 3):
    """Device time per call of ``fn``, which launches ``per_call`` kernels
    that ``keep`` accepts: their mean time a record over the records the
    profiler kept (after the session's :func:`primer`), times
    ``per_call``, so a lost record cannot read low; None when no record
    was kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times, counts = kernel_times(prof), kernel_counts(prof)
        kept = [k for k in times if keep(k) and "bitwise_not" not in k]
        total = sum(times[k] for k in kept)
        n = sum(counts.get(k, 0) for k in kept)
        if total > 0 and n:
            return total / n * per_call
    return None


def kernel_ms(fn, pattern: str, iters: int = 20):
    """Device time per call of the kernels of ``fn`` whose names match
    ``pattern`` (re.search), summed by torch.profiler over ``iters``
    calls after a warm-up; None when the profiler saw none. Unlike CUDA
    events over back-to-back calls this does not read the host's launch
    path when that is slower than the kernel."""
    for _ in range(3):
        fn()
    return profiled_ms(fn, iters, lambda name: re.search(pattern, name))


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


def kernel_counts(prof):
    """{kernel name: launches} of a torch.profiler run; it sees the kernels
    a CUDA graph replays, which no Python counter does."""
    out = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            out[evt.key] = out.get(evt.key, 0) + evt.count
    return out


def cold_ms(fn, keep, iters: int = 20, per_call=None):
    """Device time per call of ``fn``'s kernels that ``keep`` accepts, a
    64 MB buffer rewritten before each call (a bitwise-not kernel, not
    counted), so its inputs come from device memory, not the 50 MB L2, as
    a caller finds them whose other work came between (each layer of a
    decode step reads its own cache). ``per_call``: the kept kernels a
    call launches, to time by the records kept (:func:`launch_ms`); None
    sums them over the calls (:func:`profiled_ms`)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def call():
        torch.bitwise_not(flush, out=flush)
        fn()

    def kept(n):
        return keep(n) and "bitwise_not" not in n
    if per_call:
        return launch_ms(call, iters, kept, per_call)
    call()
    return profiled_ms(call, iters, kept)


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
    a whole entry (``entry`` on the fused pass, ``pair`` on the dq/dkv
    pair: the kernels' work plus reading ``out`` for delta): q, k, v and
    dout read once (k, v only up to the valid lengths), lse and delta once,
    each output written once in q's dtype (the fused kernel's f32 dq buffer
    is a cost of its design, not of the function, so it is not counted);
    the products this run's data needs, 2*D flops each per (query, key)
    pair: five for the fused pass, three for dq (s, dp, ds k), four for
    dk/dv (s, dp, p^T dout, ds^T q), seven for the pair."""
    pairs = score_pairs(B, Tq, valid, causal)
    keys = sum(valid)
    products = {"fused": 5, "entry": 5, "pair": 7, "dq": 3, "dkv": 4}[kind]
    rows = B * H * Tq * D
    nbytes = elem * (2 * rows + 2 * H * D * keys)       # q, dout; k, v
    nbytes += 2 * 4 * B * H * Tq                        # lse, delta
    if bias is not None:
        nbytes += 4 * bias.numel()
    kv_out = 2 * elem * B * H * Tk * D                  # dk, dv
    nbytes += {"fused": elem * rows + kv_out,           # dq
               "entry": elem * 2 * rows + kv_out,       # out read; dq
               "pair": elem * 2 * rows + kv_out,
               "dq": elem * rows, "dkv": kv_out}[kind]
    if want_ds and kind in ("fused", "dq", "entry", "pair"):
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


def qkv_views(torch, dev, B, T, dt, gen, d=D, h=H):
    """q, k, v as (B, h, T, d) views of one (B, T, 3 * h * d) tensor, the
    layout BERT's fused projection gives the kernels."""
    qkv = torch.randn((B, T, 3 * h * d), generator=gen).to(dev, dt)
    return tuple(t.reshape(B, T, h, d).transpose(1, 2)
                 for t in qkv.split(h * d, dim=-1))


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
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output,
    and ptxas's notes of lost performance (serialized wgmma)."""
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
        elif "Performance Loss" in line:
            print(f"phase 2: {kname}: {line.strip()}", flush=True)
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
def fwd_inputs(torch, dev, gen, c):
    """q, k, v (B, H, T, D) of a forward case: views of one fused
    (B, T, 3 H D) projection, BERT's layout (the default), or separate
    contiguous tensors with Tq = ``T`` != Tk (``cross``)."""
    B, T, d, dt = c["B"], c["T"], c.get("D", D), c["dt"]
    if c.get("cross"):
        return tuple(torch.randn((B, H, t, d), generator=gen).to(dev, dt)
                     for t in (T, c["Tk"], c["Tk"]))
    return qkv_views(torch, dev, B, T, dt, gen, d)


def fwd_bias(torch, dev, gen, c, Tq, Tk, valid):
    """None, the key-padding bias of ``valid``, or a random f32 bias
    broadcast as (B|1, H|1, Tq|1, Tk) by the case's (batch, head, query)
    flags."""
    kind = c.get("bias")
    if kind is None:
        return None
    if kind == "keypad":
        return keypad_bias(torch, dev, valid, Tk, c["dt"])
    b, h, q = kind
    shape = (c["B"] if b else 1, H if h else 1, Tq if q else 1, Tk)
    return torch.randn(shape, generator=gen).to(dev, c["dt"])


def forward_checks(torch, dev, gen, attn):
    """Forward kernel against its plain version at every head dim, ragged
    and cross-length shapes, causal, each bias broadcast, dropout, bf16,
    fp16 and f32, the fused-QKV strided layout and one layout TMA cannot
    address (its operands copied, counted); timed at the served and
    trained shapes. Dropout masks read back bit for bit."""
    import torch.nn.functional as F
    bf, fp, f32 = torch.bfloat16, torch.float16, torch.float32
    main = dict(T=512, B=B_MAIN, causal=False, bias="keypad", rate=0.0,
                timed=True)
    cases = [
        dict(main, name="bf16 T=512 key-padding", dt=bf),
        dict(main, name="bf16 T=512 key-padding dropout 0.1", dt=bf,
             rate=0.1),
        dict(main, name="fp16 T=512 key-padding", dt=fp),
        dict(main, name="bf16 T=128 key-padding", dt=bf, T=128),
        dict(main, name="bf16 D=128 T=512 key-padding", dt=bf, D=128),
        dict(main, name="bf16 D=256 T=512 key-padding", dt=bf, D=256),
        dict(name="bf16 T=250 causal ragged", T=250, dt=bf, causal=True,
             B=B_MAIN),
        dict(name="fp16 D=256 T=300 causal dropout 0.1", T=300, D=256,
             dt=fp, causal=True, B=2, rate=0.1),
        dict(name="bf16 D=128 Tq=77 Tk=333 cross key-padding", T=77,
             Tk=333, cross=True, D=128, dt=bf, B=2, bias="keypad"),
        dict(name="fp16 D=40 Tq=200 Tk=131 cross causal", T=200, Tk=131,
             cross=True, D=40, dt=fp, B=2, causal=True),
        dict(name="bf16 D=36 T=100 key-padding (padded copies)", T=100,
             D=36, dt=bf, B=2, bias="keypad", copies=3),
        dict(name="f32 T=200 full bias", T=200, dt=f32,
             bias=(False, True, True), B=2),
        dict(name="f32 T=512 key-padding dropout 0.1", T=512, dt=f32,
             bias="keypad", B=2, rate=0.1),
        dict(name="f32 D=256 T=100 causal", T=100, D=256, dt=f32, B=2,
             causal=True),
        dict(name="f32 D=37 T=100 key-padding (padded copies)", T=100,
             D=37, dt=f32, B=2, bias="keypad", copies=3),
        dict(name="f32 D=100 Tq=77 Tk=333 cross causal dropout 0.1", T=77,
             Tk=333, cross=True, D=100, dt=f32, B=2, causal=True, rate=0.1),
    ]
    for flags in ((False, False, False), (True, False, False),
                  (False, True, False), (True, True, False),
                  (False, False, True), (True, False, True),
                  (False, True, True), (True, True, True)):
        shape = "x".join(n if f else "1" for n, f in zip("BHT", flags))
        cases.append(dict(name=f"bf16 T=200 bias ({shape}, T)", T=200, dt=bf,
                          B=2, bias=flags))
    res, worst = {}, 0.0
    seed = torch.tensor([20240, -17], dtype=torch.int32, device=dev)
    for c in cases:
        Bc, T, dt = c["B"], c["T"], c["dt"]
        d, Tk = c.get("D", D), c.get("Tk", T)
        causal, rate = c.get("causal", False), c.get("rate", 0.0)
        valid = [Tk, Tk // 2, Tk // 3, 1, Tk - 7, Tk // 4, 17, Tk][:Bc] \
            if c.get("bias") == "keypad" else [Tk] * Bc
        qh, kh, vh = fwd_inputs(torch, dev, gen, c)
        bias = fwd_bias(torch, dev, gen, c, T, Tk, valid)
        sd = seed if rate > 0 else None
        scale = 1.0 / math.sqrt(d)
        before = (attn.launches["flash_attention_fwd"], attn.padded_copies)
        out, lse = attn._flash_forward(qh, kh, vh, bias, scale, causal,
                                       sd, rate)
        out_bthd = attn.flash_attention(
            qh.transpose(1, 2), kh.transpose(1, 2), vh.transpose(1, 2),
            scale=scale, causal=causal, bias=bias, dropout=rate,
            dropout_seed=sd)
        torch.cuda.synchronize()
        moved = attn.launches["flash_attention_fwd"] - before[0]
        if moved != 2:
            fail(f"{c['name']}: forward counter moved by {moved}, expected 2")
        copies = attn.padded_copies - before[1]
        if copies != 2 * c.get("copies", 0):
            fail(f"{c['name']}: {copies} padded copies, expected "
                 f"{2 * c.get('copies', 0)}")
        ref, ref_lse = attn.flash_attention_reference(
            qh.float(), kh.float(), vh.float(), bias, scale, causal, sd,
            rate)
        tol = TOL_F32 if dt == f32 else TOL_HALF
        err = check_close(c["name"], "out", out, ref, tol)
        check_close(c["name"], "out (B,T,H,D)", out_bthd.transpose(1, 2),
                    ref, tol)
        check_close(c["name"], "lse", lse, ref_lse, TOL_LSE)
        worst = max(worst, err)
        if not c.get("timed"):
            note = f", {copies} padded copies" if copies else ""
            print(f"phase 3: forward {c['name']}: max abs err {err:.3e} "
                  f"(out), lse ok{note}", flush=True)
            continue
        def call():
            return attn._flash_forward(qh, kh, vh, bias, scale, causal, sd,
                                       rate)
        ms = kernel_ms(call, FWD_KERNEL)
        host_ms = cuda_time_ms(call, iters=100)
        plain_ms = cuda_time_ms(lambda: attn.flash_attention_reference(
            qh, kh, vh, bias, scale, causal, sd, rate))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=bias, scale=scale, is_causal=causal,
            dropout_p=rate))
        dtn = str(dt).split(".")[-1]
        bnd, by = attention_bound_ms(Bc, H, T, d, valid, dtn, dt.itemsize,
                                     causal, bias)
        old = OLD_FWD_MS.get(c["name"])
        print(f"phase 3: forward {c['name']}: max abs err {err:.3e} (out), "
              f"lse ok; kernel {fmt_ms(ms)} (device)"
              f"{f' [PRs 1-2 mma.sync kernel: {old} ms]' if old else ''}, "
              f"{host_ms:.4f} ms a call back to back (CUDA events: the "
              f"host's launch path), bound {bnd:.6f} ms ({by}), plain "
              f"{plain_ms:.4f} ms, sdpa {fmt_ms(lib_ms)} (device)",
              flush=True)
        if c["name"] == "bf16 T=512 key-padding":
            # the served path's shape: the kernel's row of the result line
            res = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bnd, bound_by=by)
    for dt in (bf, fp, f32):
        dropout_mask_probe(torch, dev, attn, dt, seed)
    res["max_abs_err"] = worst
    return res


def forward_probe(torch, dev, attn):
    """Where the forward's time goes (``--probe-fwd``): the kernel rebuilt
    with its softmax, its copies after the first ring of stages, or its
    P V product cut out (``-DMXT_FWD_CUT=1/2/3``, wrong results), timed
    in turns with the full kernel at the served shape, with and without
    dropout. Variant launches are not counted."""
    import ctypes
    from mxnet_tpu_torch import _kernels
    argtypes = attn._kernel("flash_attention_fwd",
                            torch.bfloat16).argtypes
    fns = {}
    for label, define in FWD_CUTS.items():
        fn = _kernels.load("flash_attention_fwd",
                           (define,)).mxt_flash_attention_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[label] = fn
    gen = torch.Generator().manual_seed(7)
    T = T_MAIN
    valid = [T, T // 2, T // 3, 1, T - 7, T // 4, 17, T]
    seed = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    for dt in (torch.bfloat16,):
        qh, kh, vh = qkv_views(torch, dev, B_MAIN, T, dt, gen)
        bias = keypad_bias(torch, dev, valid, T, dt)
        out = torch.empty((B_MAIN, T, H, D), dtype=dt,
                          device=dev).transpose(1, 2)
        lse = torch.empty((B_MAIN, H, T, 1), device=dev)
        for rate in (0.0, 0.1):
            sd = seed if rate > 0 else None

            def run(fn):
                return lambda: attn._launch_fwd(qh, kh, vh, bias, sd, rate,
                                                out, lse, 0.125, False, fn)
            times = [("full", kernel_ms(run(None), FWD_KERNEL))]
            times += [(k, kernel_ms(run(f), FWD_KERNEL))
                      for k, f in fns.items()]
            times.append(("full again", kernel_ms(run(None), FWD_KERNEL)))
            print(f"phase 3: probe forward B={B_MAIN} H={H} T={T} D={D} "
                  f"{str(dt).split('.')[-1]} key-padding dropout {rate} "
                  "(device time a launch): "
                  + ", ".join(f"{k} {fmt_ms(v)}" for k, v in times)
                  + f"; card: {smi_line()}", flush=True)


def backward_probe(torch, dev, attn):
    """Where the fused backward's time goes (``--probe-bwd``): the kernel
    rebuilt with dropout's Philox words replaced by a hash, with the ds
    store and the dq product and reduce-add cut out, or with the
    exponentials cut out (``-DMXT_BWD_CUT=1/2/3``, wrong results, never
    checked), timed in turns with the full kernel at the training shape,
    with and without dropout. Variant launches are not counted."""
    import ctypes
    from mxnet_tpu_torch import _kernels
    name = "flash_attention_bwd_fused"
    argtypes = attn._kernel(name, torch.bfloat16).argtypes
    fns = {}
    for label, define in BWD_CUTS.items():
        fn = _kernels.load("flash_attention_bwd",
                           (define,)).mxt_flash_attention_bwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[label] = fn
    gen = torch.Generator().manual_seed(7)
    T = T_MAIN
    valid = [T, T // 2, T // 3, 1, T - 7, T // 4, 17, T]
    for rate in (0.0, 0.1):
        c = backward_case(torch, dev, gen, attn, B_MAIN, T, torch.bfloat16,
                          False, "keypad", rate, valid=valid)

        def timed(fn):
            call, _ = kernel_only_call(torch, attn, c, name, fn)
            return kernel_ms(call, BWD_KERNEL[name])
        times = [("full", timed(None))]
        times += [(k, timed(f)) for k, f in fns.items()]
        times.append(("full again", timed(None)))
        print(f"phase 3: probe backward B={B_MAIN} H={H} T={T} D={D} bf16 "
              f"key-padding dropout {rate} (device time a launch): "
              + ", ".join(f"{k} {fmt_ms(v)}" for k, v in times)
              + f"; card: {smi_line()}", flush=True)


def conv_probe(torch, dev):
    """Where conv fwd's and dgrad's time goes (``--probe-conv``): each
    rebuilt with the copies after the first ring of stages, the products,
    or the epilogue (mask, staging, stores) cut out (``-DMXT_CONV_CUT=1/2/
    3``, wrong results, never checked), timed by device time in turns with
    the full kernel at the eight junctions. Variant launches are not
    counted."""
    import ctypes
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    fns = {}
    for name, entry in (("conv1x1_fwd", "mxt_conv1x1_fwd"),
                        ("conv1x1_dgrad", "mxt_conv1x1_dgrad")):
        argtypes = cf._kernel(name).argtypes
        for label, define in CONV_CUTS.items():
            fn = getattr(_kernels.load("conv_fused", (define,)), entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name, label] = fn
    gen = torch.Generator(device=dev).manual_seed(3)
    for kind, Ci, Co, M in CONV_JUNCTIONS:
        x, w, dy, scale, shift, b = conv_case(torch, dev, gen, B_RESNET, Ci,
                                              Co, M, torch.bfloat16,
                                              kind == "triple", True)
        for name in ("conv1x1_dgrad", "conv1x1_fwd"):
            def run(fn):
                if name == "conv1x1_fwd":
                    return lambda: cf._fwd(x, scale, shift, w, True, b, fn=fn)
                return lambda: cf._dgrad(x, scale, shift, w, dy, True, fn=fn)
            times = [("full", kernel_ms(run(None), CONV_KERNEL[name]))]
            times += [(label, kernel_ms(run(fns[name, label]),
                                        CONV_KERNEL[name]))
                      for label in CONV_CUTS]
            times.append(("full again",
                          kernel_ms(run(None), CONV_KERNEL[name])))
            print(f"phase 3: probe {name} bf16 {kind} N={B_RESNET} "
                  f"{Ci}->{Co} M={M} (device time a launch): "
                  + ", ".join(f"{k} {fmt_ms(v)}" for k, v in times)
                  + f"; card: {smi_line()}", flush=True)
        del x, w, dy
    torch.cuda.empty_cache()


def dropout_mask_probe(torch, dev, attn, dt, seed, rate=0.1):
    """Read the forward kernel's dropout mask back bit for bit: with q = k
    = 0 every unmasked key has p = 1/128, and v = one-hot(key % 128) (head
    dim 128) puts
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
                  valid=None, d=D, h=H):
    qh, kh, vh = qkv_views(torch, dev, B, T, dt, gen, d, h)
    valid = valid or [T] * B
    bias = None
    if bias_kind == "keypad":
        bias = keypad_bias(torch, dev, valid, T, dt)
    elif bias_kind == "full":
        bias = torch.randn((1, h, T, T), generator=gen).to(dev, dt)
    do = torch.randn((B, T, h, d), generator=gen).to(dev, dt).transpose(1, 2)
    seed = torch.tensor([977, 31337], dtype=torch.int32, device=dev) \
        if rate > 0 else None
    scale = 1.0 / math.sqrt(d)
    out, lse = attn._flash_forward(qh, kh, vh, bias, scale, causal, seed,
                                   rate)
    return dict(q=qh, k=kh, v=vh, do=do, bias=bias, seed=seed, out=out,
                lse=lse, scale=scale, causal=causal, rate=rate, valid=valid,
                B=B, H=h, T=T, D=d, dt=dt, learned=bias_kind == "full")


def run_backward(attn, c, block_k):
    return attn._flash_backward(
        c["q"], c["k"], c["v"], c["bias"], c["seed"], c["out"], c["lse"],
        c["do"], c["scale"], c["causal"], block_k, c["rate"],
        bias_grad=c["learned"])


def backward_check(torch, attn, name, c, block_k, errs, phase="phase 3"):
    """One backward call against the plain version; returns its outputs."""
    fused = attn.backward_route(c["D"], c["T"], block_k) == "fused"
    route = ["flash_attention_bwd_fused"] if fused else \
        ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
    before = dict(attn.launches)
    copies = attn.padded_copies
    got = run_backward(attn, c, block_k)
    torch.cuda.synchronize()
    for n in attn.KERNELS[1:]:
        if attn.launches[n] - before[n] != (n in route):
            fail(f"{name}: {n} launched {attn.launches[n] - before[n]} "
                 f"times, expected {int(n in route)}")
    if attn.padded_copies != copies:
        fail(f"{name}: the fused-QKV views took "
             f"{attn.padded_copies - copies} padded copies; expected none")
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
    def entry():
        return run_backward(attn, c, block_k)
    dev_ms = device_ms(entry)
    ms = cuda_time_ms(entry)
    plain_ms = cuda_time_ms(lambda: attn.flash_attention_backward_reference(
        c["q"], c["k"], c["v"], c["bias"], c["seed"], c["rate"], c["out"],
        c["lse"], c["do"], c["scale"], c["causal"], c["learned"]))
    lib_ms = library_backward_ms(torch, c["q"], c["k"], c["v"], c["bias"],
                                 c["do"], c["scale"], c["causal"], c["rate"],
                                 c["learned"])
    bnd, by = backward_bound_ms(
        "entry" if fused else "pair", c["B"], c["H"], c["T"], c["T"],
        c["D"], c["valid"], dtn, c["dt"].itemsize, c["causal"], c["bias"],
        c["learned"])
    parts_of = "delta, zeroing, the kernel, the cast" if fused else \
        "delta, dq, dkv"
    print(f"{phase}: backward {name}: relative error {', '.join(parts)} "
          f"(limit {lim}); entry {fmt_ms(dev_ms)} (device: {parts_of}), "
          f"{ms:.4f} ms a call back to back (CUDA events), "
          f"bound {bnd:.4f} ms ({by}), plain {plain_ms:.4f} ms, sdpa "
          f"backward {fmt_ms(lib_ms)} (device)", flush=True)
    return got


def kernel_only_call(torch, attn, c, name, fn=None):
    """``(call, (dq, dk, dv))``: a call of one backward kernel alone, to be
    launched again and again on the buffers it returns, made once (the
    entry's delta, zeroing and casts excluded; the fused kernel keeps
    adding into one dq accumulator). ``fn``: a variant build of the C
    entry (``--probe-bwd``)."""
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    B, Hh, Tq, Dd = q.shape
    Tk = k.shape[2]
    delta = (do.float() * c["out"].float()).sum(dim=-1).contiguous()
    lse = c["lse"].reshape(B, Hh, Tq).contiguous()
    bias = None if c["bias"] is None else c["bias"].float()
    dev = q.device
    dk = attn._bthd_empty(B, Hh, Tk, Dd, k.dtype, dev)
    dv = attn._bthd_empty(B, Hh, Tk, Dd, v.dtype, dev)
    if name == "flash_attention_bwd_fused":
        outs = (attn.dq_accumulator(B, Hh, Tq, Dd, dev), dk, dv)
    elif name.endswith("_dq"):
        outs = (attn._bthd_empty(B, Hh, Tq, Dd, q.dtype, dev), None, None)
    else:
        outs = (None, dk, dv)
    return (lambda: attn._launch_bwd(
        name, q, k, v, do, bias, c["seed"], c["rate"], lse, delta, *outs,
        None, c["scale"], c["causal"], fn)), outs


def pair_dropout_masks(torch, attn, dev, dt, d, rate=0.1, B=2, Hh=3,
                       Tk=200):
    """The dropout masks the dq/dkv pair draws, read back bit for bit, each
    (B, Hh, Tq = d, Tk) bool: ``(from dkv, from dq, dropout_keep_reference's)``.

    dkv: with q = k = 0 every key has p = 1/Tk, and dout's row q =
    one-hot(q) puts query q's kept-or-dropped p_d[q, j] alone into
    dv[j, q] (exact: one product, the rest zeros). dq: with v = dout =
    one-hot(0), dp = 1 everywhere, and the gradient of a learned zero bias
    (B, Hh, Tq, Tk), ds = p (dp_d - delta), is positive where kept (dp_d =
    1/(1-rate) exceeds delta, the row's kept share over 1-rate, unless all
    Tk keys are kept) and negative where dropped. block_k = 64 < Tk: the
    pair at every head dim."""
    Tq, scale = d, 1.0 / math.sqrt(d)
    seed = torch.tensor([1234, 5678], dtype=torch.int32, device=dev)
    zq = torch.zeros((B, Hh, Tq, d), dtype=dt, device=dev)
    zk = torch.zeros((B, Hh, Tk, d), dtype=dt, device=dev)
    out, lse = attn._flash_forward(zq, zk, zk, None, scale, False, seed, rate)
    eye = torch.eye(d, dtype=dt, device=dev).expand(B, Hh, d, d).contiguous()
    dv = attn._flash_backward(zq, zk, zk, None, seed, out, lse, eye, scale,
                              False, 64, rate)[2]
    from_dkv = dv.transpose(-1, -2) > 0
    e0 = torch.zeros(d, dtype=dt, device=dev)
    e0[0] = 1
    v = e0.expand(B, Hh, Tk, d).contiguous()
    do = e0.expand(B, Hh, Tq, d).contiguous()
    bias = torch.zeros((B, Hh, Tq, Tk), dtype=dt, device=dev)
    out, lse = attn._flash_forward(zq, zk, v, bias, scale, False, seed, rate)
    dbias = attn._flash_backward(zq, zk, v, bias, seed, out, lse, do, scale,
                                 False, 64, rate, bias_grad=True)[3]
    want = attn.dropout_keep_reference(seed, B, Hh, Tq, Tk, rate)
    return from_dkv, dbias > 0, want


def pair_kernel_times(torch, attn, label, c, rows=None):
    """Device time of the dq and the dkv kernel alone at case ``c``, each
    beside its bound; ``rows`` (if given) gets each kernel's row."""
    dtn = str(c["dt"]).split(".")[-1]
    parts = []
    for name, kind in (("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        call, _ = kernel_only_call(torch, attn, c, name)
        ms = kernel_ms(call, BWD_KERNEL[name])
        bnd, by = backward_bound_ms(kind, c["B"], c["H"], c["T"], c["T"],
                                    c["D"], c["valid"], dtn,
                                    c["dt"].itemsize, c["causal"], c["bias"],
                                    c["learned"])
        if rows is not None:
            rows[name] = dict(ms=ms, bound_ms=bnd, bound_by=by)
        parts.append(f"{kind} {fmt_ms(ms)} (bound {bnd:.5f} ms, {by})")
    print(f"phase 3: the pair's kernels alone, {label} (device time a "
          f"launch): {', '.join(parts)}", flush=True)


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
    # the kernels alone at the training shape (dropout 0.1): result line.
    # Device time, as the forward's: at these kernels' speed the host's
    # launch path (checks, ctypes, five or six TMA descriptors) is slower
    # than the kernel, so CUDA events over back-to-back calls read the host
    for name, kind in (("flash_attention_bwd_fused", "fused"),
                       ("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        call, _ = kernel_only_call(torch, attn, c1, name)
        ms = kernel_ms(call, BWD_KERNEL[name])
        host_ms = cuda_time_ms(call)
        bnd, by = backward_bound_ms(kind, B_MAIN, H, T_MAIN, T_MAIN, D,
                                    rng_valid, "bfloat16", 2, False,
                                    c1["bias"], False)
        rows[name] = dict(ms=ms, bound_ms=bnd, bound_by=by)
        old = (f" [the mma.sync kernel it replaced: {OLD_FUSED_BWD_MS} ms a "
               "launch in the BERT step]" if kind == "fused" else
               f" [the mma.sync kernel it replaced: {OLD_PAIR_MS[name]} ms, "
               "PR 8's final run]")
        print(f"phase 3: {name} alone, B={B_MAIN} H={H} T={T_MAIN} D={D} "
              f"bf16 key-padding dropout 0.1: {fmt_ms(ms)} (device){old}, "
              f"{host_ms:.4f} ms a call back to back (CUDA events), bound "
              f"{bnd:.4f} ms ({by})", flush=True)
    plain_ms = cuda_time_ms(lambda: attn.flash_attention_backward_reference(
        c1["q"], c1["k"], c1["v"], c1["bias"], c1["seed"], c1["rate"],
        c1["out"], c1["lse"], c1["do"], c1["scale"], False, False))
    lib_ms = library_backward_ms(torch, c1["q"], c1["k"], c1["v"],
                                 c1["bias"], c1["do"], c1["scale"], False,
                                 0.1, False)
    for r in rows.values():
        r.update(plain_ms=plain_ms, library_ms=lib_ms)
    fused_reruns(torch, attn, c1, "bf16 T=512 key-padding dropout 0.1")
    # the pair writes dq once from registers, with no atomics: two runs
    # equal to the bit
    runs = []
    for _ in range(2):
        outs = []
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            call, o = kernel_only_call(torch, attn, c1, name)
            call()
            outs += [t for t in o if t is not None]
        runs.append(outs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("two runs of the dq/dkv pair differ (dq, dk or dv)")
    print("phase 3: two runs of the dq/dkv pair: dq, dk and dv equal to the "
          "bit", flush=True)
    del c0, c1, fused, two, runs
    # the pair's dropout masks, bit for bit, at every head dim and dtype
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        for d in (40, 64, 128, 256):
            from_dkv, from_dq, want = pair_dropout_masks(torch, attn, dev,
                                                         dt, d)
            torch.cuda.synchronize()
            for what, got in (("dkv", from_dkv), ("dq", from_dq)):
                if not torch.equal(got, want):
                    fail(f"{dt} D={d}: the {what} kernel's dropout mask "
                         f"differs from dropout_keep_reference in "
                         f"{int((got != want).sum())} of {want.numel()} bits")
        print(f"phase 3: the pair's {str(dt).split('.')[-1]} dropout 0.1 "
              f"masks (dkv through dv, dq through the learned bias's ds) = "
              f"dropout_keep_reference bit for bit at D=40, 64, 128, 256",
              flush=True)
    # fp16; causal and ragged (T not a multiple of the 128-key block);
    # head dims 128 and 40 (the TMA boxes zero-fill past D)
    c = mk(2, T_MAIN, torch.float16, False, "keypad", 0.1,
           valid=rng_valid[:2])
    backward_check(torch, attn, "fp16 T=512 key-padding dropout 0.1 fused",
                   c, 1024, errs)
    c = mk(2, 333, torch.bfloat16, True, None, 0.1)
    fused = backward_check(torch, attn, "bf16 T=333 causal dropout 0.1 "
                           "fused (ragged)", c, 1024, errs)
    two = backward_check(torch, attn, "bf16 T=333 causal dropout 0.1 "
                         "two-pass (block_k=128)", c, 128, errs)
    agree(torch, "bf16 T=333 causal dropout 0.1", fused, two, "bfloat16")
    c = mk(2, 300, torch.bfloat16, False, "keypad", 0.1,
           valid=[300, 77], d=128)
    fused = backward_check(torch, attn, "bf16 D=128 T=300 key-padding "
                           "dropout 0.1 fused", c, 1024, errs)
    two = backward_check(torch, attn, "bf16 D=128 T=300 key-padding "
                         "dropout 0.1 two-pass (block_k=128)", c, 128, errs)
    agree(torch, "bf16 D=128 T=300 dropout 0.1", fused, two, "bfloat16")
    c = mk(2, 200, torch.float16, True, "keypad", 0.0, valid=[200, 131],
           d=40)
    fused = backward_check(torch, attn, "fp16 D=40 T=200 causal key-padding "
                           "fused", c, 1024, errs)
    two = backward_check(torch, attn, "fp16 D=40 T=200 causal key-padding "
                         "two-pass (block_k=64)", c, 64, errs)
    agree(torch, "fp16 D=40 T=200 causal", fused, two, "float16")
    # long sequence: the two-pass pair by the default block_k, causal
    c = mk(2, 2048, torch.bfloat16, True, None, 0.0)
    backward_check(torch, attn, "bf16 T=2048 causal two-pass", c, 1024,
                   errs)
    pair_kernel_times(torch, attn, "B=2 H=12 T=2048 D=64 bf16 causal", c)
    # head dim 256: the pair at every Tk, in every dtype
    c = mk(2, 1024, torch.bfloat16, False, "keypad", 0.1, valid=[1024, 700],
           d=256, h=8)
    backward_check(torch, attn, "bf16 D=256 H=8 T=1024 key-padding dropout "
                   "0.1 (the pair: D > 128)", c, 1024, errs)
    pair_kernel_times(torch, attn, "B=2 H=8 T=1024 D=256 bf16 key-padding "
                      "dropout 0.1", c)
    c = mk(2, 333, torch.float16, True, None, 0.1, d=256, h=4)
    backward_check(torch, attn, "fp16 D=256 H=4 T=333 causal dropout 0.1 "
                   "(ragged)", c, 1024, errs)
    c = mk(2, 256, torch.bfloat16, False, "full", 0.1, d=256, h=4)
    backward_check(torch, attn, "bf16 D=256 H=4 T=256 learned bias dropout "
                   "0.1", c, 1024, errs)
    c = mk(2, 300, torch.float32, False, "keypad", 0.1, valid=[300, 77],
           d=256, h=4)
    backward_check(torch, attn, "f32 D=256 H=4 T=300 key-padding dropout "
                   "0.1", c, 1024, errs)
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
    fused_reruns(torch, attn, c, "f32 T=512 key-padding dropout 0.1")
    c = mk(1, 2048, torch.float32, True, None, 0.0)
    backward_check(torch, attn, "f32 T=2048 causal two-pass", c, 1024, errs)
    c = mk(2, 256, torch.float32, False, "full", 0.0)
    backward_check(torch, attn, "f32 T=256 learned bias fused", c, 1024,
                   errs)
    # the f32 fused pass (3xTF32) at head dims 40 and 100 (zero-filled past
    # D) and 128, causal, ragged (T=333), every bias, against the pair; its
    # dropout mask bit for bit
    for d, causal, bias_kind in ((40, True, None), (100, False, "keypad"),
                                 (128, True, "full")):
        c = mk(2, 333, torch.float32, causal, bias_kind, 0.1, d=d, h=4)
        label = (f"f32 D={d} T=333 {'causal ' if causal else ''}"
                 f"{bias_kind or 'no bias'} dropout 0.1")
        fused = backward_check(torch, attn, f"{label} fused", c, 1024, errs)
        two = backward_check(torch, attn, f"{label} two-pass (block_k=128)",
                             c, 128, errs)
        agree(torch, label, fused, two, "float32")
    for dt in (torch.bfloat16, torch.float32):
        for d in (32, 64, 100, 128):
            got, want = fused_dropout_mask(torch, attn, dev, dt, d)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{dt} D={d}: the fused pass's dropout mask differs "
                     f"from dropout_keep_reference in "
                     f"{int((got != want).sum())} of {want.numel()} bits")
        print(f"phase 3: the fused pass's {str(dt).split('.')[-1]} dropout "
              f"0.1 masks (through dv) = dropout_keep_reference bit for bit "
              f"at D=32, 64, 100, 128", flush=True)
    for name, r in rows.items():
        r["max_abs_err"] = errs.get(name, 0.0)
    return rows


def fused_reruns(torch, attn, c, label):
    """The fused kernel adds dq's key blocks in an order that changes from
    run to run: two runs' f32 accumulators agree to rounding (REL_RERUN),
    dk and dv to the bit."""
    runs = []
    for _ in range(2):
        call, outs = kernel_only_call(torch, attn, c,
                                      "flash_attention_bwd_fused")
        call()
        runs.append(outs)
    torch.cuda.synchronize()
    r = rel(runs[1][0], runs[0][0])
    if r > REL_RERUN or not all(torch.equal(a, b)
                                for a, b in zip(runs[0][1:], runs[1][1:])):
        fail(f"two runs of the fused backward ({label}): dq accumulators "
             f"differ by {r:.3e} (limit {REL_RERUN}), or dk / dv differ")
    print(f"phase 3: two runs of the fused backward ({label}): f32 dq "
          f"accumulators differ by {r:.2e} relative (limit {REL_RERUN}, "
          f"{int((runs[1][0] != runs[0][0]).sum())} elements not bit for "
          f"bit), dk and dv equal to the bit", flush=True)


def fused_dropout_mask(torch, attn, dev, dt, d, rate=0.1, B=2, Hh=3,
                       Tk=200):
    """The dropout mask the fused pass draws, read back bit for bit
    through dv: with q = k = 0 every key has p = 1 / Tk, and dout's row q
    = one-hot(q) (Tq = d) puts query q's kept-or-dropped p_d[q, j] alone
    into dv[j, q] (one product, the rest zeros). ``(got,
    dropout_keep_reference's)``, each (B, Hh, d, Tk) bool."""
    scale = 1.0 / math.sqrt(d)
    seed = torch.tensor([1234, 5678], dtype=torch.int32, device=dev)
    zq = torch.zeros((B, Hh, d, d), dtype=dt, device=dev)
    zk = torch.zeros((B, Hh, Tk, d), dtype=dt, device=dev)
    out, lse = attn._flash_forward(zq, zk, zk, None, scale, False, seed, rate)
    eye = torch.eye(d, dtype=dt, device=dev).expand(B, Hh, d, d)
    before = attn.launches["flash_attention_bwd_fused"]
    dv = attn._flash_backward(zq, zk, zk, None, seed, out, lse,
                              eye.contiguous(), scale, False, 4096, rate)[2]
    if attn.launches["flash_attention_bwd_fused"] != before + 1:
        fail(f"fused dropout mask {dt} D={d}: the fused pass did not run")
    return (dv.transpose(-1, -2) > 0,
            attn.dropout_keep_reference(seed, B, Hh, d, Tk, rate))


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
    """cuDNN at the same shape (a yardstick, never used by the port):
    F.conv2d on the already-activated input, conv2d_input, conv2d_weight.
    Returns (device time of its kernels, CUDA events back to back)."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.cuda.conv_fused import _prologue
    N, Ci, M = x.shape
    Co = w.shape[0]
    h4 = _prologue(x, scale, shift, relu).to(x.dtype).reshape(N, Ci, *hw)
    w4 = w.reshape(Co, Ci, 1, 1)
    dy4 = dy.reshape(N, Co, *hw)
    if name == "conv1x1_fwd":
        bb = b.to(x.dtype) if b is not None else None
        call = lambda: F.conv2d(h4, w4, bb)  # noqa: E731
    elif name == "conv1x1_dgrad":
        call = lambda: torch.nn.grad.conv2d_input(h4.shape, w4, dy4)  # noqa
    else:
        call = lambda: torch.nn.grad.conv2d_weight(h4, w4.shape, dy4)  # noqa
    try:
        return device_ms(call), cuda_time_ms(call)
    except Exception as e:  # noqa: BLE001 - a yardstick only: reported
        print(f"phase 3:   library call unavailable here ({e!r:.120})",
              flush=True)
        return None, None


def conv_check(torch, cf, label, case, relu, errs, timed=False, hw=None,
               junction=None):
    """The three conv kernels on one case against their plain versions;
    each launch must move its counter by one. Returns {kernel: row} when
    ``timed`` (``junction``: its index in CONV_JUNCTIONS, for the old
    kernels' times)."""
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
        if name == "conv1x1_dgrad" and relu:
            dgrad_mask_check(torch, cf, label, case, got, want)
        if name == "conv1x1_wgrad" and timed and not torch.equal(got, kern()):
            fail(f"{label}: wgrad differs from run to run")
        errs[name] = max(errs.get(name, 0.0),
                         (got.float() - want.float()).abs().max().item())
        parts.append(f"{name.split('_')[1]} {r:.2e}")
        if timed:
            # the median of three profiler sessions: a session can record
            # only part of the launches' device time
            runs = sorted(v for v in (kernel_ms(kern, CONV_KERNEL[name])
                                      for _ in range(3)) if v is not None)
            ms = runs[len(runs) // 2] if runs else None
            ev_ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain)
            lib_ms, lib_ev = library_conv_ms(torch, name, x, w, dy, scale,
                                             shift, relu, b, hw)
            bnd, by = conv_bound_ms(name, N, Ci, Co, M, dtn, x.dtype.itemsize,
                                    scale is not None, b is not None)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bnd, bound_by=by, events_ms=ev_ms,
                              library_events_ms=lib_ev)
            old = "".join(f", {pr} {t[junction]:.4f}"
                          for pr, t in OLD_CONV_MS.get(name, {}).items()
                          ) if junction is not None else ""
            print(f"phase 3: {name} {label}: kernel {fmt_ms(ms)} (device), "
                  f"bound {bnd:.4f} ms ({by}), plain {plain_ms:.4f} ms, "
                  f"cuDNN {fmt_ms(lib_ms)} (device); CUDA events: kernel "
                  f"{ev_ms:.4f}{old}, cuDNN {fmt_ms(lib_ev)}", flush=True)
    print(f"phase 3: conv {label}: relative error {', '.join(parts)}",
          flush=True)
    return rows


def dgrad_mask_check(torch, cf, label, case, got, want):
    """dgrad's ReLU mask against the plain mask ``x * scale + shift > 0``,
    bit for bit: with W and dy all ones every sum is Co, exact in f32, so
    the kernel must give exactly Co where the mask keeps and 0 where it
    does not. On the random operands the output must be 0 wherever the
    mask is 0; where it keeps, a sum of exact products can be exactly 0 in
    one order of summation and not in another, so such zeros are counted
    and printed with the plain version's values there."""
    x, w, dy, scale, shift, _ = case
    keep = cf._prologue(x, scale, shift, False) > 0
    ones = cf._dgrad(x, scale, shift, torch.ones_like(w), torch.ones_like(dy),
                     True)
    torch.cuda.synchronize()
    bad = int((ones != keep.float() * w.shape[0]).sum())
    off = int((~keep & (got != 0)).sum())
    if bad or off:
        fail(f"{label}: dgrad's ReLU mask differs from the plain version's: "
             f"{bad} elements with W = dy = 1, {off} non-zero where the "
             "mask is 0")
    zeros = keep & (got == 0)
    nz = int(zeros.sum())
    there = (f" (|plain| there at most {want[zeros].abs().max().item():.3e}, "
             f"largest |plain| {want.abs().max().item():.3e})") if nz else ""
    print(f"phase 3: dgrad {label}: ReLU mask = plain mask bit for bit over "
          f"{keep.numel()} elements ({keep.float().mean().item():.4f} kept); "
          f"kept sums exactly 0 on random operands: {nz}{there}", flush=True)


def conv_step_totals(per_junction):
    """Per-step totals of each conv kernel: the junction rows weighted by
    how often each junction occurs in one ResNet-50 v1 step; beside them
    the same totals of the kernels that fwd and dgrad replaced."""
    def total(vals):
        return None if None in vals else sum(
            c * v for c, v in zip(CONV_COUNTS, vals))
    for name in CONV_KERNELS:
        tot = {key: total([r[name][key] for r in per_junction])
               for key in ("ms", "library_ms", "bound_ms", "events_ms",
                           "library_events_ms")}
        old = "".join(f", {pr} {total(t):.4f}"
                      for pr, t in OLD_CONV_MS.get(name, {}).items())
        print(f"phase 3: {name} per ResNet-50 step (junctions weighted "
              f"{'/'.join(map(str, CONV_COUNTS))}): kernel "
              f"{fmt_ms(tot['ms'])} (device), cuDNN "
              f"{fmt_ms(tot['library_ms'])} (device), bound "
              f"{fmt_ms(tot['bound_ms'])}; CUDA events: kernel "
              f"{fmt_ms(tot['events_ms'])}{old}, cuDNN "
              f"{fmt_ms(tot['library_events_ms'])}", flush=True)


def print_plan(cf, kind, label, N, Ci, Co, M, dtype):
    plan = cf.conv1x1_plan(kind, N, Ci, Co, M, dtype)
    if kind != "wgrad" and plan["mode"] in ("tma", "runs"):
        print(f"phase 3: {kind} plan {label}: {plan['mode']}"
              + (f" (runs of up to {plan['imgs']} images a step)"
                 if plan["mode"] == "runs" else "")
              + f", tile {plan['tile']} channels x {plan['tile_panels']} "
              f"panels of 64, {plan['tiles']} tiles on {plan['blocks']} "
              f"persistent blocks, {plan['steps']} steps a tile, "
              f"{plan['stages']} ring slots of {plan['slot_bytes']} bytes, "
              f"{plan['store']} stores", flush=True)
    else:
        print(f"phase 3: {kind} plan {label}: {plan['mode']} (vec "
              f"{plan.get('vec', 1)}), tile {plan['tile']} x {plan['bk']} "
              f"deep, {plan['tiles']} tiles x {plan.get('splits', 1)} splits "
              f"= {plan['blocks']} blocks, {plan['steps']} steps a block, "
              f"{plan.get('slots', 0)} ring slots", flush=True)


def conv_checks(torch, dev):
    """The conv kernels at ResNet-50's junctions and the edge cases."""
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    gen = torch.Generator(device=dev).manual_seed(1)
    errs, rows, per_junction = {}, {}, []
    for kind, Ci, Co, M in CONV_JUNCTIONS:
        side = int(round(math.sqrt(M)))
        affine = kind == "triple"
        label = (f"bf16 {kind} N={B_RESNET} {Ci}->{Co} M={M} "
                 f"({'affine' if affine else 'relu-only'}, bias)")
        for k in ("fwd", "dgrad", "wgrad"):
            print_plan(cf, k, label, B_RESNET, Ci, Co, M, torch.bfloat16)
        case = conv_case(torch, dev, gen, B_RESNET, Ci, Co, M,
                         torch.bfloat16, affine, True)
        got = conv_check(torch, cf, label, case, True, errs, timed=True,
                         hw=(side, side),
                         junction=CONV_JUNCTIONS.index((kind, Ci, Co, M)))
        per_junction.append(got)
        if (kind, Ci, Co, M) == CONV_JUNCTIONS[0]:
            rows = got          # the result line's row: the stage-1 triple
        del case
    conv_step_totals(per_junction)
    for kind, Ci, Co, M in CONV_JUNCTIONS:
        affine = kind != "triple"     # the other variant, without bias
        conv_check(torch, cf, f"f32 N=8 {Ci}->{Co} M={M} "
                   f"({'affine' if affine else 'relu-only'}, no bias)",
                   conv_case(torch, dev, gen, 8, Ci, Co, M, torch.float32,
                             affine, False), True, errs)
    for Ci, Co, M in ((64, 256, 3136), (256, 1024, 196), (512, 2048, 49)):
        conv_check(torch, cf, f"fp16 N={B_RESNET} {Ci}->{Co} M={M} (affine, "
                   "bias)", conv_case(torch, dev, gen, B_RESNET, Ci, Co, M,
                                      torch.float16, True, True), True, errs)
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
        if rows[name]["ms"] is None:      # the profiler saw no device time
            rows[name]["ms"] = rows[name]["events_ms"]
    torch.cuda.empty_cache()
    return rows


def bn_bound_ms(name, outer, C, inner, elem):
    """Least time for one BatchNorm kernel: x (and dy) read once, the
    per-channel vectors read and written once, the output written once
    (out, dx in x's dtype; the statistics, dg, db in f32); its f32
    operations, a few an element."""
    n = outer * C * inner
    nbytes, flops = {"bn_stats": (elem * n + 16 * C, 3 * n),
                     "bn_apply": (2 * elem * n + 16 * C, 4 * n),
                     "bn_bwd_reduce": (2 * elem * n + 16 * C, 5 * n),
                     "bn_bwd_apply": (3 * elem * n + 28 * C, 8 * n)}[name]
    return bound(flops, nbytes, "float32")


def bn_case(torch, dev, gen, outer, C, inner, dt, mean=0.0):
    """x (mean ``mean``, std 2) and dy in ``dt``, (outer, C, inner); f32 a
    shift near the batch mean (the previous batch's, as the layer keeps
    it), gamma, beta and the mean and var cotangents; drawn on the card."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = randn(outer, C, inner) * 2 + mean
    s = x.mean(dim=(0, 2)) + 0.1 * randn(C)
    return dict(x=x.to(dt), dy=randn(outer, C, inner).to(dt), s=s,
                g=torch.rand((C,), generator=gen, device=dev) + 0.5,
                b=randn(C), dm=randn(C), dv=randn(C))


def ulps16(torch, got, want) -> int:
    """Largest distance in units in the last place between two 16-bit
    tensors (their bit patterns in sign-magnitude order)."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(got) - key(want)).abs().max().item())


def library_bn_ms(torch, name, c, mean, inv, dg, db, timer=None):
    """The library call that computes the same function as kernel ``name``
    on the same inputs (a yardstick, never used by the port): PyTorch's
    native batch-norm kernels that SyncBatchNorm runs, batch_norm_stats,
    batch_norm_elemt, batch_norm_backward_reduce and
    batch_norm_backward_elemt. Device time by ``timer`` (default
    :func:`device_ms`), or None."""
    x, dy, g, b = c["x"], c["dy"], c["g"], c["b"]
    n = x.shape[0] * x.shape[2]
    count = torch.full((1,), n, dtype=torch.int32, device=x.device)
    dy_xmu = dg / inv                   # sum(dy * (x - mean))
    calls = {
        "bn_stats": lambda: torch.batch_norm_stats(x, 1e-5),
        "bn_apply": lambda: torch.batch_norm_elemt(x, g, b, mean, inv, 1e-5),
        "bn_bwd_reduce": lambda: torch.batch_norm_backward_reduce(
            dy, x, mean, inv, g, True, True, True),
        "bn_bwd_apply": lambda: torch.batch_norm_backward_elemt(
            dy, x, mean, inv, g, db, dy_xmu, count)}
    try:
        return (timer or device_ms)(calls[name])
    except Exception as e:  # noqa: BLE001 - a yardstick only: reported
        print(f"phase 3:   library call for {name} unavailable here "
              f"({e!r:.120})", flush=True)
        return None


def cudnn_bn_ms(torch, c, timer=None):
    """cuDNN's training BatchNorm at the same shape (a yardstick):
    ``F.batch_norm`` in training mode, x in its dtype, f32 weight, bias
    and running statistics; the forward, and its backward through
    autograd. Device times by ``timer`` (default :func:`device_ms`), or
    (None, None)."""
    import torch.nn.functional as F
    x, dy = c["x"], c["dy"]
    C = x.shape[1]
    x4 = x.unsqueeze(-1).detach().requires_grad_(True)
    w = c["g"].detach().requires_grad_(True)
    b = c["b"].detach().requires_grad_(True)
    rm = torch.zeros(C, device=x.device)
    rv = torch.ones(C, device=x.device)

    def fwd():
        return F.batch_norm(x4, rm, rv, w, b, True, 0.1, 1e-5)
    try:
        timer = timer or device_ms
        fwd_ms = timer(fwd)
        y = fwd()
        bwd_ms = timer(lambda: torch.autograd.grad(
            y, (x4, w, b), dy.unsqueeze(-1), retain_graph=True))
        return fwd_ms, bwd_ms
    except Exception as e:  # noqa: BLE001 - a yardstick only: reported
        print(f"phase 3:   cuDNN batch_norm unavailable here ({e!r:.120})",
              flush=True)
        return None, None


def bn_one_launch(torch, bn, label, c):
    """Each reduction, one call under the profiler (after the session's
    :func:`primer`): one record of its kernel and no memset (a session
    that kept no record of it, as one can lose its first records, is
    taken again, up to three times)."""
    from torch.profiler import ProfilerActivity, profile
    x, dy, s = c["x"], c["dy"], c["s"]
    mean, _, inv = bn.bn_stats_reference(x, s, 1e-5)
    calls = {"bn_stats": lambda: bn._stats(x, s, 1e-5, False),
             "bn_bwd_reduce": lambda: bn._bwd_reduce(x, dy, mean, inv)}
    saved = dict(bn.launches)
    for name, fn in calls.items():
        fn()
        for _ in range(3):      # a session that lost the record: again
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                primer()
                fn()
                torch.cuda.synchronize()
            counts = kernel_counts(prof)
            n = sum(v for k, v in counts.items()
                    if re.search(BN_KERNEL[name], k))
            memsets = [k for k in counts if "memset" in k.lower()]
            if n or memsets:
                break
        if n != 1 or memsets:
            fail(f"{label}: {name} launched its kernel {n} times and "
                 f"{memsets or 'no'} memsets in one call (one, none)")
    bn.launches.update(saved)


def bn_check(torch, bn, label, c, errs, timed=False, cold=False):
    """BatchNorm's four kernels on one case against their plain versions
    (the statistics both ways, bn_bwd_apply with and without dy), each
    launch moving its counter by one, and a second run of each equal to
    the bit; each reduction one launch a call (:func:`bn_one_launch`).
    Returns {kernel: row} and cuDNN's (fwd, bwd) ms when ``timed``;
    ``cold``: every device time with L2 flushed before each call
    (:func:`cold_ms`)."""
    x, dy = c["x"], c["dy"]
    outer, C, inner = x.shape
    half = x.dtype != torch.float32
    dtn = str(x.dtype).split(".")[-1]

    def counted(name, fn):
        before = bn.launches[name]
        out = fn()
        torch.cuda.synchronize()
        if bn.launches[name] != before + 1:
            fail(f"{label}: {name} counter moved by "
                 f"{bn.launches[name] - before}, expected 1")
        return out

    def close(name, got, want, exact_dtype, scale=None):
        """``scale``: the mean's error is taken relative to the batch's
        standard deviation, the scale at which it moves out (a mean near
        0 has no relative error of its own)."""
        if not all(bool(t.isfinite().all()) for t in got):
            fail(f"{label}: {name} gave non-finite values")
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, want)):
            if exact_dtype and half:
                u = ulps16(torch, a, b)
                if u > TOL_BN_ULPS:
                    fail(f"{label}: {name} {u} ulps off the plain version")
            else:
                r = rel(a, b) if scale is None or i else \
                    ((a - b).norm() / scale.norm()).item()
                if r > TOL_BN_REL:
                    fail(f"{label}: {name} relative error {r:.3e} > "
                         f"{TOL_BN_REL}")
                worst = max(worst, r)
            errs[name] = max(errs.get(name, 0.0),
                             (a.float() - b.float()).abs().max().item())
        return worst

    parts = []
    stats = lambda: bn._stats(x, c["s"], 1e-5, False)  # noqa: E731
    got = counted("bn_stats", stats)
    want = bn.bn_stats_reference(x, c["s"], 1e-5, False)
    std = want[1].sqrt()
    parts.append(f"stats {close('bn_stats', got, want, False, std):.2e}")
    if not torch.equal(stats()[1], got[1]):
        fail(f"{label}: bn_stats differs from run to run")
    m0 = counted("bn_stats", lambda: bn._stats(x, None, 1e-5, False))[0]
    m0_want = bn.bn_stats_reference(x, None, 1e-5, False)[0]
    var_c = counted("bn_stats", lambda: bn._stats(x, m0_want, 1e-5, True))[1]
    var_c_want = bn.bn_stats_reference(x, m0_want, 1e-5, True)[1]
    r = close("bn_stats", (m0, var_c), (m0_want, var_c_want), False, std)
    parts.append(f"centered {r:.2e}")
    mean, _, inv = want
    apply = lambda: bn._apply(x, mean, inv, c["g"], c["b"])  # noqa: E731
    out = counted("bn_apply", apply)
    out_want = bn.bn_apply_reference(x, mean, inv, c["g"], c["b"])
    close("bn_apply", (out,), (out_want,), True)
    equal = {"out": torch.equal(out, out_want)}
    reduce = lambda: bn._bwd_reduce(x, dy, mean, inv)  # noqa: E731
    dg, db = counted("bn_bwd_reduce", reduce)
    dgw, dbw = bn.bn_bwd_reduce_reference(x, dy, mean, inv)
    r = close("bn_bwd_reduce", (dg, db), (dgw, dbw), False)
    parts.append(f"dg, db {r:.2e}")
    if not torch.equal(reduce()[0], dg):
        fail(f"{label}: bn_bwd_reduce differs from run to run")
    bwd = lambda: bn._bwd_apply(x, dy, mean, inv, c["g"], dgw, dbw,  # noqa
                                c["dm"], c["dv"])
    dx = counted("bn_bwd_apply", bwd)
    dx_want = bn.bn_bwd_apply_reference(x, dy, mean, inv, c["g"], dgw, dbw,
                                        c["dm"], c["dv"])
    close("bn_bwd_apply", (dx,), (dx_want,), True)
    dx2 = counted("bn_bwd_apply", lambda: bn._bwd_apply(
        x, None, mean, None, None, None, None, c["dm"], c["dv"]))
    dx2_want = bn.bn_bwd_apply_reference(x, None, mean, None, None, None,
                                         None, c["dm"], c["dv"])
    close("bn_bwd_apply", (dx2,), (dx2_want,), True)
    equal["dx"] = torch.equal(dx, dx_want) and torch.equal(dx2, dx2_want)
    if not (torch.equal(apply(), out) and torch.equal(bwd(), dx)):
        fail(f"{label}: bn_apply or bn_bwd_apply differs from run to run")
    bn_one_launch(torch, bn, label, c)
    print(f"phase 3: batch norm {label}: relative error {', '.join(parts)}; "
          f"out and dx equal to the plain versions' bits: {equal}; two runs "
          "equal to the bit; each reduction one launch, no memset",
          flush=True)
    if not timed:
        return None
    rows = {}
    kern = {"bn_stats": stats, "bn_apply": apply, "bn_bwd_reduce": reduce,
            "bn_bwd_apply": bwd}
    plain = {"bn_stats": lambda: bn.bn_stats_reference(x, c["s"], 1e-5),
             "bn_apply": lambda: bn.bn_apply_reference(x, mean, inv, c["g"],
                                                       c["b"]),
             "bn_bwd_reduce": lambda: bn.bn_bwd_reduce_reference(x, dy, mean,
                                                                 inv),
             "bn_bwd_apply": lambda: bn.bn_bwd_apply_reference(
                 x, dy, mean, inv, c["g"], dgw, dbw, c["dm"], c["dv"])}
    saved = dict(bn.launches)
    timer = (lambda fn: cold_ms(fn, lambda n: True)) if cold else device_ms
    for name in BN_KERNELS:
        keep = lambda n, k=BN_KERNEL[name]: re.search(k, n)  # noqa: E731
        runs = sorted(v for v in (
            cold_ms(kern[name], keep) if cold
            else kernel_ms(kern[name], BN_KERNEL[name]) for _ in range(3))
            if v is not None)
        ms = runs[len(runs) // 2] if runs else None
        bnd, by = bn_bound_ms(name, outer, C, inner, x.dtype.itemsize)
        rows[name] = dict(ms=ms, plain_ms=timer(plain[name]),
                          library_ms=library_bn_ms(torch, name, c, mean, inv,
                                                   dgw, dbw, timer),
                          bound_ms=bnd, bound_by=by,
                          events_ms=cuda_time_ms(kern[name]))
    bn.launches.update(saved)
    cudnn = cudnn_bn_ms(torch, c, timer)
    where = "device, L2 flushed" if cold else "device"
    print(f"phase 3: batch norm {label}: " + "; ".join(
        f"{n} {fmt_ms(r['ms'])} ({where}; events {r['events_ms']:.4f}), "
        f"bound {r['bound_ms']:.4f} ({r['bound_by']}), plain "
        f"{fmt_ms(r['plain_ms'])}, library {fmt_ms(r['library_ms'])}"
        for n, r in rows.items()) + f"; cuDNN training batch_norm fwd "
        f"{fmt_ms(cudnn[0])}, bwd {fmt_ms(cudnn[1])} ({where})", flush=True)
    return rows, cudnn


def bn_step_totals(per_shape):
    """Per-step totals of each BatchNorm kernel and of cuDNN's training
    BatchNorm: the shape rows weighted by how many of ResNet-50's layers
    have each shape; fused: without the apply and the dy sweep of the 16
    fused junctions. Returns {kernel: row} of the fused (main path)
    totals."""
    out = {}

    def total(vals, counts):
        return None if None in vals else sum(
            k * v for k, v in zip(counts, vals))

    layers = [n for _, _, n in BN_SHAPES]
    fused = [n - (BN_FUSED.get((C, M), 0)) for C, M, n in BN_SHAPES]
    for name in BN_KERNELS:
        counts = fused if name in ("bn_apply", "bn_bwd_reduce") else layers
        rows = [r[0][name] for r in per_shape]
        tot = {key: total([r[key] for r in rows], counts)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "events_ms")}
        unfused = total([r["ms"] for r in rows], layers)
        out[name] = dict(tot, bound_by=rows[0]["bound_by"])
        print(f"phase 3: {name} per ResNet-50 step ({sum(counts)} "
              f"launches fused, {sum(layers)} unfused): kernel "
              f"{fmt_ms(tot['ms'])} fused, {fmt_ms(unfused)} unfused "
              f"(device), bound {fmt_ms(tot['bound_ms'])}, plain "
              f"{fmt_ms(tot['plain_ms'])}, library "
              f"{fmt_ms(tot['library_ms'])}", flush=True)
    cud = [total([r[1][i] for r in per_shape], layers) for i in (0, 1)]
    kern = [total([r[0][n]["ms"] for r in per_shape], layers)
            for n in BN_KERNELS]
    bnd = [total([r[0][n]["bound_ms"] for r in per_shape], layers)
           for n in BN_KERNELS]
    ksum = None if None in kern else sum(kern)
    print(f"phase 3: batch norm per unfused ResNet-50 step (53 layers, "
          f"forward and backward): the four kernels {fmt_ms(ksum)}, bound "
          f"{sum(bnd):.4f} ms, cuDNN's training batch_norm "
          f"{fmt_ms(None if None in cud else sum(cud))} (fwd "
          f"{fmt_ms(cud[0])}, bwd {fmt_ms(cud[1])}; device)", flush=True)
    return out


def bn_checks(torch, dev):
    """BatchNorm's kernels at ResNet-50's nine shapes at N=128 in bf16
    (timed), fp16 and f32, one NHWC and one 2-d case, a large-mean input
    and ragged shapes."""
    from mxnet_tpu_torch.ops.cuda import batch_norm as bn
    gen = torch.Generator(device=dev).manual_seed(2)
    errs, per_shape = {}, []
    for C, M, n in BN_SHAPES:
        plan = bn.bn_plan(B_RESNET, C, M, torch.bfloat16)
        rplan = bn.bn_reduce_plan(B_RESNET, C, M, torch.bfloat16)
        label = f"bf16 N={B_RESNET} C={C} M={M} ({n} layers)"
        print(f"phase 3: batch norm plan {label}: {plan}; the reductions' "
              f"{rplan}", flush=True)
        if rplan["splits"] != 1:
            fail(f"{label}: the reductions take the second level {rplan}")
        case = bn_case(torch, dev, gen, B_RESNET, C, M, torch.bfloat16)
        per_shape.append(bn_check(torch, bn, label, case, errs, timed=True))
        del case
    rows = bn_step_totals(per_shape)
    for dt in (torch.float16, torch.float32):
        dtn = str(dt).split(".")[-1]
        for C, M, _ in BN_SHAPES:
            bn_check(torch, bn, f"{dtn} N={B_RESNET} C={C} M={M}",
                     bn_case(torch, dev, gen, B_RESNET, C, M, dt), errs)
    for dt in (torch.bfloat16, torch.float32):
        dtn = str(dt).split(".")[-1]
        bn_check(torch, bn, f"{dtn} NHWC (axis -1) N=128 28x28 C=512",
                 bn_case(torch, dev, gen, 128 * 784, 512, 1, dt), errs)
        bn_check(torch, bn, f"{dtn} 2-d (N, C) 4096x1024",
                 bn_case(torch, dev, gen, 4096, 1024, 1, dt), errs)
        bn_check(torch, bn, f"{dtn} mean 100 N=64 C=64 M=784",
                 bn_case(torch, dev, gen, 64, 64, 784, dt, mean=100.0), errs)
        for shape in ((3, 77, 53), (5, 45, 300), (7, 13, 1), (2, 2050, 1),
                      (6, 30, 98), (4, 9, 12), (1, 7, 300), (1, 64, 49),
                      (64, 1, 1024), (256, 1, 12)):
            bn_check(torch, bn, f"{dtn} ragged {shape}",
                     bn_case(torch, dev, gen, *shape, dt), errs)
    # the reductions' second level: few channels, large images (an RGB
    # input layer's BatchNorm), several clusters a channel
    for dt in (torch.bfloat16, torch.float32):
        rplan = bn.bn_reduce_plan(*BN_SECOND, dt)
        if rplan["splits"] < 2:
            fail(f"{BN_SECOND}: the reductions take one level {rplan}")
        label = f"{str(dt).split('.')[-1]} second level {BN_SECOND}"
        print(f"phase 3: batch norm plan {label}: {rplan}", flush=True)
        bn_check(torch, bn, label, bn_case(torch, dev, gen, *BN_SECOND, dt),
                 errs)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
        if rows[name]["ms"] is None:      # the profiler saw no device time
            rows[name]["ms"] = rows[name]["events_ms"]
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------ phase 3: heads wider than 256
def wide_case(torch, dev, gen, attn, dt, d, Tq, Tk, causal, bias_kind, rate,
              B=2, h=2):
    """Inputs and the forward of one wide case, as ``backward_case`` makes
    them, with Tq and Tk apart: q from one fused projection, k and v from
    another; a key-padding bias ragged over the batch, or a learned full
    (1, h, Tq, Tk) one."""
    qh, _, _ = qkv_views(torch, dev, B, Tq, dt, gen, d, h)
    _, kh, vh = qkv_views(torch, dev, B, Tk, dt, gen, d, h)
    valid = [Tk, max(1, Tk // 3)][:B]
    bias = None
    if bias_kind == "keypad":
        keep = torch.arange(Tk, device=dev)[None, :] < torch.tensor(
            valid, device=dev)[:, None]
        bias = torch.where(keep, 0.0, torch.finfo(dt).min).to(dt)[
            :, None, None, :]
    elif bias_kind == "full":
        bias = torch.randn((1, h, Tq, Tk), generator=gen).to(dev, dt)
    do = torch.randn((B, Tq, h, d), generator=gen).to(dev, dt).transpose(1, 2)
    seed = torch.tensor([4242, -17], dtype=torch.int32, device=dev) \
        if rate > 0 else None
    scale = 1.0 / math.sqrt(d)
    out, lse = attn._flash_forward(qh, kh, vh, bias, scale, causal, seed,
                                   rate)
    return dict(q=qh, k=kh, v=vh, do=do, bias=bias, seed=seed, out=out,
                lse=lse, scale=scale, causal=causal, rate=rate, valid=valid,
                B=B, H=h, T=Tq, D=d, dt=dt, learned=bias_kind == "full")


# (dtype, head dim, Tq, Tk, causal, bias, dropout): forward and backward
# against the plain versions. 16-bit heads take the tiled wide kernels
# (D = 300 and 530: rows TMA cannot address, copied and counted), all three
# streaming the head dim above 512 (530, 576, 640, 1024; 1280 with the
# forward's q streamed too); f32 the 3xTF32 forward, dq and dk / dv (530:
# copied), at 264 to 1280 (attn.head_dim_route)
WIDE_CASES = [("bfloat16", 288, 333, 333, False, "keypad", 0.0),
              ("bfloat16", 288, 200, 200, True, None, 0.1),
              ("bfloat16", 320, 100, 260, False, "full", 0.1),
              ("float16", 512, 130, 130, True, "keypad", 0.0),
              ("bfloat16", 264, 77, 131, True, "keypad", 0.1),
              ("float16", 300, 131, 77, True, "full", 0.0),
              ("bfloat16", 384, 96, 200, False, None, 0.1),
              ("bfloat16", 448, 150, 64, True, "full", 0.1),
              ("bfloat16", 576, 64, 96, True, "keypad", 0.0),
              ("bfloat16", 640, 100, 160, False, "full", 0.1),
              ("float16", 1024, 130, 200, True, "keypad", 0.0),
              ("bfloat16", 530, 77, 131, True, None, 0.1),
              ("bfloat16", 1280, 96, 160, False, "keypad", 0.1),
              ("float32", 288, 128, 77, False, "full", 0.1),
              ("float32", 320, 64, 64, True, None, 0.0),
              ("float32", 576, 77, 131, True, "keypad", 0.1),
              ("float32", 1024, 64, 96, False, "full", 0.0),
              ("float32", 530, 70, 45, False, None, 0.0),
              ("float32", 264, 77, 131, True, "keypad", 0.1),
              ("float32", 1280, 96, 160, False, "full", 0.1)]
# the timed shapes (B, H, T, D, bias, causal), bf16 from one fused QKV
# projection; key padding ragged over the batch (wide_timed_case). The first
# is the wide path's first shape; the kernels line carries WIDE_LINE's rows
WIDE_TIMED = ((2, 4, 512, 288, "keypad", False),
              (8, 8, 1024, 320, "keypad", False),
              (8, 8, 1024, 320, None, True),
              (4, 8, 1024, 512, "keypad", False),
              (2, 4, 512, 576, "keypad", False),
              (4, 8, 1024, 1024, "keypad", False))
WIDE_LINE = 1
# the f32 forward, dq and dk / dv (3xTF32: wide_fwd_tf32, wide_dq_tf32,
# bwd_dkv_tf32_st) timed at (B, H, T, D, bias, causal) in f32
WIDE_F32_TIMED = ((2, 4, 512, 320, "keypad", False),
                  (8, 8, 1024, 320, "keypad", False),
                  (2, 4, 512, 576, "keypad", False))


def wide_mask_probe(torch, dev, attn, dt, d=288, rate=0.1, B=2, Hh=3,
                    Tq=77):
    """The wide forward's dropout mask read back bit for bit: with q = k =
    0 every key has p = 1 / Tk, and v = the identity over Tk = d keys puts
    key j's kept-or-dropped probability alone into column j."""
    seed = torch.tensor([99, 123456], dtype=torch.int32, device=dev)
    zq = torch.zeros((B, Hh, Tq, d), dtype=dt, device=dev)
    zk = torch.zeros((B, Hh, d, d), dtype=dt, device=dev)
    eye = torch.eye(d, dtype=dt, device=dev).expand(B, Hh, d, d)
    out, _ = attn._flash_forward(zq, zk, eye, None, 1.0, False, seed, rate)
    return out > 0, attn.dropout_keep_reference(seed, B, Hh, Tq, d, rate)


def wide_timed_case(torch, dev, gen, attn, B, Hh, T, d, bias_kind, causal,
                    dtn="bfloat16"):
    """One timed wide shape (``WIDE_TIMED``, ``WIDE_F32_TIMED``), of dtype
    ``dtn``: q, k, v views of one fused (B, T, 3 Hh d) projection, a
    key-padding bias with valid lengths T - b T / (2 B) for batch b (or
    none), and the forward's out and lse."""
    dt = getattr(torch, dtn)
    qh, kh, vh = qkv_views(torch, dev, B, T, dt, gen, d, Hh)
    valid = [T - b * T // (2 * B) for b in range(B)] \
        if bias_kind == "keypad" else [T] * B
    bias = keypad_bias(torch, dev, valid, T, dt) \
        if bias_kind == "keypad" else None
    do = torch.randn((B, T, Hh, d), generator=gen).to(dev, dt).transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    out, lse = attn._flash_forward(qh, kh, vh, bias, scale, causal)
    return dict(q=qh, k=kh, v=vh, do=do, bias=bias, seed=None, out=out,
                lse=lse, scale=scale, causal=causal, rate=0.0, valid=valid,
                B=B, H=Hh, T=T, D=d, dt=dt, learned=False)


def wide_label(B, Hh, T, d, bias_kind, causal, dtn="bfloat16"):
    return (f"({B}, {Hh}, {T}, {d}) {'f32' if dtn == 'float32' else 'bf16'} "
            f"{'causal' if causal else bias_kind or 'no bias'}")


def wide_sdpa(torch, fn):
    """``fn`` under SDPA's memory-efficient backend, the only one that
    takes head dims above 256 (a yardstick, never called by the port)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        return fn()


def wide_sdpa_forward_ms(torch, q, k, v, bias, scale, causal, label):
    """Device ms of SDPA's memory-efficient forward at a wide shape, or None
    with its refusal printed (a yardstick only)."""
    import torch.nn.functional as F
    try:
        return wide_sdpa(torch, lambda: device_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, is_causal=causal, scale=scale)))
    except Exception as e:  # noqa: BLE001 - a yardstick only: reported
        print(f"phase 3:   SDPA memory-efficient forward refuses {label}: "
              f"{e!r:.160}", flush=True)
        return None


def wide_timed(torch, dev, gen, attn, errs):
    """Each ``WIDE_TIMED`` shape: the wide kernels against the plain
    versions (out within TOL_HALF, lse TOL_LSE, dq, dk, dv within
    REL_BWD), then each kernel's device time beside its bound, its plain
    version and SDPA's memory-efficient backend (forward; its whole
    backward for dq and dk / dv). Returns the rows of WIDE_LINE's shape."""
    line = {}
    for i, (B, Hh, T, d, bias_kind, causal) in enumerate(WIDE_TIMED):
        c = wide_timed_case(torch, dev, gen, attn, B, Hh, T, d, bias_kind,
                            causal)
        label = wide_label(B, Hh, T, d, bias_kind, causal)
        q, k, v, bias, scale = c["q"], c["k"], c["v"], c["bias"], c["scale"]
        ref, ref_lse = attn.flash_attention_reference(
            q.float(), k.float(), v.float(), bias, scale, causal)
        e_fwd = check_close("wide forward", label, c["out"], ref, TOL_HALF)
        check_close("wide forward lse", label, c["lse"], ref_lse, TOL_LSE)
        del ref, ref_lse
        got = run_backward(attn, c, 1024)
        want = attn.flash_attention_backward_reference(
            q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"], scale,
            causal, False)
        abs_err = {"flash_attention_wide_fwd": e_fwd}
        for nm, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            e = rel(g, w)
            if not e <= REL_BWD["bfloat16"]:
                fail(f"wide backward {label}: {nm} rel {e:.3e} beyond "
                     f"{REL_BWD['bfloat16']}")
            kname = ("flash_attention_wide_dq" if nm == "dq"
                     else "flash_attention_wide_dkv")
            abs_err[kname] = max(abs_err.get(kname, 0.0),
                                 (g.float() - w).abs().max().item())
        del got, want
        for n, e in abs_err.items():
            errs[n] = max(errs[n], e)
        bnd, by = attention_bound_ms(B, Hh, T, d, c["valid"], "bfloat16", 2,
                                     causal, bias)
        route = attn.head_dim_route(d, torch.bfloat16)
        # each kernel timed by the records of its route's own kernel
        pats = {n: WIDE_SOURCE_KERNEL[attn._source(n, torch.bfloat16)[0]][n]
                for n in WIDE_KERNELS}
        rows = {"flash_attention_wide_fwd": dict(
            ms=launch_ms(lambda: attn._flash_forward(q, k, v, bias, scale,
                                                     causal), 10,
                         lambda n: re.search(
                             pats["flash_attention_wide_fwd"], n)),
            plain_ms=device_ms(lambda: attn.flash_attention_reference(
                q, k, v, bias, scale, causal), iters=3),
            bound_ms=bnd, bound_by=by,
            library_ms=wide_sdpa_forward_ms(torch, q, k, v, bias, scale,
                                            causal, label))}
        plain_bwd = device_ms(
            lambda: attn.flash_attention_backward_reference(
                q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"], scale,
                causal, False), iters=3)
        lib_bwd = wide_sdpa(torch, lambda: library_backward_ms(
            torch, q, k, v, bias, c["do"], scale, causal, 0.0, False))
        for name, kind in (("flash_attention_wide_dq", "dq"),
                           ("flash_attention_wide_dkv", "dkv")):
            call, _ = kernel_only_call(torch, attn, c, name)
            bnd, by = backward_bound_ms(kind, B, Hh, T, T, d, c["valid"],
                                        "bfloat16", 2, causal, bias, False)
            pattern = pats[name]
            rows[name] = dict(
                ms=launch_ms(call, 5, lambda n: re.search(pattern, n)),
                plain_ms=plain_bwd, bound_ms=bnd, bound_by=by,
                library_ms=lib_bwd)
        for name in WIDE_KERNELS:
            r = rows[name]
            if r["ms"] is None:
                fail(f"{name} at {label}: the profiler kept no record of "
                     f"{pats[name]} ({route})")
            r["max_abs_err"] = abs_err[name]
            whole = " (the whole backward)" if name != WIDE_KERNELS[0] else ""
            print(f"phase 3: {name} at {label} ({route}, "
                  f"{attn._source(name, torch.bfloat16)[0]}.cu): "
                  f"{fmt_ms(r['ms'])} "
                  f"device "
                  f"(bound {r['bound_ms']:.5f} ms by {r['bound_by']}; plain "
                  f"{fmt_ms(r['plain_ms'])}{whole}; SDPA memory-efficient "
                  f"{fmt_ms(r['library_ms'])}{whole}); error "
                  f"{r['max_abs_err']:.3e}", flush=True)
        if i == WIDE_LINE:
            line = rows
        del c
        torch.cuda.empty_cache()
    return line


def wide_f32_timed(torch, dev, gen, attn):
    """The f32 wide forward, dq and dk / dv (3xTF32 on the tensor cores,
    route ``wide_f32``) at each ``WIDE_F32_TIMED`` shape: out and lse
    within TOL_F32 of the plain version, dq, dk and dv within REL_BWD of
    the plain backward, then each one's device time, by the profiler's
    records of its own kernel (``ROUTE_KERNELS["wide_f32"]``), beside its
    bound (operations at the f32 FMA peak), its products' time as 3xTF32
    on the tensor cores, the plain version's and SDPA's f32 forward or
    whole backward (its memory-efficient backend, the only one that takes
    such heads; TF32 off)."""
    patterns = dict(zip(("fwd", "dq", "dkv"), ROUTE_KERNELS["wide_f32"]))
    for B, Hh, T, d, bias_kind, causal in WIDE_F32_TIMED:
        if attn.head_dim_route(d, torch.float32) != "wide_f32":
            fail(f"WIDE_F32_TIMED: D={d} f32 takes route "
                 f"{attn.head_dim_route(d, torch.float32)}")
        c = wide_timed_case(torch, dev, gen, attn, B, Hh, T, d, bias_kind,
                            causal, "float32")
        label = wide_label(B, Hh, T, d, bias_kind, causal, "float32")
        q, k, v, bias, scale = c["q"], c["k"], c["v"], c["bias"], c["scale"]
        ref, ref_lse = attn.flash_attention_reference(q, k, v, bias, scale,
                                                      causal)
        err = {"fwd": check_close("f32 wide forward", label, c["out"], ref,
                                  TOL_F32)}
        check_close("f32 wide forward lse", label, c["lse"], ref_lse,
                    TOL_F32)
        del ref, ref_lse
        want = attn.flash_attention_backward_reference(
            q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"], scale,
            causal, False)
        calls = {"fwd": lambda: attn._flash_forward(q, k, v, bias, scale,
                                                    causal)}
        for side, parts in (("dq", ((0, "dq"),)),
                            ("dkv", ((1, "dk"), (2, "dv")))):
            calls[side], outs = kernel_only_call(
                torch, attn, c, f"flash_attention_wide_{side}")
            calls[side]()
            for i, nm in parts:
                e = rel(outs[i], want[i])
                if not e <= REL_BWD["float32"]:
                    fail(f"f32 wide {nm} {label}: rel {e:.3e} beyond "
                         f"{REL_BWD['float32']}")
                err[side] = max(err.get(side, 0.0),
                                (outs[i].float() - want[i]).abs().max().item())
        del want, outs
        big = T > 512
        ms = {side: launch_ms(calls[side], 10 if side == "fwd" or not big
                              else 3, lambda n, p=pattern: re.search(p, n))
              for side, pattern in patterns.items()}
        for side, pattern in patterns.items():
            if ms[side] is None:
                fail(f"f32 wide {side} at {label}: the profiler kept no "
                     f"record of {pattern}")
        pairs = score_pairs(B, T, c["valid"], causal)
        plain_bwd = device_ms(
            lambda: attn.flash_attention_backward_reference(
                q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"],
                scale, causal, False), iters=2 if big else 3)
        lib_bwd = wide_sdpa(torch, lambda: library_backward_ms(
            torch, q, k, v, bias, c["do"], scale, causal, 0.0, False))
        plain = {"fwd": device_ms(lambda: attn.flash_attention_reference(
            q, k, v, bias, scale, causal), iters=3), "dq": plain_bwd,
            "dkv": plain_bwd}
        lib = {"fwd": wide_sdpa_forward_ms(torch, q, k, v, bias, scale,
                                           causal, label),
               "dq": lib_bwd, "dkv": lib_bwd}
        for side, n_prod in (("fwd", 2), ("dq", 3), ("dkv", 4)):
            if side == "fwd":
                bnd, by = attention_bound_ms(B, Hh, T, d, c["valid"],
                                             "float32", 4, causal, bias)
            else:
                bnd, by = backward_bound_ms(side, B, Hh, T, T, d, c["valid"],
                                            "float32", 4, causal, bias,
                                            False)
            flops = 2.0 * n_prod * Hh * d * pairs
            whole = " (the whole backward)" if side != "fwd" else ""
            print(f"phase 3: flash_attention_wide_{side} (wide_f32, 3xTF32) "
                  f"at {label}: {fmt_ms(ms[side])} device (bound {bnd:.5f} "
                  f"ms by {by} at the f32 FMA peak; 3xTF32 on the tensor "
                  f"cores {3 * flops / TF32_FLOPS * 1e3:.5f} ms; plain "
                  f"{fmt_ms(plain[side])}{whole}; SDPA f32 memory-efficient "
                  f"{fmt_ms(lib[side])}{whole}); error {err[side]:.3e}",
                  flush=True)
        del c, calls
        torch.cuda.empty_cache()


def wide_path(torch, dev, gen, attn):
    """The wide kernels' path: attention over each ``WIDE_PATHS`` shape
    through the user's entry point ``flash_attention``, q, k, v from one
    fused QKV projection, forward and backward under autograd, the counts
    from 0 and one torch.profiler session over the runs, whose kernel
    names must show the tiled wide forward, dq and dk / dv (and no other
    wide or 3xTF32 kernel); out against the plain version. A session in a process
    that ran many earlier ones can lose a kernel's record (the counts
    still move), so a session short of a tiled kernel's records is run
    once more, and both are held to the counts. Returns the launches."""
    from torch.profiler import ProfilerActivity, profile
    runs = []
    for p in WIDE_PATHS:
        B, T, Hh, d = (p[k] for k in ("B", "T", "H", "D"))
        qkv = torch.randn((B, T, 3 * Hh * d), generator=gen).to(
            dev, torch.bfloat16).requires_grad_(True)
        runs.append((qkv, [t.reshape(B, T, Hh, d)
                           for t in qkv.split(Hh * d, dim=-1)]))
    for session in (1, 2):
        torch.cuda.synchronize()
        reset_counts(attn)                      # the wide path starts here
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer()
            outs = []
            for qkv, (q, k, v) in runs:
                qkv.grad = None
                out = attn.flash_attention(q, k, v)
                out.float().square().sum().backward()
                outs.append(out.detach())
            torch.cuda.synchronize()
        launches = {n: attn.launches[n] for n in WIDE_KERNELS}  # ... ends
        if launches != {n: len(WIDE_PATHS) for n in WIDE_KERNELS} or any(
                attn.launches[n] for n in attn.KERNELS
                if n not in WIDE_KERNELS):
            fail(f"wide path: launches {dict(attn.launches)}, expected "
                 f"{len(WIDE_PATHS)} of each wide kernel and no other")
        if attn.padded_copies:
            fail(f"wide path: {attn.padded_copies} operands copied for "
                 f"TMA; the fused-QKV views need none")
        seen = kernel_counts(prof)
        other = [k for k in seen if re.search(AUDITED, k) and not any(
            re.search(p, k) for p in ROUTE_KERNELS["wide_wg"])]
        if other:
            fail(f"wide path: {other} ran on the bf16 path")
        hits = {pattern: sum(n for k, n in seen.items()
                             if re.search(pattern, k))
                for pattern in ROUTE_KERNELS["wide_wg"]}
        if all(h == len(WIDE_PATHS) for h in hits.values()):
            break
        msg = (f"wide path: session {session}: the profiler saw {hits} "
               f"launches, expected {len(WIDE_PATHS)} of each: "
               f"{sorted(k for k in seen if 'wide' in k)}")
        if session == 2:
            fail(msg)
        print(f"phase 3: {msg}; the session is run again", flush=True)
    for (qkv, (q, k, v)), out, p in zip(runs, outs, WIDE_PATHS):
        label = f"({p['B']}, {p['T']}, {p['H']}, {p['D']})"
        qh, kh, vh = (t.detach().transpose(1, 2).float() for t in (q, k, v))
        ref, _ = attn.flash_attention_reference(qh, kh, vh)
        check_close("wide path forward", label, out.transpose(1, 2), ref,
                    TOL_HALF)
        if not bool(qkv.grad.isfinite().all()):
            fail(f"wide path {label}: non-finite gradient")
        qkv.grad = None
        ms = device_ms(lambda: attn.flash_attention(q, k, v).float().square()
                       .sum().backward(), iters=3)
        print(f"phase 3: wide path: flash_attention {label} bf16 forward "
              f"and backward under autograd: {fmt_ms(ms)} device a step",
              flush=True)
        del ref
    kernels = sorted(k for k in seen if re.search(r"wide", k))
    print(f"phase 3: wide path: launches {launches}, no operand copied; "
          f"profiler kernels {kernels}", flush=True)
    torch.cuda.empty_cache()
    return launches


def route_audit(torch, attn, c, label, route):
    """One forward and one backward of case ``c`` under torch.profiler,
    whose records must show ``route``'s own forward, dq and dk / dv
    (``ROUTE_KERNELS``) and no other wide or 3xTF32 kernel: above 512 in
    16 bits the streamed tiled ones, in f32 the 3xTF32 forward, dq and dk /
    dv. A session runs the pair twice, and a session that kept no record
    of one of them is run once more: primed sessions have been seen to
    lose the records of a D = 1280 forward and dq."""
    from torch.profiler import ProfilerActivity, profile
    patterns = ROUTE_KERNELS[route]
    for session in (1, 2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer()
            for _ in range(2):
                attn._flash_forward(c["q"], c["k"], c["v"], c["bias"],
                                    c["scale"], c["causal"], c["seed"],
                                    c["rate"])
                run_backward(attn, c, 1024)
            torch.cuda.synchronize()
        names = sorted(k for k in kernel_counts(prof) if re.search(AUDITED, k))
        if not all(any(re.search(p, k) for p in patterns) for k in names):
            fail(f"wide {label}: a kernel of another route ran on "
                 f"{route}: {names}")
        if all(any(re.search(p, k) for k in names) for p in patterns):
            return
    fail(f"wide {label}: the profiler missed one of {route}'s kernels "
         f"{patterns}: {names}")


def wide_checks(torch, dev, gen, attn):
    """Phase 3: the wide kernels (head dims above 256) against the plain
    versions in ``WIDE_CASES``, their dropout masks read back bit for bit
    (the forward's, and the pair's through ``pair_dropout_masks``), two
    runs of the forward and of the backward equal to the bit, launches
    and copies counted; their path (:func:`wide_path`); each
    ``WIDE_TIMED`` shape checked and timed (:func:`wide_timed`) and the
    f32 kernels (:func:`wide_f32_timed`). Returns (rows, the path's
    launches)."""
    errs = {n: 0.0 for n in WIDE_KERNELS}
    for dtn, d, Tq, Tk, causal, bias_kind, rate in WIDE_CASES:
        dt = getattr(torch, dtn)
        copies = attn.padded_copies
        c = wide_case(torch, dev, gen, attn, dt, d, Tq, Tk, causal,
                      bias_kind, rate)
        route = attn.head_dim_route(d, dt)
        # a q, k, v whose rows TMA cannot address (not a multiple of 16
        # bytes) are copied
        want_copies = 3 * (d * dt.itemsize % 16 != 0)
        if attn.padded_copies - copies != want_copies:
            fail(f"wide forward D={d} {dtn}: "
                 f"{attn.padded_copies - copies} copies, expected "
                 f"{want_copies}")
        label = (f"{dtn} D={d} Tq={Tq} Tk={Tk} causal={causal} "
                 f"bias={bias_kind} dropout={rate} ({route})")
        ref, ref_lse = attn.flash_attention_reference(
            c["q"].float(), c["k"].float(), c["v"].float(), c["bias"],
            c["scale"], causal, c["seed"], rate)
        tol = TOL_F32 if dtn == "float32" else TOL_HALF
        errs["flash_attention_wide_fwd"] = max(
            errs["flash_attention_wide_fwd"],
            check_close("wide forward", label, c["out"], ref, tol))
        check_close("wide forward lse", label, c["lse"], ref_lse,
                    TOL_F32 if dtn == "float32" else TOL_LSE)
        again = attn._flash_forward(c["q"], c["k"], c["v"], c["bias"],
                                    c["scale"], causal, c["seed"], rate)
        if not (torch.equal(again[0], c["out"])
                and torch.equal(again[1], c["lse"])):
            fail(f"wide forward {label}: two runs differ")
        before = {n: attn.launches[n] for n in attn.KERNELS}
        runs = [run_backward(attn, c, 1024) for _ in range(2)]
        moved = {n: attn.launches[n] - before[n] for n in attn.KERNELS}
        want = {n: 2 * (n in WIDE_KERNELS[1:]) for n in attn.KERNELS}
        if moved != want:
            fail(f"wide backward {label}: launches {moved}, expected {want}")
        if not all(torch.equal(a, b) for a, b in zip(*runs)
                   if a is not None):
            fail(f"wide backward {label}: two runs differ")
        want_grads = attn.flash_attention_backward_reference(
            c["q"], c["k"], c["v"], c["bias"], c["seed"], rate, c["out"],
            c["lse"], c["do"], c["scale"], causal, c["learned"])
        names = ("dq", "dk", "dv")
        for nm, got, ref_g in zip(names, runs[0][:3], want_grads[:3]):
            e = rel(got, ref_g)
            if not e <= REL_BWD[dtn]:
                fail(f"wide backward {label}: {nm} rel {e:.3e} beyond "
                     f"{REL_BWD[dtn]}")
            kname = ("flash_attention_wide_dq" if nm == "dq"
                     else "flash_attention_wide_dkv")
            errs[kname] = max(errs[kname],
                              (got.float() - ref_g).abs().max().item())
        if c["learned"]:
            e = rel(runs[0][3], want_grads[3].sum(dim=0, keepdim=True))
            if not e <= REL_BWD[dtn]:
                fail(f"wide backward {label}: dbias rel {e:.3e}")
        if route in ("wide_stream", "wide_f32"):
            route_audit(torch, attn, c, label, route)
        print(f"phase 3: wide {label}: out, lse within tolerance, dq, dk, "
              f"dv{', dbias' if c['learned'] else ''} within rel "
              f"{REL_BWD[dtn]}, two runs of the forward and of the "
              f"backward equal to the bit, {want_copies} copies",
              flush=True)
    for dt, d in ((torch.bfloat16, 288), (torch.float16, 384),
                  (torch.bfloat16, 512), (torch.bfloat16, 576),
                  (torch.float32, 288), (torch.float32, 576)):
        got, want = wide_mask_probe(torch, dev, attn, dt, d)
        from_dkv, from_dq, want_pair = pair_dropout_masks(torch, attn, dev,
                                                          dt, d)
        torch.cuda.synchronize()
        for what, a, b in (("forward", got, want), ("dkv", from_dkv,
                                                    want_pair),
                           ("dq", from_dq, want_pair)):
            if not torch.equal(a, b):
                fail(f"wide {what} {dt} D={d} dropout mask differs from "
                     f"dropout_keep_reference in {int((a != b).sum())} bits")
        print(f"phase 3: wide {str(dt).split('.')[-1]} D={d} dropout masks "
              f"(forward, dq, dkv) = dropout_keep_reference bit for bit",
              flush=True)
    launches = wide_path(torch, dev, gen, attn)
    rows = wide_timed(torch, dev, gen, attn, errs)
    wide_f32_timed(torch, dev, gen, attn)
    for name in WIDE_KERNELS:
        rows[name]["max_abs_err"] = errs[name]
    torch.cuda.empty_cache()
    return rows, launches


# the f32 flash kernels at head dims up to 256 (f32 is MXNet's default
# dtype: the 3xTF32 forward, fused pass and pair), timed at
# BERT-base's attention (key padding), GPT-2 training's (causal) and
# (4, 8, 1024, 256) with key padding, where the pair is the only route, in
# f32: (B, H, T, D, bias, causal)
F32_TIMED = ((8, 12, 512, 64, "keypad", False), (8, 12, 1024, 64, None, True),
             (4, 8, 1024, 256, "keypad", False))
F32_KERNEL = {"flash_attention_fwd": r"flash_fwd_tf32<",
              "flash_attention_bwd_fused": r"bwd_fused_tf32<",
              "flash_attention_bwd_dq": r"wide_dq_tf32\b",
              "flash_attention_bwd_dkv": r"bwd_dkv_tf32(<|_st\b)"}
# the f32 FMA kernels the 3xTF32 ones replaced: none of them may run
F32_GONE = r"flash_fwd_f32<|bwd_(dq|dkv)_f32<|wide::wide_dkv<"
TF32_FLOPS = 495e12   # H100 SXM data sheet, dense


def f32_timed(torch, dev, gen, attn):
    """Each ``F32_TIMED`` shape in f32: the forward, the fused backward
    pass (the route at D <= 128: Tk <= block_k) and the dq/dkv pair, each
    against its plain version (out TOL_F32, dq, dk, dv REL_BWD), then each
    kernel's device time a launch beside its bound (operations at the f32
    FMA peak), the time its products would take on the tensor cores as
    3xTF32 (three TF32 products an f32 one, as SDPA's f32 kernels do), the
    plain version's and SDPA's f32 forward or whole backward (default
    backends, TF32 off)."""
    import torch.nn.functional as F
    for B, Hh, T, d, bias_kind, causal in F32_TIMED:
        c = wide_timed_case(torch, dev, gen, attn, B, Hh, T, d, bias_kind,
                            causal, "float32")
        label = (f"({B}, {Hh}, {T}, {d}) f32 "
                 f"{'causal' if causal else bias_kind}")
        q, k, v, bias, scale = c["q"], c["k"], c["v"], c["bias"], c["scale"]
        fused = attn.backward_route(d, T, attn.DEFAULT_BLOCK_K) == "fused"
        if fused != (d <= attn.FUSED_MAX_HEAD_DIM):
            fail(f"f32 rows {label}: backward route "
                 f"{attn.backward_route(d, T, attn.DEFAULT_BLOCK_K)}")
        ref, _ = attn.flash_attention_reference(q, k, v, bias, scale, causal)
        errs = {"flash_attention_fwd": check_close(
            "f32 forward", label, c["out"], ref, TOL_F32)}
        del ref
        want = attn.flash_attention_backward_reference(
            q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"], scale,
            causal, False)
        calls = {"flash_attention_fwd": lambda: attn._flash_forward(
            q, k, v, bias, scale, causal)}
        kernels = ((("flash_attention_bwd_fused",
                     ((0, "dq"), (1, "dk"), (2, "dv"))),) if fused else ()) \
            + (("flash_attention_bwd_dq", ((0, "dq"),)),
               ("flash_attention_bwd_dkv", ((1, "dk"), (2, "dv"))))
        for name, parts in kernels:
            calls[name], outs = kernel_only_call(torch, attn, c, name)
            calls[name]()
            for i, nm in parts:
                got = outs[i]
                if name == "flash_attention_bwd_fused" and nm == "dq":
                    got = attn.dq_from_accumulator(got, T, d, torch.float32)
                e = rel(got, want[i])
                if not e <= REL_BWD["float32"]:
                    fail(f"f32 {name} {label}: {nm} rel {e:.3e} beyond "
                         f"{REL_BWD['float32']}")
                errs[name] = max(errs.get(name, 0.0), e)
        del want
        plain = {"fwd": device_ms(lambda: attn.flash_attention_reference(
            q, k, v, bias, scale, causal), iters=3),
            "bwd": device_ms(lambda: attn.flash_attention_backward_reference(
                q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"], scale,
                causal, False), iters=3)}
        lib = {"fwd": device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, is_causal=causal, scale=scale)),
            "bwd": library_backward_ms(torch, q, k, v, bias, c["do"], scale,
                                       causal, 0.0, False)}
        pairs = score_pairs(B, T, c["valid"], causal)
        for name in calls:
            pattern = F32_KERNEL[name]
            if name == "flash_attention_fwd":
                bnd, by = attention_bound_ms(B, Hh, T, d, c["valid"],
                                             "float32", 4, causal, bias)
                flops, side = 4.0 * Hh * d * pairs, "fwd"
            else:
                kind = name.rsplit("_", 1)[1]
                bnd, by = backward_bound_ms(kind, B, Hh, T, T, d, c["valid"],
                                            "float32", 4, causal, bias,
                                            False)
                flops = 2.0 * {"fused": 5, "dq": 3, "dkv": 4}[kind] * Hh \
                    * d * pairs
                side = "bwd"
            ms = launch_ms(calls[name], 5, lambda n: re.search(pattern, n))
            if ms is None:
                fail(f"f32 {name} at {label}: the profiler kept no record of "
                     f"{pattern}")
            whole = " (the whole backward)" if side == "bwd" else ""
            print(f"phase 3: f32 {name} at {label}: {fmt_ms(ms)} device "
                  f"(bound {bnd:.5f} ms by {by} at the f32 FMA peak; 3xTF32 "
                  f"on the tensor cores {3 * flops / TF32_FLOPS * 1e3:.5f} "
                  f"ms; plain {fmt_ms(plain[side])}{whole}; SDPA f32 "
                  f"{fmt_ms(lib[side])}{whole}); error {errs[name]:.3e}",
                  flush=True)
        del c, calls, outs
        torch.cuda.empty_cache()


# ------------------------------------------- phase 3: the multi-tensor update
def update_shapes(which: str):
    """The trained parameters' shapes (tied ones once) of BERT-base with
    its MLM head (phase 5) or ResNet-50 v1 (phase 6), built on the CPU;
    "small": a few ragged shapes."""
    if which == "small":
        return [(33, 17), (5,), (1000,), (64, 3, 3, 3), (16385,), (2, 7, 11)]
    if which == "bert":
        from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
        net = get_bert("bert_12_768_12", device="cpu", vocab_size=30522,
                       max_length=512, use_pooler=False,
                       use_classifier=False)
    else:
        from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
        net = get_model("resnet50_v1", device="cpu")
    return model_shapes(net)


def shifted(torch, t):
    """A copy of ``t`` one element into a larger buffer: a contiguous view
    whose address is not 16-byte aligned."""
    return torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view(t.shape).copy_(t)


def update_sides(torch, dev, case, shapes):
    """Two identical sets (kernel, plain) of an optimizer, weights and
    states, and three steps of gradients, from a seed. ``case["unaligned"]``:
    every other tensor's weight, gradient, master and states are views one
    element into their buffers (the kernel's scalar accesses)."""
    from mxnet_tpu_torch import optimizer as mo
    gen = torch.Generator(device="cpu").manual_seed(7)
    dt = case["dtype"]
    odd = (lambda i: i % 2 == 1) if case.get("unaligned") else \
        (lambda i: False)

    def place(i, t):
        return shifted(torch, t) if odd(i) else t

    ws = [torch.randn(s, generator=gen) * 0.02 for s in shapes]
    grads = [[place(i, (torch.randn(s, generator=gen) * 3).to(dev, dt))
              for i, s in enumerate(shapes)] for _ in range(3)]
    sides = []
    for _ in range(2):
        opt = mo.create(case["opt"], multi_precision=case["master"],
                        **case["kw"])
        opt.rescale_grad = 1.0 / 8
        if case.get("mults"):
            opt.set_lr_mult({i: (0.5, 1.0, 2.0)[i % 3]
                             for i in range(len(shapes))})
            opt.set_wd_mult({i: (1.0, 0.0, 0.5)[i % 3]
                             for i in range(len(shapes))})
        w = [place(i, x.to(dev, dt)) for i, x in enumerate(ws)]
        st = [opt.create_state_multi_precision(i, x) for i, x in enumerate(w)]
        st = [(type(x)(place(i, x.master), tuple(place(i, y) for y in
                                                  x.inner))
               if isinstance(x, mo.MasterWeightState) else
               tuple(place(i, y) for y in x)) for i, x in enumerate(st)]
        sides.append((opt, w, st))
    return sides, grads


def update_step(side, grads, agg, plain=False):
    """One step of every parameter of ``side``: groups of ``agg`` by the
    trainer's plan, the counts and hyperparameters in its order, through
    the kernel or its plain version."""
    from mxnet_tpu_torch.gluon.trainer import group_plan
    opt, w, st = side
    entries = [(i, w[i], grads[i], st[i]) for i in range(len(w))]
    plan = group_plan([opt._group_key(i, x, s) for i, x, _, s in entries],
                      agg)
    hyp = [opt._next_hypers(i) for i in range(len(w))]
    fn = opt._plain_update_groups if plain else opt._update_groups
    out = fn([[entries[k] for k in g] for g in plan],
             [[hyp[k] for k in g] for g in plan])
    for g, states in zip(plan, out):
        for k, s in zip(g, states):
            st[k] = s


def state_tensors(st):
    """Every tensor of a parameter's state, the master first."""
    from mxnet_tpu_torch.optimizer import MasterWeightState
    if isinstance(st, MasterWeightState):
        return [st.master] + list(st.inner)
    return list(st)


def bits_equal(a, b) -> bool:
    import torch
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def update_bound_ms(case, shapes):
    """Least time of one step: each gradient read once, each weight (or
    master) and state read and written once, a master's weight written."""
    n = sum(math.prod(s) for s in shapes)
    e = {"float32": 4, "bfloat16": 2, "float16": 2}[
        str(case["dtype"]).split(".")[-1]]
    math_e = 4 if case["master"] else e
    states = {"sgd": 2 * math_e if case["kw"].get("momentum") else 0,
              "adam": 16, "adamw": 16}[case["opt"]]
    per = e + 2 * math_e + states + (e if case["master"] else 0)
    return n * per / HBM_BYTES_PER_S * 1e3, per


def library_update_ms(torch, dev, case, shapes):
    """PyTorch's fused optimizer kernel over f32 tensors of the same shapes
    (``torch._fused_adamw_``, ``_fused_adam_``, ``_fused_sgd_``): a
    yardstick, never called by the port. Device time, or None."""
    try:
        ps = [torch.zeros(s, device=dev) for s in shapes]
        gs = [torch.ones(s, device=dev) for s in shapes]
        kw = case["kw"]
        if case["opt"] == "sgd":
            bufs = [torch.zeros(s, device=dev) for s in shapes] \
                if kw.get("momentum") else []
            def call():
                torch._fused_sgd_(ps, gs, bufs, weight_decay=kw.get("wd", 0.0),
                                  momentum=kw.get("momentum", 0.0),
                                  lr=kw["learning_rate"], dampening=0.0,
                                  nesterov=False, maximize=False,
                                  is_first_step=False)
        else:
            ms = [torch.zeros(s, device=dev) for s in shapes]
            vs = [torch.zeros(s, device=dev) for s in shapes]
            steps = [torch.ones((), device=dev) for _ in shapes]
            fn = torch._fused_adamw_ if case["opt"] == "adamw" \
                else torch._fused_adam_
            def call():
                fn(ps, gs, ms, vs, [], steps, lr=kw["learning_rate"],
                   beta1=0.9, beta2=0.999, weight_decay=kw.get("wd", 0.0),
                   eps=1e-8, amsgrad=False, maximize=False)
        return device_ms(call, iters=5)
    except Exception as e:  # noqa: BLE001 - a yardstick; reported, not fatal
        print(f"phase 3:   library call unavailable here ({e!r:.120})",
              flush=True)
        return None


# phase 3, the multi-tensor update's cases: (name, optimizer, its arguments,
# parameter shapes, dtype, f32 masters, group size (0: all in one group),
# clip_gradient and lr / wd multipliers, every other tensor's views one
# element off 16-byte alignment); three steps each, kernel against
# plain version from the same weights, gradients and states: every weight,
# master and state equal to the bit
UPDATE_KERNEL = r"mt::update<"
ADAMW_KW = {"learning_rate": 1e-4, "wd": 0.01}
UPDATE_CASES = [
    dict(name="BERT-base AdamW bf16 masters, groups of 4", opt="adamw",
         kw=ADAMW_KW, shapes="bert", dtype="bfloat16", master=True, agg=4,
         timed=True),
    dict(name="BERT-base AdamW bf16 masters, groups of 1", opt="adamw",
         kw=ADAMW_KW, shapes="bert", dtype="bfloat16", master=True, agg=1),
    dict(name="BERT-base AdamW bf16 masters, one group", opt="adamw",
         kw=ADAMW_KW, shapes="bert", dtype="bfloat16", master=True, agg=0,
         timed=True),
    dict(name="ResNet-50 SGD momentum 0.9 bf16 masters, groups of 4",
         opt="sgd", kw={"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
         shapes="resnet", dtype="bfloat16", master=True, agg=4, timed=True),
    dict(name="SGD f32, clip, multipliers", opt="sgd",
         kw={"learning_rate": 0.1, "wd": 1e-4, "clip_gradient": 0.2},
         shapes="small", dtype="float32", master=False, agg=4, mults=True),
    dict(name="Adam f32, clip, multipliers", opt="adam",
         kw={"learning_rate": 1e-3, "wd": 1e-4, "clip_gradient": 0.2},
         shapes="small", dtype="float32", master=False, agg=4, mults=True),
    dict(name="AdamW f32, clip, multipliers", opt="adamw",
         kw={"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.2},
         shapes="small", dtype="float32", master=False, agg=0, mults=True),
    dict(name="AdamW fp16 masters, clip, multipliers", opt="adamw",
         kw={"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.2},
         shapes="small", dtype="float16", master=True, agg=4, mults=True,
         unaligned=True),
    dict(name="SGD momentum fp16 masters, clip", opt="sgd",
         kw={"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
             "clip_gradient": 0.2},
         shapes="small", dtype="float16", master=True, agg=1),
    dict(name="AdamW bf16 without masters, clip", opt="adamw",
         kw={"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.2},
         shapes="small", dtype="bfloat16", master=False, agg=4, mults=True),
    dict(name="SGD momentum bf16 without masters", opt="sgd",
         kw={"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
         shapes="small", dtype="bfloat16", master=False, agg=4,
         unaligned=True),
]


def update_check(torch, dev, case, shapes, timed=False):
    """One case: three steps through the kernel and the plain version; fails
    unless every tensor ends with the same bits. Timed: device time a step
    of the kernel, of the plain version and of the library call."""
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    case = dict(case, dtype=getattr(torch, case["dtype"])
                if isinstance(case["dtype"], str) else case["dtype"])
    agg = case["agg"] or len(shapes)
    (kern, plain), grads = update_sides(torch, dev, case, shapes)
    before = mt.launches["multi_tensor_update"]
    for step in range(3):
        update_step(kern, grads[step], agg)
        update_step(plain, grads[step], agg, plain=True)
    launched = mt.launches["multi_tensor_update"] - before
    groups = -(-len(shapes) // agg)
    # one launch a step: every tensor of a case shares one layout
    if launched != 3:
        fail(f"update {case['name']}: {launched} kernel launches in three "
             f"steps of {groups} groups, expected 3 (one a layout a step)")
    worst, diff = 0.0, []
    for k in range(len(shapes)):
        pairs = [(kern[1][k], plain[1][k])] + list(zip(
            state_tensors(kern[2][k]), state_tensors(plain[2][k])))
        for a, b in pairs:
            if not bits_equal(a, b):
                diff.append(k)
                worst = max(worst, (a.float() - b.float()).abs().max().item())
    if diff:
        fail(f"update {case['name']}: tensors {sorted(set(diff))[:8]} differ "
             f"from the plain version (max abs {worst:.3e})")
    row = dict(max_abs_err=0.0, ms=None, plain_ms=None, library_ms=None)
    row["bound_ms"], per = update_bound_ms(case, shapes)
    row["bound_by"] = "bytes"
    if timed:
        row["ms"] = launch_ms(lambda: update_step(kern, grads[0], agg), 5,
                              lambda n: re.search(UPDATE_KERNEL, n))
        row["plain_ms"] = device_ms(
            lambda: update_step(plain, grads[0], agg, plain=True), iters=2)
        row["library_ms"] = library_update_ms(torch, dev, case, shapes)
    print(f"phase 3: update {case['name']}: {len(shapes)} tensors in "
          f"{groups} groups, {sum(math.prod(s) for s in shapes)} elements, "
          f"1 launch a step; weights, masters and states after 3 steps equal "
          f"to the plain version's bits; device time a step "
          f"{fmt_ms(row['ms'])} (bound {row['bound_ms']:.4f} ms at {per} B "
          f"an element), plain {fmt_ms(row['plain_ms'])}, library "
          f"{fmt_ms(row['library_ms'])}", flush=True)
    return row


def update_checks(torch, dev):
    """Phase 3: the multi-tensor update against its plain version in every
    case of UPDATE_CASES. Returns the kernel's row: BERT-base's AdamW step
    in groups of 4 (the main path's)."""
    shapes = {k: update_shapes(k) for k in ("bert", "resnet", "small")}
    rows = [update_check(torch, dev, c, shapes[c["shapes"]],
                         timed=c.get("timed", False)) for c in UPDATE_CASES]
    torch.cuda.empty_cache()
    return {"multi_tensor_update": rows[0]}


def phase_kernels(torch, dev):
    """Phase 3: every kernel against its plain version. Returns the rows
    and the wide kernels' launches on their path."""
    from mxnet_tpu_torch.ops.cuda import attention as attn
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {"flash_attention_fwd": forward_checks(torch, dev, gen, attn)}
    rows.update(backward_checks(torch, dev, gen, attn))
    f32_timed(torch, dev, gen, attn)
    wide_rows, wide_launches = wide_checks(torch, dev, gen, attn)
    rows.update(wide_rows)
    rows.update(conv_checks(torch, dev))
    rows.update(bn_checks(torch, dev))
    rows.update(update_checks(torch, dev))
    print(f"phase 3: every kernel agrees with its plain version; card: "
          f"{smi_line()}", flush=True)
    return rows, wide_launches


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
    if hasattr(mod, "padded_copies"):
        mod.padded_copies = 0


# kernel-name patterns (re.search) of each group of a breakdown
ATTN_GROUPS = {"flash forward": r"flash_fwd", "flash backward": r"bwd_"}
CONV_GROUPS = {f"conv1x1 {k.split('_')[1]}": v
               for k, v in CONV_KERNEL.items()}
RESNET_GROUPS = dict(CONV_GROUPS, **{"batch norm": r"\bbn::"})


def device_breakdown(prof, wall_ms, label, groups=None, drop=None):
    """Device time per kernel from a torch.profiler run, the device's idle
    share over ``wall_ms`` and the share of each group of kernels (names
    matching the group's pattern); kernels whose names match ``drop`` (a
    session's primer) are left out. Returns (busy ms, idle share)."""
    per_kernel = {k: v for k, v in kernel_times(prof).items()
                  if not (drop and re.search(drop, k))}
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


def forward_breakdown(torch, net, dev, mode, B=8, T=512):
    """One direct bf16 forward of the served block at the top bucket,
    eager or replayed from its graph (``mode``, as the block is
    hybridized): its time by CUDA events, and the device time per kernel
    from torch.profiler. The launch counters are restored afterwards."""
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
    print(f"phase 4: direct forward ({mode}) B={B} T={T} bf16: {ms:.3f} ms "
          f"(CUDA events, mean of 10); card: {smi_line()}", flush=True)
    device_breakdown(prof, wall_ms, f"phase 4: profiled forward ({mode})")


def phase_bert(torch, dev):
    """Phase 4: BERT-base served on the card. Returns the forward kernel's
    launches in the serving run."""
    import numpy as np
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.block import HybridBlock
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    from mxnet_tpu_torch.serving import BucketPolicy, ServedModel

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
        torch.bfloat16).to(dev)
    n_params = sum(p.numel() for p in gpu_net.parameters())
    print(f"phase 4: BERT-base built ({n_params} parameters, "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    # one direct call gives the block the signature from_block takes
    gpu_net.hybridize()
    with torch.inference_mode():
        gpu_net(torch.zeros((1, 512), dtype=torch.int32, device=dev),
                torch.full((1,), 512, dtype=torch.int32, device=dev))
    model = ServedModel.from_block(gpu_net, device=dev)
    sig = [((512,), np.dtype(np.int32)), ((), np.dtype(np.int32))]
    if model.input_signature != sig:
        fail(f"from_block took the signature {model.input_signature}, "
             f"expected {sig}")
    policy = BucketPolicy(batch_buckets=(1, 2, 4, 8), pad_axis=0,
                          length_buckets=(128, 512))
    rng = np.random.RandomState(1)
    lengths = [int(x) for x in rng.randint(16, 513, size=16)]
    lengths[0], lengths[1] = 16, 512
    samples = [(rng.randint(0, 30522, size=L).astype(np.int32),
                np.int32(L)) for L in lengths]
    runs = {}
    for mode in ("eager", "graphs"):
        gpu_net.hybridize(mode == "graphs")
        runs[mode] = serve_run(torch, model, policy, samples, mode)
    counts, results, batches = runs["eager"][:3]
    launches = counts["flash_attention_fwd"]
    alone = [runs[m][3] for m in ("eager", "graphs")]
    if not all(np.array_equal(a, b) for x, y in zip(*alone)
               for a, b in zip(x, y)):
        fail("the 16 requests, each alone, answered from the captured "
             "buckets differ from the eager server's answers")
    print("phase 4: the 16 requests, each alone, answered from the captured "
          "buckets: equal to the eager server's answers to the bit",
          flush=True)
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
    for mode in ("eager", "graphs"):
        gpu_net.hybridize(mode == "graphs")
        forward_breakdown(torch, gpu_net, dev, mode)
    print(f"phase 4: eager server: {batches} batches, {launches} forward "
          f"launches (0 padded copies); {len(check)} answers vs CPU f32: "
          f"worst relative error {worst:.3e}; card: {smi_line()}",
          flush=True)
    graph_alone = runs["graphs"][3]
    http_counts = http_run(torch, model, policy, samples, graph_alone)
    drain_and_breaker(model, policy, samples, graph_alone)
    export_counts = export_run(torch, gpu_net, dev, samples, graph_alone)
    return {n: counts[n] + http_counts[n] + export_counts[n]
            for n in counts}


def serve_run(torch, model, policy, samples, mode):
    """One server over ``model``: warm-up (for graphs, every bucket
    captured), 16 concurrent requests (req/s, latency p50 / p99; eager:
    the forward kernel's launches by its counter, 12 a batch; graphs: the
    counter must not move, every batch a replay, and the profiler must
    see 12 forward kernels a batch), then each request alone. Returns
    (counts, answers, batches, answers alone)."""
    import numpy as np
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.serving import ModelServer
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    server = ModelServer(model, policy=policy, warmup=True, timeout_ms=5)
    print(f"phase 4: {mode}: warmup {server.warmed} buckets in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(samples))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        counts = dict(attn.launches)
        batches = server.stats["batches"] - batches0
        alone = [server.infer(*x, timeout=300.0) for x in samples]
    if errors:
        fail("; ".join(errors))
    seen = pattern_counts(prof, ["flash_attention_fwd"])["flash_attention_fwd"]
    launches = counts["flash_attention_fwd"]
    if batches < 1 or seen != 12 * batches or \
            launches != (12 * batches if mode == "eager" else 0):
        fail(f"{mode} server: {batches} batches, forward kernels launched "
             f"{launches} times by the counter and {seen} by the profiler; "
             "expected 12 a batch by the profiler, by the counter 12 a batch "
             "eager and none from graphs")
    if any(counts[n] for n in attn.KERNELS[1:]):
        fail(f"serving launched a backward kernel: {counts}")
    if attn.padded_copies:
        fail(f"serving copied {attn.padded_copies} attention operands that "
             "TMA could not address; expected none")
    for (tok, L), res in zip(samples, results):
        seq, pooled = res
        if seq.shape != (L, 768) or pooled.shape != (768,) \
                or not (np.isfinite(seq).all() and np.isfinite(pooled).all()):
            fail(f"answer for length {L}: shapes {seq.shape}, "
                 f"{pooled.shape} or non-finite values")
    lat_ms = sorted(x * 1e3 for x in lat)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(math.ceil(0.99 * len(lat_ms))) - 1)]
    print(f"phase 4: {mode}: {len(samples)} requests in {wall:.3f} s "
          f"({len(samples) / wall:.2f} req/s), {batches} batches, forward "
          f"kernels {seen} by the profiler ({launches} by the counter), "
          f"latency p50 {p50:.1f} ms p99 {p99:.1f} ms; card: {smi_line()}",
          flush=True)
    return counts, results, batches, alone


def http_call(port, method, path, body=None, headers=None):
    """One HTTP request to 127.0.0.1:``port``: (status, headers, body
    bytes). ``body`` is JSON-encoded; every socket call times out."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body), headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def http_answer(data):
    """The (sequence output, pooled output) of a one-instance answer,
    parsed back to f32."""
    import numpy as np
    seq, pooled = json.loads(data)["predictions"][0]
    return (np.asarray(seq, dtype=np.float32),
            np.asarray(pooled, dtype=np.float32))


def instance(sample):
    tok, L = sample
    return {"instances": [[tok.tolist(), int(L)]]}


class HttpFront:
    """``make_http_server`` on 127.0.0.1:0 over ``server`` (a ModelServer
    or a GenerationServer), started and serving on a thread; ``close()``
    stops both."""

    def __init__(self, server):
        from mxnet_tpu_torch.serving import GenerationServer, make_http_server
        self.server = server.start()
        gen = isinstance(server, GenerationServer)
        self.httpd = make_http_server(None if gen else server,
                                      host="127.0.0.1", port=0,
                                      generation_server=server if gen
                                      else None)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        self.server.stop()


def rel_err(got, want) -> float:
    import numpy as np
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def json_encode_ms(answer, reps=5):
    """Host time of the HTTP front's encoding of one answer
    (``tolist`` and ``json.dumps``): (median ms, bytes)."""
    times, size = [], 0
    for _ in range(reps):
        t0 = time.perf_counter()
        size = len(json.dumps({"predictions": [[o.tolist()
                                                for o in answer]]}).encode())
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], size


def http_run(torch, model, policy, samples, want):
    """Phase 4 over HTTP: a graph server (every bucket captured) behind
    ``make_http_server``; the 16 requests sent together from threads
    (req/s, p50 / p99; the forward kernel 12 a batch by the profiler, none
    by the counter: every batch a replay; no operand copied for TMA), each
    within TOL_HTTP_BATCHED_REL of ``want`` (the graph server's answers to
    the requests alone, in process); then each sent alone, equal to
    ``want`` to the bit; a ``traceparent`` continued and found in
    ``/v1/traces``; ``/metrics`` counting every answered request; and the
    JSON encoding of the T=512 answer timed alone. Returns the counter's
    launches."""
    import random as pyrandom
    import numpy as np
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.serving import ModelServer
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    server = ModelServer(model, policy=policy, warmup=True, timeout_ms=5)
    front = HttpFront(server)
    print(f"phase 4: http: graph server warmed {server.warmed} buckets in "
          f"{time.perf_counter() - t0:.2f} s, listening on 127.0.0.1:"
          f"{front.port}", flush=True)
    lat = [0.0] * len(samples)
    got = [None] * len(samples)
    errors = []

    def client(i):
        try:
            t = time.perf_counter()
            status, _, data = http_call(front.port, "POST", "/v1/inference",
                                        instance(samples[i]))
            lat[i] = time.perf_counter() - t
            if status != 200:
                errors.append(f"request {i}: HTTP {status} {data[:200]!r}")
            else:
                got[i] = http_answer(data)
        except Exception as e:  # noqa: BLE001 - reported below, fatal
            errors.append(f"request {i}: {e!r}")

    try:
        status, _, _ = http_call(front.port, "GET", "/healthz")
        if status != 200:
            fail(f"http: /healthz answered {status} before traffic")
        tmx.metrics.reset()
        reset_counts(attn)
        batches0 = server.stats["batches"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(samples))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        counts = dict(attn.launches)
        batches = server.stats["batches"] - batches0
        if errors:
            fail("http: " + "; ".join(errors))
        seen = pattern_counts(prof, ["flash_attention_fwd"])[
            "flash_attention_fwd"]
        sdpa = sum(c for k, c in kernel_counts(prof).items()
                   if re.search(SDPA_KERNEL, k))
        if batches < 1 or seen != 12 * batches \
                or counts["flash_attention_fwd"] or sdpa:
            fail(f"http: {batches} batches, forward kernels {seen} by the "
                 f"profiler and {counts['flash_attention_fwd']} by the "
                 f"counter, {sdpa} SDPA kernels; expected 12 a batch by the "
                 "profiler, none by the counter (replays), no SDPA")
        if attn.padded_copies:
            fail(f"http: {attn.padded_copies} attention operands copied for "
                 "TMA; expected none")
        worst, same = 0.0, 0
        for i, (g, w) in enumerate(zip(got, want)):
            for a, b in zip(g, w):
                if a.shape != b.shape:
                    fail(f"http: request {i}: shape {a.shape} != {b.shape}")
                worst = max(worst, rel_err(a, b))
            same += all(np.array_equal(a, b) for a, b in zip(g, w))
        if worst > TOL_HTTP_BATCHED_REL:
            fail(f"http: answers to the requests sent together off the "
                 f"answers alone: relative error {worst:.3e} > "
                 f"{TOL_HTTP_BATCHED_REL}")
        lat_ms = sorted(x * 1e3 for x in lat)
        p50 = lat_ms[len(lat_ms) // 2]
        p99 = lat_ms[min(len(lat_ms) - 1,
                         int(math.ceil(0.99 * len(lat_ms))) - 1)]
        print(f"phase 4: http: {len(samples)} requests sent together in "
              f"{wall:.3f} s ({len(samples) / wall:.2f} req/s), {batches} "
              f"batches, forward kernels {seen} by the profiler (0 by the "
              f"counter, 0 SDPA, 0 padded copies), latency p50 {p50:.1f} ms "
              f"p99 {p99:.1f} ms; against the answers alone in process: "
              f"{same} of {len(samples)} equal to the bit, worst relative "
              f"error {worst:.3e}; card: {smi_line()}", flush=True)
        for i, s in enumerate(samples):
            status, _, data = http_call(front.port, "POST", "/v1/inference",
                                        instance(s))
            if status != 200:
                fail(f"http: request {i} alone: HTTP {status}")
            if not all(np.array_equal(a, b)
                       for a, b in zip(http_answer(data), want[i])):
                fail(f"http: request {i} alone: the answer parsed back to "
                     "f32 differs from the graph server's answer in process")
        print(f"phase 4: http: the {len(samples)} requests, each alone, "
              "parsed back to f32: equal to the graph server's answers in "
              "process to the bit", flush=True)
        trace_id = f"{pyrandom.getrandbits(128):032x}"
        tp = f"00-{trace_id}-{pyrandom.getrandbits(64) | 1:016x}-01"
        status, headers, _ = http_call(front.port, "POST", "/v1/inference",
                                       instance(samples[0]),
                                       {"traceparent": tp})
        back = headers.get("traceparent", "")
        _, _, data = http_call(front.port, "GET", "/v1/traces")
        names = sorted({e["name"] for e in json.loads(data)["traceEvents"]
                        if e.get("args", {}).get("trace_id") == trace_id})
        if status != 200 or trace_id not in back \
                or "http.request" not in names:
            fail(f"http: traceparent {tp}: HTTP {status}, answered "
                 f"traceparent {back!r}, spans of the trace in /v1/traces "
                 f"{names}")
        answered = 2 * len(samples) + 1
        _, _, data = http_call(front.port, "GET", "/metrics")
        line = [ln for ln in data.decode().splitlines() if ln.startswith(
            'mxnet_serving_requests_total{status="ok"}')]
        if not line or float(line[0].split()[-1]) != answered:
            fail(f"http: /metrics shows {line}, expected {answered} "
                 "requests answered ok")
        print(f"phase 4: http: traceparent continued (spans {names} in "
              f"/v1/traces); /metrics: {line[0]}", flush=True)
        enc_ms, size = json_encode_ms(want[1])
        print(f"phase 4: http: JSON encoding of one T={len(samples[1][0])} "
              f"answer ({want[1][0].shape} + {want[1][1].shape} f32, "
              f"{size} bytes) alone: {enc_ms:.2f} ms on the host (median "
              "of 5)", flush=True)
        return counts
    finally:
        front.close()


def drain_and_breaker(model, policy, samples, want):
    """Phase 4's drain and breaker over HTTP: a graph server answers
    /healthz 200; after ``start_drain()`` /healthz 503 ``draining``,
    /livez 200 and a POST 429 ``draining``, and ``await_drained()`` is
    True. A second server with ``max_restarts=0`` under the plan
    ``serving.worker:times=1``: its worker dies on the first batch, the
    breaker trips, /healthz answers 503 ``degraded``; after
    ``reset_breaker()`` /healthz answers 200 and a request is answered
    with the in-process bits again."""
    import numpy as np
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.serving import ModelServer

    def expect(port, method, path, code, key=None, value=None, body=None):
        status, _, data = http_call(port, method, path, body)
        got = json.loads(data).get(key) if key else None
        if status != code or got != value:
            fail(f"drain/breaker: {method} {path} answered {status} "
                 f"{data[:200]!r}; expected {code}"
                 + (f" with {key}={value!r}" if key else ""))
        return status

    front = HttpFront(ModelServer(model, policy=policy, timeout_ms=5))
    try:
        codes = [expect(front.port, "GET", "/healthz", 200, "status", "ok")]
        front.server.start_drain()
        codes += [expect(front.port, "GET", "/healthz", 503, "status",
                         "draining"),
                  expect(front.port, "GET", "/livez", 200, "status",
                         "alive"),
                  expect(front.port, "POST", "/v1/inference", 429, "reason",
                         "draining", instance(samples[0]))]
        if not front.server.await_drained(timeout=30.0):
            fail("drain/breaker: await_drained() returned False")
    finally:
        front.close()
    print(f"phase 4: drain: /healthz {codes[0]}, after start_drain() "
          f"/healthz {codes[1]} draining, /livez {codes[2]}, POST "
          f"{codes[3]} draining; await_drained() True", flush=True)
    front = HttpFront(ModelServer(model, policy=policy, timeout_ms=5,
                                  max_restarts=0))
    try:
        expect(front.port, "GET", "/healthz", 200, "status", "ok")
        with faults.fault_plan("serving.worker:times=1"):
            tripped, _, _ = http_call(front.port, "POST", "/v1/inference",
                                      instance(samples[0]))
        deadline = time.monotonic() + 30
        while not front.server.degraded and time.monotonic() < deadline:
            time.sleep(0.01)
        degraded = expect(front.port, "GET", "/healthz", 503, "status",
                          "degraded")
        front.server.reset_breaker()
        healthy = expect(front.port, "GET", "/healthz", 200, "status", "ok")
        status, _, data = http_call(front.port, "POST", "/v1/inference",
                                    instance(samples[0]))
        if status != 200 or not all(np.array_equal(a, b) for a, b in
                                    zip(http_answer(data), want[0])):
            fail(f"drain/breaker: after reset_breaker() a request answered "
                 f"{status}, or not with the in-process bits")
    finally:
        front.close()
    print(f"phase 4: breaker: max_restarts=0 and serving.worker:times=1: the "
          f"request in flight answered {tripped}, /healthz {degraded} "
          f"degraded; after reset_breaker() /healthz {healthy} and a request "
          f"answered {status} with the in-process bits", flush=True)


def export_run(torch, net, dev, samples, want):
    """Phase 4's export: ``net.export(..., dynamic_batch=True)`` of the
    bf16 BERT-base into ``build/export/``, ``ServedModel.from_export`` of
    the files in this process (no block built), and a ``ModelServer`` over
    it (every request padded to 512: the program's length) answering the
    16 requests sent together: req/s, p50 / p99, the forward kernel 12 a
    batch by the profiler and by the counter (the program runs eagerly), no
    SDPA kernel, no operand copied for TMA, each answer within
    TOL_EXPORT_REL of ``want`` (from_block's graph server) and whether
    equal to the bit; and a copy of the ``.params`` file with one bit
    flipped refused by its checksum. Returns the counter's launches."""
    import numpy as np
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.serving import BucketPolicy, ModelServer, ServedModel
    from torch.profiler import ProfilerActivity, profile
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "export")
    os.makedirs(folder, exist_ok=True)
    t0 = time.perf_counter()
    sym, params = net.export(os.path.join(folder, "bert_base"),
                             input_signature=[((2, 512), np.int32),
                                              ((2,), np.int32)],
                             dynamic_batch=True)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = ServedModel.from_export(sym, device=dev)
    t_load = time.perf_counter() - t0
    print(f"phase 4: export: traced and written in {t_export:.2f} s "
          f"(program {os.path.getsize(sym)} bytes of json, params "
          f"{os.path.getsize(params)} bytes), from_export in {t_load:.2f} s",
          flush=True)
    policy = BucketPolicy(batch_buckets=(1, 2, 4, 8), pad_axis=0,
                          length_buckets=(512,))
    t0 = time.perf_counter()
    server = ModelServer(model, policy=policy, warmup=True, timeout_ms=5)
    print(f"phase 4: export: warmup {server.warmed} buckets in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    lat = [0.0] * len(samples)
    got = [None] * len(samples)
    errors = []

    def client(i):
        try:
            t = time.perf_counter()
            got[i] = server.infer(*samples[i], timeout=300.0)
            lat[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 - reported below, fatal
            errors.append(f"request {i}: {e!r}")

    with server:
        reset_counts(attn)
        batches0 = server.stats["batches"]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(samples))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        counts = dict(attn.launches)
        batches = server.stats["batches"] - batches0
    if errors:
        fail("export: " + "; ".join(errors))
    seen = pattern_counts(prof, ["flash_attention_fwd"])["flash_attention_fwd"]
    sdpa = sum(c for k, c in kernel_counts(prof).items()
               if re.search(SDPA_KERNEL, k))
    launches = counts["flash_attention_fwd"]
    if batches < 1 or seen != 12 * batches or launches != 12 * batches \
            or sdpa:
        fail(f"export: {batches} batches, forward kernels {seen} by the "
             f"profiler and {launches} by the counter, {sdpa} SDPA kernels; "
             "expected 12 a batch by both, no SDPA")
    if any(counts[n] for n in attn.KERNELS[1:]) or attn.padded_copies:
        fail(f"export: launches {counts}, {attn.padded_copies} operands "
             "copied for TMA; expected the forward alone and no copy")
    worst, same = 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            if a.shape != b.shape or not np.isfinite(a).all():
                fail(f"export: request {i}: shape {a.shape} (want "
                     f"{b.shape}) or non-finite values")
            worst = max(worst, rel_err(a, b))
        same += all(np.array_equal(a, b) for a, b in zip(g, w))
    if worst > TOL_EXPORT_REL:
        fail(f"export: answers off from_block's: relative error {worst:.3e}"
             f" > {TOL_EXPORT_REL}")
    lat_ms = sorted(x * 1e3 for x in lat)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(math.ceil(0.99 * len(lat_ms))) - 1)]
    print(f"phase 4: export: {len(samples)} requests in {wall:.3f} s "
          f"({len(samples) / wall:.2f} req/s, eager program), {batches} "
          f"batches, forward kernels {seen} by the profiler ({launches} by "
          f"the counter, 0 SDPA, 0 padded copies), latency p50 {p50:.1f} ms "
          f"p99 {p99:.1f} ms; against from_block's graph server: {same} of "
          f"{len(samples)} equal to the bit, worst relative error "
          f"{worst:.3e}; card: {smi_line()}", flush=True)
    flipped = params + ".flipped"
    with open(params, "rb") as f:
        blob = bytearray(f.read())
    blob[len(blob) // 2] ^= 0x10
    with open(flipped, "wb") as f:
        f.write(blob)
    try:
        ServedModel.from_export(sym, param_file=flipped, device=dev)
    except MXNetError as e:
        if "checksum" not in str(e):
            fail(f"export: a bit-flipped .params raised {e}")
        print(f"phase 4: export: a bit-flipped copy of the .params file "
              f"refused: {str(e)[:100]}", flush=True)
    else:
        fail("export: from_export loaded a bit-flipped .params file")
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


# every kernel of the port by name (re.search), for counting launches in a
# profiler trace: a graph replay runs no Python, so no counter sees it
KERNEL_PATTERNS = dict({"flash_attention_fwd": FWD_KERNEL}, **BWD_KERNEL,
                       **CONV_KERNEL, **BN_KERNEL,
                       multi_tensor_update=UPDATE_KERNEL)
# the graphed backward's gradients against the eager ones, relative
# Frobenius: bf16 rounding of the same kernels in another order (the fused
# flash backward adds dq with atomics); where the routes are deterministic
# the script also reports whether they are equal to the bit
TOL_GRAPH_GRAD_REL = 2e-2


def pattern_counts(prof, names):
    """Launches of each kernel of ``names`` in a profiler run."""
    per = kernel_counts(prof)
    return {n: sum(c for k, c in per.items()
                   if re.search(KERNEL_PATTERNS[n], k)) for n in names}


def pattern_counts_most(profs, names):
    """Launches of each kernel of ``names``: the most any of the profiler
    runs ``profs`` saw. A torch.profiler session can drop kernel records,
    never add them (one eager ResNet-50 step once read 25 of the 28 conv
    fwd launches its counter asserted), so a step whose kernels are
    compared is profiled twice."""
    runs = [pattern_counts(p, names) for p in profs]
    return {n: max(r[n] for r in runs) for n in names}


def step_kernel_counts(torch, step, want, label, sessions=4):
    """Launches of each kernel of ``want`` in one ``step()`` by
    torch.profiler, held to ``want``: what the launch counters say an eager
    step launches. A replayed CUDA graph moves no counter, so the profiler is
    its only witness. A session can drop kernel records, never add one: in a
    process that ran earlier sessions it loses its first few launches
    (phase 8's audit), which the session's :func:`primer` takes, and now and
    then one more (PERF.md §7). So the step is profiled in up to
    ``sessions`` primed sessions, each kernel's count the most any of them
    saw, until the counts reach ``want``; fails if they pass it or never
    reach it. Returns the counts and the sessions taken."""
    from torch.profiler import ProfilerActivity, profile
    got = {n: 0 for n in want}
    for k in range(1, sessions + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            primer()
            torch.cuda.synchronize()
            step()
            torch.cuda.synchronize()
        seen = pattern_counts(prof, list(want))
        got = {n: max(got[n], seen[n]) for n in want}
        if got == want or any(got[n] > want[n] for n in want):
            break
    if got != want:
        fail(f"{label}: kernels by the profiler {got} (the most of {k} "
             f"primed sessions), the launch counters' eager step {want}")
    return got, k


def profiled_step(torch, step):
    """One ``step()`` under torch.profiler: (wall ms to a synchronize,
    the profile)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return wall_ms, prof


def step_parts(torch, autograd, forward_loss, trainer, batch_size, n=3):
    """Mean host ms of forward+loss, backward and trainer.step over ``n``
    steps, each part ended by a synchronize, and the update kernel's
    launches a step."""
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    split = {"forward+loss": 0.0, "backward": 0.0, "trainer.step": 0.0}
    before = mt.launches["multi_tensor_update"]
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = forward_loss()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        autograd.backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(batch_size)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k] += dt * 1e3 / n
    launched = (mt.launches["multi_tensor_update"] - before) / n
    return split, launched


def fmt_parts(split) -> str:
    return ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())


def graph_vs_eager(torch, autograd, net, args, loss_of, label, add=4):
    """A replayed call of the hybridized ``net`` against an eager one
    (``Block.__call__``) on the same weights, from the same generator
    state and BatchNorm statistics: the outputs, the statistics after the
    call and the generator's state after it must be equal to the bit, the
    gradients within TOL_GRAPH_GRAD_REL (whether they are equal to the
    bit is reported); two replays must draw different dropout (when the
    net has dropout); ``grad_req='add'`` on ``add`` parameters must
    accumulate over two calls as it does eagerly. Returns whether the
    gradients were equal to the bit."""
    import importlib
    from mxnet_tpu_torch.gluon.block import Block
    gen = importlib.import_module("mxnet_tpu_torch.random").generator(
        args[0].device)
    items = list(net.collect_params().items())
    stats = [p.data() for _, p in items if p.grad_req == "null"]
    seen, params = set(), []
    for k, p in items:
        if p.grad_req != "null" and id(p) not in seen:
            seen.add(id(p))
            params.append((k, p))
    g0, s0 = gen.get_state(), [t.clone() for t in stats]
    calls = (("graph", net), ("eager", lambda *a: Block.__call__(net, *a)))

    def flat(out):
        return [o.detach().clone() for o in
                (out if isinstance(out, (tuple, list)) else [out])]

    def restore():
        gen.set_state(g0)
        for t, s in zip(stats, s0):
            t.copy_(s)

    res = {}
    for mode, call in calls:
        restore()
        with autograd.record():
            out = call(*args)
            loss = loss_of(out)
        autograd.backward(loss)
        res[mode] = (flat(out), [t.clone() for t in stats], gen.get_state(),
                     [p.grad().detach().clone() for _, p in params])
    (og, sg, gg, dg), (oe, se, ge, de) = res["graph"], res["eager"]
    if not all(bits_equal(a, b) for a, b in zip(og, oe)):
        fail(f"{label}: a replayed call's outputs differ from the eager "
             "call's on the same weights and generator state")
    if not all(bits_equal(a, b) for a, b in zip(sg, se)):
        fail(f"{label}: the BatchNorm statistics after a replayed call differ "
             "from the eager call's")
    if not torch.equal(gg, ge):
        fail(f"{label}: a replay left the generator elsewhere than the eager "
             "call")
    rels = [(rel(a, b), k) for (k, _), a, b in zip(params, dg, de)]
    worst = max(rels)
    if worst[0] > TOL_GRAPH_GRAD_REL:
        fail(f"{label}: the graphed backward's gradient of {worst[1]} is off "
             f"the eager one by {worst[0]:.3e} > {TOL_GRAPH_GRAD_REL}")
    grad_bits = all(bits_equal(a, b) for a, b in zip(dg, de))
    # two replays in a row draw new numbers
    restore()
    with autograd.record():
        a = flat(net(*args))
        b = flat(net(*args))
    redraw = not all(bits_equal(x, y) for x, y in zip(a, b))
    # grad_req='add' over two calls
    some = [p for _, p in params[:add]]
    acc = {}
    for mode, call in calls:
        restore()
        for p in some:
            p.grad_req = "add"
            p.data().grad = None
        for _ in range(2):
            with autograd.record():
                loss = loss_of(call(*args))
            autograd.backward(loss)
        acc[mode] = [p.grad().detach().clone() for p in some]
        for p in some:
            p.grad_req = "write"
    add_rel = max(rel(a, b) for a, b in zip(acc["graph"], acc["eager"]))
    one = [x for x in res["graph"][3][:add]]
    grew = min(rel(a, b) for a, b in zip(acc["graph"], one))
    if add_rel > TOL_GRAPH_GRAD_REL or grew < 1e-3:
        fail(f"{label}: grad_req='add' over two graphed calls is off the "
             f"eager accumulation by {add_rel:.3e}, or did not accumulate "
             f"(relative change from one call {grew:.3e})")
    restore()
    print(f"{label}: a replayed call vs an eager one from the same generator "
          f"state and statistics: outputs, statistics and the generator's "
          f"state after equal to the bit; gradients worst relative "
          f"Frobenius {worst[0]:.3e} ({worst[1]}; limit "
          f"{TOL_GRAPH_GRAD_REL}), {'equal' if grad_bits else 'not equal'} "
          f"to the bit; two replays in a row draw "
          f"{'different' if redraw else 'the same'} numbers; grad_req='add' "
          f"over two calls within {add_rel:.3e} of eager", flush=True)
    return grad_bits, redraw


def embedding_backward_times(torch, tok, typ):
    """BERT-base's embeddings' forward and backward on the card as the port
    runs them (``ops/nn.py:_Embedding``, which a graph can capture: the
    30522-row word table by ``index_put_`` into one f32 accumulator, the
    2-row token-type table by PyTorch's one-pass kernel a chunk of 3072
    indices) against PyTorch's own (``F.embedding``, whose backward above
    3072 indices reads a count back to the host), at the main path's
    tokens, and the word table at four times the batch; beside them the
    route each table does not take. Device time of each, and whether the
    port's gradients equal PyTorch's to the bit."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.nn import _EMBED_BWD_CHUNK, _Embedding
    gen = torch.Generator(device=tok.device).manual_seed(3)
    cases = (("word", tok, 30522), ("word", tok.repeat(4, 1), 30522),
             ("token type", typ, 2))
    for name, idx, rows in cases:
        idx = idx.long()
        w = (torch.randn(rows, 768, device=tok.device, generator=gen) * 0.02
             ).to(torch.bfloat16).requires_grad_()
        dout = torch.randn(*idx.shape, 768, device=tok.device,
                           generator=gen).to(torch.bfloat16)
        flat, g = idx.reshape(-1), dout.reshape(-1, 768)

        def port():
            return torch.autograd.grad(_Embedding.apply(idx, w), w, dout)[0]

        def library():
            return torch.autograd.grad(F.embedding(idx, w), w, dout)[0]

        def accumulate():
            return torch.zeros(rows, 768, device=w.device).index_put_(
                (flat,), g.float(), accumulate=True).to(w.dtype)

        def chunks():
            total = torch.zeros(rows, 768, device=w.device)
            for k in range(0, flat.numel(), _EMBED_BWD_CHUNK):
                total.add_(torch.ops.aten.embedding_dense_backward(
                    g[k:k + _EMBED_BWD_CHUNK].float(),
                    flat[k:k + _EMBED_BWD_CHUNK], rows, -1, False))
            return total.to(w.dtype)

        got, want = port(), library()
        r = rel(got, want)
        if not bool(got.isfinite().all()) or r > 1e-2:
            fail(f"the {name} embedding's backward at {tuple(idx.shape)} is "
                 f"off PyTorch's by {r:.3e} (limit 1e-2)")
        print(f"phase 5: {name} embedding ({rows}x768 bf16), tokens "
              f"{tuple(idx.shape)}, device time: forward+backward, the "
              f"port's {fmt_ms(device_ms(port, iters=5))}, PyTorch's "
              f"{fmt_ms(device_ms(library, iters=5))}; the backward's sum "
              f"alone by index_put_ {fmt_ms(device_ms(accumulate, iters=5))}"
              f", by chunks {fmt_ms(device_ms(chunks, iters=5))}; the "
              f"port's gradient "
              f"{'equal' if bits_equal(got, want) else 'not equal'} to "
              f"PyTorch's bits (relative Frobenius {r:.3e}); card: "
              f"{smi_line()}", flush=True)


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
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt

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
    reset_counts(attn)
    reset_counts(mt)                        # the main path starts here
    for route, n_steps in plan:
        if route == "two-pass":
            # the two-pass dq/dkv kernels: key blocks of 256 < T
            os.environ["MXNET_FLASH_BLOCK_K"] = "256"
        want = {"flash_attention_fwd": 12,
                "multi_tensor_update": UPDATE_STEP["bert"]}
        want.update({"flash_attention_bwd_fused": 12} if route == "fused"
                    else {"flash_attention_bwd_dq": 12,
                          "flash_attention_bwd_dkv": 12})
        losses[route], times[route] = [], []
        for step in range(n_steps):
            before = dict(attn.launches, **mt.launches)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = train_step(torch, autograd, net, loss_fn, trainer, batch)
            torch.cuda.synchronize()
            times[route].append(time.perf_counter() - t)
            moved = {n: c[n] - before[n] for c in (attn.launches, mt.launches)
                     for n in c}
            if moved != {n: want.get(n, 0) for n in moved}:
                fail(f"{route} step {step}: kernel launches {moved}, "
                     f"expected {want}")
            lval = loss.float().mean().item()
            if not math.isfinite(lval) or tuple(loss.shape) != (B,):
                fail(f"{route} step {step}: loss {lval} of shape "
                     f"{tuple(loss.shape)}")
            losses[route].append(lval)
    os.environ.pop("MXNET_FLASH_BLOCK_K", None)
    counts = dict(attn.launches, **mt.launches)     # ... and ends here
    if attn.padded_copies:
        fail(f"training copied {attn.padded_copies} attention operands that "
             "TMA could not address; expected none")
    first, last = losses["fused"][0], losses["fused"][-1]
    if not last < first:
        fail(f"the loss did not fall over 10 steps: {losses['fused']}")
    fused_ms = 1e3 * sum(times["fused"][2:]) / len(times["fused"][2:])
    two_ms = 1e3 * sum(times["two-pass"]) / len(times["two-pass"])
    print(f"phase 5: losses (fused) {[round(x, 4) for x in losses['fused']]}"
          f", (two-pass) {[round(x, 4) for x in losses['two-pass']]}",
          flush=True)
    print(f"phase 5: launches in the training run {counts}, 0 padded "
          "copies", flush=True)
    print(f"phase 5: step {fused_ms:.3f} ms (mean of steps 3-10, host "
          f"clock to synchronize), {B * T / fused_ms * 1e3:.0f} tokens/s "
          f"({valid_tokens / fused_ms * 1e3:.0f} valid tokens/s); two-pass "
          f"route {two_ms:.3f} ms (mean of 2); card: {smi_line()}",
          flush=True)

    # where the time goes in one step of each route (counters restored
    # after)
    saved = dict(attn.launches)
    for route in ("fused", "two-pass"):
        if route == "two-pass":
            os.environ["MXNET_FLASH_BLOCK_K"] = "256"
        train_step(torch, autograd, net, loss_fn, trainer, batch)
        wall_ms, prof = profiled_step(torch, lambda: train_step(
            torch, autograd, net, loss_fn, trainer, batch))
        os.environ.pop("MXNET_FLASH_BLOCK_K", None)
        busy, _ = device_breakdown(prof, wall_ms,
                                   f"phase 5: profiled {route} step")
        if busy:
            bwd = sum(v for k, v in kernel_times(prof).items()
                      if re.search(ATTN_GROUPS["flash backward"], k))
            old = (f" [with the mma.sync backward: {MMA_SYNC_STEP_MS[0]} ms "
                   f"busy, {MMA_SYNC_STEP_MS[1]} ms backward]"
                   if route == "fused" else "")
            print(f"phase 5: {route} route: device busy {busy:.3f} ms a "
                  f"step, of it the flash backward kernels {bwd:.3f} ms "
                  f"({bwd / busy:.3f}){old}", flush=True)
    # the step's three parts by host clock, each ended by a synchronize:
    # each parameter updated alone (aggregation 1) against groups of 4
    tok, typ, vl, pos, lab = batch

    def forward_loss():
        return loss_fn(net(tok, typ, vl, pos)[-1], lab)

    for agg in (1, 4):
        trainer.optimizer.aggregate_num = agg
        split, launched = step_parts(torch, autograd, forward_loss, trainer,
                                     B)
        print(f"phase 5: step parts, aggregation {agg} (mean of 3, host "
              f"clock): {fmt_parts(split)}; {launched:.0f} update launches "
              "a step", flush=True)
    with autograd.record():
        loss = forward_loss()
    tw = time.perf_counter()
    autograd._leaves([loss])
    print(f"phase 5: the backward's grad_req graph walk alone "
          f"{(time.perf_counter() - tw) * 1e3:.3f} ms", flush=True)
    attn.launches.update(saved)
    embedding_backward_times(torch, tok, typ)
    hybrid_train(torch, dev, net, params, loss_fn, batch, losses["fused"])
    del net, trainer
    torch.cuda.empty_cache()
    train_parity(torch, dev, params, cfg)
    return counts, fused_ms


def hybrid_train(torch, dev, net, params, loss_fn, batch, eager_losses):
    """Phase 5, hybridized: the net's forward and backward as CUDA graphs,
    from the eager run's weights and generator state; step time, device
    busy and idle share, every kernel's launches a step from the profiler
    against the launch counters' eager step, the step parts; then a
    replayed call against an eager one on the fused route and on the
    two-pass pair."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    load_jax_params(net, params, dtype="bfloat16")
    trainer = Trainer(net.collect_params(), "adamw",
                      {"learning_rate": 1e-4, "multi_precision": True})
    mx_random.seed(0)
    net.hybridize()
    B, T = batch[0].shape
    losses, times = [], []
    for step in range(10):       # 1: the warm-up; 2: the capture; replays
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = train_step(torch, autograd, net, loss_fn, trainer, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.float().mean().item())
    graphs = sum(1 for g in net._cached_graph.values() if g is not True)
    if graphs != 1 or not losses[-1] < losses[0] or not all(
            math.isfinite(v) for v in losses):
        fail(f"hybridized training: {graphs} graphs captured, losses "
             f"{losses}")
    if losses[0] != eager_losses[0]:
        fail(f"hybridized training: the first (eager) step's loss "
             f"{losses[0]} differs from the eager run's {eager_losses[0]}")
    ms = 1e3 * sum(times[2:]) / len(times[2:])
    print(f"phase 5: hybridized losses {[round(x, 4) for x in losses]} "
          f"(eager run's largest difference "
          f"{max(abs(a - b) for a, b in zip(losses, eager_losses)):.4f}); "
          f"step {ms:.3f} ms (mean of steps 3-10, host clock to "
          f"synchronize), {B * T / ms * 1e3:.0f} tokens/s; card: "
          f"{smi_line()}", flush=True)
    wall_ms, prof = profiled_step(torch, lambda: train_step(
        torch, autograd, net, loss_fn, trainer, batch))
    device_breakdown(prof, wall_ms, "phase 5: profiled hybridized step")
    got, sessions = step_kernel_counts(
        torch, lambda: train_step(torch, autograd, net, loss_fn, trainer,
                                  batch),
        {"flash_attention_fwd": 12, "flash_attention_bwd_fused": 12,
         "multi_tensor_update": UPDATE_STEP["bert"]},
        "phase 5: a replayed step")
    print(f"phase 5: launches in a replayed step by the profiler {got} "
          f"({sessions} primed sessions), as the launch counters' eager step",
          flush=True)
    tok, typ, vl, pos, lab = batch
    split, launched = step_parts(
        torch, autograd, lambda: loss_fn(net(tok, typ, vl, pos)[-1], lab),
        trainer, B)
    print(f"phase 5: step parts hybridized, aggregation 4 (mean of 3, host "
          f"clock): {fmt_parts(split)}; {launched:.0f} update launches a "
          "step", flush=True)
    args = (tok, typ, vl, pos)
    _, redraw = graph_vs_eager(torch, autograd, net, args,
                               lambda out: loss_fn(out[-1], lab),
                               "phase 5: fused route")
    if not redraw:
        fail("phase 5: two replays in a row drew the same dropout")
    os.environ["MXNET_FLASH_BLOCK_K"] = "256"
    for _ in range(2):            # the pair's signature: warm-up, capture
        train_step(torch, autograd, net, loss_fn, trainer, batch)
    graph_vs_eager(torch, autograd, net, args,
                   lambda out: loss_fn(out[-1], lab),
                   "phase 5: two-pass pair")
    os.environ.pop("MXNET_FLASH_BLOCK_K", None)
    net.hybridize(False)


# the f32 BERT step's backward routes on the card (phase 5): the fused
# pass, and the dq/dkv pair with MXNET_FLASH_BLOCK_K below T = 128
F32_ROUTES = (("the fused pass", ("flash_attention_bwd_fused",), None),
              ("the dq/dkv pair", ("flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkv"), "64"))


def train_parity(torch, dev, params, cfg):
    """One f32 step, dropout 0, B=2, T=128: the card (kernels, under
    :func:`f32_audit`) on each of ``F32_ROUTES`` against the CPU (plain
    path), loss and every parameter's gradient."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
    from mxnet_tpu_torch.ops.cuda import attention as attn

    batch = mlm_batch(torch, 2, 128, 19, seed=2, lo=32)

    def step_on(where, names):
        net = load_jax_params(
            get_bert("bert_12_768_12", device=where, dropout=0.0, **cfg),
            params)
        trainer = Trainer(net.collect_params(), "adamw",
                          {"learning_rate": 1e-4})
        before = dict(attn.launches)
        xs = [x.to(where) for x in batch]

        def run():
            return train_step(torch, autograd, net,
                              SoftmaxCrossEntropyLoss(), trainer, xs)
        loss = run() if where == "cpu" else f32_audit(
            torch, "phase 5", run, names)
        moved = {n: attn.launches[n] - before[n] for n in ATTN_KERNELS}
        want = {n: 12 * (n in names) for n in ATTN_KERNELS}
        want["flash_attention_fwd"] = 12 * (where != "cpu")
        if moved != want:
            fail(f"parity step on {where}: attention launches {moved}, "
                 f"expected {want}")
        return (loss.detach().cpu(),
                {k: p.grad().detach().cpu() for k, p in
                 net.collect_params().items()},
                {k: p.data().detach().cpu() for k, p in
                 net.collect_params().items()})

    lc, gc, wc = step_on("cpu", ())
    for route, names, block_k in F32_ROUTES:
        if block_k:
            os.environ["MXNET_FLASH_BLOCK_K"] = block_k
        try:
            lg, gg, wg = step_on(dev, names)
        finally:
            os.environ.pop("MXNET_FLASH_BLOCK_K", None)
        loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
        if loss_rel > TOL_TRAIN_LOSS_REL:
            fail(f"f32 step ({route}): loss on the card {lg.tolist()} vs "
                 f"the CPU {lc.tolist()}: relative {loss_rel:.3e} > "
                 f"{TOL_TRAIN_LOSS_REL}")
        grad_rel = max((rel(gg[k], gc[k]), k) for k in gc)
        if grad_rel[0] > TOL_TRAIN_GRAD_REL:
            fail(f"f32 step ({route}): gradient of {grad_rel[1]} off the "
                 f"CPU's by {grad_rel[0]:.3e} > {TOL_TRAIN_GRAD_REL}")
        w_rel = max(rel(wg[k], wc[k]) for k in wc)
        print(f"phase 5: f32 step B=2 T=128 card ({route}) vs CPU: loss "
              f"relative {loss_rel:.3e} (limit {TOL_TRAIN_LOSS_REL}), worst "
              f"gradient relative Frobenius {grad_rel[0]:.3e} "
              f"({grad_rel[1]}; limit {TOL_TRAIN_GRAD_REL}), weights after "
              f"the step {w_rel:.3e}", flush=True)


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
                 label, first=None):
    """``n`` training steps; every step must launch each kernel of
    ``want`` (of ``first`` in the first step, when given) as often as it
    says, and nothing else. Returns (losses, seconds per step)."""
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import batch_norm as bn
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    counters = [attn.launches, cf.launches, bn.launches, mt.launches]
    losses, times = [], []
    wants = want
    for step in range(n):
        want = first if step == 0 and first is not None else wants
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
    from mxnet_tpu_torch.ops.cuda import batch_norm as bn
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt

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
    n_params = sum(p.data().numel() for p in net.collect_params().values()
                   if p.grad_req != "null")
    print(f"phase 6: ResNet-50 v1 bf16 on {dev} built in "
          f"{time.perf_counter() - t0:.1f} s ({n_params} trained "
          f"parameters); B={B}, {IMG_RESNET}x{IMG_RESNET}; SGD lr 0.1 momentum 0.9, "
          "multi_precision (f32 masters)", flush=True)

    def trainer():
        return Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9,
                        "multi_precision": True})

    def virgin(want):       # the first step: centered statistics
        return dict(want, bn_stats=2 * want["bn_stats"])

    update = {"multi_tensor_update": UPDATE_STEP["resnet"]}
    fused_want = dict({k: 28 for k in CONV_KERNELS}, **BN_STEP["1"],
                      **update)
    unfused_want = dict(BN_STEP["0"], **update)
    os.environ["MXNET_FUSE_BN_CONV"] = "1"
    tr = trainer()
    reset_counts(attn)
    reset_counts(bn)
    reset_counts(mt)
    reset_counts(cf)                    # the main path starts here
    losses, times = resnet_steps(torch, autograd, net, loss_fn, tr, x, y, 10,
                                 fused_want, "fused", virgin(fused_want))
    counts = {k: cf.launches[k] for k in CONV_KERNELS}   # ... and ends here
    counts.update({k: bn.launches[k] for k in BN_KERNELS})
    counts.update({k: mt.launches[k] for k in UPDATE_KERNELS})
    if any(attn.launches[k] for k in ATTN_KERNELS):
        fail(f"ResNet-50 launched attention kernels: {attn.launches}")
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall over 10 steps: {losses}")
    fused_ms = 1e3 * sum(times[2:]) / len(times[2:])
    print(f"phase 6: losses (fused) {[round(v, 4) for v in losses]}",
          flush=True)
    print(f"phase 6: launches in the training run {counts} (conv: 28 per "
          "step each, 16 triples + 12 deferred junctions; batch norm per "
          f"step {BN_STEP['1']}: the 16 fused junctions take only the "
          "statistics and their backward, and the first step's centered "
          "statistics two bn_stats sweeps a layer)", flush=True)
    print(f"phase 6: fused step {fused_ms:.3f} ms (mean of steps 3-10, "
          f"host clock to synchronize), {B / fused_ms * 1e3:.1f} img/s; "
          f"card: {smi_line()}", flush=True)

    # where the time goes in one fused step (counters restored after)
    saved = dict(cf.launches), dict(bn.launches)
    torch.cuda.reset_peak_memory_stats()
    wall_ms, prof = profiled_step(torch, lambda: resnet_step(
        autograd, net, loss_fn, tr, x, y))
    fused_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fused_busy, _ = device_breakdown(prof, wall_ms,
                                     "phase 6: profiled fused step",
                                     RESNET_GROUPS)
    profs = {"1": (prof, profiled_step(torch, lambda: resnet_step(
        autograd, net, loss_fn, tr, x, y))[1])}
    # the step's parts: each parameter updated alone against groups of 4
    for agg in (1, 4):
        tr.optimizer.aggregate_num = agg
        split, launched = step_parts(torch, autograd,
                                     lambda: loss_fn(net(x), y), tr, B)
        print(f"phase 6: fused step parts, aggregation {agg} (mean of 3, "
              f"host clock): {fmt_parts(split)}; {launched:.0f} update "
              "launches a step", flush=True)
    cf.launches.update(saved[0])
    bn.launches.update(saved[1])

    # the same 10 steps from the same weights on the cuDNN-only chain
    os.environ["MXNET_FUSE_BN_CONV"] = "0"
    load_jax_params(net, params)
    tr = trainer()
    u_losses, u_times = resnet_steps(torch, autograd, net, loss_fn, tr, x, y,
                                     10, unfused_want, "unfused",
                                     virgin(unfused_want))
    unfused_ms = 1e3 * sum(u_times[2:]) / len(u_times[2:])
    drift = max(abs(a - b) for a, b in zip(losses, u_losses))
    print(f"phase 6: losses (unfused) {[round(v, 4) for v in u_losses]}; "
          f"largest difference from the fused run's {drift:.4f}", flush=True)
    print(f"phase 6: unfused step {unfused_ms:.3f} ms, "
          f"{B / unfused_ms * 1e3:.1f} img/s; fused / unfused step time "
          f"{fused_ms / unfused_ms:.3f}; card: {smi_line()}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    wall_ms, prof = profiled_step(torch, lambda: resnet_step(
        autograd, net, loss_fn, tr, x, y))
    unfused_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    unfused_busy, _ = device_breakdown(prof, wall_ms,
                                       "phase 6: profiled unfused step",
                                       RESNET_GROUPS)
    profs["0"] = (prof, profiled_step(torch, lambda: resnet_step(
        autograd, net, loss_fn, tr, x, y))[1])
    if fused_busy and unfused_busy:
        print(f"phase 6: device busy fused / unfused {fused_busy:.3f} / "
              f"{unfused_busy:.3f} ms = {fused_busy / unfused_busy:.3f} "
              f"(with eager f32 BatchNorm: {EAGER_BN_RESNET_BUSY_MS[0]} / "
              f"{EAGER_BN_RESNET_BUSY_MS[1]} ms; before the conv fwd / dgrad "
              f"redesign: {OLD_CONV_RESNET_BUSY_MS[0]} / "
              f"{OLD_CONV_RESNET_BUSY_MS[1]} ms)",
              flush=True)
    print(f"phase 6: peak device memory in a profiled step "
          f"(torch.cuda.max_memory_allocated): fused {fused_peak:.3f} GiB, "
          f"unfused {unfused_peak:.3f} GiB", flush=True)

    # eval mode (running statistics): the kernels against the unfused chain
    outs = {}
    with torch.no_grad():
        for knob in ("1", "0"):
            os.environ["MXNET_FUSE_BN_CONV"] = knob
            before = dict(cf.launches, **bn.launches)
            outs[knob] = net(x).float()
            torch.cuda.synchronize()
            moved = {k: cf.launches[k] - before[k] for k in CONV_KERNELS}
            moved.update({k: bn.launches[k] - before[k] for k in BN_KERNELS})
            want = dict({k: 0 for k in BN_KERNELS},
                        conv1x1_fwd=28 if knob == "1" else 0,
                        conv1x1_dgrad=0, conv1x1_wgrad=0)
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
    del tr, outs
    hybrid_resnet(torch, net, params, loss_fn, x, y, trainer, profs,
                  {"1": losses, "0": u_losses})
    del net, x
    torch.cuda.empty_cache()
    resnet_parity(torch, dev)
    os.environ.pop("MXNET_FUSE_BN_CONV", None)
    return counts


def hybrid_resnet(torch, net, params, loss_fn, x, y, trainer, profs,
                  eager_losses):
    """Phase 6, hybridized: 10 steps with the fused junctions, then 10
    without, each from the eager runs' weights (the first, centered step
    eager, the second captured); step time, device busy and idle share,
    the conv and BatchNorm kernels' launches from the profiler against the
    eager step's, the step parts, and a replayed call against an eager
    one."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import load_jax_params
    B = x.shape[0]
    names = list(CONV_KERNELS + BN_KERNELS) + ["multi_tensor_update"]
    for knob in ("1", "0"):
        os.environ["MXNET_FUSE_BN_CONV"] = knob
        label = f"phase 6: hybridized {'fused' if knob == '1' else 'unfused'}"
        load_jax_params(net, params)
        tr = trainer()
        net.hybridize()
        losses, times = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = resnet_step(autograd, net, loss_fn, tr, x, y)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(loss.float().mean().item())
        if not losses[-1] < losses[0] or losses[0] != eager_losses[knob][0]:
            fail(f"{label}: losses {losses} (the eager run's first "
                 f"{eager_losses[knob][0]})")
        ms = 1e3 * sum(times[2:]) / len(times[2:])
        print(f"{label}: losses {[round(v, 4) for v in losses]} (eager run's "
              f"largest difference {max(abs(a - b) for a, b in zip(losses, eager_losses[knob])):.4f}); "
              f"step {ms:.3f} ms (mean of steps 3-10, host clock to "
              f"synchronize), {B / ms * 1e3:.1f} img/s; card: {smi_line()}",
              flush=True)
        wall_ms, prof = profiled_step(torch, lambda: resnet_step(
            autograd, net, loss_fn, tr, x, y))
        device_breakdown(prof, wall_ms, f"{label} profiled step",
                         RESNET_GROUPS)
        got = pattern_counts_most((prof, profiled_step(
            torch, lambda: resnet_step(autograd, net, loss_fn, tr, x,
                                       y))[1]), names)
        want = pattern_counts_most(profs[knob], names)
        if got != want:
            fail(f"{label}: kernel launches by the profiler {got}, the eager "
                 f"step's {want}")
        print(f"{label}: launches in a replayed step by the profiler {got}, "
              "as in the eager step", flush=True)
        split, launched = step_parts(torch, autograd,
                                     lambda: loss_fn(net(x), y), tr, B)
        print(f"{label} step parts, aggregation 4 (mean of 3, host clock): "
              f"{fmt_parts(split)}; {launched:.0f} update launches a step",
              flush=True)
        graph_vs_eager(torch, autograd, net, (x,),
                       lambda out: loss_fn(out, y), label)
        net.hybridize(False)
        del tr
        torch.cuda.empty_cache()


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
                {k: p.grad().detach().cpu().double() for k, p in
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


# ------------------------------------------------------------------ phase 8
# the generation phase's kernel of its own (the flash forward is row 1)
GEN_INFO = {"decode_attention": (
    "mxnet_tpu_torch/csrc/decode_attention.cu",
    "mxnet_tpu/serving/model.py:335 (_slot_block_step einsums, XLA)")}
# a call is one kernel (its chunks combined in the same launch)
DECODE_KERNEL = r"da::decode_(rows|wide)<"
KERNEL_PATTERNS["decode_attention"] = DECODE_KERNEL
# GPT-2 124M's bf16 forward on the card against the same weights in f32 on
# the CPU, relative Frobenius over the logits (12 layers of bf16 rounding)
TOL_GPT_FORWARD_REL = 5e-2
# an emitted greedy token's logit within this of its row's maximum in a
# teacher-forced bf16 full forward (logit units; the logits' spread here is
# ~1.4): the decode and the full forward round differently, so near-ties
# may flip
GREEDY_MARGIN = 0.25
GEN_SLOTS = 8
GPT_VOCAB = 50257


def random_gpt_params(block, seed: int):
    """numpy weights for every parameter of a GPT ``block``, from ``seed``,
    at a scale where greedy streams vary: matrices N(0, 1/fan_in) (each
    block's update of the order of the residual), the word embedding
    N(0, 0.05), the position table N(0, 1) (the position steers each
    step, so greedy decoding does not settle on one token: with
    N(0, 0.02) positions 4 streams of 120 tokens on the CPU ended in
    constant runs of 1-105 tokens, with N(0, 1) in runs of 1-3 tokens and
    77-79 distinct tokens each), biases N(0, 0.02), LayerNorm gamma
    1 + N(0, 0.02)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in block.collect_params().items():
        shape = tuple(p.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "word_embed.weight":
            out[name] = z * 0.05
        elif name == "position_weight":
            out[name] = z
        elif name.endswith(".weight") and len(shape) == 2:
            out[name] = z / np.float32(math.sqrt(shape[1]))
        elif name.endswith("gamma"):
            out[name] = 1.0 + 0.02 * z
        else:
            out[name] = 0.02 * z
    return out


def gpt_net(torch, dev, dtype, num_layers=12, params=None, seed=0):
    """A GPT-2 124M-wide model (``num_layers`` deep) on ``dev`` in
    ``dtype``, predict mode, with ``params`` (by default
    :func:`random_gpt_params` from ``seed``): (net, params)."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel
    net = GPTModel(vocab_size=GPT_VOCAB, num_layers=num_layers, units=768,
                   hidden_size=3072, num_heads=12, max_length=1024,
                   dropout=0.0)
    if params is None:
        params = random_gpt_params(net, seed)
    load_jax_params(net, params)
    return net.to(dev, getattr(torch, dtype)).eval(), params


def gen_requests(n=16, seed=7):
    """``n`` requests: prompts of 16-512 random tokens, 64-256 new tokens;
    every fourth sampled (sample, top_k, top_p, sample at another
    temperature), the rest greedy."""
    import numpy as np
    rng = np.random.RandomState(seed)
    sampled = [dict(method="sample", temperature=0.9, seed=101),
               dict(method="top_k", top_k=40, seed=102),
               dict(method="top_p", top_p=0.9, seed=103),
               dict(method="sample", temperature=1.3, seed=104)]
    out = []
    for i in range(n):
        kw = sampled[i // 4] if i % 4 == 3 else {}
        out.append(dict(tokens=rng.randint(0, GPT_VOCAB,
                                           rng.randint(16, 513)).tolist(),
                        max_new_tokens=int(rng.randint(64, 257)), kw=kw))
    return out


def gen_stats(ttft, wall, n_tokens):
    import numpy as np
    t = np.asarray(ttft) * 1e3
    return dict(ttft_p50=float(np.percentile(t, 50)),
                ttft_p99=float(np.percentile(t, 99)),
                tok_s=n_tokens / wall, wall_s=wall, tokens=n_tokens)


def fmt_gen(st) -> str:
    return (f"TTFT p50 {st['ttft_p50']:.3f} ms, p99 {st['ttft_p99']:.3f} ms, "
            f"{st['tokens']} tokens in {st['wall_s']:.3f} s = "
            f"{st['tok_s']:.1f} tokens/s")


def gen_inprocess(server, reqs):
    """Every request submitted at once to ``server`` (a started
    GenerationServer or a GenerationEngine's owner), each stream drained
    on a thread: (token lists, stats)."""
    n = len(reqs)
    toks, ttft, ends = [None] * n, [0.0] * n, [0.0] * n
    errors = []

    def drain(i, stream, t_sub):
        try:
            first = stream.next_token(timeout=300)
            ttft[i] = time.perf_counter() - t_sub
            out = [first]
            while True:
                t = stream.next_token(timeout=300)
                if t is None:
                    break
                out.append(t)
            toks[i] = out
            ends[i] = time.perf_counter()
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(f"request {i}: {e!r}")

    t0 = time.perf_counter()
    threads = []
    for i, r in enumerate(reqs):
        t_sub = time.perf_counter()
        s = server.generate(r["tokens"], max_new_tokens=r["max_new_tokens"],
                            **r["kw"])
        th = threading.Thread(target=drain, args=(i, s, t_sub), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join(600)
    if errors:
        fail("generation in process: " + "; ".join(errors))
    return toks, gen_stats(ttft, max(ends) - t0, sum(map(len, toks)))


def http_generate(port, body):
    """One streamed POST /v1/generate: (status, token lines, seconds to
    the first token line, seconds to the end)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        lines, t_first = [], None
        while True:
            raw = resp.readline()
            if not raw:
                break
            if not raw.strip():
                continue
            obj = json.loads(raw)
            if "token" in obj and t_first is None:
                t_first = time.perf_counter() - t0
            lines.append(obj)
        return resp.status, lines, t_first, time.perf_counter() - t0
    finally:
        conn.close()


def gen_http(port, reqs):
    """The requests over HTTP at once, streamed: (token lists, stats);
    fails on a status other than 200, a missing trailer or an index that
    is not contiguous."""
    n = len(reqs)
    res = [None] * n
    errors = []

    def one(i, r):
        try:
            body = dict(tokens=r["tokens"],
                        max_new_tokens=r["max_new_tokens"], stream=True,
                        **r["kw"])
            res[i] = http_generate(port, body)
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(f"request {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i, r), daemon=True)
               for i, r in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t0
    if errors:
        fail("generation over HTTP: " + "; ".join(errors))
    toks = []
    for i, (status, lines, t_first, _) in enumerate(res):
        tl = [ln for ln in lines if "token" in ln]
        if status != 200 or not lines or not lines[-1].get("done") \
                or lines[-1].get("error"):
            fail(f"HTTP request {i}: status {status}, last line "
                 f"{lines[-1] if lines else None}")
        if [ln["index"] for ln in tl] != list(range(len(tl))):
            fail(f"HTTP request {i}: index fields not contiguous")
        toks.append([ln["token"] for ln in tl])
    return toks, gen_stats([r[2] for r in res], wall, sum(map(len, toks)))


def compile_counts(model):
    """{label: mxnet_serving_bucket_compiles_total} of a DecodeModel's
    programs, and its graph captures."""
    from mxnet_tpu_torch import metrics
    labels = model.describe()["programs_compiled"]
    return ({t: metrics.value("mxnet_serving_bucket_compiles_total",
                              bucket=t) for t in labels}, model.captures)


LAUNCH_CALL = r"^cu(da)?LaunchKernel"   # the host's kernel-launch calls


def profile_audit(prof, op_pattern, kernel_pattern):
    """One torch.profiler session held against the launches the host made
    in it. Each kernel-launch call the profiler saw on the host is matched
    by correlation id to the record it saw on the device. Returns a dict:
    ``calls`` (launch calls) and ``records`` (device records), ``lost``
    (for each launch call without a record, the op that made it) and
    ``lost_at`` (the call's place among the session's calls), and,
    for the innermost op events whose name matches ``op_pattern``, in
    order, ``ops`` (how many), ``kernels`` (how many have a kernel
    matching ``kernel_pattern`` recorded) and ``unrecorded`` (the indexes
    of those without)."""
    def on_device(e):
        return str(e.device_type).endswith("CUDA")

    evts = list(prof.events())
    records = [e for e in evts if on_device(e)]
    recorded = {e.id for e in records}
    calls = sorted((e for e in evts
                    if not on_device(e) and re.search(LAUNCH_CALL, e.name)),
                   key=lambda e: e.time_range.start)
    lost_at = [i for i, c in enumerate(calls) if c.id not in recorded]
    lost = [getattr(calls[i].cpu_parent, "name", calls[i].name)
            for i in lost_at]
    ops = sorted((e for e in evts if not on_device(e)
                  and re.search(op_pattern, e.name)
                  and not any(re.search(op_pattern, c.name)
                              for c in e.cpu_children)),
                 key=lambda e: e.time_range.start)
    seen = [any(re.search(kernel_pattern, k.name) for k in e.kernels)
            for e in ops]
    return dict(calls=len(calls), records=len(records), lost=lost,
                lost_at=lost_at, ops=len(ops), kernels=sum(seen),
                unrecorded=[i for i, s in enumerate(seen) if not s])


def gpt_forward_check(torch, attn, net, cpu_net, sessions=3):
    """GPT-2 124M's full forward at B=1, T=1024 (bf16): twelve causal flash
    forward launches by the counter, no SDPA kernel, no operand copied;
    logits against the f32 plain path on the CPU. Each of ``sessions``
    profiled forwards gives the unprofiled forward's logits to the bit
    (so all of its kernels ran) and is audited (``profile_audit``): its
    twelve flash forward ops each have their kernel recorded, or a launch
    call whose record the session lost. A session in a process that ran
    earlier profiler sessions can lose the records of its first few
    launches, never one after a recorded launch, so the lost calls must be
    the session's first."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, GPT_VOCAB, (1, 1024), generator=gen)
    xd = x.to(net.word_embed.weight.data().device)
    keep = []
    with torch.inference_mode():
        net(xd)                                 # warm-up
        plain = net(xd)
        torch.cuda.synchronize()
        reset_counts(attn)
        runs = [profiled_step(torch, lambda: keep.append(net(xd)))
                for _ in range(sessions)]
    wall = min(w for w, _ in runs)
    audits = [profile_audit(prof, r"flash_attention_fwd", FWD_KERNEL)
              for _, prof in runs]
    sdpa = [k for _, prof in runs for k in kernel_counts(prof)
            if re.search(SDPA_KERNEL, k)]
    same = [torch.equal(out, plain) for out in keep]
    short = [a for a in audits if a["ops"] != 12 or a["kernels"]
             + sum("flash_attention_fwd" in n for n in a["lost"]) != 12
             or a["lost_at"] != list(range(len(a["lost_at"])))]
    if attn.launches["flash_attention_fwd"] != 12 * sessions \
            or not all(same) or short or sdpa or attn.padded_copies:
        fail(f"GPT-2 forward: {attn.launches['flash_attention_fwd']} "
             f"counted launches in {sessions} forwards "
             f"({12 * sessions} wanted), profiled logits equal to the "
             f"unprofiled bits {same}, audits {audits}, SDPA kernels "
             f"{sdpa}, padded copies {attn.padded_copies}")
    with torch.inference_mode():
        ref = cpu_net(x)
    err = rel(keep[-1].float().cpu(), ref)
    if not err <= TOL_GPT_FORWARD_REL:
        fail(f"GPT-2 forward B=1 T=1024 bf16: logits rel err {err:.3e} "
             f"against f32 on the CPU > {TOL_GPT_FORWARD_REL}")
    print(f"phase 8: GPT-2 124M forward B=1 T=1024 bf16: 12 causal flash "
          f"forward launches by the counter, no SDPA kernel, 0 operands "
          f"copied; logits rel err {err:.3e} vs f32 CPU (limit "
          f"{TOL_GPT_FORWARD_REL}); {wall:.3f} ms under the profiler",
          flush=True)
    for i, a in enumerate(audits):
        print(f"phase 8: GPT-2 forward profile {i + 1}/{sessions}: logits "
              f"equal to the unprofiled bits; {a['calls']} launch calls, "
              f"{a['records']} kernel records, {len(a['lost'])} records "
              f"lost (the session's first launches) "
              f"{sorted(set(a['lost']))}; flash forward ops "
              f"{a['ops']}, their kernels recorded {a['kernels']} "
              f"(missing at layers {a['unrecorded']})", flush=True)


def greedy_margins(torch, net, reqs, streams):
    """Each greedy stream held to a teacher-forced bf16 full forward: every
    emitted token's logit within GREEDY_MARGIN of its row's maximum; no
    greedy stream constant. Returns the worst gap."""
    worst = 0.0
    dev = net.word_embed.weight.data().device
    for i, (r, toks) in enumerate(zip(reqs, streams)):
        if r["kw"]:
            continue
        if len(set(toks)) == 1:
            fail(f"greedy stream {i} is constant ({toks[0]})")
        t0 = len(r["tokens"])
        seq = torch.tensor([r["tokens"] + toks[:-1]], device=dev)
        with torch.inference_mode():
            lg = net(seq)[0, t0 - 1:].float()
        tok = torch.tensor(toks, device=dev)
        gap = (lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]).max()
        worst = max(worst, float(gap))
    if worst > GREEDY_MARGIN:
        fail(f"a greedy token's logit is {worst:.4f} below its row's "
             f"maximum in the teacher-forced forward (> {GREEDY_MARGIN})")
    return worst


def decode_step_bits(torch, dm, dev):
    """The decode step at S=8, L=128 and 1024, greedy and mixed lanes, run
    eagerly and replayed from the same cache state: tokens and KV rows
    equal to the bit; host ms a step each way (a step ends in its (S,)
    readback)."""
    import numpy as np
    from mxnet_tpu_torch.serving import PagedKVCache
    from mxnet_tpu_torch.serving.model import warm_lanes
    rng = np.random.RandomState(11)
    out = {}
    for L in (128, 1024):
        cache = PagedKVCache(dm.n_layers, dm.num_heads, dm.head_dim,
                             GEN_SLOTS, buckets=(L,), dtype=dm.dtype,
                             device=dev)
        for _ in range(GEN_SLOTS):
            t0 = int(rng.randint(L // 2, L - 8))
            _, ks, vs = dm.prefill(rng.randint(0, GPT_VOCAB, t0), L)
            cache.write_prompt(cache.alloc(), ks, vs, t0)
        toks = rng.randint(0, GPT_VOCAB, GEN_SLOTS)
        pos = cache.positions.copy()
        for name, lanes in zip(("greedy", "mixed"), warm_lanes(dm,
                                                               GEN_SLOTS)):
            snap = [t.clone() for t in cache._k + cache._v]
            eager = dm.step(cache, toks, pos, lanes, graph=False)
            after = [t.clone() for t in cache._k + cache._v]
            for t, s in zip(cache._k + cache._v, snap):
                t.copy_(s)
            graphed = dm.step(cache, toks, pos, lanes)
            if not np.array_equal(eager, graphed) or not all(
                    torch.equal(a, b)
                    for a, b in zip(after, cache._k + cache._v)):
                fail(f"decode step S={GEN_SLOTS} L={L} {name}: the replay's "
                     "tokens or KV rows differ from the eager step's bits")
            times = {}
            for route, graph in (("eager", False), ("replay", True)):
                dm.step(cache, toks, pos, lanes, graph=graph)
                t = time.perf_counter()
                for _ in range(20):
                    dm.step(cache, toks, pos, lanes, graph=graph)
                times[route] = (time.perf_counter() - t) / 20 * 1e3
            out[(L, name)] = times
            print(f"phase 8: decode step S={GEN_SLOTS} L={L} {name}: replay "
                  f"equal to eager to the bit (tokens and KV rows); eager "
                  f"{times['eager']:.4f} ms, replayed {times['replay']:.4f} "
                  f"ms a step (host clock, readback included)", flush=True)
        del cache
    return out


def gen_speculation(torch, dm, draft_net, reqs, want):
    """The requests through speculative engines (self k=4; a 2-layer draft
    k=4): every stream byte-identical to the plain run's."""
    from mxnet_tpu_torch import metrics
    from mxnet_tpu_torch.serving import GenerationEngine, GenerationServer
    names = ("mxnet_gen_spec_proposed_tokens_total",
             "mxnet_gen_spec_accepted_tokens_total",
             "mxnet_gen_kv_rollbacks_total")
    for mode, kw in (("self", {}), ("draft", dict(draft_model=draft_net))):
        eng = GenerationEngine(dm, max_slots=GEN_SLOTS, spec_mode=mode,
                               spec_k=4, **kw)
        c0 = [metrics.value(n) for n in names]
        server = GenerationServer(eng, warmup=True).start()
        try:
            got, st = gen_inprocess(server, reqs)
        finally:
            server.stop()
        prop, acc, rb = (metrics.value(n) - c for n, c in zip(names, c0))
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"speculative ({mode}) streams differ from the plain run "
                 f"at requests {bad}")
        print(f"phase 8: speculation {mode} k=4: {len(reqs)} streams "
              f"byte-identical to the plain run (greedy and sampled); "
              f"accept rate "
              f"{acc / max(prop, 1):.4f} ({int(acc)} of {int(prop)} "
              f"proposals), mxnet_gen_kv_rollbacks_total +{int(rb)}; "
              f"{fmt_gen(st)}", flush=True)
        del server, eng
        torch.cuda.empty_cache()


def gen_prefix(torch, dm):
    """A shared 256-token prefix ahead of 8 suffixes (6 greedy, 2
    sampled) with the prefix cache on and off: equal streams, 7 hits."""
    import numpy as np
    from mxnet_tpu_torch import metrics
    from mxnet_tpu_torch.serving import GenerationEngine
    rng = np.random.RandomState(21)
    prefix = rng.randint(0, GPT_VOCAB, 256).tolist()
    prompts = [prefix + rng.randint(0, GPT_VOCAB, int(n)).tolist()
               for n in rng.randint(8, 120, 8)]
    kws = [{}] * 6 + [dict(method="top_k", top_k=20, seed=5),
                      dict(method="top_p", top_p=0.8, seed=6)]
    out = {}
    for slots in (8, 0):
        eng = GenerationEngine(dm, max_slots=GEN_SLOTS, prefix_slots=slots)
        eng.warmup()
        h0 = metrics.value("mxnet_gen_prefix_cache_hits_total")
        first = eng.submit(prompts[0], max_new_tokens=32, **kws[0])
        while not first.finished:
            eng.run_iteration()
        rest = [eng.submit(p, max_new_tokens=32, **kw)
                for p, kw in zip(prompts[1:], kws[1:])]
        while not all(s.finished for s in rest):
            eng.run_iteration()
        out[slots] = ([s.result(timeout=60) for s in [first] + rest],
                      metrics.value("mxnet_gen_prefix_cache_hits_total")
                      - h0)
        del eng
    if out[8][0] != out[0][0] or out[8][1] != 7 or out[0][1] != 0:
        fail(f"prefix cache: streams equal {out[8][0] == out[0][0]}, hits "
             f"{out[8][1]} (7 wanted) on, {out[0][1]} off")
    print("phase 8: shared 256-token prefix, 8 suffixes (f32): 7 prefix "
          "hits (the suffix pass on the flash forward under its bias), "
          "streams equal to the prefix cache off", flush=True)


def gen_f32_vs_cpu(torch, dm, cpu_net):
    """Three greedy prompts through an f32 engine on the card (TF32 off)
    against the f32 plain path on the CPU (the zoo's eager ``generate``):
    token for token."""
    import numpy as np
    from mxnet_tpu_torch.serving import GenerationEngine
    rng = np.random.RandomState(41)
    prompts = [rng.randint(0, GPT_VOCAB, n).tolist() for n in (20, 100, 300)]
    eng = GenerationEngine(dm, max_slots=4, prefix_slots=0)
    streams = [eng.submit(p, max_new_tokens=24) for p in prompts]
    while not all(s.finished for s in streams):
        eng.run_iteration()
    got = [s.result(timeout=60) for s in streams]
    want = [cpu_net.generate(np.asarray([p]), 24)[0].tolist()
            for p in prompts]
    if got != want:
        fail(f"f32 greedy streams on the card differ from the CPU's: "
             f"{[a == b for a, b in zip(got, want)]}")
    print("phase 8: 3 greedy prompts (lengths 20, 100, 300; 24 tokens) on "
          "an f32 engine on the card (TF32 off) equal token for token to "
          "the f32 plain path on the CPU", flush=True)


def gen_recovery(torch, dm):
    """Two replicas over HTTP (f32), 8 streamed requests, once clean and
    once with a ``serving.worker`` fault mid-stream: the same tokens,
    contiguous indexes, recoveries counted."""
    import numpy as np
    from mxnet_tpu_torch import faults, metrics
    from mxnet_tpu_torch.serving import GenerationEngine, GenerationServer
    rng = np.random.RandomState(31)
    reqs = [dict(tokens=rng.randint(0, GPT_VOCAB, int(n)).tolist(),
                 max_new_tokens=48, kw=kw)
            for n, kw in zip(rng.randint(20, 200, 8),
                             [{}] * 6 + [dict(method="sample", seed=9),
                                         dict(method="top_p", top_p=0.9,
                                              seed=10)])]

    def rec():
        return sum(metrics.value("mxnet_serving_recoveries_total", site=s)
                   for s in ("worker", "queue", "decode"))

    gs = GenerationServer(engine_factory=lambda: GenerationEngine(
        dm, max_slots=4, prefix_slots=0), replicas=2, warmup=True,
        restart_backoff_ms=10)
    front = HttpFront(gs)
    try:
        clean, _ = gen_http(front.port, reqs)
        r0 = rec()
        with faults.fault_plan("serving.worker:after=30:times=1"):
            faulted, st = gen_http(front.port, reqs)
        moved = rec() - r0
    finally:
        front.close()
    if faulted != clean or moved < 1:
        fail(f"worker death: streams equal {faulted == clean}, "
             f"mxnet_serving_recoveries_total +{moved}")
    print(f"phase 8: two replicas, a serving.worker fault mid-stream (f32): "
          f"8 HTTP streams token-identical to the unfaulted pass, indexes "
          f"contiguous, mxnet_serving_recoveries_total +{int(moved)}; "
          f"{fmt_gen(st)}", flush=True)


def prefill_kernel_rows(torch, dev, attn):
    """The flash forward at the prefill's shapes, (1, 12, T, 64) causal
    bf16, T = 128, 512, 1024, against its plain version, timed beside its
    bound and SDPA's ``is_causal`` (a yardstick the port never calls); and
    the suffix pass at Pb=256, Sb=128 with one real prefix row under its
    f32 bias. Returns the T=1024 row."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops.transformer import _mask_to_bias
    gen = torch.Generator().manual_seed(8)
    errs, row = [], None
    for T in (128, 512, 1024):
        q, k, v = qkv_views(torch, dev, 1, T, torch.bfloat16, gen, 64, 12)
        got = attn.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                   causal=True).transpose(1, 2)
        ref, _ = attn.flash_attention_reference(q.float(), k.float(),
                                                v.float(), causal=True)
        errs.append(check_close("prefill flash forward", f"T={T}", got, ref,
                                TOL_HALF))
        ms = kernel_ms(lambda: attn.flash_attention(
            *(t.transpose(1, 2) for t in (q, k, v)), causal=True),
            FWD_KERNEL)
        plain = device_ms(lambda: attn.flash_attention_reference(
            q, k, v, causal=True))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        b_ms, b_by = attention_bound_ms(1, 12, T, 64, [T], "bfloat16", 2,
                                        True, None)
        print(f"phase 8: prefill flash forward (1, 12, {T}, 64) causal bf16: "
              f"{fmt_ms(ms)} device (bound {b_ms:.6f} ms by {b_by}; plain "
              f"{fmt_ms(plain)}; SDPA is_causal {fmt_ms(lib)}); max abs err "
              f"{errs[-1]:.3e}", flush=True)
        row = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib)
    Pb, Sb, ql = 256, 128, 1
    q, _, _ = qkv_views(torch, dev, 1, Sb, torch.bfloat16, gen, 64, 12)
    _, k, v = qkv_views(torch, dev, 1, Pb + Sb, torch.bfloat16, gen, 64, 12)
    cols = torch.arange(Pb + Sb, device=dev)[None, :]
    rows = torch.arange(Sb, device=dev)[:, None]
    vis = (cols < ql) | ((cols >= Pb) & (cols - Pb <= rows))
    bias = _mask_to_bias(vis[None, None], torch.float32, 1, Sb, Pb + Sb)
    got = attn.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                               bias=bias, bias_grad=False).transpose(1, 2)
    ref, _ = attn.flash_attention_reference(q.float(), k.float(), v.float(),
                                            bias=bias)
    errs.append(check_close("suffix pass", "Pb=256 Sb=128 q=1", got, ref,
                            TOL_HALF))
    print(f"phase 8: suffix pass Pb=256 Sb=128, one real prefix row (key "
          f"tiles masked whole) under its f32 bias: finite, max abs err "
          f"{errs[-1]:.3e} vs plain", flush=True)
    row["max_abs_err"] = max(errs)
    return row


def decode_bound_ms(S, H, D, n, elem):
    """Least time for one decode attention call: each slot's visible K and
    V rows read once, q read and out written once (bytes; the products are
    4 * H * D flops a row)."""
    rows = sum(n)
    return bound(4.0 * H * D * rows,
                 elem * (2 * H * D * rows + 2 * S * H * D) + 8 * S,
                 "bfloat16")


def decode_kernel_row(torch, dev, da):
    """The decode attention kernel at the main path's shape (S=8, H=12,
    D=64, bucket L=1024, positions 300-1023) against its plain version,
    timed with a kept workspace (as the decode graphs keep one) beside its
    bound and SDPA over the masked cache (a yardstick); the same slots'
    bits in the buckets 128 and 1024 where their rows fit both, and at
    another slot index; and head dim 288 (the kernel whose lanes stride the
    head dim) against its plain version."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(9)
    S, L, H, D = GEN_SLOTS, 1024, 12, 64
    pos = torch.randint(300, L, (S,), generator=gen)
    qkv = torch.randn(S, 3 * H * D, generator=gen).to(dev, torch.bfloat16)
    q = qkv[:, :H * D].reshape(S, H, D)
    k, v = (torch.randn(S, L, H, D, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    pd = pos.to(dev)
    got = da.decode_attention(q, k, v, pd)
    ref = da.decode_attention_reference(q.float(), k.float(), v.float(), pd)
    err = check_close("decode attention", "S=8 L=1024", got, ref, TOL_HALF)
    # short sequences: the same bits in bucket 128 as in 1024, and with the
    # slots in reverse order
    short = torch.tensor([0, 5, 63, 64, 100, 127, 1, 126], device=dev)
    a = da.decode_attention(q, k, v, short)
    b = da.decode_attention(q, k[:, :128].contiguous(),
                            v[:, :128].contiguous(), short)
    c = da.decode_attention(q.flip(0), k.flip(0), v.flip(0), short.flip(0))
    if not (torch.equal(a, b) and torch.equal(a, c.flip(0))):
        fail("decode attention: a slot's bits moved with the bucket or the "
             "slot index")
    err = max(err, check_close(
        "decode attention", "S=8 L=1024 short rows", a,
        da.decode_attention_reference(q.float(), k.float(), v.float(),
                                      short), TOL_HALF))
    work = da.workspace(S, H, L, D, dev)

    def call():
        da.decode_attention(q, k, v, pd, work=work)
    keep = lambda n: re.search(DECODE_KERNEL, n)    # noqa: E731
    ms = launch_ms(call, 20, keep)
    flushed = cold_ms(call, keep, per_call=1)
    plain = device_ms(lambda: da.decode_attention_reference(q, k, v, pd))
    mask = (torch.arange(L, device=dev)[None, :] <= pd[:, None])[:, None,
                                                                 None, :]
    qh, kh, vh = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib = device_ms(sdpa)
    lib_flushed = cold_ms(sdpa, lambda n: True)
    b_ms, b_by = decode_bound_ms(S, H, D, (pos + 1).tolist(), 2)
    print(f"phase 8: decode attention S=8 H=12 D=64 L=1024 bf16 (positions "
          f"{pos.tolist()}): {fmt_ms(ms)} device back to back (K and V "
          f"stay in L2), {fmt_ms(flushed)} with L2 flushed before each "
          f"call, one launch (bound {b_ms:.6f} ms by {b_by}; plain "
          f"{fmt_ms(plain)}; SDPA over the masked cache {fmt_ms(lib)} back "
          f"to back, {fmt_ms(lib_flushed)} flushed); max abs err "
          f"{err:.3e}; a slot's bits equal in buckets 128 and 1024 and at "
          f"another slot index", flush=True)
    Dw, Hw = 288, 4
    qw = torch.randn(S, Hw, Dw, generator=gen).to(dev, torch.bfloat16)
    kw, vw = (torch.randn(S, 512, Hw, Dw, generator=gen).to(
        dev, torch.bfloat16) for _ in range(2))
    pw = torch.tensor([0, 3, 255, 256, 257, 400, 510, 511], device=dev)
    gw = da.decode_attention(qw, kw, vw, pw)
    ew = check_close("decode attention", f"D={Dw} L=512", gw,
                     da.decode_attention_reference(qw.float(), kw.float(),
                                                   vw.float(), pw), TOL_HALF)
    print(f"phase 8: decode attention S=8 H={Hw} D={Dw} L=512 bf16 within "
          f"TOL_HALF of its plain version (max abs err {ew:.3e})", flush=True)
    return dict(max_abs_err=max(err, ew), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                flushed_ms=flushed, library_flushed_ms=lib_flushed)


def phase_generate(torch, dev):
    """Phase 8: GPT-2 124M at full width and depth, generating through
    ``GenerationServer`` (the engine's decode step replayed as CUDA graphs,
    the prefill on the causal flash forward). Returns (rows, launches) of
    the flash forward and the decode attention kernel, the launches those
    of the main path: 16 concurrent requests in process."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import metrics
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    from mxnet_tpu_torch.serving import (DecodeModel, GenerationEngine,
                                         GenerationServer)
    t_phase = time.perf_counter()
    cpu_net, params = gpt_net(torch, "cpu", "float32")
    net, _ = gpt_net(torch, dev, "bfloat16", params=params)
    gpt_forward_check(torch, attn, net, cpu_net)

    dm = DecodeModel.from_block(net, device=dev)
    t = time.perf_counter()
    server = GenerationServer(GenerationEngine(dm, max_slots=GEN_SLOTS),
                              warmup=True)
    warm_s = time.perf_counter() - t
    compiles0, captures0 = compile_counts(dm)
    print(f"phase 8: GenerationServer warmup {warm_s:.2f} s: "
          f"{captures0} CUDA graphs captured (greedy and mixed decode per "
          f"KV bucket {list(server.engine.grid)}), programs "
          f"{sorted(compiles0)}", flush=True)
    reqs = gen_requests()
    server.start()
    reset_counts(attn)
    reset_counts(da)
    it0 = metrics.value("mxnet_gen_iterations_total")
    d0 = metrics.hist_stats("mxnet_gen_step_seconds", phase="decode")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        main, st_prof = gen_inprocess(server, reqs)
        torch.cuda.synchronize()
    counts = kernel_counts(prof)
    launches = {"flash_attention_fwd": attn.launches["flash_attention_fwd"],
                "decode_attention": sum(
                    c for k, c in counts.items()
                    if re.search(DECODE_KERNEL, k))}
    sdpa = [k for k in counts if re.search(SDPA_KERNEL, k)]
    if launches["flash_attention_fwd"] != 12 * len(reqs) \
            or not launches["decode_attention"] or sdpa \
            or attn.padded_copies:
        fail(f"generation main path: launches {launches} (flash forward "
             f"{12 * len(reqs)} wanted), SDPA kernels {sdpa}, padded "
             f"copies {attn.padded_copies}")
    iters = metrics.value("mxnet_gen_iterations_total") - it0
    d1 = metrics.hist_stats("mxnet_gen_step_seconds", phase="decode")
    print(f"phase 8: 16 concurrent requests in process (main path, under "
          f"the profiler): {fmt_gen(st_prof)}; {int(iters)} iterations, "
          f"decode step {(d1[0] - d0[0]) / max(d1[1] - d0[1], 1) * 1e3:.4f} "
          f"ms; launches {launches}", flush=True)
    runs = {}
    for label in ("in process", "HTTP"):
        server.engine.cache.prefix.clear()     # every prefill cold
        it0 = metrics.value("mxnet_gen_iterations_total")
        d0 = metrics.hist_stats("mxnet_gen_step_seconds", phase="decode")
        if label == "HTTP":
            front = HttpFront(server)
            try:
                got, st = gen_http(front.port, reqs)
            finally:
                front.close()
        else:
            got, st = gen_inprocess(server, reqs)
        iters = metrics.value("mxnet_gen_iterations_total") - it0
        d1 = metrics.hist_stats("mxnet_gen_step_seconds", phase="decode")
        step_ms = (d1[0] - d0[0]) / max(d1[1] - d0[1], 1) * 1e3
        if got != main:
            bad = [i for i, (a, b) in enumerate(zip(got, main)) if a != b]
            fail(f"generation {label}: streams differ from the main run at "
                 f"requests {bad}")
        runs[label] = st
        print(f"phase 8: 16 concurrent requests {label}: {fmt_gen(st)}; "
              f"{int(iters)} iterations, {st['wall_s'] / max(iters, 1) * 1e3:.4f} "
              f"ms an iteration, decode step {step_ms:.4f} ms; streams equal "
              f"to the main run's", flush=True)
    compiles1, captures1 = compile_counts(dm)
    moved = {k: v for k, v in compiles1.items()
             if compiles0.get(k) != v and (k.startswith("decode:")
                                           or k.startswith("prefill:"))}
    if moved or captures1 != captures0:
        fail(f"traffic compiled after warmup: {moved}, captures "
             f"{captures0} -> {captures1}")
    worst = greedy_margins(torch, net, reqs, main)
    print(f"phase 8: 12 greedy streams varied and held to a teacher-forced "
          f"full forward: worst gap below the row maximum {worst:.4f} "
          f"(limit {GREEDY_MARGIN}); no capture and no decode/prefill "
          f"compile after warmup", flush=True)

    decode_step_bits(torch, dm, dev)
    draft, _ = gpt_net(torch, dev, "bfloat16", num_layers=2, seed=1)
    gen_speculation(torch, dm, draft, reqs, main)
    del draft

    net32, _ = gpt_net(torch, dev, "float32", params=params)
    dm32 = DecodeModel.from_block(net32, device=dev)
    gen_f32_vs_cpu(torch, dm32, cpu_net)
    gen_prefix(torch, dm32)
    gen_recovery(torch, dm32)
    del net32, dm32, cpu_net
    torch.cuda.empty_cache()

    rows = {"flash_attention_fwd": prefill_kernel_rows(torch, dev, attn),
            "decode_attention": decode_kernel_row(torch, dev, da)}
    print(f"phase 8: generation done in {time.perf_counter() - t_phase:.1f} "
          f"s; card: {smi_line()}", flush=True)
    return rows, launches


# ------------------------------------------------------------ phases 9, 10
# the kernels a training step of each model launches (the eager run's
# counters): every attention runs the flash forward and, at T <= block_k
# and D = 64, the fused backward; one update launch a step
S2S_VOCAB = 32000
S2S_B, S2S_T = 32, 128          # 4096 target tokens: the usual ~4k NMT batch
S2S_ATTN = 18                   # 6 encoder, 6 causal decoder, 6 cross
S2S_PAIR_BLOCK_K = 64           # below T: the dq/dkv pair
S2S_SOURCES = [16, 32, 48, 64, 80, 96, 112, 128]   # translate's lengths
S2S_NEW = 64
S2S_BEAM = 4
GPT_B, GPT_T = 8, 1024          # bench.py:557 bench_gpt's batch
GPT_ATTN = 12
GPT_PAIR_BLOCK_K = 512
TRAIN_STEPS = 10


def random_transformer_params(block, seed: int):
    """numpy weights for every parameter of a Transformer ``block``, from
    ``seed``, as :func:`random_gpt_params` makes GPT's (matrices
    N(0, 1/fan_in), the shared embedding N(0, 0.05), the position tables
    N(0, 1), biases N(0, 0.02), LayerNorm gamma 1 + N(0, 0.02)): greedy
    translations vary and the loss falls under Adam at lr 1e-4. A tied
    embedding gets one array under both names."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out, seen = {}, {}
    for name, p in block.collect_params().items():
        if id(p) in seen:
            out[name] = out[seen[id(p)]]
            continue
        seen[id(p)] = name
        shape = tuple(p.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("embed.weight"):
            out[name] = z * 0.05
        elif name.endswith("_pos"):
            out[name] = z
        elif name.endswith(".weight") and len(shape) == 2:
            out[name] = z / np.float32(math.sqrt(shape[1]))
        elif name.endswith("gamma"):
            out[name] = 1.0 + 0.02 * z
        else:
            out[name] = 0.02 * z
    return out


def seq2seq_batch(torch, B, Ts, Tt, seed, lo=32, vocab=S2S_VOCAB):
    """Source tokens, target input, target labels and source valid lengths
    (``lo`` to Ts), from ``seed``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    valid = rng.randint(min(lo, Ts), Ts + 1, size=B)
    src = rng.randint(0, vocab, (B, Ts))
    tgt = rng.randint(0, vocab, (B, Tt + 1))
    return [torch.from_numpy(np.asarray(x, dtype=np.int64))
            for x in (src, tgt[:, :-1], tgt[:, 1:], valid)]


def lm_batch(torch, B, T, seed, vocab=GPT_VOCAB):
    """Tokens and next-token labels (B, T), from ``seed``."""
    import numpy as np
    toks = np.random.RandomState(seed).randint(0, vocab, (B, T + 1))
    t = torch.from_numpy(toks.astype(np.int64))
    return [t[:, :-1].contiguous(), t[:, 1:].contiguous()]


def s2s_step(torch, autograd, net, loss_fn, trainer, batch):
    src, tin, lab, vl = batch
    with autograd.record():
        loss = loss_fn(net(src, tin, vl), lab)
    autograd.backward(loss)
    trainer.step(src.shape[0])
    return loss


def lm_step(torch, autograd, net, loss_fn, trainer, batch):
    x, y = batch
    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss


def counts_now(mods):
    return {n: c for m in mods for n, c in m.launches.items()}


def model_training(torch, dev, tag, build, params, batch, step, opt,
                   n_attn, pair_block_k, tokens):
    """Phase 9 / 10's training: ``build(device, dropout)`` made bf16 with
    f32 masters from ``params``, ``TRAIN_STEPS`` eager steps of ``step``
    (each launching the flash forward and the fused backward ``n_attn``
    times and the update kernel once, and nothing else of the port), one
    step at ``MXNET_FLASH_BLOCK_K=pair_block_k`` (the dq/dkv pair); the
    loss must fall; step ms and tokens/s (``tokens`` a step), one profiled
    step (busy and idle share, no SDPA kernel), peak memory; then
    ``TRAIN_STEPS`` hybridized steps from the same weights and generator
    state (an eager and a replayed step's kernels by the profiler equal to
    the launch counters' eager step). Returns the launch counts of the
    eager run and the pair step, and the measurements."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    mods = (attn, mt, da)
    net = load_jax_params(build(dev), params, dtype="bfloat16")
    loss_fn = SoftmaxCrossEntropyLoss(axis=-1)
    hp = dict(opt[1], multi_precision=True)
    trainer = Trainer(net.collect_params(), opt[0], dict(hp))
    batch = [x.to(dev) for x in batch]

    def one():
        return step(torch, autograd, net, loss_fn, trainer, batch)

    mx_random.seed(0)
    os.environ.pop("MXNET_FLASH_BLOCK_K", None)
    for m in mods:
        reset_counts(m)                     # the main path starts here
    want = {"flash_attention_fwd": n_attn,
            "flash_attention_bwd_fused": n_attn, "multi_tensor_update": 1}
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        before = counts_now(mods)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        moved = {n: c - before[n] for n, c in counts_now(mods).items()}
        if moved != {n: want.get(n, 0) for n in moved}:
            fail(f"{tag} step {i}: kernel launches {moved}, expected {want}")
        lval = loss.float().mean().item()
        if not math.isfinite(lval):
            fail(f"{tag} step {i}: loss {lval}")
        losses.append(lval)
    os.environ["MXNET_FLASH_BLOCK_K"] = str(pair_block_k)
    before = counts_now(mods)
    pair_loss = one().float().mean().item()
    torch.cuda.synchronize()
    os.environ.pop("MXNET_FLASH_BLOCK_K", None)
    moved = {n: c - before[n] for n, c in counts_now(mods).items()}
    pair_want = {"flash_attention_fwd": n_attn,
                 "flash_attention_bwd_dq": n_attn,
                 "flash_attention_bwd_dkv": n_attn, "multi_tensor_update": 1}
    if moved != {n: pair_want.get(n, 0) for n in moved} or \
            not math.isfinite(pair_loss):
        fail(f"{tag} step at MXNET_FLASH_BLOCK_K={pair_block_k}: launches "
             f"{moved}, expected {pair_want}; loss {pair_loss}")
    counts = counts_now(mods)                # ... and ends here
    if attn.padded_copies:
        fail(f"{tag}: training copied {attn.padded_copies} attention "
             "operands that TMA could not address; expected none")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the loss did not fall over {TRAIN_STEPS} steps: "
             f"{losses}")
    ms = 1e3 * sum(times[2:]) / len(times[2:])
    print(f"{tag}: eager losses {[round(x, 4) for x in losses]}; one step at "
          f"MXNET_FLASH_BLOCK_K={pair_block_k} (the dq/dkv pair) loss "
          f"{pair_loss:.4f}; launches in the run {counts}, 0 padded copies",
          flush=True)
    # where the time goes: one profiled step; the peak memory of a step
    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    wall_ms, prof = profiled_step(torch, one)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy, idle = device_breakdown(prof, wall_ms, f"{tag}: profiled eager step")
    eager_counts, eager_sessions = step_kernel_counts(
        torch, one, want, f"{tag}: an eager step")
    sdpa = [k for k in kernel_counts(prof) if re.search(SDPA_KERNEL, k)]
    if sdpa:
        fail(f"{tag}: library attention kernels ran in a step: {sdpa}")
    print(f"{tag}: eager step {ms:.3f} ms (mean of steps 3-{TRAIN_STEPS}, "
          f"host clock to a synchronize), {tokens / ms * 1e3:.0f} tokens/s; "
          f"device busy {fmt_ms(busy)} a step, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; peak "
          f"memory {peak:.2f} GiB; no library attention kernel in the "
          f"profile; card: {smi_line()}", flush=True)
    stats = dict(eager_ms=ms, busy=busy, idle=idle, peak=peak)

    # hybridized: the same weights and generator state
    load_jax_params(net, params, dtype="bfloat16")
    trainer = Trainer(net.collect_params(), opt[0], dict(hp))
    mx_random.seed(0)
    net.hybridize()
    h_losses, h_times = [], []
    for _ in range(TRAIN_STEPS):   # 1: the warm-up; 2: the capture; replays
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = one()
        torch.cuda.synchronize()
        h_times.append(time.perf_counter() - t)
        h_losses.append(loss.float().mean().item())
    graphs = sum(1 for g in net._cached_graph.values() if g is not True)
    if graphs != 1 or not h_losses[-1] < h_losses[0] or not all(
            math.isfinite(v) for v in h_losses):
        fail(f"{tag} hybridized: {graphs} graphs captured, losses "
             f"{h_losses}")
    if h_losses[0] != losses[0]:
        fail(f"{tag} hybridized: the first (eager) step's loss "
             f"{h_losses[0]} differs from the eager run's {losses[0]}")
    h_ms = 1e3 * sum(h_times[2:]) / len(h_times[2:])
    wall_ms, prof = profiled_step(torch, one)
    h_busy, h_idle = device_breakdown(prof, wall_ms,
                                      f"{tag}: profiled hybridized step")
    got, sessions = step_kernel_counts(torch, one, want,
                                       f"{tag} hybridized: a replayed step")
    net.hybridize(False)
    print(f"{tag}: hybridized losses {[round(x, 4) for x in h_losses]} "
          f"(the eager run's largest difference "
          f"{max(abs(a - b) for a, b in zip(h_losses, losses)):.4f}); step "
          f"{h_ms:.3f} ms (mean of steps 3-{TRAIN_STEPS}), "
          f"{tokens / h_ms * 1e3:.0f} tokens/s; device busy {fmt_ms(h_busy)}"
          f", idle share "
          f"{'not measured' if h_idle is None else f'{h_idle:.3f}'}; a "
          f"replayed step's kernels by the profiler {got} ({sessions} "
          f"primed sessions; an eager step's {eager_counts}, "
          f"{eager_sessions}), as the launch counters' eager step; card: "
          f"{smi_line()}", flush=True)
    stats.update(hybrid_ms=h_ms, hybrid_busy=h_busy, hybrid_idle=h_idle)
    del net, trainer
    torch.cuda.empty_cache()
    return counts, stats


def f32_audit(torch, tag, run, names=("flash_attention_bwd_fused",)):
    """``run()``, an f32 step on the card, under torch.profiler: its
    records must show the 3xTF32 forward and the 3xTF32 backward kernels
    of ``names`` (``F32_KERNEL``) and none of the f32 FMA kernels they
    replaced (``F32_GONE``). Returns what ``run`` returns."""
    names = ("flash_attention_fwd",) + tuple(names)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primer()
        result = run()
        torch.cuda.synchronize()
    seen = list(kernel_counts(prof))
    found = {n: [k for k in seen if re.search(F32_KERNEL[n], k)]
             for n in names}
    gone = [k for k in seen if re.search(F32_GONE, k)]
    if not all(found.values()) or gone:
        fail(f"{tag} f32 step: the profiler's attention kernels "
             f"{found} {gone}, expected the 3xTF32 kernels of {names} "
             f"alone")
    return result


def f32_step_parity(torch, dev, tag, build, params, batch, step, opt,
                    n_attn):
    """One f32 step, dropout 0, on the card (the kernels; TF32 off) against
    the same step on the CPU (the plain path): loss and every parameter's
    gradient; the card's step under :func:`f32_audit`."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops.cuda import attention as attn
    out = {}
    for where in ("cpu", dev):
        net = load_jax_params(build(where), params)
        trainer = Trainer(net.collect_params(), opt[0], dict(opt[1]))
        before = dict(attn.launches)
        xs = [x.to(where) for x in batch]

        def run():
            return step(torch, autograd, net,
                        SoftmaxCrossEntropyLoss(axis=-1), trainer, xs)
        loss = run() if where == "cpu" else f32_audit(torch, tag, run)
        for name in ("flash_attention_fwd", "flash_attention_bwd_fused"):
            moved = attn.launches[name] - before[name]
            if moved != (n_attn if where != "cpu" else 0):
                fail(f"{tag} f32 step on {where}: {moved} {name} "
                     "launches")
        out[str(where)] = (loss.detach().cpu(), {
            k: p.grad().detach().cpu()
            for k, p in net.collect_params().items()})
        del net, trainer
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    loss_rel = ((lg - lc).abs() / lc.abs()).max().item()
    grad_rel = max((rel(gg[k], gc[k]), k) for k in gc)
    if loss_rel > TOL_TRAIN_LOSS_REL or grad_rel[0] > TOL_TRAIN_GRAD_REL:
        fail(f"{tag} f32 step card vs CPU: loss relative {loss_rel:.3e} "
             f"(limit {TOL_TRAIN_LOSS_REL}), gradient of {grad_rel[1]} "
             f"{grad_rel[0]:.3e} (limit {TOL_TRAIN_GRAD_REL})")
    print(f"{tag}: f32 step card vs CPU: loss relative {loss_rel:.3e} (limit "
          f"{TOL_TRAIN_LOSS_REL}), worst gradient relative Frobenius "
          f"{grad_rel[0]:.3e} ({grad_rel[1]}; limit {TOL_TRAIN_GRAD_REL})",
          flush=True)
    torch.cuda.empty_cache()


def path_attention_rows(torch, dev, attn, tag, B, H, T, valid, causal,
                        pair_block_k):
    """The flash forward, the fused backward and the dq/dkv pair at a
    training path's shape (bf16, D = 64, key padding by ``valid`` or
    causal) against their plain versions, each timed by device time beside
    its bound, its plain version and SDPA (a yardstick). Returns the four
    kernels' rows."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cpu").manual_seed(11)
    c = backward_case(torch, dev, gen, attn, B, T, torch.bfloat16, causal,
                      None if causal else "keypad", 0.0, valid=valid, d=64,
                      h=H)
    q, k, v, bias = c["q"], c["k"], c["v"], c["bias"]
    ref, _ = attn.flash_attention_reference(q.float(), k.float(), v.float(),
                                            bias=bias, causal=causal)
    err = check_close(f"{tag} flash forward", f"({B}, {H}, {T}, 64)",
                      c["out"], ref, TOL_HALF)

    def fwd():
        attn._flash_forward(q, k, v, bias, c["scale"], causal)
    rows = {"flash_attention_fwd": dict(
        max_abs_err=err, ms=kernel_ms(fwd, FWD_KERNEL),
        plain_ms=device_ms(lambda: attn.flash_attention_reference(
            q, k, v, bias=bias, causal=causal)),
        library_ms=device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, is_causal=causal)))}
    rows["flash_attention_fwd"]["bound_ms"], \
        rows["flash_attention_fwd"]["bound_by"] = attention_bound_ms(
            B, H, T, 64, valid, "bfloat16", 2, causal, bias)
    errs = {}
    phase = tag.split(" causal")[0]
    backward_check(torch, attn, f"({B}, {H}, {T}, 64) fused", c,
                   attn.DEFAULT_BLOCK_K, errs, phase)
    backward_check(torch, attn, f"({B}, {H}, {T}, 64) pair (block_k="
                   f"{pair_block_k})", c, pair_block_k, errs, phase)
    plain = device_ms(lambda: attn.flash_attention_backward_reference(
        q, k, v, bias, None, 0.0, c["out"], c["lse"], c["do"], c["scale"],
        causal, False), iters=3)
    lib = library_backward_ms(torch, q, k, v, bias, c["do"], c["scale"],
                              causal, 0.0, False)
    for name, kind in (("flash_attention_bwd_fused", "fused"),
                       ("flash_attention_bwd_dq", "dq"),
                       ("flash_attention_bwd_dkv", "dkv")):
        call, _ = kernel_only_call(torch, attn, c, name)
        bnd, by = backward_bound_ms(kind, B, H, T, T, 64, valid, "bfloat16",
                                    2, causal, bias, False)
        rows[name] = dict(max_abs_err=errs[name],
                          ms=kernel_ms(call, BWD_KERNEL[name]),
                          plain_ms=plain, library_ms=lib, bound_ms=bnd,
                          bound_by=by)
    for name, r in rows.items():
        print(f"{tag}: {name} at ({B}, {H}, {T}, 64) bf16 "
              f"{'causal' if causal else 'key padding'}: {fmt_ms(r['ms'])} "
              f"device a launch (bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}; plain {fmt_ms(r['plain_ms'])}; SDPA "
              f"{fmt_ms(r['library_ms'])}); max abs err "
              f"{r['max_abs_err']:.3e} vs plain", flush=True)
    return rows


def path_update_row(torch, dev, tag, name, opt, shapes):
    """The multi-tensor update over a model's parameters (bf16, f32
    masters) against its plain version, timed."""
    case = dict(name=f"{name} {opt[0]} bf16 masters, one group", opt=opt[0],
                kw=opt[1], shapes=None, dtype="bfloat16", master=True,
                agg=0)
    row = update_check(torch, dev, case, shapes, timed=True)
    print(f"{tag}: the update over {name}'s {len(shapes)} tensors: "
          f"{fmt_ms(row['ms'])} device a step (bound {row['bound_ms']:.4f} "
          f"ms; plain {fmt_ms(row['plain_ms'])}; library "
          f"{fmt_ms(row['library_ms'])})", flush=True)
    torch.cuda.empty_cache()
    return row


def model_shapes(net):
    """The trained parameters' shapes, tied ones once."""
    seen, out = set(), []
    for p in net.collect_params().values():
        if p.grad_req != "null" and id(p) not in seen:
            seen.add(id(p))
            out.append(tuple(p.shape))
    return out


def s2s_build(dropout):
    from mxnet_tpu_torch.gluon.model_zoo import get_transformer

    def build(device):
        return get_transformer("transformer_base", S2S_VOCAB, device=device,
                               dropout=dropout)
    return build


def translate_margins(torch, net, src, vl, toks, bos):
    """Each greedy token held to a teacher-forced bf16 ``decode`` over the
    same prefix: its logit within GREEDY_MARGIN of its row's maximum; no
    stream constant. Returns the worst gap."""
    B = src.shape[0]
    prefix = torch.cat([torch.full((B, 1), bos, dtype=torch.int64,
                                   device=src.device),
                        toks[:, :-1].to(src.device, torch.int64)], 1)
    with torch.inference_mode():
        memory = net.encode(src, vl)
        lg = net.decode(prefix, memory, vl, src=src).float()
    t = toks.to(src.device, torch.int64)
    gap = (lg.max(-1).values - lg.gather(2, t[:, :, None])[:, :, 0]).max()
    constant = [i for i, row in enumerate(toks.tolist())
                if len(set(row)) == 1]
    if constant or float(gap) > GREEDY_MARGIN:
        fail(f"translate: streams {constant} constant, or a greedy token "
             f"{float(gap):.4f} below its row's maximum in the teacher-forced "
             f"decode (> {GREEDY_MARGIN})")
    return float(gap)


def s2s_translate(torch, dev, params):
    """Phase 9's translation: transformer_base bf16 from ``params``, greedy
    ``translate`` of 8 sources (lengths S2S_SOURCES, padded to 128) for
    S2S_NEW tokens: 6 flash forwards (the encoder) and 12 decode-attention
    launches a token by the counters, the decode kernel and no library
    attention in a profiled call; each token held to a teacher-forced
    ``decode``; ``beam_translate`` at K = S2S_BEAM (scores best-first, the
    best no lower than K = 1's); then in f32 (TF32 off) three sources, one
    of valid length 0, token for token against the port's f32 CPU path.
    Returns the decode kernel's launches in the greedy call."""
    import numpy as np
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    tag = "phase 9"
    B, Ts = len(S2S_SOURCES), max(S2S_SOURCES)
    rng = np.random.RandomState(21)
    src = torch.from_numpy(rng.randint(1, S2S_VOCAB, (B, Ts))).to(dev)
    vl = torch.tensor(S2S_SOURCES, device=dev)
    src = torch.where(torch.arange(Ts, device=dev)[None] < vl[:, None], src,
                      torch.zeros_like(src))          # padded with 0
    net = load_jax_params(s2s_build(0.0)(dev), params, dtype="bfloat16")
    bos = 1
    net.translate(src, 4, bos, src_valid_length=vl)      # warm-up
    torch.cuda.synchronize()
    reset_counts(attn)
    reset_counts(da)
    t = time.perf_counter()
    toks = net.translate(src, S2S_NEW, bos, src_valid_length=vl)
    dt = time.perf_counter() - t
    counts = dict(attn.launches, **da.launches)
    want = {"flash_attention_fwd": 6, "decode_attention": 12 * S2S_NEW}
    if {n: c for n, c in counts.items() if c} != want or \
            attn.padded_copies:
        fail(f"translate: launches {counts}, expected {want}; padded copies "
             f"{attn.padded_copies}")
    if tuple(toks.shape) != (B, S2S_NEW):
        fail(f"translate: tokens of shape {tuple(toks.shape)}")
    gap = translate_margins(torch, net, src, vl, toks, bos)
    print(f"{tag}: translate greedy B={B} (source lengths {S2S_SOURCES}, "
          f"padded to {Ts}) {S2S_NEW} new tokens: {dt * 1e3 / S2S_NEW:.3f} "
          f"ms a token, {B * S2S_NEW / dt:.0f} tokens/s (host clock, eager "
          f"loop); launches {counts}; worst gap below the teacher-forced "
          f"row maximum {gap:.4f} (limit {GREEDY_MARGIN}); distinct tokens "
          f"a stream {[len(set(r)) for r in toks.tolist()]}", flush=True)
    _, prof = profiled_step(torch, lambda: net.translate(
        src, 4, bos, src_valid_length=vl))
    names = kernel_counts(prof)
    sdpa = [k for k in names if re.search(SDPA_KERNEL, k)]
    dec = sum(c for k, c in names.items() if re.search(DECODE_KERNEL, k))
    if sdpa or not dec:
        fail(f"translate: library attention kernels {sdpa}, decode kernels "
             f"{dec} in a profiled call")
    t = time.perf_counter()
    seqs, scores = net.beam_translate(src, S2S_NEW, bos, beam_size=S2S_BEAM,
                                      src_valid_length=vl)
    beam_s = time.perf_counter() - t
    _, one = net.beam_translate(src, S2S_NEW, bos, beam_size=1,
                                src_valid_length=vl)
    sc = scores.float()
    if tuple(seqs.shape) != (B, S2S_BEAM, S2S_NEW) or \
            not bool(sc.isfinite().all()) or \
            bool((sc[:, 1:] > sc[:, :-1]).any()) or \
            bool((sc[:, 0] < one[:, 0] - 1e-4).any()):
        fail(f"beam_translate: shape {tuple(seqs.shape)}, scores {sc} (must "
             f"be best-first), K=1 scores {one}")
    print(f"{tag}: beam_translate K={S2S_BEAM}: {beam_s * 1e3:.1f} ms for "
          f"{S2S_NEW} steps ({B * S2S_BEAM} rows); scores best-first, the "
          f"best no lower than K=1's (margins "
          f"{(sc[:, 0] - one[:, 0]).min().item():.4f} and up)", flush=True)
    del net
    torch.cuda.empty_cache()
    # f32 (TF32 off): card against the port's CPU path, one empty source
    sub = torch.tensor([0, 3, 7])
    vl32 = torch.tensor([40, 0, 128])
    cpu = load_jax_params(s2s_build(0.0)("cpu"), params)
    want = cpu.translate(src[sub].cpu(), 16, bos, src_valid_length=vl32)
    del cpu
    card = load_jax_params(s2s_build(0.0)(dev), params)
    got = card.translate(src[sub], 16, bos, src_valid_length=vl32.to(dev))
    g16 = load_jax_params(s2s_build(0.0)(dev), params, dtype="bfloat16")
    zero = g16.translate(src[sub], 16, bos, src_valid_length=vl32.to(dev))
    if not torch.equal(got, want):
        fail(f"translate f32: the card's tokens {got.tolist()} differ from "
             f"the CPU's {want.tolist()}")
    print(f"{tag}: translate f32 (TF32 off), sources of valid length "
          f"{vl32.tolist()}: the card's 16 tokens equal the CPU path's, "
          f"token for token; bf16 with the empty source: tokens "
          f"{zero[1].tolist()[:8]}...", flush=True)
    del card, g16
    torch.cuda.empty_cache()
    return counts["decode_attention"]


def s2s_decode_row(torch, dev, da):
    """The decode attention at translate's shapes (S=8, H=8, D=64): the
    cross-attention over the memory (L = 128, pos = valid length - 1) and
    the self-attention over the cache (L = 64), against the plain version;
    the cross call timed with a kept workspace beside its bound and SDPA
    over the masked memory (a yardstick)."""
    import torch.nn.functional as F
    gen = torch.Generator().manual_seed(12)
    S, H, D = len(S2S_SOURCES), 8, 64
    q = torch.randn(S, H, D, generator=gen).to(dev, torch.bfloat16)
    errs = []
    for L, pos in ((max(S2S_SOURCES), [n - 1 for n in S2S_SOURCES]),
                   (S2S_NEW, [S2S_NEW // 2] * S)):
        k, v = (torch.randn(S, L, H, D, generator=gen).to(dev, torch.bfloat16)
                for _ in range(2))
        pd = torch.tensor(pos, device=dev)
        errs.append(check_close(
            "decode attention", f"S={S} L={L}", da.decode_attention(
                q, k, v, pd), da.decode_attention_reference(
                q.float(), k.float(), v.float(), pd), TOL_HALF))
    L = max(S2S_SOURCES)
    k, v = (torch.randn(S, L, H, D, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    pd = torch.tensor([n - 1 for n in S2S_SOURCES], device=dev)
    work = da.workspace(S, H, L, D, dev)

    def call():
        da.decode_attention(q, k, v, pd, work=work)
    keep = lambda n: re.search(DECODE_KERNEL, n)    # noqa: E731
    ms = launch_ms(call, 20, keep)
    flushed = cold_ms(call, keep, per_call=1)
    plain = device_ms(lambda: da.decode_attention_reference(q, k, v, pd))
    mask = (torch.arange(L, device=dev)[None, :] <= pd[:, None])[:, None,
                                                                 None, :]
    qh, kh, vh = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    lib = device_ms(sdpa)
    b_ms, b_by = decode_bound_ms(S, H, D, S2S_SOURCES, 2)
    print(f"phase 9: decode attention (cross) S={S} H={H} D={D} L={L} bf16, "
          f"valid lengths {S2S_SOURCES}: {fmt_ms(ms)} device back to back, "
          f"{fmt_ms(flushed)} with L2 flushed (bound {b_ms:.6f} ms by "
          f"{b_by}; plain {fmt_ms(plain)}; SDPA over the masked memory "
          f"{fmt_ms(lib)}); max abs err {max(errs):.3e}", flush=True)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, flushed_ms=flushed)


def phase_seq2seq(torch, dev):
    """Phase 9: the encoder-decoder Transformer (transformer_base, vocab
    32000, bf16 with f32 masters, weights from a seed) trained with Adam
    at lr 1e-4, dropout 0.1, on B=32 pairs of Ts = Tt = 128 (source valid
    lengths 32-128): eager, at the pair's block_k, hybridized; the f32
    step against the CPU (B=2, Ts=24, Tt=16); then translated greedy and
    by beam search. Returns (rows, launches)."""
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    t_phase = time.perf_counter()
    tag = "phase 9"
    params = random_transformer_params(s2s_build(0.1)("cpu"), seed=0)
    batch = seq2seq_batch(torch, S2S_B, S2S_T, S2S_T, seed=1)
    valid = batch[3].tolist()
    print(f"{tag}: transformer_base (6 + 6 layers, 512 units, FFN 2048, 8 "
          f"heads, vocab {S2S_VOCAB}, tied embedding) bf16; B={S2S_B} "
          f"Ts=Tt={S2S_T}, source valid lengths {valid}", flush=True)
    adam = ("adam", {"learning_rate": 1e-4})
    launches, stats = model_training(
        torch, dev, tag, s2s_build(0.1), params, batch, s2s_step, adam,
        S2S_ATTN, S2S_PAIR_BLOCK_K, S2S_B * S2S_T)
    f32 = seq2seq_batch(torch, 2, 24, 16, seed=2, lo=10)
    f32_step_parity(torch, dev, tag, s2s_build(0.0), params, f32, s2s_step,
                    adam, S2S_ATTN)
    launches["decode_attention"] = s2s_translate(torch, dev, params)
    rows = path_attention_rows(torch, dev, attn, tag, S2S_B, 8, S2S_T,
                               valid, False, S2S_PAIR_BLOCK_K)
    path_attention_rows(torch, dev, attn, f"{tag} causal", S2S_B, 8, S2S_T,
                        [S2S_T] * S2S_B, True, S2S_PAIR_BLOCK_K)
    rows["decode_attention"] = s2s_decode_row(torch, dev, da)
    rows["multi_tensor_update"] = path_update_row(
        torch, dev, tag, "transformer_base", adam,
        model_shapes(s2s_build(0.1)("cpu")))
    print(f"{tag}: done in {time.perf_counter() - t_phase:.1f} s; card: "
          f"{smi_line()}", flush=True)
    return rows, launches, stats


def phase_gpt_train(torch, dev):
    """Phase 10: GPT-2 124M (``get_gpt("gpt2_124m", vocab_size=50257,
    dropout=0.0, max_length=1024)``, bf16 with f32 masters, weights from a
    seed) trained with AdamW at lr 1e-4 on B=8, T=1024 (``bench.py:557``'s
    configuration): eager, at the pair's block_k, hybridized; the f32 step
    against the CPU (B=2, T=128). Returns (rows, launches)."""
    from mxnet_tpu_torch.gluon.model_zoo import get_gpt
    from mxnet_tpu_torch.ops.cuda import attention as attn
    t_phase = time.perf_counter()
    tag = "phase 10"

    def build(device):
        return get_gpt("gpt2_124m", vocab_size=GPT_VOCAB, dropout=0.0,
                       max_length=1024, device=device)
    params = random_gpt_params(build("cpu"), seed=0)
    print(f"{tag}: GPT-2 124M (12 layers, 768 units, 12 heads, vocab "
          f"{GPT_VOCAB}) bf16, B={GPT_B} T={GPT_T}, AdamW lr 1e-4",
          flush=True)
    adamw = ("adamw", {"learning_rate": 1e-4, "wd": 0.01})
    launches, stats = model_training(
        torch, dev, tag, build, params, lm_batch(torch, GPT_B, GPT_T, 1),
        lm_step, adamw, GPT_ATTN, GPT_PAIR_BLOCK_K, GPT_B * GPT_T)
    f32_step_parity(torch, dev, tag, build, params, lm_batch(torch, 2, 128, 2),
                    lm_step, adamw, GPT_ATTN)
    rows = path_attention_rows(torch, dev, attn, tag, GPT_B, 12, GPT_T,
                               [GPT_T] * GPT_B, True, GPT_PAIR_BLOCK_K)
    rows["multi_tensor_update"] = path_update_row(
        torch, dev, tag, "GPT-2 124M", adamw, model_shapes(build("cpu")))
    print(f"{tag}: done in {time.perf_counter() - t_phase:.1f} s; card: "
          f"{smi_line()}", flush=True)
    return rows, launches, stats


# ------------------------------------------- phase 11: layers and losses
# MXNet's Gluon DCGAN (example/gluon/dc_gan/dcgan.py; Radford et al., ICLR
# 2016): nz 100, ngf = ndf = 64, 3 channels, 64x64 images, B = 64, Adam lr
# 2e-4 beta1 0.5, f32 as the example trains
DCGAN = dict(nz=100, ngf=64, ndf=64, nc=3)
B_DCGAN, B_DCGAN_PARITY, DCGAN_ITERS = 64, 8, 10
DCGAN_ADAM = {"learning_rate": 2e-4, "beta1": 0.5}
# BatchNorm launches an iteration: G's 4 layers run forward twice (D's step
# on G(z).detach(), G's step) and backward once, D's 3 forward three times
# (real, fake, G's step) and backward twice; the first iteration's
# centered statistics (the virgin shift) add one bn_stats sweep a layer;
# the update kernel once a trainer step (every parameter f32, one layout)
DCGAN_STEP = {"bn_stats": 17, "bn_apply": 17, "bn_bwd_reduce": 13,
              "bn_bwd_apply": 13, "multi_tensor_update": 2}
DCGAN_FIRST_EXTRA = {"bn_stats": 7}
# DCGAN's BatchNorm shapes at B = 64: (C, H*W, forward, backward launches
# an iteration): G's 512 x 4x4 and D's last, G's 256 x 8x8 and D's second,
# G's 128 x 16x16 and D's first, G's 64 x 32x32
DCGAN_BN_SHAPES = ((512, 16, 5, 3), (256, 64, 5, 3), (128, 256, 5, 3),
                   (64, 1024, 2, 1))
# the groups of a DCGAN iteration's profile (kernel names, re.search)
DCGAN_GROUPS = {"batch norm": r"\bbn::", "update": r"multi_tensor|mt::",
                "convolution": r"conv|cudnn|sm90_xmma|implicit|gemm|nvjet"}
# phase 11, the DCGAN iteration on the card (f32, TF32 off) against the
# same port on the CPU: BERT's f32 limits (PERF.md section 2)
TOL_DCGAN_LOSS_REL = 1e-4
TOL_DCGAN_GRAD_REL = 1e-3
# D's Adam step there, card against CPU (dcgan_d_step): an element's
# gradient is settled where the two differ by at most an eighth of the
# CPU's; at most DCGAN_D_UNSETTLED of D's 2765568 are not
DCGAN_D_SETTLED = 8
DCGAN_D_UNSETTLED = 128
# phase 11's sweep, card against CPU, relative Frobenius error of the
# output and of each gradient: f32 (TF32 off) 1e-5; convolutions, CTC and
# reductions over more than 1e4 terms, in the forward or in a gradient (a
# norm's gamma and beta gradients sum over N * H * W) 1e-4; bf16 on the card against f32
# on the card on the same (rounded) inputs 2e-2, the output and the
# gradients, but the output alone for the clamped activations
# (HardSigmoid, HardSwish), whose derivative steps where alpha * x + beta
# crosses 0 or 1: a bf16 rounding moves ~0.2% of N(0, 2) inputs across,
# each taking its whole gradient with it (~4e-2 measured)
TOL_SWEEP = 1e-5
TOL_SWEEP_LONG = 1e-4
TOL_SWEEP_BF16 = 2e-2


def dcgan_nets(nn, nz, ngf, ndf, nc):
    """The example's generator and discriminator as its script builds them
    (``nn.Sequential``; shapes given, as the port takes them)."""
    netG = nn.Sequential()
    cin = nz
    for i, c in enumerate((ngf * 8, ngf * 4, ngf * 2, ngf)):
        netG.add(nn.Conv2DTranspose(c, 4, 1 if i == 0 else 2,
                                    0 if i == 0 else 1, use_bias=False,
                                    in_channels=cin),
                 nn.BatchNorm(in_channels=c), nn.Activation("relu"))
        cin = c
    netG.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False,
                                in_channels=ngf), nn.Activation("tanh"))
    netD = nn.Sequential()
    netD.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False, in_channels=nc),
             nn.LeakyReLU(0.2))
    cin = ndf
    for c in (ndf * 2, ndf * 4, ndf * 8):
        netD.add(nn.Conv2D(c, 4, 2, 1, use_bias=False, in_channels=cin),
                 nn.BatchNorm(in_channels=c), nn.LeakyReLU(0.2))
        cin = c
    netD.add(nn.Conv2D(1, 4, 1, 0, use_bias=False, in_channels=ndf * 8))
    return netG, netD


def dcgan_weights(net, seed):
    """The example's ``initialize(mx.init.Normal(0.02))``: convolutions
    N(0, 0.02) from ``seed``, the BatchNorms' own ones and zeros."""
    import numpy as np
    rng = np.random.RandomState(seed)
    fill = {"gamma": 1.0, "running_var": 1.0}
    return {k: (rng.normal(0, 0.02, p.shape) if k.endswith("weight") else
                np.full(p.shape, fill.get(k.rsplit(".", 1)[1], 0.0)))
            .astype("float32") for k, p in net.collect_params().items()}


def dcgan_setup(torch, dev, params):
    """Both nets on ``dev`` from ``params``, their Adam trainers and the
    loss."""
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon import Trainer, loss, nn
    netG, netD = dcgan_nets(nn, **DCGAN)
    load_jax_params(netG.to(dev), params[0])
    load_jax_params(netD.to(dev), params[1])
    trD = Trainer(netD.collect_params(), "adam", dict(DCGAN_ADAM))
    trG = Trainer(netG.collect_params(), "adam", dict(DCGAN_ADAM))
    return netG, netD, trD, trG, loss.SigmoidBCELoss()


def dcgan_iteration(torch, nets, real, noise, grads=False, d_after=None,
                    d_step=None):
    """The example's loop body: D on the real batch (label 1) and on
    ``G(z).detach()`` (label 0), ``trainerD.step``; G through D (label 1),
    ``trainerG.step``. Returns errD, errG and, with ``grads``, the
    gradients of D's step and of G's step by parameter name. ``d_step``: a
    dict that takes D's trained parameters after its step, on the CPU, by
    name. ``d_after``: D's parameters by name, loaded into D after its step
    (the G step then goes through those weights)."""
    from mxnet_tpu_torch import autograd
    netG, netD, trD, trG, loss = nets
    B = real.shape[0]
    ones = torch.ones(B, device=real.device)
    zeros = torch.zeros(B, device=real.device)

    def taken(net):
        return {k: p.grad().detach().cpu().clone() for k, p in
                net.collect_params().items() if p.grad_req != "null"} \
            if grads else None

    with autograd.record():
        err_real = loss(netD(real).reshape((-1, 1)), ones)
        fake = netG(noise)
        err_fake = loss(netD(fake.detach()).reshape((-1, 1)), zeros)
        errD = err_real + err_fake
    autograd.backward(errD)
    gD = taken(netD)
    trD.step(B)
    if d_step is not None:
        d_step.update({k: p.data().detach().cpu().clone() for k, p in
                       netD.collect_params().items() if p.grad_req != "null"})
    if d_after is not None:
        with torch.no_grad():
            for k, p in netD.collect_params().items():
                if k in d_after:
                    p.data().copy_(d_after[k].to(p.data().device))
    with autograd.record():
        errG = loss(netD(netG(noise)).reshape((-1, 1)), ones)
    autograd.backward(errG)
    gG = taken(netG)
    trG.step(B)
    return errD.detach(), errG.detach(), gD, gG


def dcgan_data(torch, B, seed, dev):
    """Synthetic images in [-1, 1] (the example's normalized batch) and
    the noise, drawn on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    real = torch.rand((B, DCGAN["nc"], 64, 64), generator=gen,
                      device=dev) * 2 - 1
    noise = torch.randn((B, DCGAN["nz"], 1, 1), generator=gen, device=dev)
    return real, noise


def dcgan_d_step(before, got, want, g_got, g_want):
    """D's Adam step, ``got`` against ``want`` (D's parameters after it, by
    name, from the same ``before``): ``(err, name, unsettled)``, the worst
    relative error of a tensor's update (after less before) over its
    settled elements, and the count of the others. An element is settled
    where ``g_got`` differs from its gradient in ``g_want`` by at most
    1 / DCGAN_D_SETTLED of it. Adam's first step moves a weight by lr *
    g / (|g| + eps'), eps' = eps / sqrt(1 - beta2) on the rescaled g: by
    about lr times g's sign, and, where |g| is within a few eps', by an
    amount that rounding of g moves; an unsettled gradient is rounding's
    in its sign or its size."""
    worst, unsettled = (0.0, None), 0
    for k, w in want.items():
        g = g_want[k].float()
        keep = g.abs() >= DCGAN_D_SETTLED * (g_got[k].float() - g).abs()
        b = before[k].float()
        worst = max(worst, (rel((got[k].float() - b)[keep],
                                (w.float() - b)[keep]), k))
        unsettled += int((~keep).sum())
    return worst[0], worst[1], unsettled


def dcgan_parity(torch, dev, params):
    """One iteration at B = 8, f32, on the card and on the CPU from the
    same weights and data: losses and every gradient within the limits.
    D's step is held to the CPU's by :func:`dcgan_d_step`: its update
    within TOL_DCGAN_GRAD_REL where the gradient's sign is settled, and at
    most DCGAN_D_UNSETTLED elements where it is not. G's step then goes
    through the same D on both: the CPU's D after its step. Adam's first
    step moves each weight by about lr times the sign of its gradient, so
    a D gradient within rounding of 0 whose sign differs moves that weight
    2 lr apart and G's gradients with it: one such sign flips between 1
    and 3 CPU threads on the same CPU and puts G's 10.gamma 8.5e-3 apart
    (``tools/torch_dcgan_parity.py``)."""
    real, noise = dcgan_data(torch, B_DCGAN_PARITY, 11, "cpu")
    out, d_after, d_card = {}, None, {}
    for where in ("cpu", dev):
        nets = dcgan_setup(torch, where, params)
        out[str(where)] = dcgan_iteration(
            torch, nets, real.to(where), noise.to(where), grads=True,
            d_after=d_after, d_step=None if d_after is None else d_card)
        if d_after is None:
            d_after = {k: p.data().detach().clone() for k, p in
                       nets[1].collect_params().items()
                       if p.grad_req != "null"}
    (cD, cG, cgD, cgG), (gD, gG, ggD, ggG) = out["cpu"], out[str(dev)]
    loss_err = max(rel(gD.cpu(), cD), rel(gG.cpu(), cG))
    grad_err = max((rel(g[k], c[k]), k) for g, c in ((ggD, cgD), (ggG, cgG))
                   for k in c)
    before = {k: torch.from_numpy(v) for k, v in params[1].items()}
    step_err, step_name, unsettled = dcgan_d_step(before, d_card, d_after,
                                                  ggD, cgD)
    if loss_err > TOL_DCGAN_LOSS_REL or grad_err[0] > TOL_DCGAN_GRAD_REL \
            or step_err > TOL_DCGAN_GRAD_REL or unsettled > DCGAN_D_UNSETTLED:
        fail(f"phase 11: DCGAN card against CPU at B={B_DCGAN_PARITY}: "
             f"losses rel {loss_err:.3e} (limit {TOL_DCGAN_LOSS_REL}), worst "
             f"gradient {grad_err[1]} rel {grad_err[0]:.3e}, worst of D's "
             f"updates {step_name} rel {step_err:.3e} (limits "
             f"{TOL_DCGAN_GRAD_REL}), {unsettled} unsettled elements (limit "
             f"{DCGAN_D_UNSETTLED})")
    print(f"phase 11: DCGAN one iteration at B={B_DCGAN_PARITY} f32 (TF32 "
          f"off), card against CPU: errD / errG rel {loss_err:.3e} (limit "
          f"{TOL_DCGAN_LOSS_REL}); worst of {len(cgD) + len(cgG)} gradients "
          f"{grad_err[1]} rel {grad_err[0]:.3e}; worst of D's {len(cgD)} "
          f"updates {step_name} rel {step_err:.3e} (limits "
          f"{TOL_DCGAN_GRAD_REL}), {unsettled} unsettled elements (limit "
          f"{DCGAN_D_UNSETTLED})", flush=True)


def dcgan_train(torch, dev, params):
    """The main path: DCGAN_ITERS iterations at B = 64 on the card, the
    launch counts from 0 (asserted an iteration); the losses finite and
    every parameter moved; iteration ms and img/s (mean of iterations
    3-10, host clock to a synchronize); busy ms and idle share of one
    primed profiled iteration; peak memory. Returns the launches."""
    from mxnet_tpu_torch.ops.cuda import batch_norm as bn
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    mods = (bn, mt)
    nets = dcgan_setup(torch, dev, params)
    real, noise = dcgan_data(torch, B_DCGAN, 12, dev)
    start = {k: p.data().detach().clone() for net in nets[:2]
             for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    for m in mods:
        reset_counts(m)                     # the main path starts here
    times, losses = [], []
    for i in range(DCGAN_ITERS):
        before = counts_now(mods)
        torch.cuda.synchronize()
        t = time.perf_counter()
        errD, errG, _, _ = dcgan_iteration(torch, nets, real, noise)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        moved = {n: c - before[n] for n, c in counts_now(mods).items()}
        want = {n: DCGAN_STEP.get(n, 0) + (DCGAN_FIRST_EXTRA.get(n, 0)
                                           if i == 0 else 0) for n in moved}
        if moved != want:
            fail(f"phase 11: DCGAN iteration {i}: launches {moved}, "
                 f"expected {want}")
        losses.append((errD.mean().item(), errG.mean().item()))
        if not all(math.isfinite(v) for v in losses[-1]):
            fail(f"phase 11: DCGAN iteration {i}: losses {losses[-1]}")
    counts = counts_now(mods)               # ... and ends here
    still = [k for net in nets[:2] for k, p in net.collect_params().items()
             if p.grad_req != "null" and torch.equal(p.data(),
                                                     start[k].to(dev))]
    if still:
        fail(f"phase 11: DCGAN parameters that did not move: {still}")
    ms = 1e3 * sum(times[2:]) / len(times[2:])
    torch.cuda.reset_peak_memory_stats(dev)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        primer()
        torch.cuda.synchronize()
        t = time.perf_counter()
        dcgan_iteration(torch, nets, real, noise)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy, idle = device_breakdown(
        prof, wall_ms, "phase 11: a primed profiled DCGAN iteration",
        DCGAN_GROUPS, drop="bitwise_not")
    print(f"phase 11: DCGAN (nz {DCGAN['nz']}, ngf = ndf = {DCGAN['ngf']}, "
          f"64x64) B={B_DCGAN} f32, Adam lr 2e-4 beta1 0.5: losses (errD, "
          f"errG) {[(round(a, 4), round(b, 4)) for a, b in losses]}, every "
          f"trained parameter moved; iteration {ms:.3f} ms (mean of "
          f"iterations 3-{DCGAN_ITERS}, host clock to a synchronize), "
          f"{B_DCGAN / ms * 1e3:.1f} img/s; device busy {fmt_ms(busy)}, "
          f"idle share {'not measured' if idle is None else f'{idle:.3f}'} "
          f"(one primed profiled iteration, wall {wall_ms:.3f} ms); peak "
          f"memory {peak:.3f} GiB; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}; launches in the run {counts} "
          f"({DCGAN_STEP} an iteration, the first +{DCGAN_FIRST_EXTRA}); "
          f"card: {smi_line()}", flush=True)
    del nets
    torch.cuda.empty_cache()
    return counts


def dcgan_kernel_rows(torch, dev, params):
    """BatchNorm's kernels at DCGAN's shapes (f32, B = 64) against their
    plain versions, timed with L2 flushed (the tensors, 0.5-17 MB, fit in
    L2, and the bound is at the HBM rate), and per iteration (each shape
    weighted by its launches); the update kernel over the generator's and
    the discriminator's parameters (f32, Adam; one launch each an
    iteration). Returns {kernel: row} of the per-iteration totals."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.ops.cuda import batch_norm as bn
    gen = torch.Generator(device=dev).manual_seed(13)
    errs, rows = {}, {n: {} for n in BN_KERNELS}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "events_ms")
    for C, M, nf, nb in DCGAN_BN_SHAPES:
        rplan = bn.bn_reduce_plan(B_DCGAN, C, M, torch.float32)
        print(f"phase 11: batch norm reductions' plan at C={C} M={M}: "
              f"{rplan}", flush=True)
        if rplan["splits"] != 1:
            fail(f"DCGAN C={C} M={M}: the reductions take the second "
                 f"level {rplan}")
        r, _ = bn_check(torch, bn, f"f32 N={B_DCGAN} C={C} M={M} (DCGAN)",
                        bn_case(torch, dev, gen, B_DCGAN, C, M,
                                torch.float32), errs, timed=True, cold=True)
        for name in BN_KERNELS:
            k = nf if name in ("bn_stats", "bn_apply") else nb
            for key in keys:
                v, acc = r[name][key], rows[name].get(key, 0.0)
                rows[name][key] = None if v is None or acc is None \
                    else acc + k * v
            rows[name]["bound_by"] = r[name]["bound_by"]
    for name, row in rows.items():
        row["max_abs_err"] = errs[name]
        if row["ms"] is None:
            row["ms"] = row["events_ms"]
        print(f"phase 11: {name} per DCGAN iteration ({DCGAN_STEP[name]} "
              f"launches): {fmt_ms(row['ms'])} device, bound "
              f"{row['bound_ms']:.4f} ms, plain {fmt_ms(row['plain_ms'])}, "
              f"library {fmt_ms(row['library_ms'])}", flush=True)
    # the update kernel on both of the main path's parameter sets: D's in
    # trainerD.step, G's in trainerG.step
    upd = []
    for side, net in zip(("generator", "discriminator"),
                         dcgan_nets(nn, **DCGAN)):
        case = dict(name=f"DCGAN {side} Adam f32, one group", opt="adam",
                    kw=DCGAN_ADAM, shapes=None, dtype="float32",
                    master=False, agg=0)
        upd.append(update_check(torch, dev, case, model_shapes(net),
                                timed=True))
    rows["multi_tensor_update"] = {
        k: None if None in (upd[0][k], upd[1][k]) else upd[0][k] + upd[1][k]
        for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    rows["multi_tensor_update"].update(max_abs_err=0.0, bound_by="bytes")
    torch.cuda.empty_cache()
    return rows



class SweepCase:
    """One operator, layer or loss of phase 11's sweep: ``fn(*args)`` or
    ``block(*args)``; ``make(n, gen)`` its inputs at batch ``n`` on the
    generator's device (float ones take gradients); compared at
    ``n_cmp`` on the card and the CPU, timed at ``n_full`` on the card;
    ``bf16``: also run in bf16 against f32 ('forward': the output
    alone)."""

    def __init__(self, name, size, make, n_full, n_cmp=None, fn=None,
                 block=None, tol=TOL_SWEEP, bf16=False, grad=True,
                 train=False):
        self.name, self.size, self.make = name, size, make
        self.n_full, self.n_cmp = n_full, n_cmp or n_full
        self.fn, self.block, self.tol = fn, block, tol
        self.bf16, self.grad, self.train = bf16, grad, train

    def __call__(self, block, *xs):
        """The operator, or ``block``, on ``xs`` (in training mode for a
        layer whose forward depends on it)."""
        from mxnet_tpu_torch import autograd
        fn = block if block is not None else self.fn
        if self.train:
            with autograd.train_mode():
                return fn(*xs)
        return fn(*xs)


def rel64(got, want) -> float:
    """Relative Frobenius error in f64 (a masked log-softmax holds values
    near f32's lowest, whose squares f32 cannot hold)."""
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()


def sweep_cases(torch):
    """Phase 11's sweep: every operator, layer and loss of Queue A 6 at a
    size its users run."""
    from mxnet_tpu_torch import npx
    from mxnet_tpu_torch.gluon import contrib, loss, nn
    L = TOL_SWEEP_LONG

    def randn(gen, *shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=gen.device) * scale

    def rand(gen, *shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=gen.device) \
            * (hi - lo) + lo

    def randint(gen, lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=gen.device)

    def bert_act(n, gen):               # BERT-base's FFN activation
        return [randn(gen, n, 512, 3072, scale=2.0)]

    def signs(gen, *shape):
        return torch.where(rand(gen, *shape) > 0.5, 1.0, -1.0)

    C = []
    act = "BERT-base FFN (8, 512, 3072)"
    for name, block in (
            ("LeakyReLU (npx.leaky_relu)", lambda: nn.LeakyReLU(0.2)),
            ("PReLU (npx.prelu)", lambda: nn.PReLU(in_channels=3072)),
            ("ELU (npx.elu)", lambda: nn.ELU(0.5)),
            ("SELU (npx.selu)", lambda: nn.SELU()),
            ("GELU erf", lambda: nn.GELU()),
            ("GELU tanh", lambda: nn.GELU("tanh")),
            ("Swish / SiLU (npx.silu)", lambda: nn.Swish()),
            ("Swish beta 1.5", lambda: nn.Swish(1.5)),
            ("Mish (npx.mish)", lambda: nn.Mish()),
            ("HardSigmoid (npx.hard_sigmoid)", lambda: nn.HardSigmoid()),
            ("HardSwish (npx.hard_swish)", lambda: nn.HardSwish())):
        C.append(SweepCase(name, act, bert_act, 8, block=block,
                           bf16="forward" if "Hard" in name else True))
    for name in ("softrelu", "softsign", "log_sigmoid"):
        C.append(SweepCase(f"npx.{name}", act, bert_act, 8,
                           fn=getattr(npx, name), bf16=True))
    C += [
        SweepCase("npx.leaky_relu act_type elu", act, bert_act, 8,
                  fn=lambda x: npx.leaky_relu(x, 0.3, "elu"), bf16=True),
        SweepCase("npx.softmax temperature 2", act, bert_act, 8,
                  fn=lambda x: npx.softmax(x, temperature=2.0), bf16=True),
        SweepCase("npx.softmax length", act, lambda n, g: bert_act(n, g) + [
            randint(g, 1024, 3073, n)], 8, fn=lambda x, ln: npx.softmax(
                x, length=ln), bf16=True),
        SweepCase("npx.masked_log_softmax", act, lambda n, g: bert_act(n, g)
                  + [rand(g, n, 1, 3072) > 0.1], 8,
                  fn=npx.masked_log_softmax, bf16=True),
        SweepCase("npx.masked_softmax key padding",
                  "BERT-base scores (8, 12, 512, 512)", lambda n, g: [
                      randn(g, n, 12, 512, 512, scale=3.0),
                      torch.arange(512, device=g.device)[None, None, None]
                      < randint(g, 64, 513, n, 1, 1, 1)], 8,
                  fn=npx.masked_softmax, bf16=True),
        SweepCase("npx.rms_norm", act, lambda n, g: bert_act(n, g) + [
            rand(g, 3072, lo=0.5, hi=1.5)], 8, fn=npx.rms_norm, bf16=True),
        SweepCase("GroupNorm(32) (npx.group_norm)", "(32, 256, 56, 56)",
                  lambda n, g: [randn(g, n, 256, 56, 56) + 0.5], 32, 8,
                  block=lambda: nn.GroupNorm(32, in_channels=256), tol=L,
                  bf16=True),
        SweepCase("InstanceNorm (npx.instance_norm)", "(32, 256, 56, 56)",
                  lambda n, g: [randn(g, n, 256, 56, 56) + 0.5], 32, 8,
                  block=lambda: nn.InstanceNorm(in_channels=256), tol=L,
                  bf16=True),
        SweepCase("SyncBatchNorm training (BatchNorm's kernels)",
                  "(32, 256, 56, 56)", lambda n, g: [randn(g, n, 256, 56, 56)],
                  32, 8, block=lambda: nn.SyncBatchNorm(in_channels=256),
                  tol=L, train=True),
        SweepCase("npx.lrn", "AlexNet conv1 (128, 96, 55, 55)",
                  lambda n, g: [randn(g, n, 96, 55, 55, scale=3.0)], 128, 16,
                  fn=lambda x: npx.lrn(x, 1e-4, 0.75, 2.0, 5), bf16=True)]
    for mode, tol in (("instance", L), ("channel", TOL_SWEEP),
                      ("spatial", TOL_SWEEP)):
        C.append(SweepCase(f"npx.l2_normalization {mode}",
                           "SSD conv4_3 (32, 512, 38, 38)",
                           lambda n, g: [randn(g, n, 512, 38, 38)], 32, 8,
                           fn=lambda x, m=mode: npx.l2_normalization(
                               x, mode=m), tol=tol))
    C += [
        SweepCase("Conv1D k=3 (npx.convolution)", "(32, 512, 1024)",
                  lambda n, g: [randn(g, n, 512, 1024)], 32, 2,
                  block=lambda: nn.Conv1D(512, 3, padding=1,
                                          in_channels=512), tol=L, bf16=True),
        SweepCase("Conv3D k=3", "(8, 64, 16, 56, 56)",
                  lambda n, g: [randn(g, n, 64, 16, 56, 56)], 8, 1,
                  block=lambda: nn.Conv3D(64, 3, padding=1, in_channels=64),
                  tol=L, bf16=True)]
    cin = DCGAN["nz"]
    for i, (c, hw) in enumerate(((512, 1), (256, 4), (128, 8), (64, 16),
                                 (3, 32))):
        k = 64 if i == 4 else c
        C.append(SweepCase(
            f"Conv2DTranspose {cin}->{c} (npx.deconvolution)",
            f"DCGAN G layer {i + 1} ({B_DCGAN}, {cin}, {hw}, {hw})",
            lambda n, g, ci=cin, s=hw: [randn(g, n, ci, s, s)], B_DCGAN, 8,
            block=lambda ci=cin, co=c, first=i == 0: nn.Conv2DTranspose(
                co, 4, 1 if first else 2, 0 if first else 1, use_bias=False,
                in_channels=ci), tol=L, bf16=True))
        cin = k
    C += [
        SweepCase("Conv1DTranspose k=4 s=2", "(32, 512, 1024)",
                  lambda n, g: [randn(g, n, 512, 1024)], 32, 2,
                  block=lambda: nn.Conv1DTranspose(256, 4, 2, 1,
                                                   in_channels=512),
                  tol=L, bf16=True),
        SweepCase("Conv3DTranspose k=4 s=2", "(8, 64, 8, 28, 28)",
                  lambda n, g: [randn(g, n, 64, 8, 28, 28)], 8, 1,
                  block=lambda: nn.Conv3DTranspose(32, 4, 2, 1,
                                                   in_channels=64),
                  tol=L, bf16=True),
        SweepCase("npx.adaptive_avg_pool2d", "ResNet-50 head (32, 2048, 7, 7)",
                  lambda n, g: [randn(g, n, 2048, 7, 7)], 32,
                  fn=lambda x: npx.adaptive_avg_pool2d(x, 1)),
        SweepCase("npx.roi_pooling 7x7", "Fast R-CNN (2, 512, 38, 50), "
                  "128 ROIs", lambda n, g: [randn(g, 2, 512, 38, 50), torch.cat(
                      [randint(g, 0, 2, n, 1).float(),
                       rand(g, n, 2, hi=500.0),
                       rand(g, n, 2, lo=100.0, hi=300.0)], 1)], 128, 16,
                  fn=lambda x, r: npx.roi_pooling(
                      x, torch.cat([r[:, :3], r[:, 1:3] + r[:, 3:]], 1),
                      (7, 7), 1 / 16)),
        SweepCase("npx.up_sampling nearest x2", "(8, 256, 32, 32)",
                  lambda n, g: [randn(g, n, 256, 32, 32)], 8,
                  fn=lambda x: npx.up_sampling(x, 2), bf16=True),
        SweepCase("npx.up_sampling bilinear x2", "(8, 256, 32, 32)",
                  lambda n, g: [randn(g, n, 256, 32, 32)], 8,
                  fn=lambda x: npx.up_sampling(x, 2, "bilinear"), bf16=True)]
    tnc = "(T=512, N=32, 1024) TNC, lengths 64-512"

    def seq(n, g):
        return [randn(g, 512, n, 1024), randint(g, 64, 513, n)]
    for name in ("sequence_mask", "sequence_last", "sequence_reverse"):
        C.append(SweepCase(f"npx.{name}", tnc, seq, 32,
                           fn=lambda x, ln, f=getattr(npx, name): f(
                               x, ln, use_sequence_length=True)))
    C += [
        SweepCase("npx.topk_mask k=50", "BERT vocabulary (64, 30522)",
                  lambda n, g: [randn(g, n, 30522)], 64,
                  fn=lambda x: npx.topk_mask(x, 50), grad=False),
        SweepCase("npx.smooth_l1", act, bert_act, 8,
                  fn=lambda x: npx.smooth_l1(x, 1.0)),
        SweepCase("npx.arange_like", act, bert_act, 8, fn=npx.arange_like,
                  grad=False),
        SweepCase("npx.softmax_output", "ImageNet logits (256, 1000)",
                  lambda n, g: [randn(g, n, 1000), randint(g, -1, 1000, n)],
                  256, fn=lambda x, lab: npx.softmax_output(
                      x, lab, use_ignore=True, normalization="valid")),
        SweepCase("npx.linear_regression_output", "(1024, 256)",
                  lambda n, g: [randn(g, n, 256), randn(g, n, 256)], 1024,
                  fn=npx.linear_regression_output),
        SweepCase("npx.mae_regression_output", "(1024, 256)",
                  lambda n, g: [randn(g, n, 256), randn(g, n, 256)], 1024,
                  fn=npx.mae_regression_output),
        SweepCase("npx.logistic_regression_output", "(1024, 256)",
                  lambda n, g: [randn(g, n, 256), rand(g, n, 256)], 1024,
                  fn=npx.logistic_regression_output),
        SweepCase("npx.make_loss", "(1024, 256)",
                  lambda n, g: [randn(g, n, 256)], 1024,
                  fn=lambda x: npx.make_loss(x, normalization="batch")),
        SweepCase("npx.interleaved_matmul_selfatt_qk",
                  "BERT-base (T=512, N=8, 2304)",
                  lambda n, g: [randn(g, 512, n, 2304)], 8,
                  fn=lambda x: npx.interleaved_matmul_selfatt_qk(x, 12),
                  bf16=True),
        SweepCase("npx.interleaved_matmul_selfatt_valatt",
                  "BERT-base (512, 8, 2304), (96, 512, 512)",
                  lambda n, g: [randn(g, 512, n, 2304),
                                rand(g, n * 12, 512, 512) / 256], 8,
                  fn=lambda x, a: npx.interleaved_matmul_selfatt_valatt(
                      x, a, 12), bf16=True),
        SweepCase("npx.interleaved_matmul_encdec_qk",
                  "transformer_base (128, 32, 512), (128, 32, 1024)",
                  lambda n, g: [randn(g, 128, n, 512), randn(g, 128, n, 1024)],
                  32, fn=lambda q, kv: npx.interleaved_matmul_encdec_qk(
                      q, kv, 8), bf16=True),
        SweepCase("npx.interleaved_matmul_encdec_valatt",
                  "transformer_base (128, 32, 1024), (256, 128, 128)",
                  lambda n, g: [randn(g, 128, n, 1024),
                                rand(g, n * 8, 128, 128) / 64], 32,
                  fn=lambda kv, a: npx.interleaved_matmul_encdec_valatt(
                      kv, a, 8), bf16=True)]
    c1, c3 = "(32, 512, 1024)", "(8, 64, 16, 56, 56)"

    def x1(n, g):
        return [randn(g, n, 512, 1024)]

    def x3(n, g):
        return [randn(g, n, 64, 16, 56, 56)]
    C += [
        SweepCase("MaxPool1D", c1, x1, 32, block=lambda: nn.MaxPool1D()),
        SweepCase("AvgPool1D", c1, x1, 32, block=lambda: nn.AvgPool1D()),
        SweepCase("MaxPool3D", c3, x3, 8, 2, block=lambda: nn.MaxPool3D()),
        SweepCase("AvgPool3D", c3, x3, 8, 2, block=lambda: nn.AvgPool3D()),
        SweepCase("GlobalMaxPool1D", c1, x1, 32,
                  block=lambda: nn.GlobalMaxPool1D()),
        SweepCase("GlobalMaxPool2D", "ResNet-50 head (32, 2048, 7, 7)",
                  lambda n, g: [randn(g, n, 2048, 7, 7)], 32,
                  block=lambda: nn.GlobalMaxPool2D()),
        SweepCase("GlobalMaxPool3D", c3, x3, 8, 2,
                  block=lambda: nn.GlobalMaxPool3D()),
        SweepCase("GlobalAvgPool1D", c1, x1, 32,
                  block=lambda: nn.GlobalAvgPool1D()),
        SweepCase("GlobalAvgPool3D", c3, x3, 8, 2, tol=L,
                  block=lambda: nn.GlobalAvgPool3D()),
        SweepCase("ReflectionPad2D(1)", "CycleGAN block (8, 256, 64, 64)",
                  lambda n, g: [randn(g, n, 256, 64, 64)], 8,
                  block=lambda: nn.ReflectionPad2D(1)),
        SweepCase("PixelShuffle1D(2)", c1, x1, 32,
                  block=lambda: contrib.nn.PixelShuffle1D(2)),
        SweepCase("PixelShuffle2D(2)", "ESPCN (16, 256, 64, 64)",
                  lambda n, g: [randn(g, n, 256, 64, 64)], 16,
                  block=lambda: contrib.nn.PixelShuffle2D(2)),
        SweepCase("PixelShuffle3D(2)", "(8, 512, 8, 28, 28)",
                  lambda n, g: [randn(g, n, 512, 8, 28, 28)], 8, 2,
                  block=lambda: contrib.nn.PixelShuffle3D(2))]

    def branches(cls):
        net = cls(axis=1)
        net.add(nn.Conv2D(64, 1, in_channels=256), nn.Identity(),
                nn.Conv2D(32, 3, padding=1, in_channels=256))
        return net
    inception = "Inception branches (32, 256, 28, 28)"
    for name, cls in (("HybridConcurrent", contrib.nn.HybridConcurrent),
                      ("Concurrent", contrib.nn.Concurrent),
                      ("HybridConcatenate / Concatenate",
                       nn.HybridConcatenate)):
        C.append(SweepCase(name, inception,
                           lambda n, g: [randn(g, n, 256, 28, 28)], 32, 8,
                           block=lambda c=cls: branches(c), tol=L))
    C += [
        SweepCase("Identity", act, bert_act, 8, block=lambda: nn.Identity(),
                  grad=False),
        SweepCase("Lambda('tanh')", act, bert_act, 8,
                  block=lambda: nn.Lambda("tanh")),
        SweepCase("HybridLambda(x * x)", act, bert_act, 8,
                  block=lambda: nn.HybridLambda(lambda x: x * x))]
    cls1000 = "(1024, 1000)"

    def pl(n, g):
        return [randn(g, n, 1000, scale=2.0), randn(g, n, 1000)]
    C += [
        SweepCase("L1Loss", cls1000, pl, 1024, block=lambda: loss.L1Loss()),
        SweepCase("SigmoidBCELoss pos_weight", "multi-label (1024, 1000)",
                  lambda n, g: [randn(g, n, 1000, scale=2.0),
                                (rand(g, n, 1000) > 0.9).float(), None,
                                rand(g, 1000, lo=1.0, hi=5.0)], 1024,
                  block=lambda: loss.SigmoidBCELoss()),
        SweepCase("KLDivLoss from logits", "distillation (1024, 1000)",
                  lambda n, g: [randn(g, n, 1000, scale=2.0),
                                torch.softmax(randn(g, n, 1000), -1)], 1024,
                  block=lambda: loss.KLDivLoss(from_logits=False)),
        SweepCase("HuberLoss", cls1000, pl, 1024,
                  block=lambda: loss.HuberLoss()),
        SweepCase("HingeLoss", cls1000, lambda n, g: [
            randn(g, n, 1000), signs(g, n, 1000)], 1024,
                  block=lambda: loss.HingeLoss()),
        SweepCase("SquaredHingeLoss", cls1000, lambda n, g: [
            randn(g, n, 1000), signs(g, n, 1000)], 1024,
                  block=lambda: loss.SquaredHingeLoss()),
        SweepCase("LogisticLoss", cls1000, lambda n, g: [
            randn(g, n, 1000), signs(g, n, 1000)], 1024,
                  block=lambda: loss.LogisticLoss()),
        SweepCase("TripletLoss", "embeddings (1024, 128)", lambda n, g: [
            randn(g, n, 128), randn(g, n, 128), randn(g, n, 128)], 1024,
                  block=lambda: loss.TripletLoss()),
        SweepCase("CosineEmbeddingLoss", "(1024, 512)", lambda n, g: [
            randn(g, n, 512), randn(g, n, 512), signs(g, n)], 1024,
                  block=lambda: loss.CosineEmbeddingLoss()),
        SweepCase("PoissonNLLLoss", cls1000, lambda n, g: [
            randn(g, n, 1000), torch.poisson(rand(g, n, 1000, hi=4.0),
                                             generator=g)], 1024,
                  block=lambda: loss.PoissonNLLLoss(), tol=L),
        SweepCase("SDMLLoss", "(256, 512)", lambda n, g: [
            randn(g, n, 512), randn(g, n, 512)], 256,
                  block=lambda: loss.SDMLLoss()),
        SweepCase("CTCLoss (npx.ctc_loss)",
                  "T=400, B=32, 29 classes, labels 20-100",
                  lambda n, g: [randn(g, n, 400, 29, scale=2.0),
                                randint(g, 1, 29, n, 100),
                                randint(g, 300, 401, n),
                                randint(g, 20, 101, n)], 32,
                  block=lambda: loss.CTCLoss(), tol=L)]
    return C


def sweep_run(torch, case, block, args):
    """Output and gradients (of the float arguments and the block's
    parameters; zeros where no gradient reaches one) of one call, for a
    random cotangent."""
    xs = [a.detach().clone().requires_grad_(
        case.grad and a.is_floating_point()) if a is not None else None
        for a in args]
    out = case(block, *xs)
    if not case.grad:
        return out, []
    leaves = sweep_leaves(xs, block)
    gen = torch.Generator(device="cpu").manual_seed(7)
    cot = torch.randn(out.shape, generator=gen).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, leaves, cot, allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if g is None else g
                          for x, g in zip(leaves, grads)]


def sweep_leaves(xs, block):
    """The tensors a sweep call differentiates: its float arguments and
    the trained parameters of its block."""
    leaves = [x for x in xs if x is not None and x.requires_grad]
    if block is not None:
        leaves += [p.data() for p in block.collect_params().values()
                   if p.grad_req != "null"]
    return leaves


def sweep_ms(fn):
    """Device ms a call of ``fn``: the median of three profiler sessions
    that recorded device time (a session can lose records and read low or
    nothing), None when none did."""
    runs = sorted(v for v in (device_ms(fn, iters=5) for _ in range(3))
                  if v)
    return runs[len(runs) // 2] if runs else None


def sweep_blocks(torch, case, dev):
    """The case's block on the CPU (parameters from a CPU generator) and a
    copy on the card with the same parameters; (None, None) for an
    operator."""
    if case.block is None:
        return None, None
    from mxnet_tpu_torch.convert import export_params, load_jax_params
    cpu = case.block()
    cpu.initialize(generator=torch.Generator().manual_seed(5), device="cpu")
    return cpu, load_jax_params(case.block().to(dev), export_params(cpu))


def sweep_one(torch, dev, case):
    """Card against CPU at ``n_cmp`` (f32; bf16 against f32 on the card),
    then the forward and the forward+backward timed at ``n_full``."""
    gen = torch.Generator(device="cpu").manual_seed(21)
    args = case.make(case.n_cmp, gen)
    on_dev = [None if a is None else a.to(dev) for a in args]
    cpu_block, dev_block = sweep_blocks(torch, case, dev)
    want, want_g = sweep_run(torch, case, cpu_block, args)
    got, got_g = sweep_run(torch, case, dev_block, on_dev)
    if got.dtype == torch.bool:
        err = 0.0 if torch.equal(got.cpu(), want) else 1.0
    else:
        err = max([rel64(got, want)] + [rel64(a, b)
                                         for a, b in zip(got_g, want_g)])
    if err > case.tol or not all(bool(t.isfinite().all()) for t in
                                 [got.float()] + list(got_g)):
        fail(f"phase 11: {case.name}: card against CPU rel {err:.3e} "
             f"(limit {case.tol})")
    err16 = None
    if case.bf16:
        half = [a.to(torch.bfloat16) if a is not None and
                a.is_floating_point() else a for a in on_dev]
        ref = [a.float() if a is not None and a.is_floating_point() else a
               for a in half]
        if dev_block is not None:
            dev_block.cast("bfloat16")
            b16, b16_g = sweep_run(torch, case, dev_block, half)
            dev_block.cast("float32")
        else:
            b16, b16_g = sweep_run(torch, case, None, half)
        f32, f32_g = sweep_run(torch, case, dev_block, ref)
        err16 = max([rel64(b16, f32)] + ([] if case.bf16 == "forward" else
                                         [rel64(a, b) for a, b in
                                          zip(b16_g, f32_g)]))
        if err16 > TOL_SWEEP_BF16:
            fail(f"phase 11: {case.name}: bf16 against f32 rel "
                 f"{err16:.3e} (limit {TOL_SWEEP_BF16})")
    del args, on_dev, want, want_g, got, got_g
    gdev = torch.Generator(device=dev).manual_seed(22)
    full = case.make(case.n_full, gdev)
    fwd_ms = sweep_ms(lambda: case(dev_block, *full))
    bwd_ms = None
    if case.grad:
        xs = [a.requires_grad_(True) if a is not None and
              a.is_floating_point() else a for a in full]
        leaves = sweep_leaves(xs, dev_block)
        cot = torch.randn(case(dev_block, *xs).shape, generator=gdev,
                          device=dev)
        bwd_ms = sweep_ms(lambda: torch.autograd.grad(
            case(dev_block, *xs), leaves, cot, allow_unused=True))
    print(f"phase 11: sweep {case.name} at {case.size}: card against CPU "
          f"(N={case.n_cmp}) rel {err:.3e} (limit {case.tol})"
          + ("" if err16 is None else f", bf16 against f32 rel "
             f"{err16:.3e} (limit {TOL_SWEEP_BF16}"
             + (", the output" if case.bf16 == "forward" else "") + ")")
          + f"; device ms forward {fmt_ms(fwd_ms)}, forward+backward "
          f"{fmt_ms(bwd_ms)} (N={case.n_full})", flush=True)
    del full
    torch.cuda.empty_cache()


def init_check(torch, dev):
    """The ported initializers drawing on the card: Orthogonal rows
    orthonormal to its scale, MSRAPrelu's variance Xavier's, Constant,
    Bilinear, LSTMBias and ``gluon.Constant`` equal to the CPU's bits."""
    from mxnet_tpu_torch import initializer as init
    from mxnet_tpu_torch.gluon import Constant
    gen = torch.Generator(device=dev).manual_seed(3)
    q = init.Orthogonal(1.414)((1024, 1024), gen, device=dev).double()
    orth = ((q @ q.T - 1.414 ** 2 * torch.eye(1024, device=dev,
                                               dtype=torch.float64)).abs()
            .max().item())
    w = init.MSRAPrelu()((256, 256, 3, 3), gen, device=dev)
    var = w.double().var().item() / (2.0 / (1 + 0.25 ** 2) / (256 * 9))
    cpu = torch.Generator().manual_seed(0)
    same = all(torch.equal(ini((2, 3, 4, 4), gen, device=dev).cpu(),
                           ini((2, 3, 4, 4), cpu))
               for ini in (init.Constant(0.3), init.Bilinear(),
                           init.LSTMBias(2.0)))
    c = Constant(torch.arange(6.0).reshape(2, 3))
    c.initialize(device=dev)
    if orth > 1e-5 or abs(var - 1) > 0.05 or not same or \
            c.data().device != dev or not torch.equal(
                c.data().cpu(), torch.arange(6.0).reshape(2, 3)):
        fail(f"phase 11: initializers on the card: Orthogonal |q q^T - "
             f"s^2 I| {orth:.2e}, MSRAPrelu variance / Xavier's {var:.4f}, "
             f"Constant / Bilinear / LSTMBias equal to the CPU's {same}, "
             f"gluon.Constant on {c.data().device}")
    print(f"phase 11: initializers on the card: Orthogonal (1024, 1024) "
          f"|q q^T - 1.414^2 I| {orth:.2e}; MSRAPrelu (256, 256, 3, 3) "
          f"variance / Xavier's formula {var:.4f}; Constant, Bilinear and "
          f"LSTMBias equal to the CPU's bits; gluon.Constant placed on "
          f"{c.data().device}", flush=True)


def phase_layers(torch, dev):
    """Phase 11: MXNet's Gluon DCGAN on the card (the B = 8 iteration
    against the CPU, the B = 64 main path with its launches, time and
    memory), its kernels' rows at its shapes, the initializers, and the
    sweep of every ported operator, layer and loss against the CPU.
    Returns (rows, launches)."""
    from mxnet_tpu_torch.gluon import nn
    t_phase = time.perf_counter()
    netG, netD = dcgan_nets(nn, **DCGAN)
    params = (dcgan_weights(netG, 0), dcgan_weights(netD, 1))
    dcgan_parity(torch, dev, params)
    launches = dcgan_train(torch, dev, params)
    rows = dcgan_kernel_rows(torch, dev, params)
    init_check(torch, dev)
    t = time.perf_counter()
    cases = sweep_cases(torch)
    for case in cases:
        sweep_one(torch, dev, case)
    print(f"phase 11: sweep of {len(cases)} operators, layers and losses in "
          f"{time.perf_counter() - t:.1f} s; phase done in "
          f"{time.perf_counter() - t_phase:.1f} s; card: {smi_line()}",
          flush=True)
    return rows, launches


# ------------------------------- phase 12: int8 ResNet-50, SSD box operators
# the main path (upstream MXNet's example/quantization flow): resnet50_v1,
# 1000 classes, f32 weights from a seed, quantize_net with naive
# calibration on 10 batches of 32 (the example's default), then entropy on
# 2 (cut from 10 to bound the phase's time: the numpy histograms and the
# KL sweep take ~0.3 s a layer a batch), forwards at B = 64, 224x224
B_QUANT, B_CALIB, CALIB_NAIVE, CALIB_ENTROPY, B_QUANT_CPU = 64, 32, 10, 2, 2
# int8 kernel launches a quantized ResNet-50 forward: 53 convolutions and
# the Dense layer
QUANT_STEP = 54
# the quantized net on the card against the port's int8 net on the CPU at
# B = 2, the card's calibrated ranges copied over (the int8 weights equal).
# Each quantized layer given the CPU layer's own input computes the CPU's
# bits (the int8 products are exact, the f32 operations around them the
# same), which is checked layer by layer. End to end, the f32 operations
# between the layers (BatchNorm's rsqrt, the average pool's sum) round
# differently on the card by an ulp; an activation within an ulp of a code
# boundary then takes the neighbouring code, a step of 1/127 of its
# layer's range, which moves codes downstream in turn: 1.056e-2 measured
# at B = 2 (first chip run; a limit of 1e-2 set before it was measured
# failed), so the logits are held to 5e-2
TOL_QUANT_CPU_REL = 5e-2
QUANT_INFO = {
    "int8_conv": ("mxnet_tpu_torch/csrc/int8_conv.cu",
                  "mxnet_tpu/ops/quantization.py:236 (quantized_conv; and "
                  ":183 quantized_fully_connected, XLA)"),
    "int8_conv_f32": ("mxnet_tpu_torch/csrc/int8_conv.cu",
                      "mxnet_tpu/contrib/quantization.py:189 (QuantizedConv"
                      ".forward; and :144 QuantizedDense.forward: "
                      "quantize_v2, the int8 product, dequantize, XLA)"),
    "box_nms": ("mxnet_tpu_torch/csrc/box_nms.cu",
                "mxnet_tpu/ops/boxes.py:114 (box_nms's lax.fori_loop, XLA)"),
}
INT8_KERNEL = r"conv_s8_wg"
NMS_KERNEL = r"nms::"
# library convolutions and products (kernel names, re.search): none may run
# in a quantized forward
LIB_KERNEL = (r"cudnn|cublas|gemm|gemv|nvjet|xmma|cutlass|implicit|winograd|"
              r"fprop|dgrad|wgrad|conv2d|convolve")
PEAK_INT8_OPS = 1979e12          # H100 SXM data sheet, dense int8
# shapes the main path does not run, each checked and timed: (label,
# layout, data, weight, stride, pad, dilate, groups)
INT8_EXTRA = (
    ("grouped 3x3, 32 groups (ResNeXt-50 stage 2)", "NCHW",
     (64, 256, 28, 28), (256, 8, 3, 3), (1, 1), (1, 1), (1, 1), 32),
    ("dilated 3x3, dilation 2 (DeepLab stage 4)", "NCHW",
     (16, 512, 28, 28), (512, 512, 3, 3), (1, 1), (2, 2), (2, 2), 1),
    ("1-d, k 5 (a speech frontend)", "NCW", (64, 256, 400), (256, 256, 5),
     (1,), (2,), (1,), 1),
    ("3-d 3x3x3 (C3D conv3)", "NCDHW", (8, 128, 8, 28, 28),
     (256, 128, 3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1), 1),
)
# SSD-300 (Liu et al., ECCV 2016) as GluonCV's ssd_300_vgg16_atrous_voc
# configures it: six feature maps, anchor sizes 30-315 over 300, ratios
# {1, 2, 1/2} or {1, 2, 1/2, 3, 1/3}, steps 8-300 over 300: 8732 anchors;
# VOC's 20 classes and background, B = 32, 64 label rows (1-40 valid)
SSD_MAPS = ((38, 8, (1, 2, 0.5)), (19, 16, (1, 2, 0.5, 3, 1 / 3)),
            (10, 32, (1, 2, 0.5, 3, 1 / 3)), (5, 64, (1, 2, 0.5, 3, 1 / 3)),
            (3, 100, (1, 2, 0.5)), (1, 300, (1, 2, 0.5)))
SSD_SIZES = (30, 60, 111, 162, 213, 264, 315)
SSD_ANCHORS, SSD_B, SSD_CLASSES, SSD_LABELS = 8732, 32, 21, 64
# the box operators on the card against the CPU: the same f32 formulas
# (every division an IEEE one on both); exp and log may differ by an ulp,
# so the encoded targets and decoded boxes at 1e-5, and a decoded box's
# IoU within an ulp of the 0.45 threshold may flip its keep bit: at most
# SSD_FLIPS rows of the detection's 32 x 8732
TOL_BOX_REL = 1e-5
SSD_FLIPS = 8


def quant_net(torch, dev, params, dtype=None):
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    return load_jax_params(get_model("resnet50_v1", device=dev), params,
                           dtype=dtype)


def quant_batches(torch, n, B, seed, dev):
    """``n`` synthetic batches of B images in [-1, 1] from ``seed`` (bench.py's
    synthetic batch)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.uniform(-1, 1, (B, 3, 224, 224)).astype(
        np.float32)).to(dev) for _ in range(n)]


def quant_layers(net):
    from mxnet_tpu_torch.contrib.quantization import (QuantizedConv,
                                                      QuantizedDense)
    return {k: m for k, m in net.named_modules()
            if isinstance(m, (QuantizedConv, QuantizedDense))}


def quant_forward_ms(torch, net, x, label):
    """Prints ms a forward (eager; then hybridized, replayed) by CUDA
    events, img/s, busy / idle of a primed profiled replay, peak memory."""
    from mxnet_tpu_torch.gluon.block import Block
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        eager = cuda_time_ms(lambda: Block.__call__(net, x), iters=5)
        net.hybridize()
        for _ in range(2):
            net(x)
        torch.cuda.reset_peak_memory_stats()
        replay = cuda_time_ms(lambda: net(x), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer()
            torch.cuda.synchronize()
            t = time.perf_counter()
            net(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    busy, idle = device_breakdown(
        prof, wall, f"phase 12: a primed profiled replay ({label})",
        {"int8 kernel": INT8_KERNEL, "library conv / GEMM": LIB_KERNEL},
        drop="bitwise_not")
    net.hybridize(False)
    B = x.shape[0]
    print(f"phase 12: {label} forward B={B}: eager {eager:.3f} ms, replayed "
          f"{replay:.3f} ms ({B / replay * 1e3:.1f} img/s; CUDA events); "
          f"busy {fmt_ms(busy)}, idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; peak "
          f"memory {peak:.3f} GiB", flush=True)


def quant_main_path(torch, dev, params):
    """The int8 ResNet-50 main path. Returns (launches, shapes): the int8
    kernel's launches of the eager forwards and {shape: launches a
    forward} of its convolutions and Dense layer."""
    import os
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.gluon.block import Block
    from mxnet_tpu_torch.ops.cuda import conv_fused as cf
    from mxnet_tpu_torch.ops.cuda import int8_conv as i8
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    net = quant_net(torch, dev, params)
    x = quant_batches(torch, 1, B_QUANT, 100, dev)[0]
    with torch.inference_mode():
        ref = Block.__call__(net, x).float()
    quant_forward_ms(torch, net, x, "f32 ResNet-50 (cuDNN)")
    calib = quant_batches(torch, CALIB_NAIVE, B_CALIB, 101, dev)
    t = time.perf_counter()
    quantize_net(net, calib_data=calib, calib_mode="naive")
    t_naive = time.perf_counter() - t
    layers = quant_layers(net)
    if len(layers) != QUANT_STEP:
        fail(f"phase 12: quantize_net swapped {len(layers)} layers in, not "
             f"{QUANT_STEP}")
    shapes = {}

    def record(m, args):
        q = m._cfg if hasattr(m, "_cfg") else None
        key = (tuple(args[0].shape), tuple(m.wq.shape),
               None if q is None else (q["stride"], q["pad"], q["dilate"],
                                       q["num_group"]))
        shapes[key] = shapes.get(key, 0) + 1
    hooks = [m.register_forward_pre_hook(record) for m in layers.values()]
    for mod in (i8, cf):
        reset_counts(mod)                   # the main path starts here
    copies0 = dict(i8.copies)
    outs = []
    knob0 = os.environ.get("MXNET_FUSE_BN_CONV")
    with torch.inference_mode():
        for knob in ("0", "1", "0"):
            os.environ["MXNET_FUSE_BN_CONV"] = knob
            before = sum(i8.launches.values())
            outs.append(net(x))
            torch.cuda.synchronize()
            n = sum(i8.launches.values()) - before
            if n != QUANT_STEP:
                fail(f"phase 12: a quantized forward (MXNET_FUSE_BN_CONV="
                     f"{knob}) launched the int8 kernel {n} times, not "
                     f"{QUANT_STEP}")
    if knob0 is None:
        os.environ.pop("MXNET_FUSE_BN_CONV", None)
    else:
        os.environ["MXNET_FUSE_BN_CONV"] = knob0
    launches = dict(i8.launches)            # ... and ends here
    for h in hooks:
        h.remove()
    copies = {k: (v - copies0[k]) // 3 for k, v in i8.copies.items()}
    shapes = {k: n // 3 for k, n in shapes.items()}     # a forward's
    if copies["weight"]:
        fail(f"phase 12: a quantized forward repacked {copies['weight']} "
             "weights (each layer packs its own once)")
    if any(cf.launches.values()):
        fail(f"phase 12: the quantized net reached the fused bf16 conv "
             f"kernels: {cf.launches}")
    if not all(torch.equal(o, outs[0]) for o in outs[1:]):
        fail("phase 12: two quantized forwards (fusion on and off) differ")
    q = outs[0].float()
    if tuple(q.shape) != (B_QUANT, 1000) or not torch.isfinite(q).all():
        fail(f"phase 12: quantized logits {tuple(q.shape)}, finite "
             f"{bool(torch.isfinite(q).all())}")
    err, top1 = rel(q, ref), (q.argmax(1) == ref.argmax(1)).float().mean()
    # a random net maps every image near one direction: the error of the
    # logits less their batch mean, and the f32 net's distinct top-1
    # classes, say how much of the agreement is that direction's
    centered = rel(q - q.mean(0), ref - ref.mean(0))
    classes = len(set(ref.argmax(1).tolist()))
    # no library convolution or product in a primed profiled forward
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            primer()
            net(x)
            torch.cuda.synchronize()
    counts = kernel_counts(prof)
    lib = sorted(k for k in counts if re.search(LIB_KERNEL, k)
                 and not re.search(INT8_KERNEL, k))
    n_int8 = sum(c for k, c in counts.items() if re.search(INT8_KERNEL, k))
    if lib or n_int8 > QUANT_STEP:
        fail(f"phase 12: the profiled quantized forward ran library kernels "
             f"{lib[:6]} or {n_int8} int8 kernels")
    quant_forward_ms(torch, net, x, "int8 ResNet-50")
    # hybridized: the replay equals the eager forward, run after run
    with torch.inference_mode():
        net.hybridize()
        replays = [net(x) for _ in range(3)]
        net.hybridize(False)
    if not all(torch.equal(r, outs[0]) for r in replays):
        fail("phase 12: a replayed quantized forward differs from the eager "
             "one")
    print(f"phase 12: int8 ResNet-50 v1 (quantize_net naive, {CALIB_NAIVE} "
          f"batches of {B_CALIB}, {t_naive:.1f} s): {QUANT_STEP} int8 kernel "
          f"launches a forward by the counters with MXNET_FUSE_BN_CONV 0 and "
          f"1 (the fused conv kernels 0), {n_int8} int8 records and no "
          f"library convolution or product in a primed profiled forward; "
          f"copies a forward {copies}; two eager runs and three replays equal "
          f"to the bit; logits against the f32 net: rel Frobenius "
          f"{err:.3e} (less the batch mean {centered:.3e}), top-1 agreement "
          f"{float(top1):.4f} (the f32 net's top-1: {classes} classes of "
          f"{B_QUANT} images); launches in the run {launches}", flush=True)
    # entropy calibration on a fresh f32 net
    net_e = quant_net(torch, dev, params)
    t = time.perf_counter()
    quantize_net(net_e, calib_data=calib[:CALIB_ENTROPY],
                 calib_mode="entropy")
    t_entropy = time.perf_counter() - t
    with torch.inference_mode():
        qe = net_e(x).float()
    if not torch.isfinite(qe).all():
        fail("phase 12: the entropy-calibrated logits are not finite")
    err_e = rel(qe, ref)
    top1_e = (qe.argmax(1) == ref.argmax(1)).float().mean()
    print(f"phase 12: entropy calibration on {CALIB_ENTROPY} batches of "
          f"{B_CALIB} in {t_entropy:.1f} s: logits against the f32 net rel "
          f"Frobenius {err_e:.3e} (less the batch mean "
          f"{rel(qe - qe.mean(0), ref - ref.mean(0)):.3e}), top-1 agreement "
          f"{float(top1_e):.4f}", flush=True)
    del net_e
    quant_cpu_check(torch, net, params, x, ref)
    quant_forward_ms(torch, quant_net(torch, dev, params, "bfloat16"),
                     x.to(torch.bfloat16), "bf16 ResNet-50 (cuDNN)")
    print(f"phase 12: main path done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del net
    torch.cuda.empty_cache()
    return launches, shapes


# the quantized operators' own path: ResNet-50 v1's stage-1 bottleneck
# (64@56^2: 1x1 -> 64, 3x3 -> 64, 1x1 -> 256; (filters, kernel, pad)) as
# MXNet's symbolic int8 graphs run it, at B = 64; the CPU checks the first
# B_QUANT_OPS_CPU images
QUANT_OPS_BLOCK = ((64, 1, 0), (64, 3, 1), (256, 1, 0))
QUANT_OPS_C, QUANT_OPS_H, B_QUANT_OPS_CPU = 64, 56, 4


def quant_operator_path(torch, dev, B=B_QUANT, B_cpu=B_QUANT_OPS_CPU):
    """The quantized operators as upstream MXNet's symbolic int8 graphs
    (``contrib.quant.quantize_model``) call them, through ``mx.npx``:
    ``quantize_v2`` at the input, each convolution ``quantized_conv``
    (int8 in, int32 out: the int8-in variant of the kernel) and
    ``requantize`` into the next layer's int8, ``quantized_act`` (relu)
    between the layers, ``dequantize`` at the end; QUANT_OPS_BLOCK at B
    images, weights and data from a seed, the requantize ranges
    calibrated on the CPU's first B_cpu images. The card's int8 codes of
    every layer and its f32 output equal the CPU's on those images to the
    bit. Returns the operator chain's output."""
    import numpy as np
    from mxnet_tpu_torch import npx
    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, QUANT_OPS_C, QUANT_OPS_H,
                                             QUANT_OPS_H)).astype(np.float32))
    layers, c = [], QUANT_OPS_C
    for o, k, p in QUANT_OPS_BLOCK:
        layers.append((torch.from_numpy(rng.randint(-127, 128, (o, c, k, k))
                                        .astype(np.int8)),
                       torch.from_numpy(rng.randint(-127, 128, (o,))
                                        .astype(np.int8)), k, p, o))
        c = o

    def chain(xs, where, calib=None):
        """(codes of each layer, f32 output, each requantize's range)"""
        q, mn, mx = npx.quantize_v2(xs.to(where), -1.0, 1.0)
        codes, seen = [q], []
        for i, (w, b, k, p, o) in enumerate(layers):
            y, mn_o, mx_o = npx.quantized_conv(
                q, w.to(where), b.to(where), mn, mx, -0.3, 0.3, -0.5, 0.5,
                kernel=(k, k), stride=(1, 1), pad=(p, p), num_filter=o,
                layout="NCHW")
            r = (None, None) if calib is None else (-calib[i], calib[i])
            q, mn, mx = npx.requantize(y, mn_o, mx_o, *r)
            seen.append(float(mx))
            if i < len(layers) - 1:
                q, mn, mx = npx.quantized_act(q, mn, mx, act_type="relu")
            codes.append(q)
        return codes, npx.dequantize(q, mn, mx), seen
    t = time.perf_counter()
    with torch.inference_mode():
        calib = chain(x[:B_cpu], "cpu")[2]
        codes, out, _ = chain(x, dev, calib)
        torch.cuda.synchronize()
        cpu_codes, cpu_out, _ = chain(x[:B_cpu], "cpu", calib)
    for i, (got, want) in enumerate(zip(codes, cpu_codes)):
        if not torch.equal(got[:B_cpu].cpu(), want):
            fail(f"phase 12: the quantized operators' layer {i} codes "
                 f"differ card / CPU")
    if not torch.equal(out[:B_cpu].cpu(), cpu_out) \
            or not torch.isfinite(out).all():
        fail("phase 12: the quantized operators' output differs card / CPU "
             "or is not finite")
    print(f"phase 12: the quantized operators (quantize_v2, quantized_conv "
          f"and requantize a layer, quantized_act, dequantize) through "
          f"{len(layers)} convolutions of a ResNet-50 bottleneck at B={B}, "
          f"{QUANT_OPS_H}^2: codes of every layer and the output equal to "
          f"the CPU's on {B_cpu} images; in {time.perf_counter() - t:.1f} s",
          flush=True)
    return out


def quant_cpu_check(torch, net, params, x, ref):
    """The port's int8 net on the CPU at B = 2 with the card's calibrated
    ranges copied in: the int8 weights equal, each quantized layer on the
    CPU layer's input equal to its output to the bit, the logits within
    TOL_QUANT_CPU_REL (the f32 nets' own difference printed beside)."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    cpu = quant_net(torch, "cpu", params)
    xc = x[:B_QUANT_CPU].cpu()
    with torch.inference_mode():
        f32_err = rel(ref[:B_QUANT_CPU].cpu(), cpu(xc).float())
    quantize_net(cpu, calib_data=[xc], calib_mode="naive")
    card, host = quant_layers(net), quant_layers(cpu)
    for k, m in host.items():
        src = card[k]
        if not torch.equal(m.wq, src.wq.cpu()) or (
                m.bq is not None and not torch.equal(m.bq, src.bq.cpu())):
            fail(f"phase 12: {k}: the int8 weights differ card and CPU")
        m._in_min, m._in_max = src._in_min, src._in_max
        m.in_min.copy_(src.in_min)
        m.in_max.copy_(src.in_max)
    seen = {}
    hooks = [m.register_forward_hook(
        lambda _m, a, o, _k=k: seen.__setitem__(_k, (a[0], o)))
        for k, m in host.items()]
    with torch.inference_mode():
        got = net(x[:B_QUANT_CPU]).float().cpu()
        want = cpu(xc).float()
        for h in hooks:
            h.remove()
        for k, (inp, out) in seen.items():
            if not torch.equal(card[k](inp.to(x.device)).cpu(), out):
                fail(f"phase 12: quantized layer {k} on the CPU layer's "
                     f"input differs from the CPU's output")
    err = rel(got, want)
    print(f"phase 12: int8 ResNet-50 B={B_QUANT_CPU} card against the port's "
          f"CPU int8 net (the card's ranges): int8 weights of all "
          f"{len(host)} layers equal; each layer on the CPU layer's input "
          f"equal to its output to the bit; logits rel Frobenius {err:.3e} "
          f"(limit {TOL_QUANT_CPU_REL}; the f32 nets card / CPU "
          f"{f32_err:.3e}), top-1 {got.argmax(1).tolist()} / "
          f"{want.argmax(1).tolist()}", flush=True)
    if not err <= TOL_QUANT_CPU_REL:
        fail(f"phase 12: card against CPU {err:.3e} > {TOL_QUANT_CPU_REL}")


def int8_bound_ms(M, N, K, x_bytes, O):
    """The larger of the products' time at the int8 peak (M x N outputs of
    a K-long reduction) and the bytes' time: ``x_bytes`` of input read, the
    (O, K) int8 weight and the int32 bias read, the M x O 4-byte output
    written."""
    t_ops = 2.0 * M * N * K / PEAK_INT8_OPS * 1e3
    nbytes = x_bytes + O * K + O * 4 + M * O * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_read_elems(layout, xs, ws, stride, pad, dilate):
    """The input elements a convolution reads: along each spatial dim the
    indices that some output's tap lands on (a 1x1 stride-2 layer reads a
    quarter of its input), times the images and the channels; the FC's
    whole input."""
    if layout == "FC":
        return math.prod(xs)
    first = layout.startswith("NC")
    n = xs[0] * (xs[1] if first else xs[-1])
    sp, ks = (xs[2:], ws[2:]) if first else (xs[1:-1], ws[:-2])
    for i, k, st, p, d in zip(sp, ks, stride, pad, dilate):
        o = (i + 2 * p - d * (k - 1) - 1) // st + 1
        n *= len({a * st - p + b * d for a in range(o) for b in range(k)}
                 & set(range(i)))
    return n


def library_int_mm_ms(torch, a, b):
    """torch._int_mm(a, b) (a yardstick, never called by the port), or None
    where it does not take the shapes."""
    try:
        return kernel_ms(lambda: torch._int_mm(a, b), r".", iters=10)
    except RuntimeError as e:
        print(f"phase 12:   torch._int_mm unavailable here ({e!r:.100})",
              flush=True)
        return None


def int8_row(torch, dev, label, layout, xs, ws, stride, pad, dilate, groups,
             gen):
    """One int8 kernel shape, both variants. int8 in, int32 out: the kernel
    against its plain version (equal to the bit), its device time, the plain
    version's, torch._int_mm's where the shape is a plain product (stride-1
    1x1 or the FC), and the bound. f32 in, f32 out (a whole quantized layer,
    what the main path launches): the same against its plain version, and
    the time of the unfused operators it replaces (quantize_v2, the int8
    product, dequantize, as the layer ran them before), the bound counting
    f32 bytes in and out. Both bounds count the input elements the
    convolution reads (int8_read_elems). Returns the f32 variant's row and
    the int8 one's."""
    from mxnet_tpu_torch.ops import quantization as qop
    from mxnet_tpu_torch.ops.cuda import int8_conv as i8
    fc = layout == "FC"
    first = layout.startswith("NC")
    x = torch.randint(-127, 128, xs, generator=gen, dtype=torch.int8,
                      device=dev)
    xf = torch.randn(xs, generator=gen, device=dev) * 60
    conv1 = not fc and xs[1] == 3      # the NCHW image, read as it lies
    if first and x.ndim == 4 and not conv1:   # as the path gives it
        x = x.contiguous(memory_format=torch.channels_last)
        xf = xf.contiguous(memory_format=torch.channels_last)
    w = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8,
                      device=dev)
    O = ws[0] if first or fc else ws[-1]
    b = torch.randint(-2 ** 20, 2 ** 20, (O,), generator=gen,
                      dtype=torch.int32, device=dev)
    scale = torch.full((), 1.0, device=dev)
    step = torch.full((), 1e-4, device=dev)
    bq = torch.randint(-127, 128, (O,), generator=gen, dtype=torch.int8,
                       device=dev)
    rng = [torch.full((), v, device=dev) for v in (-127.0, 127.0, -0.5,
                                                   0.5, -0.25, 0.25)]
    if fc:
        run = (lambda: i8.fully_connected(x, w, b))
        plain = (lambda: i8.fully_connected_reference(x, w, b))
        run_f = (lambda: i8.fully_connected_f32(xf, w, b, scale, step))
        plain_f = (lambda: i8.fully_connected_f32_reference(xf, w, b, scale,
                                                            step))

        def unfused():
            q, mn, mx = qop.quantize_v2(xf, rng[0], rng[1])
            y, mn_o, mx_o = qop.quantized_fully_connected(
                q, w, bq, mn, mx, *rng[2:], num_hidden=O)
            return qop.dequantize(y, mn_o, mx_o)
    else:
        cfg = (stride, pad, dilate, groups, layout)
        run = (lambda: i8.conv(x, w, b, *cfg))
        plain = (lambda: i8.conv_reference(x, w, b, *cfg))
        run_f = (lambda: i8.conv_f32(xf, w, b, scale, step, *cfg))
        plain_f = (lambda: i8.conv_f32_reference(xf, w, b, scale, step,
                                                 *cfg))

        def unfused():
            q, mn, mx = qop.quantize_v2(xf, rng[0], rng[1])
            y, mn_o, mx_o = qop.quantized_conv(
                q, w, bq, mn, mx, *rng[2:], stride=stride, pad=pad,
                dilate=dilate, num_group=groups, layout=layout)
            return qop.dequantize(y, mn_o, mx_o)
    saved = dict(i8.launches)
    for what, fn, ref in (("int8", run, plain), ("f32", run_f, plain_f)):
        got, want = fn(), ref()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"phase 12: int8 kernel {label} ({what} variant): differs "
                 f"from its plain version (max abs "
                 f"{(got.double() - want.double()).abs().max():.3e})")
    ms = launch_ms(run, 10, lambda n: re.search(INT8_KERNEL, n))
    ms_f = launch_ms(run_f, 10, lambda n: re.search(INT8_KERNEL, n))
    plain_ms = device_ms(plain, iters=3)
    plain_f_ms = device_ms(plain_f, iters=3)
    unfused_ms = device_ms(unfused, iters=5)
    i8.launches.update(saved)
    lib = None
    if fc:
        lib = library_int_mm_ms(torch, x, w.t())
    elif ws[2:] == (1,) * (len(ws) - 2) and all(s == 1 for s in stride) \
            and groups == 1 and first:
        lib = library_int_mm_ms(torch, x.movedim(1, -1).reshape(-1, xs[1]),
                                w.reshape(O, -1).t())
    M = want.numel() // O
    K = w.numel() // O
    elems = int8_read_elems(layout, xs, ws, stride, pad, dilate)
    bnd, by = int8_bound_ms(M, O, K, elems, O)
    bnd_f, by_f = int8_bound_ms(M, O, K, 4 * elems, O)
    one = fc or (all(k == 1 for k in (ws[2:] if first else ws[:-2]))
                 and all(v == 1 for v in stride) and all(v == 0 for v in pad))
    plan = i8.int8_plan(M, xs[-1] if not first and not fc else xs[1],
                        O // groups, groups, K, one, 4, first)
    ops = 2.0 * M * O * K
    print(f"phase 12: int8 {label}: both variants equal to their plain "
          f"versions; int8 in: kernel {fmt_ms(ms)}, plain {fmt_ms(plain_ms)}"
          f", library {'none' if lib is None else fmt_ms(lib)}, bound "
          f"{bnd:.4f} ms ({by}), {ops / (ms or float('inf')) / 1e9:.1f} "
          f"TOP/s; f32 in (the layer): kernel {fmt_ms(ms_f)}, plain "
          f"{fmt_ms(plain_f_ms)}, unfused operators {fmt_ms(unfused_ms)}, "
          f"bound {bnd_f:.4f} ms ({by_f}); route {plan.route}, tiles "
          f"{plan.tiles}, split {plan.split}", flush=True)
    return (dict(ms=ms_f, plain_ms=plain_f_ms, library_ms=lib,
                 bound_ms=bnd_f, bound_by=by_f, unfused_ms=unfused_ms),
            dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=bnd,
                 bound_by=by))


def int8_kernel_rows(torch, dev, shapes):
    """The int8 kernel at each distinct shape of the main path (in its
    order; weighted by its launches a forward) and at the extra shapes.
    The kernels line's rows: ``int8_conv``, the int8-in variant (int8 in,
    int32 out: the quantized operators' product), and ``int8_conv_f32``,
    the f32-in variant (a whole quantized layer, what the path launches),
    each at every shape of the path; their library_ms is None (no one
    PyTorch call computes every shape)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    keys = ("ms", "plain_ms", "bound_ms")
    total = dict.fromkeys(keys + ("unfused_ms",), 0.0)
    total8 = dict.fromkeys(keys, 0.0)
    kinds = {"bytes": 0.0, "operations": 0.0}   # the bound's ms by kind
    kinds8 = dict.fromkeys(kinds, 0.0)

    def add(acc, r, n):
        for k in acc:
            acc[k] = None if acc[k] is None or r[k] is None \
                else acc[k] + n * r[k]
    for (xs, ws, cfg), n in shapes.items():
        if cfg is None:
            r, r8 = int8_row(torch, dev, f"FC {xs} x {ws} ({n} a forward)",
                             "FC", xs, ws, None, None, None, 1, gen)
        else:
            stride, pad, dilate, groups = cfg
            r, r8 = int8_row(torch, dev, f"{xs} -> {ws[0]}, {ws[2]}x{ws[3]} "
                             f"stride {stride[0]} ({n} a forward)", "NCHW",
                             xs, ws, stride, pad, dilate, groups, gen)
        add(total, r, n)
        add(total8, r8, n)
        kinds[r["bound_by"]] += n * r["bound_ms"]
        kinds8[r8["bound_by"]] += n * r8["bound_ms"]
    for label, layout, xs, ws, st, pd, dl, g in INT8_EXTRA:
        int8_row(torch, dev, label, layout, xs, ws, st, pd, dl, g, gen)
    unfused = total.pop("unfused_ms")
    row = dict(total, library_ms=None, bound_by=max(kinds, key=kinds.get))
    row8 = dict(total8, library_ms=None,
                bound_by=max(kinds8, key=kinds8.get))
    print(f"phase 12: int8 kernel per quantized ResNet-50 forward (B="
          f"{B_QUANT}, {sum(shapes.values())} layers): f32-in variant "
          f"(int8_conv_f32, the path's) {fmt_ms(row['ms'])} device, plain "
          f"{fmt_ms(row['plain_ms'])}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), the unfused operators it replaces "
          f"{fmt_ms(unfused)}; int8-in variant (int8_conv, the operators' "
          f"product) {fmt_ms(row8['ms'])}, plain {fmt_ms(row8['plain_ms'])}"
          f", bound {row8['bound_ms']:.4f} ms ({row8['bound_by']})",
          flush=True)
    return row8, row


# --probe-int8's shapes: the ten that torch._int_mm computes, conv1, three
# 3x3 ones and a strided 1x1 of the path (label, layout, data, weight,
# stride, pad, dilate)
INT8_PROBE = [("FC", "FC", (64, 2048), (1000, 2048), None, None, None)] + [
    (f"{c}@{h}^2 -> {o} {k}x{k}", "NCHW", (64, c, h, h), (o, c, k, k),
     (s, s), (k // 2, k // 2), (1, 1)) for c, h, o, k, s in (
        (3, 224, 64, 7, 2), (64, 56, 64, 1, 1), (64, 56, 256, 1, 1),
        (256, 56, 64, 1, 1), (128, 28, 512, 1, 1), (512, 28, 128, 1, 1),
        (256, 14, 1024, 1, 1), (1024, 14, 256, 1, 1), (512, 7, 2048, 1, 1),
        (2048, 7, 512, 1, 1), (64, 56, 64, 3, 1), (512, 7, 512, 3, 1),
        (128, 28, 128, 3, 1), (256, 56, 512, 1, 2))]


def int8_probe(torch, dev):
    """Where the int8 kernel's time goes (``--probe-int8``): both variants
    at INT8_PROBE's shapes, timed by device time in turns with builds of
    the kernel with A's copies, the products or the epilogue's stores cut
    out (``-DMXT_I8_CUT=3/1/2``) or the epilogue's TMA stores alone, with
    its proxy fence or with its staging writes (5/6/7; wrong results,
    never checked), INT8_PROBE_ROUNDS rounds of every build in turns: the
    median and the range of each. Variant launches are not counted."""
    import ctypes
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops.cuda import int8_conv as i8
    argtypes = i8._kernel().argtypes
    fns = {}
    for label, define in INT8_CUTS.items():
        fn = _kernels.load("int8_conv", (define,)).mxt_int8_conv
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[label] = fn
    gen = torch.Generator(device=dev).manual_seed(5)
    keep = (lambda n: re.search(INT8_KERNEL, n))
    saved = dict(i8.launches)
    for label, layout, xs, ws, st, pd, dl in INT8_PROBE:
        fc = layout == "FC"
        O = ws[0]
        w = torch.randint(-127, 128, ws, generator=gen, dtype=torch.int8,
                          device=dev)
        b = torch.randint(-2 ** 20, 2 ** 20, (O,), generator=gen,
                          dtype=torch.int32, device=dev)
        scale = torch.full((), 1.0, device=dev)
        step = torch.full((), 1e-4, device=dev)
        for variant in ("int8", "f32"):
            f32 = variant == "f32"
            x = (torch.randn(xs, generator=gen, device=dev) * 60) if f32 \
                else torch.randint(-127, 128, xs, generator=gen,
                                   dtype=torch.int8, device=dev)
            if not fc and xs[1] != 3:
                x = x.contiguous(memory_format=torch.channels_last)
            sc, sp = (scale, step) if f32 else (None, None)

            def run(fn):
                if fc:
                    return lambda: i8._fc(x, w, b, None, sc, sp, False, fn)
                return lambda: i8._conv(x, w, b, st, pd, dl, 1, layout, None,
                                        sc, sp, False, fn)
            runs = dict(full=run(None),
                        **{lab: run(fns[lab]) for lab in INT8_CUTS})
            times = {k: [] for k in runs}
            for _ in range(INT8_PROBE_ROUNDS):
                for k, fn in runs.items():
                    t = launch_ms(fn, 10, keep)
                    if t is not None:
                        times[k].append(t)
            print(f"phase 12: probe int8 kernel, {variant} in, {label} "
                  f"(device time a launch, median [min-max] of "
                  f"{INT8_PROBE_ROUNDS} rounds): " + ", ".join(
                      f"{k} {statistics.median(v):.4f} ms [{min(v):.4f}-"
                      f"{max(v):.4f}]" if v else f"{k} not measured"
                      for k, v in times.items())
                  + f"; card: {smi_line()}", flush=True)
        del x, w
    i8.launches.update(saved)
    torch.cuda.empty_cache()


def ssd_anchors(torch, dev):
    """SSD-300's 8732 anchors: multibox_prior over the six feature maps."""
    from mxnet_tpu_torch.ops import boxes
    out = []
    for i, (f, step, ratios) in enumerate(SSD_MAPS):
        s0, s1 = SSD_SIZES[i] / 300, SSD_SIZES[i + 1] / 300
        out.append(boxes.multibox_prior(
            torch.zeros((1, 1, f, f), device=dev), sizes=(s0, (s0 * s1) ** 0.5),
            ratios=ratios, steps=(step / 300, step / 300)))
    return torch.cat(out, 1)


def ssd_inputs(torch, seed):
    """SSD's label rows (1-40 valid a image, cls -1 past them), class
    predictions and location offsets for B = 32, from ``seed``, on the
    CPU."""
    import numpy as np
    rng = np.random.RandomState(seed)
    B, M, C, N = SSD_B, SSD_LABELS, SSD_CLASSES, SSD_ANCHORS
    lab = np.full((B, M, 5), -1.0, np.float32)
    for b in range(B):
        k = rng.randint(1, 41)
        xy = rng.uniform(0, 0.8, (k, 2))
        wh = rng.uniform(0.05, 0.5, (k, 2))
        lab[b, :k, 0] = rng.randint(0, C - 1, k)
        lab[b, :k, 1:3] = xy
        lab[b, :k, 3:5] = np.minimum(xy + wh, 1.0)
    logits = rng.standard_normal((B, C, N)).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.standard_normal((B, N * 4)) * 0.5).astype(np.float32)
    return [torch.from_numpy(a) for a in (lab, logits, prob.astype(
        np.float32), loc)]


def ssd_time(torch, fn):
    """Device time of ``fn``: the median of three profiler sessions."""
    import statistics
    fn()
    got = [device_ms(fn, iters=3) for _ in range(3)]
    return None if None in got else statistics.median(got)


def ssd_boxes(torch, dev):
    """SSD-300's box operators on the card against the port's CPU path, each
    timed; the NMS kernel's launches counted over the detections. Returns
    (launches, nms row)."""
    from mxnet_tpu_torch.ops import boxes
    from mxnet_tpu_torch.ops.cuda import box_nms as nms
    t0 = time.perf_counter()
    lab, logits, prob, loc = ssd_inputs(torch, 41)
    anc = {d: ssd_anchors(torch, d) for d in ("cpu", dev)}
    if tuple(anc["cpu"].shape) != (1, SSD_ANCHORS, 4) or \
            rel(anc[dev].cpu(), anc["cpu"]) > TOL_BOX_REL:
        fail(f"phase 12: multibox_prior gave {tuple(anc[dev].shape)} anchors,"
             f" card against CPU {rel(anc[dev].cpu(), anc['cpu']):.3e}")
    on = {"cpu": (lab, logits, prob, loc)}
    on[dev] = tuple(t.to(dev) for t in on["cpu"])
    ops = {
        "multibox_prior": lambda d: ssd_anchors(torch, d),
        "box_iou": lambda d: boxes.box_iou(anc[d], on[d][0][..., 1:5]),
        "bipartite_matching": lambda d: boxes.bipartite_matching(
            boxes.box_iou(on[d][0][..., 1:5], anc[d]), threshold=0.1),
        "multibox_target": lambda d: boxes.multibox_target(
            anc[d], on[d][0], on[d][1], negative_mining_ratio=3.0),
        "multibox_detection": lambda d: boxes.multibox_detection(
            on[d][2], on[d][3], anc[d], threshold=0.01, nms_threshold=0.45,
            nms_topk=400),
    }
    reset_counts(nms)                       # the main path starts here
    results = {}
    for name, fn in ops.items():
        got, want = fn(dev), fn("cpu")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        results[name] = (got, want)
    launches = dict(nms.launches)           # ... and ends here
    if launches["box_nms"] != 1:
        fail(f"phase 12: multibox_detection launched the NMS kernel "
             f"{launches['box_nms']} times, not once")
    flips = 0
    for name, (got, want) in results.items():
        for g, w in zip(got, want):
            g = g.cpu()
            if g.shape != w.shape or not torch.isfinite(g).all():
                fail(f"phase 12: {name}: card {tuple(g.shape)} against CPU "
                     f"{tuple(w.shape)}, finite {bool(torch.isfinite(g).all())}")
            if name == "multibox_detection":
                kg, kw = g[..., 0] >= 0, w[..., 0] >= 0
                flips = int((kg != kw).sum())
                both = kg & kw
                err = rel(g[both], w[both])
                if flips > SSD_FLIPS or not err <= TOL_BOX_REL:
                    fail(f"phase 12: multibox_detection: {flips} keep bits "
                         f"differ card / CPU, kept rows rel {err:.3e}")
            elif g.dtype.is_floating_point and g.abs().max() > 0:
                err = ((g - w).abs() / (w.abs() + 1)).max().item()
                if not err <= TOL_BOX_REL:
                    fail(f"phase 12: {name}: card against CPU {err:.3e}")
    # the NMS kernel's keep mask against its plain version on the card's
    # own sorted boxes: the detection's (B = 32, topk 400) and all 8732
    # anchors of one image
    row = None
    for label, B, n in (("detection B=32, topk 400", SSD_B, 400),
                        ("one image, all 8732 anchors", 1, SSD_ANCHORS)):
        bx, cl, va = nms_inputs(torch, on[dev], anc[dev], B, n)
        saved = dict(nms.launches)
        got = nms.nms_keep(bx, cl, va, 0.45, False)
        want = nms.nms_keep_reference(bx, cl, va, 0.45, False)
        if not torch.equal(got, want):
            fail(f"phase 12: NMS keep mask ({label}) differs from its plain "
                 f"version in {int((got != want).sum())} rows")
        ms = launch_ms(lambda: nms.nms_keep(bx, cl, va, 0.45, False), 10,
                       lambda k: re.search(NMS_KERNEL, k), per_call=2)
        if n < SSD_ANCHORS:
            plain_ms, how = device_ms(lambda: nms.nms_keep_reference(
                bx, cl, va, 0.45, False), iters=1), "device time"
        else:       # 8732 steps of ~15 launches: CUDA events, not records
            plain_ms, how = cuda_time_ms(lambda: nms.nms_keep_reference(
                bx, cl, va, 0.45, False), iters=1, warmup=0), "CUDA events"
        nms.launches.update(saved)
        t_ops = B * n * (n - 1) / 2 * 17 / PEAK_FLOPS["float32"] * 1e3
        t_bytes = B * (n * 20 + va.shape[1] * 2) / HBM_BYTES_PER_S * 1e3
        bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
            (t_ops, "operations")
        print(f"phase 12: NMS kernel, {label}: keep mask equal to the plain "
              f"version's ({int(got.sum())} kept of {int(va.sum())} valid); "
              f"{fmt_ms(ms)} (both passes), plain {fmt_ms(plain_ms)} "
              f"({how}), bound {bnd:.5f} ms ({by}), library none (PyTorch "
              f"has no NMS)", flush=True)
        if row is None:
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                       library_ms=None, max_abs_err=0.0)
    for name, fn in ops.items():
        print(f"phase 12: SSD-300 {name}: card equal to the CPU within "
              f"{TOL_BOX_REL}; device {fmt_ms(ssd_time(torch, lambda: fn(dev)))}"
              f" (median of three profiler sessions)", flush=True)
    print(f"phase 12: SSD-300 box operators ({SSD_ANCHORS} anchors, B="
          f"{SSD_B}, {SSD_CLASSES} classes, {SSD_LABELS} label rows): "
          f"detection keep bits differing card / CPU {flips}; NMS launches "
          f"{launches}; done in {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, row


def nms_inputs(torch, data, anc, B, n):
    """The score-sorted boxes, classes and validity box_nms hands its
    kernel for multibox_detection's first B images, the sweep restricted to
    n rows."""
    from mxnet_tpu_torch.ops import boxes
    prob, loc = data[2][:B], data[3][:B]
    rows = boxes.multibox_detection(prob, loc, anc, threshold=0.01,
                                    nms_threshold=1.0)      # nothing suppressed
    N = rows.shape[1]
    valid = rows[..., 1] > 0
    valid &= torch.arange(N, device=rows.device)[None, :] < n
    return rows[:, :n, 2:6].contiguous(), rows[:, :n, 0].contiguous(), valid


def phase_quant(torch, dev):
    """Phase 12: int8 ResNet-50 v1 through quantize_net (the main path,
    checks and times), the quantized operators' own path, the int8
    kernel's rows, and SSD-300's box operators with the NMS kernel.
    Returns (rows, launches)."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    t = time.perf_counter()
    # gamma 1 in every BatchNorm, so every convolution's output reaches the
    # logits (random_resnet_params' zero last gamma would mute a third)
    params = random_resnet_params(get_model("resnet50_v1", device="cpu"),
                                  seed=0, zero_last_gamma=False)
    launches, shapes = quant_main_path(torch, dev, params)
    from mxnet_tpu_torch.ops.cuda import int8_conv as i8
    reset_counts(i8)                        # the operators' path starts here
    quant_operator_path(torch, dev)
    for k, n in i8.launches.items():        # ... and ends here
        launches[k] += n
    print(f"phase 12: int8 kernel launches of the operators' path "
          f"{dict(i8.launches)}", flush=True)
    row8, row = int8_kernel_rows(torch, dev, shapes)
    rows = {"int8_conv": dict(row8, max_abs_err=0.0),
            "int8_conv_f32": dict(row, max_abs_err=0.0)}
    nms_launches, rows["box_nms"] = ssd_boxes(torch, dev)
    launches.update(nms_launches)
    torch.cuda.empty_cache()
    print(f"phase 12: done in {time.perf_counter() - t:.1f} s; card: "
          f"{smi_line()}", flush=True)
    return rows, launches


def initialize_check(torch) -> None:
    """Phase 1: MXNet's ``initialize()`` with no arguments puts a block's
    parameters on the current context, ``cuda:0``."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(4, in_units=3)
    net.initialize()
    where = {str(p.data().device) for p in net.collect_params().values()}
    if where != {"cuda:0"}:
        fail(f"Dense(4, in_units=3).initialize() put its parameters on "
             f"{where}, not cuda:0")
    print("phase 1: Dense(4, in_units=3).initialize() with no arguments "
          "put its parameters on cuda:0", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels", "rtc", "generate",
                                       "seq2seq", "gpt-train", "layers",
                                       "quant"],
                    default=None,
                    help="kernels: stop after the kernel checks (phases "
                    "1-3); rtc: phases 1 and 7 only; generate: phases 1, "
                    "2 and 8 (GPT-2 generation); seq2seq: phases 1, 2 and "
                    "9 (the encoder-decoder Transformer); gpt-train: "
                    "phases 1, 2 and 10 (GPT-2 training); layers: phases "
                    "1, 2 and 11 (the DCGAN and the layer sweep); quant: "
                    "phases 1, 2 and 12 (int8 ResNet-50 and SSD's box "
                    "operators)")
    ap.add_argument("--probe-fwd", action="store_true",
                    help="after phase 3, time the flash forward against "
                    "builds of it with one part cut out")
    ap.add_argument("--probe-bwd", action="store_true",
                    help="after phase 3, time the fused flash backward "
                    "against builds of it with one part cut out")
    ap.add_argument("--probe-conv", action="store_true",
                    help="after phase 3, time conv fwd and dgrad against "
                    "builds of them with one part cut out")
    ap.add_argument("--probe-int8", action="store_true",
                    help="in phase 12, time the int8 kernel against builds "
                    "of it with one part cut out")
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
    initialize_check(torch)

    entries = []
    if args.only != "rtc":
        # phase 2
        t0 = time.perf_counter()
        variants = []
        if args.probe_fwd:
            variants += [("flash_attention_fwd", (d,))
                         for d in FWD_CUTS.values()]
        if args.probe_bwd:
            variants += [("flash_attention_bwd", (d,))
                         for d in BWD_CUTS.values()]
        if args.probe_conv:
            variants += [("conv_fused", (d,)) for d in CONV_CUTS.values()]
        if args.probe_int8:
            variants += [("int8_conv", (d,)) for d in INT8_CUTS.values()]
        built = _kernels.build_all(variants=variants)
        print(f"phase 2: built {sorted(built)} in "
              f"{time.perf_counter() - t0:.1f} s "
              f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})",
              flush=True)
        for kname in _kernels.KERNEL_SOURCES:
            print_ptxas(kname, _kernels._target(kname).with_suffix(".log"))

        rows, launches = {}, {n: None for n in KERNEL_INFO}
        if args.only in (None, "kernels"):
            # phase 3
            rows, wide_launches = phase_kernels(torch, dev)
            launches.update(wide_launches)
            from mxnet_tpu_torch.ops.cuda import attention as attn
            if args.probe_fwd:
                forward_probe(torch, dev, attn)
            if args.probe_bwd:
                backward_probe(torch, dev, attn)
            if args.probe_conv:
                conv_probe(torch, dev)

        if args.only is None:
            serve = phase_bert(torch, dev)
            train, _ = phase_train(torch, dev)
            launches.update({n: serve[n] + train[n] for n in ATTN_KERNELS})
            missing = [n for n in ATTN_KERNELS if not train[n]]
            if missing:
                fail(f"kernels never launched on the training path: "
                     f"{missing}")
            resnet = phase_resnet(torch, dev)
            launches.update({n: resnet[n] for n in CONV_KERNELS + BN_KERNELS})
            launches.update({n: train[n] + resnet[n] for n in UPDATE_KERNELS})
            missing = [n for n in CONV_KERNELS + BN_KERNELS
                       if not resnet[n]] + [n for n in UPDATE_KERNELS
                                            if not train[n] or not resnet[n]]
            if missing:
                fail(f"kernels never launched on the ResNet-50 path: "
                     f"{missing}")
        names = list(KERNEL_INFO)
        if args.only in (None, "generate"):
            # phase 8 (after phase 6; phase 7 follows)
            gen_rows, gen_launches = phase_generate(torch, dev)
            if args.only == "generate":
                names = ["flash_attention_fwd"]
                rows["flash_attention_fwd"] = gen_rows["flash_attention_fwd"]
                launches["flash_attention_fwd"] = 0
            launches["flash_attention_fwd"] += \
                gen_launches["flash_attention_fwd"]
        decode = {"decode_attention": 0}
        if args.only in (None, "generate"):
            decode = dict(gen_launches)
            decode_row = gen_rows["decode_attention"]
        paths = []
        if args.only in (None, "seq2seq"):
            # phase 9 (after phase 8)
            paths.append(phase_seq2seq(torch, dev))
        if args.only in (None, "gpt-train"):
            # phase 10
            paths.append(phase_gpt_train(torch, dev))
        if args.only in ("seq2seq", "gpt-train"):
            # the kernels of the path alone, its rows measured at its shapes
            path_rows, path_launches, _ = paths[0]
            names = [n for n in KERNEL_INFO if n in path_rows]
            rows.update(path_rows)
            launches.update({n: 0 for n in names})
            if "decode_attention" in path_rows:
                decode_row = path_rows["decode_attention"]
        for _, path_launches, _ in paths:
            for n in names:
                launches[n] += path_launches.get(n, 0)
            decode["decode_attention"] += path_launches.get(
                "decode_attention", 0)
        missing = [n for _, pl, _ in paths for n in
                   ATTN_KERNELS + UPDATE_KERNELS if not pl[n]]
        if missing:
            fail(f"kernels never launched on the training paths: {missing}")
        if args.only in (None, "layers"):
            # phase 11 (after phase 10; phase 7 follows)
            layer_rows, layer_launches = phase_layers(torch, dev)
            layer_names = list(BN_KERNELS + UPDATE_KERNELS)
            if args.only == "layers":
                names = layer_names
                rows.update(layer_rows)
                launches.update({n: 0 for n in names})
            missing = [n for n in layer_names if not layer_launches[n]]
            if missing:
                fail(f"kernels never launched on the DCGAN path: {missing}")
            for n in layer_names:
                launches[n] += layer_launches[n]
        if args.only in (None, "quant"):
            # phase 12 (after phase 11; phase 7 follows)
            quant_rows, quant_launches = phase_quant(torch, dev)
            if args.probe_int8:
                int8_probe(torch, dev)
            missing = [n for n in QUANT_INFO if not quant_launches[n]]
            if missing:
                fail(f"kernels never launched on the int8 and SSD paths: "
                     f"{missing}")
            if args.only == "quant":
                names = []
        entries += [dict(name=n, route="cuda", source=KERNEL_INFO[n][0],
                         replaces=KERNEL_INFO[n][1], launches=launches[n],
                         **rows[n]) for n in names]
        if args.only in (None, "quant"):
            entries += [dict(name=n, route="cuda", source=QUANT_INFO[n][0],
                             replaces=QUANT_INFO[n][1],
                             launches=quant_launches[n], **quant_rows[n])
                        for n in QUANT_INFO]
        if args.only in (None, "generate", "seq2seq"):
            entries += [dict(name=n, route="cuda", source=GEN_INFO[n][0],
                             replaces=GEN_INFO[n][1],
                             launches=decode[n], **decode_row)
                        for n in GEN_INFO]

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
    # the decode row adds its times with L2 flushed before each call
    extra = ("flushed_ms", "library_flushed_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys + extra if k in e}
                                  for e in entries]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
