#!/usr/bin/env python3
"""The multi-tensor update, the decode attention kernel, the wide flash
attention kernels, the f32 flash kernels and BatchNorm's two reductions of
the PyTorch port in the tree at ROOT, timed on one GPU at their main
paths' shapes.

    python3 tools/torch_kernel_ab.py ROOT [update|decode|wide|f32|bn ...]

(the named parts only; all five by default)

ROOT is a checkout (or a ``git archive``) of the repository whose
``mxnet_tpu_torch`` and ``chip_smoke.py`` are measured. The update: one
step of ``chip_smoke.py``'s timed ``UPDATE_CASES`` (BERT-base AdamW, 154
bf16 tensors with f32 masters, in groups of 4 and in one group; ResNet-50
SGD with momentum 0.9, 193 tensors, groups of 4), the device time of the
update kernel a step by torch.profiler, median of 5 sessions of 5 steps.
Every time here is taken kernel by kernel from the records the profiler
kept (a kernel's mean time a record, times its launches a call), after 16
launches of a tiny kernel that is not counted: a session in a process
that ran earlier sessions can lose the records of its first launches, so
a session's sum over its calls would read low.
The decode attention: S=8 slots, H=12, D=64, bucket L=1024, bf16, the
positions, q, k and v that ``chip_smoke.py``'s phase 8 row draws (seed
9), device time a call, median of 5 sessions of 20 calls, warm (calls back
to back: the 25 MB of K and V stay in the 50 MB L2) and cold (a 64 MB
buffer rewritten before each call, as each layer of a decode step finds
its cache), beside SDPA over the masked cache timed the same two ways.
The wide kernels (head dims above 256: ``wide_fwd``, ``wide_dq``,
``wide_dkv``) at ``WIDE_SHAPES``, bf16 or f32, q, k, v from one fused
projection, key padding ragged over the batch (valid lengths
T - b T / (2 B)) or causal: the device time of each kernel alone a launch,
median of 5
sessions (the forward through ``_flash_forward``, dq and dk / dv through
``chip_smoke.kernel_only_call``, so the entry's delta is not in them), the
kernels' names matched whatever tree they come from.
The f32 part: the f32 forward, the fused backward pass and the dq / dk /
dv pair at ``chip_smoke.py``'s ``F32_TIMED`` shapes (BERT-base's (8, 12,
512, 64) key padding, GPT-2 training's (8, 12, 1024, 64) causal; the
forward and the pair alone at (4, 8, 1024, 256) key padding) and the f32
wide dq and dk / dv at (2, 4, 512, 320) and (8, 8, 1024, 320) key
padding, each kernel alone a launch (the forward through
``_flash_forward``, the backward kernels through
``chip_smoke.kernel_only_call``), median of 5 sessions, beside SDPA's f32
forward and whole f32 backward on the same inputs (TF32 off); the
kernels' names matched whatever the tree calls them (``F32_PARTS``).
The bn part: ``bn_stats`` and ``bn_bwd_reduce`` (``_stats`` shifted about
a shift near the batch mean, ``_bwd_reduce``) at DCGAN's four BatchNorm
shapes (f32, B = 64) and ResNet-50's nine (bf16, N = 128), on
``chip_smoke.py``'s ``bn_case`` inputs (seed 31): each kernel's device
time a call back to back (``warm_ms``) and with a 64 MB buffer rewritten
before each call (``cold_ms``: DCGAN's tensors, 0.5-17 MB, fit in the
50 MB L2), median of 5 sessions, and the same two ways the library's
``batch_norm_stats`` / ``batch_norm_backward_reduce``
(``chip_smoke.library_bn_ms``); the plain version's time and the bound
(``chip_smoke.bn_bound_ms``) beside them.
To compare two commits, run it on each tree in turns on one card (parent,
change, change, parent). The result line starts with ``AB``. Imports
nothing of JAX.
"""
import json
import os
import re
import statistics
import sys


def median_ms(cs, fn, iters, keep, per_call=1):
    """Median over 5 sessions of the device time a call of ``fn``: for
    each kernel name ``keep`` accepts, its mean time a kept record times
    ``per_call`` (its launches a call), summed over the names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    primer = torch.zeros(256, dtype=torch.uint8, device="cuda")
    vals = []
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(16):         # the records a session may lose
                torch.bitwise_not(primer, out=primer)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times, counts = cs.kernel_times(prof), cs.kernel_counts(prof)
        names = [k for k in times if keep(k) and counts.get(k)
                 and "bitwise_not" not in k]
        if names and sum(times[k] for k in names) > 0:
            vals.append(sum(times[k] / counts[k] for k in names) * per_call)
    return statistics.median(vals) if vals else None


def update_times(torch, cs, dev, mt):
    """{case: ms and launches a step} of each timed update case."""
    out = {}
    shapes = {k: cs.update_shapes(k) for k in ("bert", "resnet")}
    keep = lambda n: re.search(r"mt::update<", n)   # noqa: E731
    for case in cs.UPDATE_CASES:
        if not case.get("timed"):
            continue
        c = dict(case, dtype=getattr(torch, case["dtype"]))
        sh = shapes[c["shapes"]]
        agg = c["agg"] or len(sh)
        (kern, _), grads = cs.update_sides(torch, dev, c, sh)
        before = mt.launches["multi_tensor_update"]
        cs.update_step(kern, grads[0], agg)
        launched = mt.launches["multi_tensor_update"] - before
        ms = median_ms(cs, lambda: cs.update_step(kern, grads[0], agg), 5,
                       keep, per_call=launched)
        out[case["name"]] = dict(ms=ms, launches_a_step=launched)
        del kern, grads
        torch.cuda.empty_cache()
    return out


def decode_inputs(torch, dev):
    """phase 8's decode row: the same draws from the same seed."""
    gen = torch.Generator().manual_seed(9)
    S, L, H, D = 8, 1024, 12, 64
    pos = torch.randint(300, L, (S,), generator=gen)
    qkv = torch.randn(S, 3 * H * D, generator=gen).to(dev, torch.bfloat16)
    q = qkv[:, :H * D].reshape(S, H, D)
    k, v = (torch.randn(S, L, H, D, generator=gen).to(dev, torch.bfloat16)
            for _ in range(2))
    return q, k, v, pos.to(dev)


def two_ways(torch, cs, call, keep, iters=20):
    """(warm, cold) device ms a call of ``call``'s kernels ``keep``
    accepts; cold rewrites a 64 MB buffer (a bitwise-not kernel, not kept)
    before each call."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def cold():
        torch.bitwise_not(flush, out=flush)
        call()
    for _ in range(3):
        call()
    warm = median_ms(cs, call, iters, keep)
    return warm, median_ms(cs, cold, iters,
                           lambda n: keep(n) and "bitwise_not" not in n)


def decode_times(torch, cs, dev, da):
    import torch.nn.functional as F
    q, k, v, pos = decode_inputs(torch, dev)
    kw = {}
    if hasattr(da, "workspace"):        # a kept workspace, as the graphs
        kw["work"] = da.workspace(8, 12, 1024, 64, dev)
    got = da.decode_attention(q, k, v, pos, **kw)
    ref = da.decode_attention_reference(q.float(), k.float(), v.float(), pos)
    err = (got.float() - ref).abs().max().item()
    warm, cold = two_ways(torch, cs, lambda: da.decode_attention(
        q, k, v, pos, **kw), lambda n: re.search(r"da::decode_", n))
    L = k.shape[1]
    mask = (torch.arange(L, device=dev)[None, :] <= pos[:, None])[
        :, None, None, :]
    qh, kh, vh = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    lib_warm, lib_cold = two_ways(
        torch, cs, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), lambda n: True)
    bound, _ = cs.decode_bound_ms(8, 12, 64, (pos + 1).tolist(), 2)
    return dict(warm_ms=warm, cold_ms=cold, sdpa_warm_ms=lib_warm,
                sdpa_cold_ms=lib_cold, bound_ms=bound, max_abs_err=err)


# (B, H, T, D, bias, causal, dtype) of the wide kernels' timings:
# chip_smoke.py's WIDE_TIMED (bf16) and WIDE_F32_TIMED
WIDE_SHAPES = ((2, 4, 512, 288, "keypad", False, "bfloat16"),
               (8, 8, 1024, 320, "keypad", False, "bfloat16"),
               (8, 8, 1024, 320, None, True, "bfloat16"),
               (4, 8, 1024, 512, "keypad", False, "bfloat16"),
               (2, 4, 512, 576, "keypad", False, "bfloat16"),
               (4, 8, 1024, 1024, "keypad", False, "bfloat16"),
               (2, 4, 512, 320, "keypad", False, "float32"),
               (8, 8, 1024, 320, "keypad", False, "float32"),
               (2, 4, 512, 576, "keypad", False, "float32"))
# every route's names: the tiled (_wg), the streamed (_st, 16-bit heads
# above 512), the 3xTF32 (_tf32 and the f32 dk / dv bwd_dkv_tf32_st) and
# the warp-a-row kernels
WIDE_PATTERNS = {"fwd": r"wide_fwd", "dq": r"wide_dq",
                 "dkv": r"wide_dkv|bwd_dkv_tf32_st"}


def wide_times(torch, cs, dev, attn):
    """{shape: ms a launch of each wide kernel} at ``WIDE_SHAPES``."""
    import math
    out = {}
    gen = torch.Generator().manual_seed(23)
    for B, Hh, T, d, bias_kind, causal, dtn in WIDE_SHAPES:
        dt = getattr(torch, dtn)
        q, k, v = cs.qkv_views(torch, dev, B, T, dt, gen, d, Hh)
        valid = [T - b * T // (2 * B) for b in range(B)]
        bias = cs.keypad_bias(torch, dev, valid, T, dt) \
            if bias_kind == "keypad" else None
        do = torch.randn((B, T, Hh, d), generator=gen).to(
            dev, dt).transpose(1, 2)
        scale = 1.0 / math.sqrt(d)
        o, lse = attn._flash_forward(q, k, v, bias, scale, causal)
        c = dict(q=q, k=k, v=v, do=do, bias=bias, seed=None, out=o, lse=lse,
                 scale=scale, causal=causal, rate=0.0)
        row = {"fwd": median_ms(cs, lambda: attn._flash_forward(
            q, k, v, bias, scale, causal), 5,
            lambda n: re.search(WIDE_PATTERNS["fwd"], n))}
        for part, name in (("dq", "flash_attention_wide_dq"),
                           ("dkv", "flash_attention_wide_dkv")):
            call, _ = cs.kernel_only_call(torch, attn, c, name)
            pattern = WIDE_PATTERNS[part]
            row[part] = median_ms(cs, call, 3,
                                  lambda n: re.search(pattern, n))
        label = (f"({B}, {Hh}, {T}, {d}) {dtn} "
                 f"{'causal' if causal else bias_kind}")
        out[label] = row
        del q, k, v, do, o, lse, c
        torch.cuda.empty_cache()
    return out


# each f32 kernel's entry name and its names in any tree: the 3xTF32
# kernels and the FMA and warp-a-row kernels they replaced
F32_PARTS = {
    "fwd": ("flash_attention_fwd", r"flash_fwd_f32<|flash_fwd_tf32<"),
    "fused": ("flash_attention_bwd_fused",
              r"bwd_fused_tf32|bwd_dkv_f32<\d+, true>"),
    "dq": ("flash_attention_bwd_dq", r"bwd_dq_f32<|wide_dq_tf32"),
    "dkv": ("flash_attention_bwd_dkv", r"bwd_dkv_(f32<|tf32)"),
    "wide_dq": ("flash_attention_wide_dq", r"wide_dq"),
    "wide_dkv": ("flash_attention_wide_dkv",
                 r"wide::wide_dkv<|bwd_dkv_tf32_st")}
# (B, H, T, D, bias, causal, parts) of the f32 part: chip_smoke.py's
# F32_TIMED and the f32 wide pair
F32_SHAPES = ((8, 12, 512, 64, "keypad", False,
               ("fwd", "fused", "dq", "dkv")),
              (8, 12, 1024, 64, None, True, ("fwd", "fused", "dq", "dkv")),
              (4, 8, 1024, 256, "keypad", False, ("fwd", "dq", "dkv")),
              (2, 4, 512, 320, "keypad", False, ("wide_dq", "wide_dkv")),
              (8, 8, 1024, 320, "keypad", False, ("wide_dq", "wide_dkv")))


def f32_times(torch, cs, dev, attn):
    """{shape: ms a launch of each f32 kernel, SDPA's f32 forward and
    whole f32 backward} at ``F32_SHAPES``."""
    import torch.nn.functional as F
    out = {}
    gen = torch.Generator().manual_seed(29)
    for B, Hh, T, d, bias_kind, causal, parts in F32_SHAPES:
        c = cs.wide_timed_case(torch, dev, gen, attn, B, Hh, T, d, bias_kind,
                               causal, "float32")
        q, k, v, bias, scale = (c[x] for x in ("q", "k", "v", "bias",
                                               "scale"))
        row = {}
        for part in parts:
            name, pattern = F32_PARTS[part]
            if part == "fwd":
                def call():
                    return attn._flash_forward(q, k, v, bias, scale, causal)
            else:
                call, _ = cs.kernel_only_call(torch, attn, c, name)
            row[part] = median_ms(cs, call, 3,
                                  lambda n, p=pattern: re.search(p, n))
            del call
        if "fwd" in parts:
            row["sdpa_fwd"] = median_ms(
                cs, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias, is_causal=causal, scale=scale),
                3, lambda n: True)
        row["sdpa_bwd"] = cs.library_backward_ms(
            torch, c["q"], c["k"], c["v"], c["bias"], c["do"], c["scale"],
            causal, 0.0, False)
        label = (f"({B}, {Hh}, {T}, {d}) f32 "
                 f"{'causal' if causal else bias_kind}")
        out[label] = row
        del c
        torch.cuda.empty_cache()
    return out


# (outer, C, inner, dtype) of the bn part: DCGAN's shapes (phase 11's
# DCGAN_BN_SHAPES) and ResNet-50's (phase 3's BN_SHAPES)
BN_SHAPES = tuple((64, C, M, "float32") for C, M in
                  ((512, 16), (256, 64), (128, 256), (64, 1024))) + tuple(
    (128, C, M, "bfloat16") for C, M in
    ((64, 12544), (64, 3136), (256, 3136), (128, 784), (512, 784),
     (256, 196), (1024, 196), (512, 49), (2048, 49)))
# the two reductions' kernels in any tree
BN_PATTERNS = {"bn_stats": r"reduce_kernel<[^>]*, 0>",
               "bn_bwd_reduce": r"reduce_kernel<[^>]*, 1>"}


def bn_times(torch, cs, dev, bn, library=True):
    """{shape: {kernel: warm and cold ms, the library's, plain, bound}}
    at ``BN_SHAPES``; ``library`` False: the kernels' times and the bound
    alone."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(31)
    for outer, C, M, dtn in BN_SHAPES:
        c = cs.bn_case(torch, dev, gen, outer, C, M, getattr(torch, dtn))
        x, dy, s = c["x"], c["dy"], c["s"]
        mean, _, inv = bn.bn_stats_reference(x, s, 1e-5)
        dg, db = bn.bn_bwd_reduce_reference(x, dy, mean, inv)
        calls = {"bn_stats": lambda: bn._stats(x, s, 1e-5, False),
                 "bn_bwd_reduce": lambda: bn._bwd_reduce(x, dy, mean, inv)}
        plain = {"bn_stats": lambda: bn.bn_stats_reference(x, s, 1e-5),
                 "bn_bwd_reduce": lambda: bn.bn_bwd_reduce_reference(
                     x, dy, mean, inv)}
        row = {}
        for name, call in calls.items():
            pattern = BN_PATTERNS[name]
            warm, cold = two_ways(torch, cs, call,
                                  lambda n, p=pattern: re.search(p, n), 10)
            bound = cs.bn_bound_ms(name, outer, C, M, x.element_size())[0]
            if not library:
                row[name] = dict(warm_ms=warm, cold_ms=cold, bound_ms=bound)
                continue
            lib = cs.library_bn_ms(
                torch, name, c, mean, inv, dg, db,
                lambda fn: two_ways(torch, cs, fn, lambda n: True, 10)) or \
                (None, None)
            row[name] = dict(
                warm_ms=warm, cold_ms=cold, library_warm_ms=lib[0],
                library_cold_ms=lib[1],
                plain_ms=median_ms(cs, plain[name], 3, lambda n: True),
                bound_ms=bound)
        out[f"({outer}, {C}, {M}) {dtn}"] = row
        del c, x, dy, calls, plain
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parts = sys.argv[2:] or ["update", "decode", "wide", "f32", "bn"]
    if len(sys.argv) < 2 or not set(parts) <= {"update", "decode", "wide",
                                               "f32", "bn"}:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mxnet_tpu_torch.ops.cuda import attention as attn
    from mxnet_tpu_torch.ops.cuda import decode_attention as da
    from mxnet_tpu_torch.ops.cuda import multi_tensor as mt
    dev = torch.device("cuda:0")
    card = cs.smi_line()
    res = dict(root=root, card=card)
    if "update" in parts:
        res["update"] = update_times(torch, cs, dev, mt)
    if "decode" in parts:
        res["decode"] = decode_times(torch, cs, dev, da)
    if "wide" in parts:
        res["wide"] = wide_times(torch, cs, dev, attn)
    if "f32" in parts:
        torch.backends.cuda.matmul.allow_tf32 = False
        res["f32"] = f32_times(torch, cs, dev, attn)
    if "bn" in parts:
        from mxnet_tpu_torch.ops.cuda import batch_norm as bn
        res["bn"] = bn_times(torch, cs, dev, bn)
    print("AB " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
