#!/usr/bin/env python3
"""The multi-tensor update, the decode attention kernel and the wide flash
attention kernels of the PyTorch port in the tree at ROOT, timed on one GPU
at their main paths' shapes.

    python3 tools/torch_kernel_ab.py ROOT [update|decode|wide ...]

(the named parts only; all three by default)

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
``wide_dkv``) at ``WIDE_SHAPES``, bf16, q, k, v from one fused projection,
key padding ragged over the batch (valid lengths T - b T / (2 B)) or
causal: the device time of each kernel alone a launch, median of 5
sessions (the forward through ``_flash_forward``, dq and dk / dv through
``chip_smoke.kernel_only_call``, so the entry's delta is not in them), the
kernels' names matched whatever tree they come from.
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


# (B, H, T, D, bias, causal) of the wide kernels' timings: chip_smoke.py's
# WIDE_TIMED
WIDE_SHAPES = ((2, 4, 512, 288, "keypad", False),
               (8, 8, 1024, 320, "keypad", False),
               (8, 8, 1024, 320, None, True),
               (4, 8, 1024, 512, "keypad", False),
               (2, 4, 512, 576, "keypad", False),
               (4, 8, 1024, 1024, "keypad", False))
# every route's names: the tiled (_wg), the streamed (_st, heads above 512)
# and the warp-a-row kernels
WIDE_PATTERNS = {"fwd": r"wide_fwd(_wg|_st)?<", "dq": r"wide_dq(_wg|_st)?<",
                 "dkv": r"wide_dkv(_wg)?<"}


def wide_times(torch, cs, dev, attn):
    """{shape: ms a launch of each wide kernel} at ``WIDE_SHAPES``."""
    import math
    out = {}
    gen = torch.Generator().manual_seed(23)
    dt = torch.bfloat16
    for B, Hh, T, d, bias_kind, causal in WIDE_SHAPES:
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
        label = (f"({B}, {Hh}, {T}, {d}) "
                 f"{'causal' if causal else bias_kind}")
        out[label] = row
        del q, k, v, do, o, lse, c
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parts = sys.argv[2:] or ["update", "decode", "wide"]
    if len(sys.argv) < 2 or not set(parts) <= {"update", "decode", "wide"}:
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
    print("AB " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
