#!/usr/bin/env python3
"""Designs of four flash kernels of the PyTorch port, each built from a
copy of its source with text replaced, timed in turns on one GPU.

    python3 tools/torch_wide_variants.py fwd [VARIANT ...]
    python3 tools/torch_wide_variants.py dkv [VARIANT ...]
    python3 tools/torch_wide_variants.py fused [VARIANT ...]
    python3 tools/torch_wide_variants.py f32dkv [VARIANT ...]

``fwd``: the f32 forward on 3xTF32 (``wwg::wide_fwd_tf32`` in
``csrc/flash_attention_wide_wg.cu``) at (2, 4, 512, 320), (8, 8, 1024, 320),
(2, 4, 512, 576) and (4, 8, 1024, 1024) f32 with key padding. ``dkv``: the
streamed 16-bit dk / dv (``wdkv::wide_dkv_st`` in
``csrc/flash_attention_wide_dkv.cu``) at (2, 4, 512, 576), (4, 8, 1024, 1024)
and (2, 4, 512, 1280) bf16 with key padding. Variants (all of the part's by
default; ``base`` is the source as it stands):

- fwd ``no5``: slices of at most 5 output panels (TF_NO; 4 or 5 at these
  shapes);
  ``g1``: one panel a ring step (TF_G); ``pipe0``: one wgmma group a score
  or value step, waited on before the next is issued; ``oldmap``: V's
  transpose with a warp over 4 keys x 8 chunks (bank conflicts on its
  stores); ``oldk``: K's split loading one float4 at a time;
- fwd cut builds, wrong by design (their error only shows that they ran):
  ``no_s`` (the S products out), ``no_pv`` (the P V products out),
  ``no_split`` (the splitters' work out);
- dkv ``g2``, ``g4``: 2 / 4 head-dim panels a score step (ST_G).

``fused``: the f32 fused backward pass on 3xTF32 (``tf::bwd_fused_tf32`` in
``csrc/flash_attention_bwd.cu``) at BERT-base's (8, 12, 512, 64) key
padding and GPT-2 training's (8, 12, 1024, 64) causal, cut builds, wrong by
design: ``no_sdp`` (the s^T and dp^T products out; K's and V's halves
still split), ``no_dkv`` (the dv and dk products out), ``no_dq`` (dq^T's
K^T halves, products and staging out; the reduce-add of a zeroed buffer
kept), ``no_split`` (the splitter warps' work out).

``f32dkv``: the f32 dk / dv that streams the head dim on 3xTF32
(``tf::bwd_dkv_tf32_st`` in ``csrc/flash_attention_bwd.cu``) at (4, 8,
1024, 256), (2, 4, 512, 320) and (8, 8, 1024, 320) f32 with key padding,
cut builds, wrong by design: ``no_sdp`` (the s^T and dp^T products out;
K's and V's halves still split), ``no_val`` (the dv and dk products of the
value step out, and with them the split of their A operand),
``no_split`` (the splitter warps' work out).

Each build goes into ``build/variants/`` with ``_kernels.NVCC_FLAGS`` (its
``-Xptxas -v`` lines for the kernel printed), then every variant is timed
in the order base, variants, variants reversed, base: the device time of
the kernel's records a launch (``chip_smoke.launch_ms``), beside its max
error against the plain version (relative for dk / dv, the fused pass's
relative for dk and dv). Run from the root
of a checkout on a machine with the card. Imports nothing of JAX.
"""
import ctypes
import os
import re
import subprocess
import sys

WG = "mxnet_tpu_torch/csrc/flash_attention_wide_wg.cu"
BWD = "mxnet_tpu_torch/csrc/flash_attention_bwd.cu"
DKV = "mxnet_tpu_torch/csrc/flash_attention_wide_dkv.cu"
_SLICES = "static_assert(TF_NO == 6, \"wide_fwd_tf32 takes slices of 4 to 6 panels\");"
_S_MMA = """          hop::wgmma_tf32_rs32(sc, ah[g][kk], dkh,
                               j > 0 || g > 0 || kk > 0);
          hop::wgmma_tf32_rs32(sc, ah[g][kk],
                               hop::desc_kmajor_sw128(kl + kk * 32));
          hop::wgmma_tf32_rs32(sc, al[g][kk], dkh);"""
_PV_MMA = """          hop::wgmma_tf32_rs32(acc, phi[j], hop::desc_kmajor_sw128(b));
          hop::wgmma_tf32_rs32(acc, phi[j],
                               hop::desc_kmajor_sw128(b + TF_LO));
          hop::wgmma_tf32_rs32(acc, plo[j], hop::desc_kmajor_sw128(b));"""
_SPLIT = """        if (j < L.NS)
          tf_split_keys(slot, min(TF_G, L.P - j * TF_G), t);
        else
          tf_split_values(slot, min(TF_G, no - (j - L.NS) * TF_G), t);"""
_PIPE0 = [
    ("""        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the group before this one is done
        if (g == 0 && j > 0) release(empty + prev);
      }
      prev = st;
      st_advance(st, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);""",
     """      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      release(empty + st);
      st_advance(st, ph, L.SLOTS);
    }"""),
    ("""      hop::wgmma_commit();
      hop::wgmma_wait<1>();  // the step before is done
      if (v > 0) release(empty + prev);
      prev = st;
      st_advance(st, ph, L.SLOTS);
    }
    hop::wgmma_wait<0>();
    release(empty + prev);""",
     """      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      release(empty + st);
      st_advance(st, ph, L.SLOTS);
    }"""),
    ("""    int prev = 0;  // the slot of the step before, in use until its last
                   // group is done
""", "")]
_OLDMAP = [
    ("const int i = t + u * TF_SPLIT, r = i & 31, c = (i >> 5) & 7;",
     "const int i = t + u * TF_SPLIT, r = (i >> 3) & 31, c = i & 7;"),
    ("const int i = t + u * TF_SPLIT, s = tf32_key_pos(i & 31);",
     "const int i = t + u * TF_SPLIT, s = tf32_key_pos((i >> 3) & 31);"),
    ("const int row = (i / K4) * 32 + ((i >> 5) & 7) * 4 + e;",
     "const int row = (i / K4) * 32 + (i & 7) * 4 + e;")]
_OLDK = [("""  float4 x[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * TF_SPLIT;
    if (i < n * K4) x[u] = reinterpret_cast<const float4*>(hi)[i];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = t + u * TF_SPLIT;
    if (i >= n * K4) break;
    uint4 h, l;""", """  float4 x[1];
#pragma unroll
  for (int i = t; i < TF_G * K4; i += TF_SPLIT) {
    if (i >= n * K4) break;
    const int u = 0;
    x[0] = reinterpret_cast<const float4*>(hi)[i];
    uint4 h, l;""")]

# the fused pass's cut builds: text of csrc/flash_attention_bwd.cu
_SDP = [("""#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_tf32_3x(st, h0[kk], l0[kk], qt + p * PANEL_Q + kk * 32, T,
                           p > 0 || kk > 0);""",
  """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        st[kk] += __uint_as_float(h0[kk][0] ^ l0[kk][3]);"""),
 ("""#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::wgmma_tf32_3x(dpt, h1[kk], l1[kk], ot + p * PANEL_Q + kk * 32,
                           T, p > 0 || kk > 0);""",
  """#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        dpt[kk] += __uint_as_float(h1[kk][0] ^ l1[kk][3]);""")]
_DKV = [("""        hop::wgmma_tf32_3x(dv[p], h0[j], l0[j],
                           ot + 2 * T + p * PANEL_Q + j * 32, T);
        hop::wgmma_tf32_3x(dk[p], h1[j], l1[j],
                           qt + 2 * T + p * PANEL_Q + j * 32, T);""",
  """        dv[p][j] += __uint_as_float(h0[j][0] ^ l0[j][3]);
        dk[p][j] += __uint_as_float(h1[j][0] ^ l1[j][3]);""")]
_DQ = [("""#pragma unroll
    for (int c = 0; c < MC; ++c) {
      // two groups of 4 k8 steps (keys 0-31, 32-63), their A halves in the
      // two sets of registers, so the second's are split as the first runs
      float acc[16];
      const int d = 64 * c + kl;  // this thread's rows d, d + 8 of dq^T
      const bool in = 64 * c + 16 * warp < DP;
      const unsigned char* kp = sm + L::K + (d >> 5) * PANEL_K;
      const int dw = (d & 31) >> 2, dc = (d & 3) * 4;
      kt_split(kp, dw, dc, t4, 0, in, h0, l0);
      hop::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        hop::wgmma_tf32_3x(acc, h0[u], l0[u], base + L::DS + u * 32,
                           L::DS_LO, u > 0);
      hop::wgmma_commit();
      kt_split(kp, dw, dc, t4, 1, in, h1, l1);
      hop::wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u)
        hop::wgmma_tf32_3x(acc, h1[u], l1[u],
                           base + L::DS + PANEL_Q + u * 32, L::DS_LO);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc, 16);
      // dq^T's element i: row d + 8 ((i >> 1) & 1), query 8 (i / 4) + 2 t4
      // + (i & 1), into the staging buffer's [query][d]
#pragma unroll
      for (int i = 0; i < 16; ++i)
        stage[(8 * (i >> 2) + 2 * t4 + (i & 1)) * L::ACC_LD + d +
              ((i & 2) ? 8 : 0)] = acc[i];
    }
""",
  """""")]
_FSPLIT = [("""      split_tile<NP>(st + L::Q, t);
      split_tile<NP>(st + L::O, t);""",
  """      (void)st;""")]
# the streamed f32 dk / dv's cut builds: text of csrc/flash_attention_bwd.cu
_ST_SDP = [("""#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_tf32_3x(acc, hi[kk], lo[kk], b + kk * 32, b_lo, add || kk > 0);""",
  """  (void)b; (void)b_lo; (void)add;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    acc[kk] += __uint_as_float(hi[kk][0] ^ lo[kk][3]);""")]
_ST_VAL = [("""        hop::wgmma_tf32_3x(acc[p], h0[j], l0[j], vt + p * PANEL_Q + j * 32,
                           V_LO);""",
  """        (void)vt;""")]
_ST_SPLIT = [("""          split_rows(slot + S_Q, n, t);
          if (DK) split_rows(slot + S_O, n, t);""",
  """          (void)n;"""),
 ("""          split_cols(slot, w, t);""", """          (void)slot;""")]

PARTS = {
    "fwd": dict(
        source=WG, entry="mxt_flash_wide_wg_fwd", kernel="wide_fwd_tf32",
        shapes=((2, 4, 512, 320), (8, 8, 1024, 320), (2, 4, 512, 576),
                (4, 8, 1024, 1024)),
        variants={
            "no5": [("constexpr int TF_NO = 6;", "constexpr int TF_NO = 5;"),
                    (_SLICES, "")],
            "g1": [("constexpr int TF_G = 2;", "constexpr int TF_G = 1;")],
            "pipe0": _PIPE0, "oldmap": _OLDMAP, "oldk": _OLDK,
            "no_s": [(_S_MMA, "(void)dkh; (void)kl;")],
            "no_pv": [(_PV_MMA, "(void)acc; (void)b;")],
            "no_split": [(_SPLIT, "(void)slot;")]}),
    "dkv": dict(
        source=DKV, entry="mxt_flash_wide_wg_dkv", kernel="wide_dkv_st",
        shapes=((2, 4, 512, 576), (4, 8, 1024, 1024), (2, 4, 512, 1280)),
        variants={
            "g2": [("constexpr int ST_G = 3;", "constexpr int ST_G = 2;")],
            "g4": [("constexpr int ST_G = 3;", "constexpr int ST_G = 4;")]}),
    "fused": dict(
        source=BWD, entry="mxt_flash_attention_bwd", kernel="bwd_fused_tf32",
        shapes=((8, 12, 512, 64, "keypad", False),
                (8, 12, 1024, 64, None, True)),
        variants={"no_sdp": _SDP, "no_dkv": _DKV, "no_dq": _DQ,
                  "no_split": _FSPLIT}),
    "f32dkv": dict(
        source=BWD, entry="mxt_flash_attention_bwd", kernel="bwd_dkv_tf32_st",
        shapes=((4, 8, 1024, 256), (2, 4, 512, 320), (8, 8, 1024, 320)),
        variants={"no_sdp": _ST_SDP, "no_val": _ST_VAL,
                  "no_split": _ST_SPLIT})}


def start_build(kernels, which, part, name, cuts):
    """nvcc of the part's source with ``cuts`` replaced, started."""
    src = open(part["source"]).read()
    for old, new in cuts:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: its text is not in "
                             f"{part['source']} once: {old[:60]!r}")
        src = src.replace(old, new)
    os.makedirs("build/variants", exist_ok=True)
    cu = f"build/variants/{which}_{name}.cu"
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", "mxnet_tpu_torch/csrc",
         "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), so


def load(part, so, log, name):
    """The built entry with ctypes argument types, its ptxas lines printed
    (those naming the kernel's mangled template, ``<length>name I``)."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if not re.search(r"\d" + part["kernel"] + "[IE]", ln):
            continue
        if re.search(r"C75\d\d", ln):
            print(f"{name}: {ln.strip()[:160]}", flush=True)
        elif "Function properties" in ln:
            used = next((x for x in lines[i:i + 4] if "Used" in x), "")
            print(f"{name}: {used.strip()}", flush=True)
    fn = getattr(ctypes.CDLL(os.path.abspath(so)), part["entry"])
    p, i = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    if part["entry"].endswith("_fwd"):
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, strides,
                       ctypes.c_float, i, p, i, ctypes.c_uint,
                       ctypes.c_float, p]
    else:
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                       strides, ctypes.c_float, i, p, i, ctypes.c_uint,
                       ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def timed(torch, cs, attn, which, part, fn, c, want):
    """(device ms a launch, error) of one build on case ``c``."""
    keep = lambda n: part["kernel"] in n   # noqa: E731
    if which == "fwd":
        q, k, v, bias, scale = (c[x] for x in ("q", "k", "v", "bias",
                                               "scale"))
        out, lse = attn._fwd_outputs(q)
        call = lambda: attn._launch_fwd(   # noqa: E731
            q, k, v, bias, None, 0.0, out, lse, scale, False, fn=fn)
        call()
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        return cs.launch_ms(call, 10, keep), err
    name = ("flash_attention_bwd_fused" if which == "fused"
            else "flash_attention_bwd_dkv" if c["D"] <= attn.MAX_HEAD_DIM
            else "flash_attention_wide_dkv")
    call, outs = cs.kernel_only_call(torch, attn, c, name, fn=fn)
    call()
    torch.cuda.synchronize()
    err = max(cs.rel(outs[1], want[1]), cs.rel(outs[2], want[2]))
    return cs.launch_ms(call, 5, keep), err


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] not in PARTS:
        print(__doc__, file=sys.stderr)
        return 2
    which, part = sys.argv[1], PARTS[sys.argv[1]]
    names = sys.argv[2:] or list(part["variants"])
    if not set(names) <= set(part["variants"]):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops.cuda import attention as attn
    print(cs.smi_line(), flush=True)
    builds = {n: start_build(_kernels, which, part, n,
                             part["variants"].get(n, []))
              for n in ["base"] + names}
    fns = {}
    for n, (proc, so) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{n}: build failed\n{log[-3000:]}", file=sys.stderr)
            return 1
        fns[n] = load(part, so, log, n)
    order = ["base"] + names + names[::-1] + ["base"]
    dtn = "bfloat16" if which == "dkv" else "float32"
    gen = torch.Generator().manual_seed(5)
    dev = torch.device("cuda:0")
    for B, Hh, T, d, *rest in part["shapes"]:
        bias_kind, causal = rest or ("keypad", False)
        c = cs.wide_timed_case(torch, dev, gen, attn, B, Hh, T, d, bias_kind,
                               causal, dtn)
        if which == "fwd":
            want, _ = attn.flash_attention_reference(
                c["q"], c["k"], c["v"], c["bias"], c["scale"], False)
        else:
            want = attn.flash_attention_backward_reference(
                c["q"], c["k"], c["v"], c["bias"], None, 0.0, c["out"],
                c["lse"], c["do"], c["scale"], causal, False)
        res = {}
        for n in order:
            res.setdefault(n, []).append(
                timed(torch, cs, attn, which, part, fns[n], c, want))
        print(f"({B}, {Hh}, {T}, {d}) {dtn} "
              f"{'causal' if causal else bias_kind}: " + "; ".join(
            f"{n} {' / '.join(f'{ms:.4f}' for ms, _ in r)} ms "
            f"(error {max(e for _, e in r):.1e})" for n, r in res.items()),
            flush=True)
        del c, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
