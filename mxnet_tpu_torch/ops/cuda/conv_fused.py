"""Prologue-fused 1x1 convolution: the Hopper kernels, their plain versions,
autograd.

Counterpart of ``mxnet_tpu/ops/pallas/conv_fused.py``
(``fused_prologue_conv1x1``, ``_fused_core`` and its custom VJP, ``_fwd``,
``_dgrad``, ``_wgrad``). ``csrc/conv_fused.cu`` replaces ``_fwd_kernel``,
``_dgrad_kernel`` and ``_wgrad_kernel``; it is built and loaded by
:mod:`mxnet_tpu_torch._kernels`. Over x flattened to (N, Ci, M), M = H*W, and
``f(x) = relu(x * scale + shift)`` per input channel (the affine part and the
ReLU each optional):

- fwd: ``y[n] = W @ f(x[n]) + bias``, in x's dtype;
- dgrad: ``da[n] = (W^T @ dy[n]) * [x * scale + shift > 0]``, in f32;
- wgrad: ``dW = sum_n dy[n] @ f(x[n])^T``, in W's dtype, with both operands
  rounded to bf16 first when dy is bf16; for fp16 f(x) stays f32, as in
  the JAX kernel (the kernel multiplies dy by fp16(f) and by the fp16
  remainder f - fp16(f) into the same f32 sums).

Routing: a tensor on the CPU takes the plain versions
(:func:`conv1x1_fwd_reference`, :func:`conv1x1_dgrad_reference`,
:func:`conv1x1_wgrad_reference`); a CUDA tensor launches the kernels or
raises :class:`MXNetError`. Nothing falls back. Each launch adds one to its
kernel's entry in :data:`launches`. The JAX package's ``fusion_profitable``
(a TPU traffic rule) and block chooser have no counterpart: the Hopper
kernels tile by the plan of :func:`conv1x1_plan`, a pure function of the
shape, the dtype and the operands' alignment. wgrad's split partial sums
are added in a fixed order, so dW is the same from run to run.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ...base import MXNetError

__all__ = ["fused_prologue_conv1x1", "conv1x1_fwd_reference",
           "conv1x1_dgrad_reference", "conv1x1_wgrad_reference",
           "conv1x1_plan", "launches", "KERNELS"]

KERNELS = ("conv1x1_fwd", "conv1x1_dgrad", "conv1x1_wgrad")
# per-kernel launch counters: +1 per kernel launch, nowhere else
launches = {name: 0 for name in KERNELS}
_COUNT_LOCK = threading.Lock()
_FNS = {}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TILE = 64
# the f32 wgrad splits its N*M reduction until about this many blocks are
# in flight: four per SM of an H100's 132
_WGRAD_BLOCKS = 4 * 132
SMS = 132                    # an H100's streaming multiprocessors
# the 16-bit wgrad (csrc/conv_fused.cu, namespace wg): 128 x 128 output
# tiles, 64 deep a step; its runs keep as many image slots as fit beside
# its barriers and two 16 KB tiles (the C entry derives the shared memory
# from the plan and refuses a plan that does not fit); it splits its
# reduction until about two blocks per SM are in flight
_WG_TILE, _WG_BK, _TILE_BYTES = 128, 64, 128 * 64 * 2
_BARS, _MAX_SLOTS, SMEM_MAX = 256, 16, 232448
_WGRAD_TARGET = 2 * SMS
# the 16-bit fwd and dgrad (namespace tc): 64-position panels, 64-deep
# steps, 8 KB panels of 64 swizzled 128-byte rows; the ring takes as many
# slots (at most 6) as fit beside dgrad's repacked B buffers (runs), the
# output staging, 1 KB of alignment and 256 bytes of barriers
# (tc::make_plan), and at least two
PANEL, _PANEL_BYTES, _TC_MAX_STAGES, _TC_BARS = 64, 64 * 128, 6, 256


def _tc_layout(kind, N, Ci, Co, M, tile):
    """tc::make_plan's walk and shared-memory layout, or None where the
    ring would take fewer than two slots."""
    dgrad = kind == "dgrad"
    runs = M % 8 != 0
    ppi = _cdiv(M, PANEL)
    panels = N * ppi
    pb = 256 // tile if dgrad else 2
    groups = _cdiv(panels, pb)
    imgs = 0
    if runs:        # the start P0 % ppi repeats within ppi groups
        imgs = max(min(panels - 1, g * pb + pb - 1) // ppi - g * pb // ppi + 1
                   for g in range(min(groups, ppi)))
    w_bytes = tile // 64 * _PANEL_BYTES if dgrad else tile * 128
    act = _cdiv(imgs * 128 * M, 1024) * 1024 if runs else pb * _PANEL_BYTES
    slot = w_bytes + act    # dgrad's x fill (TMA rows) fits too
    bt = 2 * pb * _PANEL_BYTES if runs else 0   # repacked panels
    staging = 2 * 64 * 128 * 4 if dgrad else 2 * tile * 128
    stages = min(_TC_MAX_STAGES,
                 (SMEM_MAX - 1024 - _TC_BARS - bt - staging) // slot)
    if stages < 2:
        return None
    return dict(ppi=ppi, panels=panels, tile_panels=pb, imgs=imgs,
                tiles=groups * _cdiv(Ci if dgrad else Co, tile),
                stages=stages, slot_bytes=slot, bt_bytes=bt,
                staging_bytes=staging)


# ---------------------------------------------------------- plain versions
def _prologue(x3, scale, shift, relu: bool):
    """f(x) in f32: ``x * scale + shift`` per channel, then the ReLU."""
    a = x3.float()
    if scale is not None:
        a = a * scale.float().reshape(1, -1, 1) + shift.float().reshape(1, -1, 1)
    return torch.relu(a) if relu else a


def conv1x1_fwd_reference(x3, scale, shift, w, relu: bool, bias=None):
    """Plain version of the fwd kernel: ``W @ f(x) + bias`` over x3 (N, Ci,
    M), W (Co, Ci); f(x) rounded to W's dtype, f32 products and sums, the
    result in x's dtype."""
    h = _prologue(x3, scale, shift, relu).to(w.dtype).float()
    y = torch.matmul(w.float(), h)
    if bias is not None:
        y = y + bias.float().reshape(1, -1, 1)
    return y.to(x3.dtype)


def conv1x1_dgrad_reference(x3, scale, shift, w, dy3, relu: bool):
    """Plain version of the dgrad kernel: ``W^T @ dy``, zero where
    ``x * scale + shift <= 0`` when ``relu``; f32 (N, Ci, M)."""
    da = torch.matmul(w.float().t(), dy3.float())
    if relu:
        a = _prologue(x3, scale, shift, False)
        da = torch.where(a > 0, da, torch.zeros_like(da))
    return da


def conv1x1_wgrad_reference(x3, scale, shift, dy3, relu: bool, out_dtype):
    """Plain version of the wgrad kernel: ``sum_n dy[n] @ f(x[n])^T`` in
    ``out_dtype``; both operands rounded to bf16 first when dy is bf16."""
    h = _prologue(x3, scale, shift, relu)
    cd = torch.bfloat16 if dy3.dtype == torch.bfloat16 else torch.float32
    dw = torch.einsum("nom,ncm->oc", dy3.to(cd).float(), h.to(cd).float())
    return dw.to(out_dtype)


# ------------------------------------------------------------- the kernels
def _kernel(name: str):
    """The ctypes entry of kernel ``name``, its library built on first use."""
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    from ... import _kernels
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _kernels.load("conv_fused")
    if name == "conv1x1_fwd":
        fn = lib.mxt_conv1x1_fwd
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    elif name == "conv1x1_dgrad":
        fn = lib.mxt_conv1x1_dgrad
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    else:
        fn = lib.mxt_conv1x1_wgrad
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    _FNS[name] = fn
    return fn


def _check_operands(x3, w=None, dy3=None, scale=None, shift=None, bias=None):
    """x3 (N, Ci, M), w (Co, Ci) and dy3 (N, Co, M) contiguous on one CUDA
    device in one dtype; scale, shift (Ci,) and bias (Co,) contiguous f32
    there. Returns (N, Ci, Co, M)."""
    ts = [t for t in (x3, w, dy3) if t is not None]
    vecs = [t for t in (scale, shift, bias) if t is not None]
    if not all(t.is_cuda and t.device == x3.device for t in ts + vecs):
        raise MXNetError("conv1x1: every operand must lie on one CUDA device")
    if x3.dtype not in _DTYPE_CODE or not all(t.dtype == x3.dtype for t in ts):
        raise MXNetError(f"conv1x1: x, w and dy must share one dtype of "
                         f"float32/bfloat16/float16; got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.dtype == torch.float32 for t in vecs):
        raise MXNetError("conv1x1: scale, shift and bias must be float32")
    if not all(t.is_contiguous() for t in ts + vecs):
        raise MXNetError("conv1x1: operands must be contiguous")
    if (scale is None) != (shift is None):
        raise MXNetError("conv1x1: scale and shift come together")
    N, Ci, M = x3.shape
    Co = w.shape[0] if w is not None else dy3.shape[1]
    if (w is not None and tuple(w.shape) != (Co, Ci)) or \
            (dy3 is not None and tuple(dy3.shape) != (N, Co, M)) or \
            (scale is not None and (scale.numel() != Ci
                                    or shift.numel() != Ci)) or \
            (bias is not None and bias.numel() != Co):
        raise MXNetError(
            f"conv1x1: shapes do not match: x {tuple(x3.shape)}, w "
            f"{None if w is None else tuple(w.shape)}, dy "
            f"{None if dy3 is None else tuple(dy3.shape)}")
    return N, Ci, Co, M


def _ptr(t):
    return None if t is None else t.data_ptr()


def _run(name, *args, device, fn=None) -> None:
    """Launch kernel ``name``, or ``fn``, a build of it with an experiment's
    defines (``chip_smoke.py --probe-conv``), which is not counted."""
    counted = fn is None
    fn = _kernel(name) if fn is None else fn
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise MXNetError(f"{name} kernel launch failed: CUDA error {err}")
    if counted:
        with _COUNT_LOCK:
            launches[name] += 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align(*ts) -> int:
    """The largest power of two up to 16 that divides every tensor's
    address."""
    a = 16
    for t in ts:
        while t.data_ptr() % a:
            a //= 2
    return a


def conv1x1_plan(kind: str, N: int, Ci: int, Co: int, M: int, dtype,
                 align: int = 16) -> dict:
    """How the ``fwd``, ``dgrad`` or ``wgrad`` kernel runs at a shape: a
    pure function of the shape, the dtype and ``align`` (the largest power
    of two up to 16 dividing the operands' addresses), so the split of
    wgrad's reduction, and with it the order of its sums, is too.

    16-bit fwd and dgrad (channels multiples of 8, every operand 16-byte
    aligned): ``mode`` ``tma`` (M % 8 == 0: TMA boxes of whole 64-position
    panels) or ``runs`` (else: one cp.async.bulk of each image's 64-channel
    run a step, while two ring slots fit); ``ppi`` 64-position panels a
    image and ``panels`` in all, ``tile`` output channels a block tile
    (dgrad: ci, fwd: co; 64 or 128) and ``tile_panels``
    its panels, ``imgs`` (runs) most images a tile's panels touch,
    ``steps`` 64-deep contraction steps a tile (dgrad's ReLU on TMA rows
    adds one fill, the mask's x tile), ``stages`` ring slots of
    ``slot_bytes``, ``tiles`` and ``blocks`` (persistent: at most one an
    SM), ``store``: ``tma`` where the output's rows are 16-byte multiples
    (f32 da: M % 4 == 0; 16-bit y: M % 8 == 0), else ``bulk`` where a
    panel is a whole image (M <= 64: one 1-D bulk copy of its contiguous
    channel rows), else ``threads``. Other shapes take ``general`` (the
    FMA kernels).

    16-bit wgrad: ``mode`` how x and dy reach shared memory, ``rows16`` /
    ``rows8`` (16- / 8-byte cp.async of rows whose length is a multiple of
    8 / 4 elements), ``runs`` (cp.async.bulk of each image's contiguous
    channel-tile run, 8 <= M < 64 not a multiple of 4) or ``general``
    (element loads, any shape); ``vec`` elements per copy of x and dy;
    ``tile`` (co, ci) of the output per block, ``bk`` the contraction per
    step; ``splits`` blocks along the reduction, ``per`` images each,
    ``slots`` images in its ring (runs); ``tiles``, ``blocks`` (tiles x
    splits) and ``steps`` (contraction steps of a block). f32 (``mode``
    ``f32``), and 16-bit ``general`` fwd and dgrad: the FMA kernels' 64 x
    64 tiles; f32 wgrad's splits in steps of 16 positions."""
    if kind not in ("fwd", "dgrad", "wgrad"):
        raise MXNetError(f"conv1x1_plan: kind must be fwd, dgrad or wgrad, "
                         f"not {kind!r}")
    if kind != "wgrad":
        out_ch = Co if kind == "fwd" else Ci
        tile = 64 if out_ch <= 64 else 128
        layout = None
        if dtype != torch.float32 and align >= 16 and Ci % 8 == 0 and \
                Co % 8 == 0:
            layout = _tc_layout(kind, N, Ci, Co, M, tile)
        if layout is None:
            tiles = _cdiv(M, 64) * _cdiv(out_ch, 64) * N
            return dict(kind=kind, mode="f32" if dtype == torch.float32
                        else "general", tile=(64, 64), bk=16, tiles=tiles,
                        blocks=tiles,
                        steps=_cdiv(Co if kind == "dgrad" else Ci, 16))
        store = "tma" if M % (4 if kind == "dgrad" else 8) == 0 else \
            "bulk" if layout["ppi"] == 1 else "threads"
        return dict(kind=kind, mode="tma" if M % 8 == 0 else "runs",
                    tile=tile, steps=_cdiv(Ci if kind == "fwd" else Co, 64),
                    blocks=min(layout["tiles"], SMS), store=store, **layout)
    if dtype == torch.float32:
        steps = N * _cdiv(M, 16)
        tiles = _cdiv(Co, 64) * _cdiv(Ci, 64)
        splits = max(1, min(steps, _cdiv(_WGRAD_BLOCKS, tiles), 65535))
        return dict(kind=kind, mode="f32", vec=1, tile=(64, 64), bk=16,
                    splits=splits, per=_cdiv(steps, splits), slots=0,
                    tiles=tiles, steps=_cdiv(steps, splits),
                    blocks=tiles * splits)
    vec = 8 if M % 8 == 0 and align >= 16 else \
        4 if M % 4 == 0 and align >= 8 else 1
    mode = {8: "rows16", 4: "rows8", 1: "general"}[vec]
    slots = 0
    if vec == 1 and align >= 16 and Ci % 8 == 0 and Co % 8 == 0 and \
            8 <= M < 64:
        # the fp16 wgrad keeps a third tile: f(x) - fp16(f(x))
        tiles = 3 if dtype == torch.float16 else 2
        slots = min(_MAX_SLOTS,
                    (SMEM_MAX - _BARS - tiles * _TILE_BYTES) // (512 * M))
        if slots >= _cdiv(_WG_BK - 1, M) + 3:
            mode = "runs"
    if mode != "runs":
        slots = 0
    tiles = _cdiv(Co, _WG_TILE) * _cdiv(Ci, _WG_TILE)
    per = _cdiv(N, max(1, min(N, _cdiv(_WGRAD_TARGET, tiles))))
    splits = _cdiv(N, per)
    return dict(kind=kind, mode=mode, vec=vec, tile=(_WG_TILE, _WG_TILE),
                bk=_WG_BK, slots=slots, splits=splits, per=per,
                steps=_cdiv(per * M, _WG_BK), tiles=tiles,
                blocks=tiles * splits)


def _tc_args(plan) -> tuple:
    """The C entries' (tc, tile, blocks) of a fwd / dgrad plan."""
    if plan["mode"] not in ("tma", "runs"):
        return 0, 64, 1
    return 1, plan["tile"], plan["blocks"]


def _fwd(x3, scale, shift, w, relu: bool, bias=None, fn=None):
    if not x3.is_cuda:
        return conv1x1_fwd_reference(x3, scale, shift, w, relu, bias)
    N, Ci, Co, M = _check_operands(x3, w, None, scale, shift, bias)
    plan = conv1x1_plan("fwd", N, Ci, Co, M, x3.dtype, _align(x3, w))
    y = torch.empty((N, Co, M), dtype=x3.dtype, device=x3.device)
    _run("conv1x1_fwd", _DTYPE_CODE[x3.dtype], x3.data_ptr(), w.data_ptr(),
         _ptr(scale), _ptr(shift), _ptr(bias), y.data_ptr(), N, Ci, Co, M,
         int(relu), *_tc_args(plan), device=x3.device, fn=fn)
    return y


def _dgrad(x3, scale, shift, w, dy3, relu: bool, fn=None):
    if not x3.is_cuda:
        return conv1x1_dgrad_reference(x3, scale, shift, w, dy3, relu)
    N, Ci, Co, M = _check_operands(x3, w, dy3, scale, shift)
    plan = conv1x1_plan("dgrad", N, Ci, Co, M, x3.dtype, _align(x3, w, dy3))
    da = torch.empty((N, Ci, M), dtype=torch.float32, device=x3.device)
    _run("conv1x1_dgrad", _DTYPE_CODE[x3.dtype], x3.data_ptr(), w.data_ptr(),
         dy3.data_ptr(), _ptr(scale), _ptr(shift), da.data_ptr(), N, Ci, Co,
         M, int(relu), *_tc_args(plan), device=x3.device, fn=fn)
    return da


def _wgrad(x3, scale, shift, dy3, relu: bool, out_dtype):
    if not x3.is_cuda:
        return conv1x1_wgrad_reference(x3, scale, shift, dy3, relu, out_dtype)
    N, Ci, Co, M = _check_operands(x3, None, dy3, scale, shift)
    if out_dtype != x3.dtype:
        raise MXNetError(f"conv1x1: wgrad writes x's dtype {x3.dtype}, not "
                         f"{out_dtype}")
    plan = conv1x1_plan("wgrad", N, Ci, Co, M, x3.dtype, _align(x3, dy3))
    ws = torch.empty((plan["splits"], Co, Ci), dtype=torch.float32,
                     device=x3.device)
    dw = torch.empty((Co, Ci), dtype=out_dtype, device=x3.device)
    _run("conv1x1_wgrad", _DTYPE_CODE[x3.dtype], x3.data_ptr(),
         dy3.data_ptr(), _ptr(scale), _ptr(shift), dw.data_ptr(),
         ws.data_ptr(), N, Ci, Co, M, int(relu), int(plan["mode"] == "runs"),
         plan["vec"], plan["splits"], plan["per"], plan["slots"],
         device=x3.device)
    return dw


class _FusedConv1x1(torch.autograd.Function):
    """``_fused_core`` with its custom VJP: the fwd kernel, then the dgrad
    and wgrad kernels on the saved x (not f(x)); the per-channel sums of
    the backward in plain torch, as the JAX package leaves them to XLA."""

    @staticmethod
    def forward(ctx, x3, scale, shift, bias, w, relu):
        ctx.save_for_backward(x3, scale, shift, bias, w)
        ctx.relu = relu
        return _fwd(x3, scale, shift, w, relu, bias)

    @staticmethod
    def backward(ctx, dy):
        x3, scale, shift, bias, w = ctx.saved_tensors
        dy = dy.contiguous()
        da = _dgrad(x3, scale, shift, w, dy, ctx.relu)
        dw = _wgrad(x3, scale, shift, dy, ctx.relu, w.dtype)
        dscale = dshift = dbias = None
        if scale is not None:
            dx = (da * scale.reshape(1, -1, 1)).to(x3.dtype)
            dscale = (da * x3.float()).sum(dim=(0, 2)).to(scale.dtype)
            dshift = da.sum(dim=(0, 2)).to(shift.dtype)
        else:
            dx = da.to(x3.dtype)
        if bias is not None:
            dbias = dy.float().sum(dim=(0, 2)).to(bias.dtype)
        return dx, dscale, dshift, dbias, dw, None


def fused_prologue_conv1x1(x, w, scale: Optional[torch.Tensor] = None,
                           shift: Optional[torch.Tensor] = None,
                           relu: bool = True,
                           bias: Optional[torch.Tensor] = None):
    """``y = w @ relu(x * scale + shift) + bias`` as one kernel, NCHW.

    x: (N, Ci, H, W); w: (Co, Ci) or (Co, Ci, 1, 1) in x's dtype;
    scale/shift: (Ci,) per-channel affine (the BN apply), or None for a
    plain-ReLU prologue; bias: (Co,) conv bias or None. Returns (N, Co, H,
    W) in x's dtype. Differentiable in x, w, scale, shift and bias."""
    N, Ci, H, W_ = x.shape
    if w.ndim == 4:
        w = w.reshape(w.shape[0], w.shape[1])
    Co = w.shape[0]
    x3 = x.reshape(N, Ci, H * W_).contiguous()
    if scale is not None:
        scale = scale.float().reshape(Ci).contiguous()
        shift = shift.float().reshape(Ci).contiguous()
    if bias is not None:
        bias = bias.float().reshape(Co).contiguous()
    y3 = _FusedConv1x1.apply(x3, scale, shift, bias, w.contiguous(),
                             bool(relu))
    return y3.reshape(N, Co, H, W_)
