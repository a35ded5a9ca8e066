"""The port's prologue-fused 1x1 convolution on CPU tensors against the JAX
package's Pallas kernels run in interpret mode.

``mxnet_tpu_torch/ops/cuda/conv_fused.py`` holds the plain versions of the
three Hopper kernels (fwd, dgrad, wgrad) and the autograd Function around
them; on the CPU the Function runs the plain versions, which these tests
hold against ``mxnet_tpu/ops/pallas/conv_fused.py`` (``_fwd``, ``_dgrad``,
``_wgrad`` with ``interpret=True``, and ``fused_prologue_conv1x1`` with its
custom VJP) on the same numpy inputs.

Tolerances: f32 against f32, summation order only: rtol=atol=1e-5 for the
forward and dgrad (sums over at most 80 channels), atol=1e-4 for wgrad
(sums over N*M up to 4100 products) and for gradients through a sin(y)
loss; bf16 inputs: one bf16 rounding of the output (rtol=8e-3).
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas import conv_fused as jcf
from mxnet_tpu_torch.ops.cuda import conv_fused as cf

F32 = dict(rtol=1e-5, atol=1e-5)
F32_SUM = dict(rtol=1e-5, atol=1e-4)


def _case(seed, N, Ci, Co, M, affine, bias=False):
    rng = onp.random.RandomState(seed)
    x = rng.randn(N, Ci, M).astype("float32")
    w = (rng.randn(Co, Ci) * 0.1).astype("float32")
    dy = rng.randn(N, Co, M).astype("float32")
    scale = (rng.rand(Ci) + 0.5).astype("float32") if affine else None
    shift = (rng.randn(Ci) * 0.1).astype("float32") if affine else None
    b = (rng.randn(Co) * 0.1).astype("float32") if bias else None
    return x, w, dy, scale, shift, b


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, shape=None, dtype=jnp.float32):
    if a is None:
        return None
    a = jnp.asarray(a, dtype)
    return a if shape is None else a.reshape(shape)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_forward_matches_pallas(affine, relu, bias):
    N, Ci, Co, M = 2, 16, 24, 35
    x, w, _, s, t, b = _case(0, N, Ci, Co, M, affine, bias)
    want = jcf._fwd(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(w), relu, True,
                    _j(b, (Co, 1)))
    got = cf.conv1x1_fwd_reference(_t(x), _t(s), _t(t), _t(w), relu, _t(b))
    assert got.dtype == torch.float32 and got.shape == (N, Co, M)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_dgrad_matches_pallas(affine, relu):
    N, Ci, Co, M = 2, 16, 24, 35
    x, w, dy, s, t, _ = _case(1, N, Ci, Co, M, affine)
    want = jcf._dgrad(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(w), _j(dy),
                      relu, True)
    got = cf.conv1x1_dgrad_reference(_t(x), _t(s), _t(t), _t(w), _t(dy),
                                     relu)
    assert got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_wgrad_matches_pallas(affine, relu):
    N, Ci, Co, M = 2, 16, 24, 35
    x, _, dy, s, t, _ = _case(2, N, Ci, Co, M, affine)
    want = jcf._wgrad(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(dy), relu,
                      True, jnp.float32)
    got = cf.conv1x1_wgrad_reference(_t(x), _t(s), _t(t), _t(dy), relu,
                                     torch.float32)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32_SUM)


def test_plain_versions_match_pallas_in_bf16():
    """bf16 x, w, dy: f(x) rounded to bf16 before the product in fwd and
    wgrad, the output rounded once; dgrad's f32 output sums exact
    products."""
    N, Ci, Co, M = 2, 32, 16, 50
    x, w, dy, s, t, b = _case(3, N, Ci, Co, M, True, True)
    bf = jnp.bfloat16
    jx, jw, jdy = _j(x, dtype=bf), _j(w, dtype=bf), _j(dy, dtype=bf)
    tx, tw, tdy = (_t(a, torch.bfloat16) for a in (x, w, dy))
    js, jt = _j(s, (Ci, 1)), _j(t, (Ci, 1))
    y = cf.conv1x1_fwd_reference(tx, _t(s), _t(t), tw, True, _t(b))
    assert y.dtype == torch.bfloat16
    onp.testing.assert_allclose(
        y.float().numpy(),
        onp.asarray(jcf._fwd(jx, js, jt, jw, True, True, _j(b, (Co, 1))),
                    "float32"), rtol=8e-3, atol=1e-2)
    da = cf.conv1x1_dgrad_reference(tx, _t(s), _t(t), tw, tdy, True)
    onp.testing.assert_allclose(
        da.numpy(), onp.asarray(jcf._dgrad(jx, js, jt, jw, jdy, True, True)),
        **F32)
    dw = cf.conv1x1_wgrad_reference(tx, _t(s), _t(t), tdy, True,
                                    torch.bfloat16)
    assert dw.dtype == torch.bfloat16
    onp.testing.assert_allclose(
        dw.float().numpy(),
        onp.asarray(jcf._wgrad(jx, js, jt, jdy, True, True, bf), "float32"),
        rtol=8e-3, atol=1e-2)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_op_and_gradients_match_jax(affine, relu, bias):
    """fused_prologue_conv1x1's output and its gradients in x, w, scale,
    shift and bias (loss sum(sin(y))) through the port's autograd Function
    against jax.grad through the JAX package's custom VJP."""
    N, Ci, Co, H, W = 2, 16, 24, 5, 7
    x, w, _, s, t, b = _case(4, N, Ci, Co, H * W, affine, bias)
    x = x.reshape(N, Ci, H, W)
    w4 = w.reshape(Co, Ci, 1, 1)

    def jloss(x, w, s, t, b):
        return jnp.sum(jnp.sin(jcf.fused_prologue_conv1x1(x, w, s, t, relu,
                                                          b)))

    args = [_j(a) for a in (x, w4, s, t, b)]
    live = [i for i, a in enumerate(args) if a is not None]
    jy = jcf.fused_prologue_conv1x1(*args[:4], relu, args[4])
    jg = jax.grad(lambda *a: jloss(*[dict(zip(live, a)).get(i)
                                     for i in range(5)]),
                  argnums=tuple(range(len(live))))(*[args[i] for i in live])

    targs = [None if a is None else _t(a).requires_grad_(True)
             for a in (x, w4, s, t, b)]
    ty = cf.fused_prologue_conv1x1(*targs[:4], relu, targs[4])
    torch.sin(ty).sum().backward()
    onp.testing.assert_allclose(ty.detach().numpy(), onp.asarray(jy), **F32)
    for i, g in zip(live, jg):
        onp.testing.assert_allclose(targs[i].grad.numpy(), onp.asarray(g),
                                    rtol=1e-4, atol=1e-4, err_msg=str(i))


def test_nondivisible_channels():
    """Ci and Co that do not divide the JAX kernels' blocks (48 % 32, 80 %
    32) nor the Hopper kernels' 64-wide tiles, and a ragged M."""
    N, Ci, Co, M = 2, 48, 80, 33
    x, w, dy, s, t, _ = _case(5, N, Ci, Co, M, False)
    kw = dict(block_co=32, block_m=16, block_ci=32)
    y = jcf._fwd(_j(x), None, None, _j(w), True, True, **kw)
    onp.testing.assert_allclose(
        cf.conv1x1_fwd_reference(_t(x), None, None, _t(w), True).numpy(),
        onp.asarray(y), **F32)
    da = jcf._dgrad(_j(x), None, None, _j(w), _j(dy), True, True, **kw)
    onp.testing.assert_allclose(
        cf.conv1x1_dgrad_reference(_t(x), None, None, _t(w), _t(dy),
                                   True).numpy(), onp.asarray(da), **F32)
    dw = jcf._wgrad(_j(x), None, None, _j(dy), True, True, jnp.float32, **kw)
    onp.testing.assert_allclose(
        cf.conv1x1_wgrad_reference(_t(x), None, None, _t(dy), True,
                                   torch.float32).numpy(),
        onp.asarray(dw), **F32_SUM)


@pytest.mark.parametrize("affine", [True, False])
def test_wgrad_ragged_large_m(affine):
    """M = 4100 > 4096: the JAX wgrad tiles M by 512 with a ragged 4-lane
    last block masked on both operands; the sum must match and be finite."""
    N, Ci, Co, M = 1, 8, 8, 4100
    x, _, dy, s, t, _ = _case(12, N, Ci, Co, M, affine)
    dy = dy * 0.1
    want = jcf._wgrad(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(dy), True,
                      True, jnp.float32)
    got = cf.conv1x1_wgrad_reference(_t(x), _t(s), _t(t), _t(dy), True,
                                     torch.float32)
    assert torch.isfinite(got).all()
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32_SUM)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU no kernel is launched: the counters stay where they are,
    and the result is the plain version's."""
    before = dict(cf.launches)
    x, w, _, s, t, b = _case(6, 2, 8, 8, 9, True, True)
    xt = _t(x).reshape(2, 8, 3, 3).requires_grad_(True)
    y = cf.fused_prologue_conv1x1(xt, _t(w), _t(s), _t(t), True, _t(b))
    y.sum().backward()
    assert cf.launches == before
    want = cf.conv1x1_fwd_reference(_t(x), _t(s), _t(t), _t(w), True, _t(b))
    assert torch.equal(y.detach().reshape(2, 8, 9), want)


# ResNet-50's eight 1x1 junctions at batch 128 (Ci, Co, M), then ragged ones
JUNCTIONS = [(64, 256, 3136), (128, 512, 784), (256, 1024, 196),
             (512, 2048, 49), (256, 64, 3136), (512, 128, 784),
             (1024, 256, 196), (2048, 512, 49)]
SHAPES = [(128,) + j for j in JUNCTIONS] + [(3, 45, 77, 53), (2, 72, 40, 4100)]


@pytest.mark.parametrize("ci,co,m", JUNCTIONS)
def test_plan_puts_every_junction_on_the_copy_ring(ci, co, m):
    """At every b128 junction fwd and dgrad take the ring kernels: TMA
    exactly where the rows are 16-byte multiples (M = 3136, 784), one bulk
    copy of each image's 64-channel run at M = 196 and 49; one persistent
    block an SM, at most as many as tiles; the ring (two slots at least),
    dgrad's repacked B buffers and the output staging fit the shared
    memory. wgrad keeps its copy modes and fills the card. Each plan is a
    pure function of the shape."""
    n = 128
    for dtype in (torch.bfloat16, torch.float16):
        for kind in ("fwd", "dgrad"):
            plan = cf.conv1x1_plan(kind, n, ci, co, m, dtype)
            assert plan == cf.conv1x1_plan(kind, n, ci, co, m, dtype)
            assert plan["mode"] == ("tma" if m in (3136, 784) else "runs")
            assert plan["store"] == {
                3136: "tma", 784: "tma", 49: "bulk",
                196: "tma" if kind == "dgrad" else "threads"}[m]
            assert plan["blocks"] == min(plan["tiles"], cf.SMS)
            assert plan["tiles"] >= cf.SMS or (kind, ci) == ("fwd", 2048)
            assert plan["stages"] >= 2
            assert plan["stages"] * plan["slot_bytes"] + plan["bt_bytes"] \
                + plan["staging_bytes"] + 1280 <= cf.SMEM_MAX
            # no warpgroup multiplies rows past the channels at Ci = 64
            assert plan["tile"] <= max(64, ci if kind == "dgrad" else co)
        plan = cf.conv1x1_plan("wgrad", n, ci, co, m, dtype)
        assert plan["mode"] == ("rows16" if m % 8 == 0 else
                                "rows8" if m % 4 == 0 else "runs")
        assert plan["blocks"] >= cf.SMS
        assert plan["splits"] * plan["per"] >= n
        assert (plan["splits"] - 1) * plan["per"] < n


@pytest.mark.parametrize("shape,mode,wmode", [
    ((3, 45, 77, 53), "general", "general"),
    ((2, 72, 40, 4100), "general", "rows8"),
    ((2, 64, 72, 67), "runs", "general")])
def test_plan_of_ragged_shapes(shape, mode, wmode):
    """Channels that are not multiples of 8 send fwd and dgrad to the
    general path (the FMA kernels), and so do runs too long for two ring
    slots (M = 4100); M = 67 takes runs. wgrad's rows that are not 8-byte
    aligned take its element loads. An operand address that is not 16-byte
    aligned sends every junction to the general paths."""
    for kind in ("fwd", "dgrad"):
        assert cf.conv1x1_plan(kind, *shape, torch.bfloat16)["mode"] == mode
        for j in JUNCTIONS:
            assert cf.conv1x1_plan(kind, 128, *j, torch.bfloat16,
                                   align=8)["mode"] == "general"
        assert cf.conv1x1_plan(kind, *shape, torch.float32)["mode"] == "f32"
    assert cf.conv1x1_plan("wgrad", *shape, torch.bfloat16)["mode"] == wmode
    for j in JUNCTIONS:
        assert cf.conv1x1_plan("wgrad", 128, *j, torch.bfloat16,
                               align=2)["mode"] == "general"


# ------------------------------------------------------------------------
# numpy walks of the ring kernels' index arithmetic (csrc/conv_fused.cu,
# namespace tc)
def _swz(r, c):
    return r * 128 + ((c ^ (r & 7)) << 4)


def _a_addr(m0, kk, lane):
    mi = lane >> 3
    return _swz(16 * kk + ((mi >> 1) << 3) + (lane & 7), (m0 >> 3) + (mi & 1))


def _a_fragment(m, k):
    """(m, k) of each (lane, register, half) of the wgmma A fragment of
    warp w's 16 rows: registers 0/1 rows g, g + 8 at k 2 t4 (+ 1),
    registers 2/3 the same at k + 8."""
    out = {}
    for lane in range(32):
        g8, t4 = lane >> 2, lane & 3
        for r in range(4):
            for e in range(2):
                out[lane, r, e] = (m + g8 + 8 * (r & 1),
                                   k + 2 * t4 + e + 8 * (r >> 1))
    return out


@pytest.mark.parametrize("M", [49, 196, 67, 12])
def test_the_a_fragment_from_panels_and_from_runs(M):
    """ldmatrix.trans at the lanes' addresses in a swizzled 64 x 64 panel
    (row k holds 64 m) gives each thread its A fragment; fwd's element
    loads from an image's run (row k of M positions, the panel at p0)
    give the same (position, channel) pairs, zero past M and past the
    channels."""
    panel = {_swz(r, q >> 3) + 2 * (q & 7): (q, r)        # (m, k)
             for r in range(64) for q in range(64)}
    for warp in range(4):
        for kk in range(4):
            addr = [_a_addr(16 * warp, kk, lane) for lane in range(32)]
            assert all(a % 16 == 0 and 0 <= a < 8192 for a in addr)
            want = _a_fragment(16 * warp, 16 * kk)
            for lane in range(32):
                g8, t4 = lane >> 2, lane & 3
                for r in range(4):
                    for e in range(2):
                        # matrix r's row 2 t4 + e, column g8
                        got = panel[addr[8 * r + 2 * t4 + e] + 2 * g8]
                        assert got == want[lane, r, e]
    # runs: fwd_tma's element loads, image li at li * 64 * M elements
    ppi, rows = -(-M // 64), 40
    for li in range(2):
        for pi in range(ppi):
            p0 = 64 * pi
            for warp in range(4):
                ma = 16 * warp
                frags = [_a_fragment(ma, 16 * kk) for kk in range(4)]
                for lane in range(32):
                    g8, t4 = lane >> 2, lane & 3
                    for kk in range(4):
                        for r in range(4):
                            k = 16 * kk + 2 * t4 + 8 * (r >> 1)
                            pos = p0 + ma + g8 + 8 * (r & 1)
                            for e in range(2):
                                m_, k_ = frags[kk][lane, r, e]
                                assert (m_, k_) == (pos - p0, k + e)
                                if pos < M and k + e < rows:
                                    idx = li * 64 * M + (k + e) * M + pos
                                    assert li * 64 * M <= idx < \
                                        (li + 1) * 64 * M
                                    assert (idx - li * 64 * M) // M == k + e


def _ring_walk(fills, stages):
    """The ring as Ring::begin / wait / release run it: the producer takes
    fill f into slot f % S after waiting on empty[s] with parity
    ((f / S) + 1) & 1 (f >= S), the consumers wait on full[s] with parity
    (f / S) & 1 and release in order, waiting for fill f + 1 while they
    still hold f (the next step's operands are built during this step's
    product). Each wait must find the completion it names (the phase of
    that parity that belongs to this fill), the producer never overwrites
    a slot that is not released, and nothing waits forever."""
    assert stages >= 2
    full = [0] * stages      # completed phases of full[s]
    empty = [0] * stages
    produced = consumed = 0
    while consumed < fills:
        # the consumers hold fill `consumed` and wait for the next one
        if consumed + 1 < fills:
            assert produced > consumed + 1 or \
                produced - consumed < stages, "the ring would stall"
        while produced < fills and produced - consumed < stages:
            f, s = produced, produced % stages
            if f >= stages:
                # it waits for the (f / S)-th completion of empty[s]
                assert empty[s] >= f // stages
                assert (empty[s] - 1) & 1 == ((f // stages) + 1) & 1
            full[s] += 1
            produced += 1
        f, s = consumed, consumed % stages
        assert full[s] == f // stages + 1          # this fill's phase
        assert (full[s] - 1) & 1 == (f // stages) & 1
        empty[s] += 1
        consumed += 1
    return produced


def _walk_common(plan, relu):
    """The persistent walk: block b takes tiles b, b + blocks, ...; every
    tile is taken once; each block's fills go through the ring in order
    (dgrad with the ReLU on TMA rows: one more a tile, the mask's x)."""
    seen = onp.zeros(plan["tiles"], onp.int64)
    per_tile = plan["steps"] + (1 if relu and plan["kind"] == "dgrad"
                                and plan["mode"] == "tma" else 0)
    for b in range(plan["blocks"]):
        tiles = list(range(b, plan["tiles"], plan["blocks"]))
        seen[tiles] += 1
        if b < 3:            # the ring's bookkeeping is the same for all
            n = len(tiles) * per_tile
            assert _ring_walk(n, plan["stages"]) == n
    assert (seen == 1).all()


def _step_copies(plan, K, M, P0, k0, w_bytes):
    """load_step's activation copies of one step: [(destination offset,
    first element, elements)] of the (N, K, M) tensor, TMA boxes of 64 x
    64 as (offset, (n, k0, p0)) or bulk runs."""
    pb, ppi, panels = plan["tile_panels"], plan["ppi"], plan["panels"]
    rows = min(64, K - k0)
    if plan["mode"] == "tma":
        return [(w_bytes + pp * 8192, ((P0 + pp) // ppi, k0,
                                       (P0 + pp) % ppi * 64))
                for pp in range(pb)]
    n_first = P0 // ppi
    imgs = min(panels - 1, P0 + pb - 1) // ppi - n_first + 1
    assert 1 <= imgs <= plan["imgs"]
    return [(w_bytes + i * 128 * M, ((n_first + i) * K + k0) * M, rows * M)
            for i in range(imgs)]


def _check_copies(plan, N, K, M, w_bytes):
    """Every copy of the sampled tiles' steps lands inside its slot and
    reads inside its tensor; bulk runs are 16-byte aligned multiples of 16
    bytes."""
    nct = plan["tiles"] // -(-plan["panels"] // plan["tile_panels"])
    for t in sorted({0, plan["tiles"] - 1,
                     min(plan["blocks"], plan["tiles"] - 1)}):
        P0 = t // nct * plan["tile_panels"]
        for s in range(plan["steps"]):
            for dst, src, *cnt in _step_copies(plan, K, M, P0, 64 * s,
                                               w_bytes):
                if plan["mode"] == "tma":
                    assert dst + 8192 <= plan["slot_bytes"] and dst % 1024 == 0
                    continue
                first, count = src, cnt[0]
                assert dst + 2 * count <= plan["slot_bytes"]
                assert 0 <= first and first + count <= N * K * M
                assert (2 * first) % 16 == 0 and (2 * count) % 16 == 0
                assert dst % 16 == 0


@pytest.mark.parametrize("N,Ci,Co,M", SHAPES)
def test_dgrad_walk_covers_each_output_once(N, Ci, Co, M):
    """A walk of dgrad_tma: the persistent blocks take every tile once and
    the ring's parities match its fills (with and without the ReLU's x
    fill); every TMA box and bulk run lands inside its slot and reads
    inside dy; the runs' repack fills each B unit once a step from the
    right (co, position) of the right image; the epilogue's fragment ->
    f32 staging -> TMA boxes (or the threads' stores) write each (n, ci,
    m) once."""
    plan = cf.conv1x1_plan("dgrad", N, Ci, Co, M, torch.bfloat16)
    if plan["mode"] not in ("tma", "runs"):
        assert (Ci % 8, Co % 8) != (0, 0) or M % 8
        return
    for relu in (True, False):
        _walk_common(plan, relu)
    cb, tp, ppi = plan["tile"], plan["tile_panels"], plan["ppi"]
    nct = -(-Ci // cb)
    assert plan["tiles"] == -(-plan["panels"] // tp) * nct
    w_bytes = cb // 64 * 8192
    if plan["mode"] == "tma":                             # the x fill
        assert cb // 64 * tp * 8192 <= plan["slot_bytes"]
    _check_copies(plan, N, Co, M, w_bytes)
    if plan["mode"] == "runs":
        # repack: thread id -> (panel, row k, chunk c) covers each unit once
        ids = onp.arange(tp * 512)
        units = list(zip(ids >> 9, (ids >> 3) & 63, ids & 7))
        assert len(set(units)) == tp * 512
        for t in (0, plan["tiles"] - 1):
            P0 = t // nct * tp
            n_first = P0 // ppi
            for pp in range(tp):
                P = P0 + pp
                if P >= plan["panels"]:
                    continue
                n, p0 = P // ppi, P % ppi * 64
                assert 0 <= n - n_first < plan["imgs"]
                for k in (0, 63):
                    for c in range(8):
                        for e in range(8):
                            if p0 + 8 * c + e < M:
                                idx = ((n - n_first) * 64 + k) * M + p0 + \
                                    8 * c + e
                                assert idx < plan["imgs"] * 64 * M
                                assert idx // M % 64 == k
    written = onp.zeros((N, Ci, M), onp.int64)
    # the fragment -> staging map of one warpgroup, and its read-back
    stage = {}
    for warp in range(4):
        for lane in range(32):
            g8, t4 = lane >> 2, lane & 3
            for h in range(2):
                r = 16 * warp + g8 + 8 * h
                for j in range(16):
                    box = (j >> 3) * 2 + ((j >> 2) & 1)
                    off = box * 8192 + _swz(r, 2 * (j & 3) + (t4 >> 1)) + \
                        8 * (t4 & 1)
                    for e in range(2):
                        stage[off + 4 * e] = (r, 8 * j + 2 * t4 + e)
    assert len(stage) == 64 * 128
    # bulk stores (a panel is a whole image): the same fragment densely,
    # rows of M, each element once inside the panel's 64 * M floats
    if plan["store"] == "bulk":
        assert M <= 64
        dense = set()
        for (r, q) in stage.values():
            if q % 64 < M:
                off = (q // 64) * 64 * M + r * M + q % 64
                assert off < (q // 64 + 1) * 64 * M
                dense.add(off)
        assert len(dense) == 2 * 64 * M
    # read back as the TMA store's 32 x 64 f32 boxes, or by the threads
    for i in range(2):
        for q in range(64):
            for r in range(64):
                off = (2 * i + (q >> 5)) * 8192 + _swz(r, (q & 31) >> 2) + \
                    4 * (q & 3)
                assert stage[off] == (r, 64 * i + q)
    for t in range(plan["tiles"]):
        grp, c0 = t // nct, (t % nct) * cb
        for wg in range(2):
            wci, wpp = (64 * wg, 0) if cb == 128 else (0, 2 * wg)
            ci0 = c0 + wci
            if ci0 >= Ci:
                continue
            for i in range(2):
                P = grp * tp + wpp + i
                if P >= plan["panels"]:
                    break
                n, p0 = P // ppi, (P % ppi) * 64
                # TMA: boxes of 32 positions from p0 while inside M, clipped
                # at M and Ci; threads: positions p0 + q < M
                written[n, ci0:min(Ci, ci0 + 64), p0:min(M, p0 + 64)] += 1
    assert (written == 1).all()


@pytest.mark.parametrize("N,Ci,Co,M", SHAPES)
def test_fwd_walk_covers_each_output_once(N, Ci, Co, M):
    """A walk of fwd_tma: the persistent walk and the ring as dgrad's; W's
    box and the x panels or runs land inside the slot and read inside x;
    each warpgroup's panel and the co tile's staged y (16-bit,
    128-byte-swizzled CT x 64 box) go out by TMA store or by the threads,
    each (n, co, m) once."""
    plan = cf.conv1x1_plan("fwd", N, Ci, Co, M, torch.bfloat16)
    if plan["mode"] not in ("tma", "runs"):
        assert (Ci % 8, Co % 8) != (0, 0) or M % 8
        return
    _walk_common(plan, False)
    ct, tp, ppi = plan["tile"], plan["tile_panels"], plan["ppi"]
    assert tp == 2
    nct = -(-Co // ct)
    _check_copies(plan, N, Ci, M, ct * 128)
    # fragment -> staging of one panel (position r, channel c), read back
    # as the TMA store's box or by the threads
    stage = {}
    for warp in range(4):
        for lane in range(32):
            g8, t4 = lane >> 2, lane & 3
            for j in range(ct // 8):
                for h in range(2):
                    r = 16 * warp + g8 + 8 * h
                    for e in range(2):
                        c = 8 * j + 2 * t4 + e
                        stage[_swz(c, r >> 3) + (r & 7) * 2] = (c, r)
    assert len(stage) == ct * 64
    assert all(stage[_swz(c, q >> 3) + 2 * (q & 7)] == (c, q)
               for c in range(ct) for q in range(64))
    written = onp.zeros((N, Co, M), onp.int64)
    for t in range(plan["tiles"]):
        grp, co0 = t // nct, (t % nct) * ct
        for wg in range(2):
            P = grp * tp + wg
            if P >= plan["panels"]:
                continue
            n, p0 = P // ppi, (P % ppi) * 64
            if plan["mode"] == "runs":   # its image among the tile's runs
                assert 0 <= n - (grp * tp) // ppi < plan["imgs"]
            written[n, co0:min(Co, co0 + ct), p0:min(M, p0 + 64)] += 1
    assert (written == 1).all()


def _k_groups():
    """wgrad's K-major tile: thread group i -> (row, k chunk, 16-byte
    unit), as conv_fused.cu's k_row / k_chunk."""
    i = onp.arange(1024)
    r, kc = (i >> 6) * 8 + (i & 7), (i >> 3) & 7
    return r, kc, kc * 128 + r


def _load8(C, M, c, p, pb):
    """load8's element offsets into a (., C, M) tensor for channel c and
    positions p .. p + 7 (arrays broadcast), and which are read."""
    q = p[..., None] + onp.arange(8)
    ok = (c[..., None] < C) & (q < pb)
    n = q // M
    return (n * C + c[..., None]) * M + (q - n * M), ok


@pytest.mark.parametrize("N,Ci,Co,M", SHAPES)
def test_wgrad_walk_covers_each_position_once(N, Ci, Co, M):
    """A walk of the wgrad kernel's index arithmetic: the 1024 groups of a
    tile fill its 1024 units once; over the splits and their 64-position
    steps every (n, m) of the reduction is read once per row, at the
    offset of (n, c, m); in runs mode the ring holds each image in its slot
    when a step reads it, waited with the parity of that fill."""
    plan = cf.conv1x1_plan("wgrad", N, Ci, Co, M, torch.bfloat16)
    r, kc, unit = _k_groups()
    assert sorted(unit) == list(range(1024))
    assert sorted(zip(r, kc)) == [(a, b) for a in range(128) for b in range(8)]
    seen = onp.zeros(N * M, onp.int64)
    c = onp.array([Ci - 1])           # the last row of the tensor
    for s in range(plan["splits"]):
        na, nb = s * plan["per"], min(N, (s + 1) * plan["per"])
        pa, pb = na * M, nb * M
        steps = -(-(pb - pa) // 64)
        assert steps <= plan["steps"]
        p = pa + 64 * onp.arange(steps)[:, None] + 8 * onp.arange(8)
        off, ok = _load8(Ci, M, c, p, pb)
        q = (p[..., None] + onp.arange(8))[ok]
        onp.add.at(seen, q, 1)
        n, m = q // M, q % M
        assert (off[ok] == (n * Ci + Ci - 1) * M + m).all()
        if plan["mode"] == "runs":
            _walk_ring(plan["slots"], nb - na, M, steps)
    assert (seen == 1).all()


def _walk_ring(S, nimg, M, steps):
    """wgrad_runs' ring of S image slots, as its loop issues and waits."""
    slot, fills = [None] * S, [0] * S
    def issue(n):
        slot[n % S] = n
        fills[n % S] += 1
    issued, waited = min(S, nimg), 0
    for n in range(issued):
        issue(n)
    P = nimg * M
    for t in range(steps):
        p0 = 64 * t
        hi = min(P - 1, p0 + 63) // M
        while waited <= hi:
            assert waited < issued and slot[waited % S] == waited
            assert (fills[waited % S] - 1) % 2 == (waited // S) & 1
            waited += 1
        for p in range(p0, min(P, p0 + 64)):
            assert slot[(p // M) % S] == p // M
        lo = min(P, p0 + 64) // M
        while issued < nimg and issued < lo + S:
            issue(issued)
            issued += 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgrad_split_partials_in_plan_order_match_the_plain_sum(dtype):
    """dW as the kernels form it: each split's partial sum over its share
    of the reduction (whole images in the 16-bit plan, 16-position steps
    in the f32 plan), the partials then added in split order, in f32,
    against conv1x1_wgrad_reference."""
    N, Ci, Co, M = 7, 24, 40, 50
    x, _, dy, s, t, _ = _case(13, N, Ci, Co, M, True)
    h = cf._prologue(_t(x), _t(s), _t(t), True)
    d = _t(dy)
    plan = cf.conv1x1_plan("wgrad", N, Ci, Co, M, dtype)
    if dtype == torch.float32:
        spn = -(-M // 16)
        steps = [(n, m0) for n in range(N) for m0 in range(0, M, 16)]
        assert len(steps) == N * spn
        shares = [steps[i * plan["per"]:(i + 1) * plan["per"]]
                  for i in range(plan["splits"])]
    else:
        shares = [[(n, 0) for n in range(i * plan["per"],
                                         min(N, (i + 1) * plan["per"]))]
                  for i in range(plan["splits"])]
    total = torch.zeros(Co, Ci)
    for share in shares:
        part = torch.zeros(Co, Ci)
        for n, m0 in share:
            m1 = m0 + 16 if dtype == torch.float32 else M
            part += d[n, :, m0:m1] @ h[n, :, m0:m1].t()
        total += part
    want = cf.conv1x1_wgrad_reference(_t(x), _t(s), _t(t), d, True,
                                      torch.float32)
    onp.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                                atol=1e-5)
