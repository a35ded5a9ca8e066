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
def test_plan_fills_the_card_with_async_copies(ci, co, m):
    """At every b128 junction both 16-bit kernels put at least 132 blocks
    in flight, stage by async copies (16- or 8-byte cp.async of aligned
    rows, or cp.async.bulk of whole runs at M=49), and are planned by a
    pure function of the shape."""
    n = 128
    for kind in ("dgrad", "wgrad"):
        for dtype in (torch.bfloat16, torch.float16):
            plan = cf.conv1x1_plan(kind, n, ci, co, m, dtype)
            assert plan == cf.conv1x1_plan(kind, n, ci, co, m, dtype)
            assert plan["mode"] == ("rows16" if m % 8 == 0 else
                                    "rows8" if m % 4 == 0 else "runs")
            assert plan["blocks"] >= cf.SMS
            assert plan["tile"] == (128, 128) and plan["bk"] == 64
        if kind == "wgrad":
            # whole images per split, every split non-empty
            assert plan["splits"] * plan["per"] >= n
            assert (plan["splits"] - 1) * plan["per"] < n


@pytest.mark.parametrize("shape,mode", [((3, 45, 77, 53), "general"),
                                        ((2, 72, 40, 4100), "rows8"),
                                        ((2, 64, 72, 67), "general")])
def test_plan_of_ragged_shapes(shape, mode):
    """Channels that are not multiples of 8 and rows that are not 8-byte
    aligned take the general path (element loads) in the same kernels;
    M=4100's rows are 8 bytes aligned and take 8-byte copies. An operand
    address that is not 16-byte aligned sends every junction to it."""
    for kind in ("dgrad", "wgrad"):
        assert cf.conv1x1_plan(kind, *shape, torch.bfloat16)["mode"] == mode
        for j in JUNCTIONS:
            assert cf.conv1x1_plan(kind, 128, *j, torch.bfloat16,
                                   align=2)["mode"] == "general"


def _k_groups():
    """wgrad's K-major tile: thread group i -> (row, k chunk, 16-byte
    unit), as conv_fused.cu's k_row / k_chunk."""
    i = onp.arange(1024)
    r, kc = (i >> 6) * 8 + (i & 7), (i >> 3) & 7
    return r, kc, kc * 128 + r


def _mn_groups():
    """dgrad's MN-major tile: group i -> (k row, MN chunk, unit), as
    mn_k / mn_chunk / mn_unit."""
    i = onp.arange(1024)
    k, mc = (i >> 7) * 8 + (i & 7), (i >> 3) & 15
    return k, mc, (k >> 3) * 128 + mc * 8 + (k & 7)


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


@pytest.mark.parametrize("N,Ci,Co,M", SHAPES)
def test_dgrad_walk_covers_each_output_once(N, Ci, Co, M):
    """A walk of the dgrad kernel's index arithmetic: the tile's groups
    fill its units once; the tiles along the flattened N*M axis and along
    ci, and the epilogue's accumulator positions, cover each output
    element once; W and dy are read at the offsets of their elements; in
    runs mode every staged run stays inside its stage."""
    plan = cf.conv1x1_plan("dgrad", N, Ci, Co, M, torch.bfloat16)
    k, mc, unit = _mn_groups()
    assert sorted(unit) == list(range(1024))
    NM = N * M
    qtiles, citiles = -(-NM // 128), -(-Ci // 128)
    assert plan["tiles"] == qtiles * citiles
    # the epilogue: rows 64 w + 16 warp + g + 8 h, columns 8 j + 2 t4 + e
    w, warp, g, h = onp.meshgrid(*map(onp.arange, (2, 4, 8, 2)),
                                 indexing="ij")
    rows = (64 * w + 16 * warp + g + 8 * h).ravel()
    j, t4, e = onp.meshgrid(*map(onp.arange, (16, 4, 2)), indexing="ij")
    cols = (8 * j + 2 * t4 + e).ravel()
    assert sorted(rows) == list(range(128)) == sorted(cols)
    ci = (128 * onp.arange(citiles)[:, None] + rows).ravel()
    assert onp.bincount(ci[ci < Ci], minlength=Ci).tolist() == [1] * Ci
    q = (128 * onp.arange(qtiles)[:, None] + cols).ravel()
    assert (onp.bincount(q[q < NM], minlength=NM) == 1).all()
    # the loaders: W^T as (1, Co, Ci), dy along positions, every step
    for t in range(plan["steps"]):
        co = 64 * t + k
        off, ok = _load8(Co, Ci, co, onp.zeros_like(k) + 8 * mc, Ci)
        ci_ = 8 * mc[:, None] + onp.arange(8)
        assert (off[ok] == (co[:, None] * Ci + ci_)[ok]).all()
    q0 = 128 * onp.arange(qtiles)
    p = q0[:, None] + 8 * mc
    off, ok = _load8(Co, M, onp.broadcast_to(k, p.shape) + 0, p, NM)
    qq = p[..., None] + onp.arange(8)
    assert (off[ok] == (((qq // M) * Co + k[None, :, None]) * M
                        + qq % M)[ok]).all()
    if plan["mode"] == "runs":
        img = 1 + -(-127 // M)
        n_first = q0 // M
        n_last = onp.minimum(NM - 1, q0 + 127) // M
        assert (n_last - n_first + 1 <= img).all()
        # repack_mn reads run (n - n_first) at row k, column m
        li = qq // M - n_first[:, None, None]
        idx = li * 64 * M + k[None, :, None] * M + qq % M
        assert (idx[qq < NM] < img * 64 * M).all() and (li >= 0).all()
        # the epilogue's x runs: 128 rows per image in the same stages
        assert img * 128 * M <= 4 * img * 64 * M


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
