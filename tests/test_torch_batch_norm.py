"""BatchNorm's training forward and backward in the port
(``ops/cuda/batch_norm.py``: ``_BatchNormTrain``, ``_BatchStats`` and the
plain versions of their four kernels, which CPU tensors take) against the
JAX package's ``_bn_train_core`` / ``_bn_batch_stats`` (XLA, no Pallas
kernel) through ``npx.batch_norm`` and ``npx.batch_norm_relu_conv1x1``
under ``autograd.record``, on the same numpy inputs made from a seed.

The loss uses ``out``, ``mean`` and ``var`` (nonzero mean and var
cotangents). Shifted statistics take a shift near the batch mean (as the
layer's stat-shift buffer is: the previous batch's mean); an input mean of
100 with a shift of 0 would cancel in f32 in both packages alike.

Tolerances:
- f32: out, mean and var rtol=atol=1e-5; the gradients of x, gamma and beta
  rtol=1e-4, atol=1e-5 (XLA and torch reduce in another order). At an input
  mean of 100 (67 standard deviations), out is held to atol=5e-5 and the
  gradients to rtol=2e-3, atol=1e-4: one f32 ulp of 100 is 7.6e-6, the two
  packages' batch means differ by a few of them (summation order; most with
  centered statistics, whose first sweep sums x itself), and ``x - mean``
  carries that into out (measured: 2.6e-5) and into every xhat, whose sum
  against dy is dgamma (measured: 7.4e-4 relative);
- bf16 x (f32 gamma, beta and statistics): each result within a relative
  Frobenius error of 1e-2 (both round out and dx to bf16 once, 2^-8 =
  3.9e-3 a value, from f32 sums taken in another order).

Also: one training call saves x and three per-channel vectors (at most
``x.nbytes + 64 * C`` bytes, so no f32 copy of x), and the kernels' walks
(``bn_plan`` for the elementwise kernels, ``bn_reduce_plan`` for the two
reductions) read every element exactly once, replayed in numpy with the
kernels' index arithmetic; the reductions' plans at ResNet-50's and DCGAN's
shapes fit the kernel (clusters of at most 8 blocks, one level), and the
elementwise kernels' plans there are what they were.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd, npx
from mxnet_tpu_torch.ops.cuda import batch_norm as bn

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
OUT_ATOL = {3.0: 1e-5, 100.0: 5e-5}   # by input mean (docstring)
GRAD_AT = {3.0: GRAD, 100.0: dict(rtol=2e-3, atol=1e-4)}
BF16_REL = 1e-2

LAYOUTS = {"nchw": ((4, 6, 5, 5), 1), "nhwc": ((4, 5, 5, 6), -1),
           "2d": ((32, 6), 1)}


def _inputs(layout, mean, seed=0):
    shape, axis = LAYOUTS[layout]
    C = shape[axis]
    rng = onp.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + mean).astype("float32")
    red = tuple(i for i in range(len(shape)) if i != axis % len(shape))
    return dict(
        x=x, gamma=(rng.rand(C) + 0.5).astype("float32"),
        beta=rng.randn(C).astype("float32"),
        rm=onp.zeros(C, "float32"), rv=onp.ones(C, "float32"),
        shift=(x.mean(axis=red) + 0.3 * rng.randn(C)).astype("float32"),
        g=rng.randn(*shape).astype("float32"),
        a=rng.randn(C).astype("float32"), b=rng.randn(C).astype("float32"))


def _rel(got, want):
    got, want = onp.asarray(got, "float64"), onp.asarray(want, "float64")
    return onp.linalg.norm(got - want) / max(onp.linalg.norm(want), 1e-30)


def _jax_bn(d, axis, stats, fix_gamma, dtype):
    arrs = {k: mx.np.array(v) for k, v in d.items()}
    x = arrs["x"].astype(dtype)
    for k in ("gamma", "beta"):
        arrs[k].attach_grad()
    x.attach_grad()
    with mx.autograd.record():
        out, m, v = mx.npx.batch_norm(
            x, arrs["gamma"], arrs["beta"], arrs["rm"], arrs["rv"],
            fix_gamma=fix_gamma, axis=axis, stats=stats, shift=arrs["shift"])
        loss = (out.astype("float32") * arrs["g"]).sum() + \
            (m * arrs["a"]).sum() + (v * arrs["b"]).sum()
    loss.backward()
    res = [t.astype("float32").asnumpy() for t in (out, m, v)]
    grads = [t.grad.astype("float32").asnumpy()
             for t in (x, arrs["gamma"], arrs["beta"])]
    return res, grads


def _port_bn(d, axis, stats, fix_gamma, dtype):
    ts = {k: torch.from_numpy(v) for k, v in d.items()}
    x = ts["x"].to(dtype).requires_grad_(True)
    gamma = ts["gamma"].requires_grad_(True)
    beta = ts["beta"].requires_grad_(True)
    with autograd.record():
        out, m, v = npx.batch_norm(x, gamma, beta, ts["rm"], ts["rv"],
                                   fix_gamma=fix_gamma, axis=axis,
                                   stats=stats, shift=ts["shift"])
        loss = (out.float() * ts["g"]).sum() + (m * ts["a"]).sum() + \
            (v * ts["b"]).sum()
    autograd.backward(loss)
    res = [t.detach().float().numpy() for t in (out, m, v)]
    grads = [onp.zeros_like(d[k]) if t.grad is None
             else t.grad.float().numpy()
             for k, t in (("x", x), ("gamma", gamma), ("beta", beta))]
    return res, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("mean", [3.0, 100.0])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("stats", ["shifted", "centered"])
def test_batch_norm_training_matches_jax(stats, layout, mean, fix_gamma,
                                         dtype):
    """out, mean, var and the gradients of x, gamma and beta through a loss
    of out, mean and var."""
    d = _inputs(layout, mean)
    axis = LAYOUTS[layout][1]
    jres, jgrads = _jax_bn(d, axis, stats, fix_gamma, dtype)
    tres, tgrads = _port_bn(d, axis, stats, fix_gamma,
                            getattr(torch, dtype))
    names = ("out", "mean", "var", "dx", "dgamma", "dbeta")
    for name, got, want in zip(names, tres + tgrads, jres + jgrads):
        if dtype == "bfloat16":
            assert _rel(got, want) <= BF16_REL, name
        elif name == "out":
            onp.testing.assert_allclose(got, want, rtol=1e-5,
                                        atol=OUT_ATOL[mean], err_msg=name)
        elif name in ("mean", "var"):
            onp.testing.assert_allclose(got, want, **F32, err_msg=name)
        else:
            onp.testing.assert_allclose(got, want, **GRAD_AT[mean],
                                        err_msg=name)


@pytest.mark.parametrize("mean", [3.0, 100.0])
@pytest.mark.parametrize("stats", ["shifted", "centered"])
def test_fused_junction_statistics_gradients_match_jax(stats, mean):
    """batch_norm_relu_conv1x1: its batch statistics (``_BatchStats``) and
    the gradients of x, gamma and beta through a loss of the conv output
    and of the statistics."""
    d = _inputs("nchw", mean, seed=1)
    rng = onp.random.RandomState(2)
    w = (rng.randn(4, 6, 1, 1) * 0.3).astype("float32")
    g = rng.randn(4, 4, 5, 5).astype("float32")

    arrs = {k: mx.np.array(v) for k, v in d.items()}
    jw, jg = mx.np.array(w), mx.np.array(g)
    for k in ("x", "gamma", "beta"):
        arrs[k].attach_grad()
    with mx.autograd.record():
        out, m, v = mx.npx.batch_norm_relu_conv1x1(
            arrs["x"], arrs["gamma"], arrs["beta"], arrs["rm"], arrs["rv"],
            jw, stats=stats, shift=arrs["shift"])
        loss = (out * jg).sum() + (m * arrs["a"]).sum() + \
            (v * arrs["b"]).sum()
    loss.backward()
    want = [t.asnumpy() for t in (out, m, v)] + \
        [arrs[k].grad.asnumpy() for k in ("x", "gamma", "beta")]

    ts = {k: torch.from_numpy(v) for k, v in d.items()}
    for k in ("x", "gamma", "beta"):
        ts[k].requires_grad_(True)
    with autograd.record():
        out, m, v = npx.batch_norm_relu_conv1x1(
            ts["x"], ts["gamma"], ts["beta"], ts["rm"], ts["rv"],
            torch.from_numpy(w), stats=stats, shift=ts["shift"])
        loss = (out * torch.from_numpy(g)).sum() + (m * ts["a"]).sum() + \
            (v * ts["b"]).sum()
    autograd.backward(loss)
    got = [t.detach().numpy() for t in (out, m, v)] + \
        [ts[k].grad.numpy() for k in ("x", "gamma", "beta")]
    tols = [dict(rtol=1e-5, atol=OUT_ATOL[mean]), F32, F32] + \
        [GRAD_AT[mean]] * 3
    for i, (a, b) in enumerate(zip(got, want)):
        onp.testing.assert_allclose(a, b, **tols[i], err_msg=str(i))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
def test_one_training_call_saves_x_and_per_channel_vectors(dtype, fused):
    """No f32 copy of x and no xhat: the tensors one training call saves
    for its backward add up to at most x.nbytes + 64 * C bytes."""
    N, C, H, W = 4, 16, 6, 6
    x = torch.randn(N, C, H, W).to(dtype).requires_grad_(True)
    gamma = torch.ones(C, requires_grad=True)
    beta = torch.zeros(C, requires_grad=True)
    rm, rv = torch.zeros(C), torch.ones(C)
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with autograd.record(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if fused:
            npx.batch_norm_relu_conv1x1(x, gamma, beta, rm, rv,
                                        torch.ones(8, C, 1, 1, dtype=dtype),
                                        shift=rm)
        else:
            npx.batch_norm(x, gamma, beta, rm, rv, shift=rm)
    limit = x.numel() * x.element_size() + 64 * C
    if fused:          # the conv's own saved operands are not BatchNorm's
        limit += x.numel() * x.element_size() + 8 * C * 2 + 16 * C
    assert saved and sum(saved) <= limit, saved


def test_plain_versions_are_the_kernels_formulas():
    """The four plain versions against float64 evaluations of the same
    formulas on a ragged shape."""
    g = torch.Generator().manual_seed(3)
    x3 = torch.randn(3, 7, 11, generator=g, dtype=torch.float32) * 2 + 5
    dy = torch.randn(3, 7, 11, generator=g)
    s = torch.full((7,), 5.0)
    gm, b = torch.rand(7, generator=g) + 0.5, torch.randn(7, generator=g)
    dm, dv = torch.randn(7, generator=g), torch.randn(7, generator=g)
    xd, dyd = x3.double(), dy.double()
    n = 33
    mean64 = xd.mean(dim=(0, 2))
    var64 = ((xd - mean64[None, :, None]) ** 2).mean(dim=(0, 2))
    for centered, shift in ((False, s), (True, mean64.float())):
        mean, var, inv = bn.bn_stats_reference(x3, shift, 1e-5, centered)
        assert torch.allclose(mean.double(), mean64, rtol=1e-6)
        assert torch.allclose(var.double(), var64, rtol=1e-5)
    inv64 = 1 / torch.sqrt(var64 + 1e-5)
    mean, inv = mean64.float(), inv64.float()
    xh = (xd - mean64[None, :, None]) * inv64[None, :, None]
    out = bn.bn_apply_reference(x3, mean, inv, gm, b)
    assert torch.allclose(out.double(), xh * gm.double()[None, :, None]
                          + b.double()[None, :, None], rtol=1e-5, atol=1e-5)
    dg, db = bn.bn_bwd_reduce_reference(x3, dy, mean, inv)
    assert torch.allclose(dg.double(), (dyd * xh).sum(dim=(0, 2)), rtol=1e-5)
    assert torch.allclose(db.double(), dyd.sum(dim=(0, 2)), rtol=1e-5)
    dx = bn.bn_bwd_apply_reference(x3, dy, mean, inv, gm, dg, db, dm, dv)
    c = (lambda v: v.double()[None, :, None])
    want = c(gm * inv) * (dyd - c(db) / n - xh * c(dg) / n) + c(dm) / n + \
        c(dv) * 2 / n * (xd - c(mean))
    assert torch.allclose(dx.double(), want, rtol=1e-4, atol=1e-5)


def _walk(plan, outer, C, inner):
    """How many times the kernels' walk (``csrc/batch_norm.cu``
    reduce_kernel / apply_kernel) reads each element of x (outer, C,
    inner) under ``plan``: their index arithmetic, thread by thread."""
    T, seen = bn.THREADS, onp.zeros(outer * C * inner, onp.int64)
    vec, cg, per, rows = plan["vec"], plan["cg"], plan["per"], plan["rows"]
    for gi in range(plan["groups"]):
        c0 = gi * cg
        cn = min(cg, C - c0)
        for sj in range(plan["splits"]):
            o0, o1 = sj * per, min(outer, sj * per + per)
            for t in range(T):
                if plan["one"]:
                    vpr = inner // vec
                    for i in range(t, (o1 - o0) * vpr, T):
                        o, s = divmod(i, vpr)
                        p = ((o0 + o) * C + c0) * inner + s * vec
                        seen[p:p + vec] += 1
                    continue
                nsf, nsl = cg * inner // vec, cn * inner // vec
                r, slot0, step = 0, t, T
                if rows > 1:
                    r, slot0, step = t // nsf, t % nsf, nsf
                if r >= rows:
                    continue
                k_slots = max(1, 4 // vec)
                for o in range(o0 + r, o1, rows):
                    for k in range(k_slots):
                        s = slot0 + k * step
                        if s < nsl:
                            p = (o * C + c0) * inner + s * vec
                            seen[p:p + vec] += 1
    return seen


@pytest.mark.parametrize("shape", [(5, 7, 300), (6, 40, 49), (3, 11, 196),
                                   (130, 24, 1), (9, 264, 1), (4, 3, 8),
                                   (2, 2048, 1), (33, 5, 17), (3, 6, 260),
                                   (4, 9, 12), (5, 36, 1), (3, 50, 49),
                                   (2, 30, 98), (3, 20, 6)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_walk_reads_every_element_once(shape, dtype):
    outer, C, inner = shape
    plan = bn.bn_plan(outer, C, inner, dtype)
    assert (_walk(plan, outer, C, inner) == 1).all(), plan


@pytest.mark.parametrize("C,M", [(64, 12544), (64, 3136), (256, 3136),
                                 (128, 784), (512, 784), (256, 196),
                                 (1024, 196), (512, 49), (2048, 49)])
def test_plans_at_resnet50_shapes_fit_the_kernels(C, M):
    """At N = 128 in bf16: 16-byte loads everywhere (at M = 196 and 49
    the spans of whole runs are multiples of 8 elements), a block a
    channel for M >= 256 and groups of whole runs below, about 8 blocks an
    SM, and a span that fits the kernels' shared memory."""
    plan = bn.bn_plan(128, C, M, torch.bfloat16)
    assert plan["vec"] == 8
    assert plan["one"] == (M >= bn.LONG_RUN)
    assert 800 <= plan["blocks"] <= 2048
    assert plan["cg"] * M <= bn.MAX_SPAN or plan["one"]
    assert (plan["splits"] - 1) * plan["per"] < 128 <= \
        plan["splits"] * plan["per"]


def _reduce_walk(plan, outer, C, inner):
    """How many times the reduction kernel (``csrc/batch_norm.cu``
    reduce_kernel: block_sums_one / block_sums_group) reads each element of
    x (outer, C, inner) under ``plan``, over every group, block (cluster
    rank and split) and thread: its index arithmetic, vectorized over the
    threads."""
    T, seen = bn.THREADS, onp.zeros(outer * C * inner, onp.int64)
    vec, cg, per, rows = plan["vec"], plan["cg"], plan["per"], plan["rows"]
    lanes = onp.arange(vec)
    t = onp.arange(T)
    for gi in range(plan["groups"]):
        c0 = gi * cg
        cn = min(cg, C - c0)
        for b in range(plan["cluster"] * plan["splits"]):
            if plan["one"]:
                vpr = inner // vec
                i0 = b * per
                n = max(0, min(outer * vpr, i0 + per) - i0)
                j = (t[:, None] + T * onp.arange(_cdiv(n, T))[None, :])
                i = i0 + j[j < n]
                o, s = i // vpr, i % vpr
                p = ((o * C + c0) * inner + s * vec)
            else:
                o0, o1 = min(outer, b * per), min(outer, b * per + per)
                nsf, nsl = cg * inner // vec, cn * inner // vec
                r, slot0, step = onp.zeros(T, int), t, T
                if rows > 1:
                    r, slot0, step = t // nsf, t % nsf, nsf
                k_slots = max(1, 4 // vec)
                s = slot0[:, None] + step * onp.arange(k_slots)[None, :]
                ok = (r[:, None] < rows) & (s < nsl)
                o = o0 + r[:, None, None] + rows * onp.arange(
                    _cdiv(max(o1 - o0, 0), rows) + 1)[None, None, :]
                keep = ok[:, :, None] & (o < o1)
                ob = onp.broadcast_to(o, keep.shape)
                sb = onp.broadcast_to(s[:, :, None], keep.shape)
                p = (ob[keep] * C + c0) * inner + sb[keep] * vec
            onp.add.at(seen, (p[:, None] + lanes[None, :]).ravel(), 1)
    return seen


def _cdiv(a, b):
    return -(-a // b)


WALK_SHAPES = [(5, 7, 300), (6, 40, 49), (3, 11, 196), (130, 24, 1),
               (9, 264, 1), (4, 3, 8), (2, 2048, 1), (33, 5, 17),
               (3, 6, 260), (4, 9, 12), (5, 36, 1), (3, 50, 49),
               (2, 30, 98), (3, 20, 6)]
# DCGAN's BatchNorm shapes at B = 64 (f32): (C, H*W)
DCGAN_BN = [(512, 16), (256, 64), (128, 256), (64, 1024)]
RESNET_BN = [(64, 12544), (64, 3136), (256, 3136), (128, 784), (512, 784),
             (256, 196), (1024, 196), (512, 49), (2048, 49)]


@pytest.mark.parametrize("shape,dtype", [
    (s, d) for s in WALK_SHAPES for d in (torch.bfloat16, torch.float32)] + [
    ((64, C, M), torch.float32) for C, M in DCGAN_BN])
def test_reduction_walk_reads_every_element_once(shape, dtype):
    outer, C, inner = shape
    plan = bn.bn_reduce_plan(outer, C, inner, dtype)
    assert (_reduce_walk(plan, outer, C, inner) == 1).all(), plan


def _fits_the_kernel(plan, outer, inner):
    """The kernel's own checks (``csrc/batch_norm.cu`` bad_reduce)."""
    passes = (outer * (inner // plan["vec"]) if plan["one"] else outer)
    return (1 <= plan["cluster"] <= bn.MAX_CLUSTER and
            plan["cluster"] * plan["splits"] <= 65535 and
            plan["cluster"] * plan["splits"] * plan["per"] >= passes and
            plan["cg"] <= bn.MAX_CG and
            (plan["one"] or plan["per"] % plan["rows"] == 0) and
            plan["blocks"] == plan["groups"] * plan["cluster"] *
            plan["splits"])


@pytest.mark.parametrize("outer,C,M,dtype", [
    (128, C, M, torch.bfloat16) for C, M in RESNET_BN] + [
    (64, C, M, torch.float32) for C, M in DCGAN_BN])
def test_reduction_plans_at_resnet50_and_dcgan_shapes(outer, C, M, dtype):
    """One level (a cluster of at most 8 blocks a group, one split, no
    workspace or counter), the grid at least 128 blocks (DCGAN's C = 512,
    M = 16 takes 128, one batch of loads a thread) and at most four an
    SM, 16-byte loads, and the walk as bn_plan's (one channel a block from
    M = 256)."""
    plan = bn.bn_reduce_plan(outer, C, M, dtype)
    assert _fits_the_kernel(plan, outer, M), plan
    assert plan["splits"] == 1, plan
    assert 128 <= plan["blocks"] <= 4 * 132, plan
    assert plan["vec"] * torch.empty((), dtype=dtype).element_size() == 16
    assert plan["one"] == (M >= bn.LONG_RUN)
    walk = bn.bn_plan(outer, C, M, dtype)
    assert plan["cg"] <= walk["cg"] and plan["vec"] == walk["vec"]


@pytest.mark.parametrize("outer,C,M,dtype", [
    (32, 3, 50176, torch.bfloat16), (16, 16, 12544, torch.float32),
    (64, 1, 1024, torch.float32)])
def test_reduction_plan_takes_the_second_level_for_few_large_channels(
        outer, C, M, dtype):
    """Few channels with large images: eight-block clusters cannot fill
    the card, so several clusters a group split the images."""
    plan = bn.bn_reduce_plan(outer, C, M, dtype)
    assert _fits_the_kernel(plan, outer, M), plan
    assert plan["cluster"] == bn.MAX_CLUSTER and plan["splits"] > 1, plan


def test_second_level_counters_under_capture_are_the_graphs_own(
        monkeypatch):
    """While a CUDA graph is captured, each second-level call makes zeroed
    counters of its own (zeroed in its graph at each replay) and keeps none
    for a later call or graph."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    x3 = torch.zeros(32, 3, 50176, dtype=torch.bfloat16)
    plan = bn.bn_reduce_plan(32, 3, 50176, torch.bfloat16)
    kept = dict(bn._COUNTERS)
    (ws, a), (_, b) = (bn._second_level(x3, plan) for _ in range(2))
    assert plan["splits"] > 1 and a.data_ptr() != b.data_ptr()
    assert a.dtype == torch.int32 and not a.any()
    assert a.numel() == plan["groups"] * plan["cluster"]
    assert ws.numel() == plan["splits"] * 3 * 2 and bn._COUNTERS == kept


@pytest.mark.parametrize("outer,C,inner", [
    (1, 7, 300), (1, 64, 49), (1, 5, 1), (40, 1, 300), (64, 1, 12),
    (1, 1, 1)])
def test_reduction_plans_for_one_image_or_one_channel(outer, C, inner):
    """outer = 1 and C = 1: no block of a cluster without work but the
    last, and the walk still reads every element once."""
    for dtype in (torch.float32, torch.float16):
        plan = bn.bn_reduce_plan(outer, C, inner, dtype)
        assert _fits_the_kernel(plan, outer, inner), plan
        assert (_reduce_walk(plan, outer, C, inner) == 1).all(), plan


# bn_plan at ResNet-50's shapes (N = 128, bf16): (one, vec, cg, rows,
# groups, splits, per), as the elementwise kernels have walked since they
# were written
APPLY_PLANS = {(64, 12544): (True, 8, 1, 1, 64, 16, 8),
               (64, 3136): (True, 8, 1, 1, 64, 16, 8),
               (256, 3136): (True, 8, 1, 1, 256, 5, 26),
               (128, 784): (True, 8, 1, 1, 128, 9, 15),
               (512, 784): (True, 8, 1, 1, 512, 3, 43),
               (256, 196): (False, 8, 10, 1, 26, 32, 4),
               (1024, 196): (False, 8, 10, 1, 103, 11, 12),
               (512, 49): (False, 8, 40, 1, 13, 64, 2),
               (2048, 49): (False, 8, 40, 1, 52, 19, 7)}


@pytest.mark.parametrize("C,M", RESNET_BN)
def test_apply_plans_at_resnet50_shapes_are_unchanged(C, M):
    plan = bn.bn_plan(128, C, M, torch.bfloat16)
    assert tuple(plan[k] for k in ("one", "vec", "cg", "rows", "groups",
                                   "splits", "per")) == APPLY_PLANS[(C, M)]
