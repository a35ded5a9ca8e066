"""The port's vision slice on CPU tensors against the JAX package:
``npx.batch_norm``, ``batch_norm_relu_conv1x1`` and ``relu_conv1x1``, the
BatchNorm layer's statistics, the BatchNorm -> relu -> 1x1-conv junction
matcher, the ResNet zoo, and three SGD-momentum steps of a small ResNet v1,
with ``MXNET_FUSE_BN_CONV=1`` in both packages where the test says so.

Tolerances (f32 on both sides; the statistics and sums are reduced in
another order by XLA and by torch):
- op outputs and batch statistics rtol=atol=1e-5; their gradients through a
  sin loss rtol=1e-4, atol=1e-5;
- the BatchNorm layer over three steps: outputs and statistics rtol=1e-5,
  atol=1e-5 (inputs with a mean of 3, so the shifted statistics matter);
- fused against unfused inside the port: losses rtol=1e-5, gradients
  relative Frobenius error 1e-4 (the conv biases in front of a BatchNorm
  have gradients near 0, so only elements above 1e-5 are compared there);
- the small ResNet (layers [2, 2, 1, 1], channels 16-256, B=4, 64x64, 10
  classes), three SGD steps (lr 0.1, momentum 0.9): per-sample losses
  rtol=1e-4, atol=1e-5 (measured: 1.5e-4 relative on a loss of 0.053);
  every weight and running statistic after the steps within a relative
  Frobenius error of 1e-4 (measured: 6e-5), except the conv biases that feed a
  BatchNorm, whose gradients are noise around 0 in both packages and are
  held to an absolute bound instead.
"""
import os

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu_torch import autograd, npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.block import PreActivation
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
from mxnet_tpu_torch.ops.cuda import conv_fused as cf

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def knob():
    """Set MXNET_FUSE_BN_CONV for both packages; restored afterwards."""
    prev = os.environ.get("MXNET_FUSE_BN_CONV")

    def set_(val):
        os.environ["MXNET_FUSE_BN_CONV"] = val
        mx.npx.conv_fusion_enabled()        # the JAX package re-polls

    yield set_
    if prev is None:
        os.environ.pop("MXNET_FUSE_BN_CONV", None)
    else:
        os.environ["MXNET_FUSE_BN_CONV"] = prev
    mx.npx.conv_fusion_enabled()


def _rel(a, b):
    return float(onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30))


def _t(a):
    return torch.from_numpy(onp.ascontiguousarray(a))


class _Spy:
    """Counts calls of the fused forward (``conv_fused._fwd``), and how
    many of them were relu-only (no scale): the deferred junctions."""

    def __init__(self):
        self.calls, self.relu_only = 0, 0
        self._orig = cf._fwd

    def __enter__(self):
        def spy(x3, scale, *a, **k):
            self.calls += 1
            self.relu_only += scale is None
            return self._orig(x3, scale, *a, **k)
        cf._fwd = spy
        return self

    def __exit__(self, *exc):
        cf._fwd = self._orig


# ------------------------------------------------------------------ npx ops
def test_npx_op_contracts(knob):
    x3 = torch.zeros(2, 4, 8)
    w = torch.zeros(6, 4, 1, 1)
    with pytest.raises(MXNetError):
        npx.relu_conv1x1(x3, w)
    with pytest.raises(MXNetError):
        npx.batch_norm_relu_conv1x1(x3, torch.ones(4), torch.zeros(4),
                                    torch.zeros(4), torch.ones(4), w)
    for val, want in (("0", False), ("1", True), ("off", False)):
        knob(val)
        assert npx.conv_fusion_enabled() is want
    knob("auto")      # one CUDA device; this machine has none
    assert npx.conv_fusion_enabled() is (
        torch.cuda.is_available() and torch.cuda.device_count() == 1)


def _bn_inputs(seed, N=4, C=6, H=5, W=7, Co=10):
    rng = onp.random.RandomState(seed)
    return dict(
        x=(rng.randn(N, C, H, W) * 2 + 3).astype("float32"),
        gamma=(rng.rand(C) + 0.5).astype("float32"),
        beta=(rng.randn(C) * 0.1).astype("float32"),
        rm=(rng.randn(C) * 0.1 + 3).astype("float32"),
        rv=(rng.rand(C) + 0.5).astype("float32"),
        shift=(rng.randn(C) * 0.1 + 3).astype("float32"),
        w=(rng.randn(Co, C, 1, 1) * 0.2).astype("float32"),
        cb=(rng.randn(Co) * 0.1).astype("float32"),
        g=rng.randn(N, Co, H, W).astype("float32"))


@pytest.mark.parametrize("training,stats", [(True, None),
                                            (True, "centered"),
                                            (False, None)])
@pytest.mark.parametrize("fused", [True, False])
def test_batch_norm_ops_match_jax(training, stats, fused):
    """npx.batch_norm (fused=False) and npx.batch_norm_relu_conv1x1: out,
    batch mean and var, and the gradients in x, gamma, beta, the conv
    weight and bias through sum(out * g)."""
    d = _bn_inputs(1)
    names = ["x", "gamma", "beta", "w", "cb"] if fused else \
        ["x", "gamma", "beta"]

    def run_jax():
        arrs = {k: mx.np.array(v) for k, v in d.items()}
        for k in names:
            arrs[k].attach_grad()
        with mx.autograd.record(train_mode=training):
            if fused:
                out, m, v = mx.npx.batch_norm_relu_conv1x1(
                    arrs["x"], arrs["gamma"], arrs["beta"], arrs["rm"],
                    arrs["rv"], arrs["w"], conv_bias=arrs["cb"],
                    stats=stats, shift=arrs["shift"])
                head = (out * arrs["g"]).sum()
            else:
                out, m, v = mx.npx.batch_norm(
                    arrs["x"], arrs["gamma"], arrs["beta"], arrs["rm"],
                    arrs["rv"], stats=stats, shift=arrs["shift"])
                head = (out * arrs["g"][:, :6]).sum()
        head.backward()
        return ([t.asnumpy() for t in (out, m, v)],
                {k: arrs[k].grad.asnumpy() for k in names})

    def run_port():
        ts = {k: _t(v) for k, v in d.items()}
        for k in names:
            ts[k].requires_grad_(True)
        with autograd.record(train_mode=training):
            if fused:
                out, m, v = npx.batch_norm_relu_conv1x1(
                    ts["x"], ts["gamma"], ts["beta"], ts["rm"], ts["rv"],
                    ts["w"], conv_bias=ts["cb"], stats=stats,
                    shift=ts["shift"])
                head = (out * ts["g"]).sum()
            else:
                out, m, v = npx.batch_norm(
                    ts["x"], ts["gamma"], ts["beta"], ts["rm"], ts["rv"],
                    stats=stats, shift=ts["shift"])
                head = (out * ts["g"][:, :6]).sum()
        autograd.backward(head)
        return ([t.detach().numpy() for t in (out, m, v)],
                {k: ts[k].grad.numpy() for k in names})

    (jo, jg), (to, tg) = run_jax(), run_port()
    for a, b in zip(to, jo):
        onp.testing.assert_allclose(a, b, **F32)
    for k in names:
        onp.testing.assert_allclose(tg[k], jg[k], **GRAD, err_msg=k)


def test_relu_conv1x1_matches_jax():
    d = _bn_inputs(2)
    jx, jw, jb = (mx.np.array(d[k]) for k in ("x", "w", "cb"))
    for a in (jx, jw, jb):
        a.attach_grad()
    with mx.autograd.record():
        jy = mx.npx.relu_conv1x1(jx - 3.0, jw, jb)
        (jy * mx.np.array(d["g"])).sum().backward()
    tx, tw, tb = (_t(d[k]).requires_grad_(True) for k in ("x", "w", "cb"))
    with autograd.record():
        ty = npx.relu_conv1x1(tx - 3.0, tw, tb)
    autograd.backward((ty * _t(d["g"])).sum())
    onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **F32)
    for t, j in ((tx, jx), (tw, jw), (tb, jb)):
        onp.testing.assert_allclose(t.grad.numpy(), j.grad.asnumpy(), **GRAD)


@pytest.mark.parametrize("pool_type,kw", [
    ("max", dict(kernel=3, stride=2, pad=1)),
    ("avg", dict(kernel=2)),
    ("avg", dict(kernel=3, stride=2, pad=1, count_include_pad=False)),
    ("max", dict(global_pool=True)),
    ("avg", dict(global_pool=True))])
def test_pooling_matches_jax(pool_type, kw):
    x = onp.random.RandomState(3).randn(2, 3, 9, 8).astype("float32")
    want = mx.npx.pooling(mx.np.array(x), pool_type=pool_type, **kw)
    got = npx.pooling(_t(x), pool_type=pool_type, **kw)
    onp.testing.assert_allclose(got.numpy(), want.asnumpy(), **F32)


@pytest.mark.parametrize("stride,pad,groups,bias", [
    (1, 0, 1, False), (2, 3, 1, False), (1, 1, 2, True)])
def test_convolution_matches_jax(stride, pad, groups, bias):
    rng = onp.random.RandomState(4)
    k = 7 if pad == 3 else 3
    x = rng.randn(2, 4, 15, 14).astype("float32")
    w = (rng.randn(6, 4 // groups, k, k) * 0.1).astype("float32")
    b = rng.randn(6).astype("float32") if bias else None
    want = mx.npx.convolution(
        mx.np.array(x), mx.np.array(w), None if b is None else mx.np.array(b),
        kernel=(k, k), stride=stride, pad=pad, num_filter=6,
        num_group=groups, no_bias=not bias)
    got = npx.convolution(_t(x), _t(w), None if b is None else _t(b),
                          kernel=(k, k), stride=stride, pad=pad,
                          num_filter=6, num_group=groups, no_bias=not bias)
    onp.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-4,
                                atol=1e-4)


# -------------------------------------------------------------- the layers
def _bn_relu_conv_net(seed):
    torch.manual_seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, use_bias=False, in_channels=4),
            nn.BatchNorm(in_channels=8), nn.Activation("relu"),
            nn.Conv2D(16, 1, use_bias=False, in_channels=8))
    return net.initialize(generator=torch.Generator().manual_seed(seed),
                          device="cpu")


def _train_two_steps(knob_val, knob, x):
    knob(knob_val)
    net = _bn_relu_conv_net(7)
    losses = []
    with _Spy() as spy:
        for _ in range(2):
            with autograd.record():
                y = net(x)
                loss = (y * y).sum()
            autograd.backward(loss)
            losses.append(float(loss.detach()))
        grads = {k: p.grad().numpy().copy()
                 for k, p in net.collect_params().items()
                 if p.grad_req != "null"}
        stats = {k: p.data().detach().numpy().copy()
                 for k, p in net.collect_params().items()
                 if "running" in k or "stat_shift" in k}
        eval_y = net(x).detach().numpy()
    return losses, grads, stats, eval_y, spy.calls


def test_gluon_junction_fused_matches_unfused(knob):
    """The HybridSequential (BatchNorm, relu, 1x1 conv) fusion is
    numerically invisible: losses, gradients, the moving statistics and
    the eval-mode output agree with the unfused chain over two steps, and
    the fused op ran in each of the three forwards."""
    x = _t(onp.random.RandomState(0).randn(4, 4, 8, 8).astype("float32"))
    lf, gf, sf, ef, calls = _train_two_steps("1", knob, x)
    lu, gu, su, eu, none = _train_two_steps("0", knob, x)
    assert calls == 3 and none == 0
    onp.testing.assert_allclose(lf, lu, rtol=1e-5)
    for k in gu:
        assert _rel(gf[k], gu[k]) <= 1e-4, k
    for k in su:
        onp.testing.assert_allclose(sf[k], su[k], **F32)
    onp.testing.assert_allclose(ef, eu, **F32)


@pytest.mark.parametrize("make", [
    lambda: nn.Conv2D(6, 1, strides=2, in_channels=4),
    lambda: nn.Conv2D(6, 3, padding=1, in_channels=4),
    lambda: nn.Conv2D(6, 1, in_channels=4, activation="relu"),
    lambda: nn.Conv2D(6, 1, padding=1, in_channels=4),
    "hook", "sigmoid", "off"])
def test_gluon_fusion_skips_ineligible(knob, make):
    """Strided, 3x3, activated or padded consumers, a hooked child, a
    non-relu activation, or the knob off: the chain runs unfused, and
    gives the unfused output."""
    knob("0" if make == "off" else "1")
    conv = nn.Conv2D(6, 1, in_channels=4) if isinstance(make, str) \
        else make()
    act = nn.Activation("sigmoid" if make == "sigmoid" else "relu")
    net = nn.HybridSequential()
    net.add(nn.BatchNorm(in_channels=4), act, conv)
    net.initialize(generator=torch.Generator().manual_seed(1), device="cpu")
    seen = []
    if make == "hook":
        act.register_forward_hook(lambda *a: seen.append(1))
    x = _t(onp.random.RandomState(2).randn(2, 4, 8, 8).astype("float32"))
    with _Spy() as spy:
        y = net(x)
    assert spy.calls == 0
    want = conv(act(net[0](x)))
    onp.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(),
                                **F32)
    if make == "hook":
        assert seen


def test_batchnorm_virgin_then_shifted_stats_match_jax():
    """Three training steps of one BatchNorm layer in both packages, on
    inputs with a mean near 3: the first takes centered statistics (the
    stat-shift buffer is still zero), the next two the shifted one-pass
    statistics about the previous batch's mean. Outputs, running mean and
    var and the shift buffer agree after every step; then eval mode."""
    rng = onp.random.RandomState(5)
    xs = [(rng.randn(4, 6, 5, 5) * (1 + i) + 3 + i).astype("float32")
          for i in range(3)]
    jbn = mx.gluon.nn.BatchNorm(in_channels=6, momentum=0.8)
    jbn.initialize()
    tbn = nn.BatchNorm(in_channels=6, momentum=0.8)
    load_jax_params(tbn, {k: p.data().asnumpy()
                          for k, p in jbn.collect_params().items()})
    assert tbn._resolve_virgin_stats()
    for i, x in enumerate(xs):
        with mx.autograd.record():
            jy = jbn(mx.np.array(x))
        with autograd.record():
            ty = tbn(_t(x))
        assert not tbn._resolve_virgin_stats()
        onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **F32)
        jp = {k: p.data().asnumpy() for k, p in jbn.collect_params().items()}
        tp = export_params(tbn)
        for k in ("running_mean", "running_var", "stat_shift"):
            onp.testing.assert_allclose(tp[k], jp[k], **F32,
                                        err_msg=f"{k} step {i}")
    onp.testing.assert_allclose(tbn(_t(xs[0])).detach().numpy(),
                                jbn(mx.np.array(xs[0])).asnumpy(), **F32)


def test_load_rebuilds_a_missing_stat_shift():
    """stat_shift is runtime-only: carried when given, zeroed (the next
    training step is centered again) when a parameter set lacks it; any
    other missing name raises."""
    bn = nn.BatchNorm(in_channels=3)
    full = {"gamma": onp.ones(3), "beta": onp.zeros(3),
            "running_mean": onp.full(3, 2.0), "running_var": onp.ones(3),
            "stat_shift": onp.full(3, 2.0)}
    load_jax_params(bn, full)
    assert not bn._resolve_virgin_stats()
    load_jax_params(bn, {k: v for k, v in full.items() if k != "stat_shift"})
    assert bn._resolve_virgin_stats()
    assert float(bn.running_mean.data()[0]) == 2.0
    with pytest.raises(MXNetError, match="missing"):
        load_jax_params(bn, {k: v for k, v in full.items()
                             if k != "running_var"})


# ------------------------------------------------------------------ ResNet
@pytest.mark.parametrize("name", ["resnet50_v1", "resnet101_v1",
                                  "resnet18_v2", "resnet50_v2"])
def test_zoo_names_match_jax(name):
    """The zoo's parameter names equal the JAX package's collect_params()
    keys (its shapes settle only at a first forward there; the small
    ResNet below loads every BottleneckV1 shape strictly)."""
    tnet = vision.get_model(name, classes=10, device="cpu")
    jnet = jresnet.__dict__[name](classes=10)
    assert list(tnet.collect_params()) == list(jnet.collect_params())


def test_residual_stage_never_leaks_the_preactivation(knob):
    knob("1")
    stage = resnet._ResidualStage()
    stage.add(resnet.BottleneckV1(16, 1, True, in_channels=8),
              resnet.BottleneckV1(16, 1, False, in_channels=16))
    stage.initialize(generator=torch.Generator().manual_seed(0),
                     device="cpu")
    x = _t(onp.random.RandomState(0).randn(2, 8, 6, 6).astype("float32"))
    with _Spy() as spy:
        y = stage(x)
    assert isinstance(y, torch.Tensor) and (y >= 0).all()
    assert (spy.calls, spy.relu_only) == (3, 1)
    # a block that does not consume the box materializes it on entry
    z = _t(onp.random.RandomState(1).randn(2, 16, 6, 6).astype("float32"))
    act = nn.Activation("sigmoid")
    onp.testing.assert_allclose(act(PreActivation(z)).numpy(),
                                torch.sigmoid(torch.relu(z)).numpy())


LAYERS, CHANNELS = [2, 2, 1, 1], [16, 32, 64, 128, 256]


def test_small_resnet_three_sgd_steps_match_jax(knob):
    """ResNetV1 with BottleneckV1 blocks, fusion on in both packages (the
    port fuses all 6 triples and 2 deferred junctions), three SGD-momentum
    steps from the same parameters: per-sample losses, every weight and
    every BatchNorm statistic after the steps, then an eval forward."""
    knob("1")
    mx.random.seed(0)
    jnet = jresnet.ResNetV1(jresnet.BottleneckV1, LAYERS, CHANNELS,
                            classes=10)
    jnet.initialize()
    jnet(mx.np.zeros((1, 3, 64, 64)))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = load_jax_params(resnet.ResNetV1(resnet.BottleneckV1, LAYERS,
                                           CHANNELS, classes=10), params)
    rng = onp.random.RandomState(0)
    x = rng.uniform(-1, 1, (4, 3, 64, 64)).astype("float32")
    y = rng.randint(0, 10, (4,)).astype("int32")
    hp = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(hp))
    ttr = Trainer(tnet.collect_params(), "sgd", dict(hp))
    jloss, tloss = mx.gluon.loss.SoftmaxCrossEntropyLoss(), \
        SoftmaxCrossEntropyLoss()
    tx, ty = _t(x), _t(y).long()
    with _Spy() as spy:
        for step in range(3):
            with mx.autograd.record():
                jl = jloss(jnet(mx.np.array(x)), mx.np.array(y))
            jl.backward()
            jtr.step(4)
            with autograd.record():
                tl = tloss(tnet(tx), ty)
            autograd.backward(tl)
            ttr.step(4)
            onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                        rtol=1e-4, atol=1e-5,
                                        err_msg=f"step {step}")
    assert (spy.calls, spy.relu_only) == (3 * 8, 3 * 2)
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tp = export_params(tnet)
    assert sorted(jp) == sorted(tp)
    moved = 0
    for k in jp:
        if k.endswith(("body.0.bias", "body.6.bias")):
            # a conv bias feeding a BatchNorm: its gradient is ~0
            onp.testing.assert_allclose(tp[k], jp[k], atol=1e-5, err_msg=k)
            continue
        assert _rel(tp[k], jp[k]) <= 1e-4, (k, _rel(tp[k], jp[k]))
        moved = max(moved, _rel(tp[k], params[k]))
    assert moved > 1e-3                      # three steps are not a no-op
    onp.testing.assert_allclose(tnet(tx).detach().numpy(),
                                jnet(mx.np.array(x)).asnumpy(),
                                rtol=1e-4, atol=1e-4)
