"""The port's Gluon layers (``gluon.nn`` activations, basic, convolution and
pooling layers, ``gluon.contrib.nn``) against the JAX package on the CPU.

Each case builds the layer in both packages, initializes the JAX one,
carries its parameters (PReLU's ``alpha``, the norms' gamma and beta, the
1-d, 3-d and transposed convolutions' weights and biases) to the port by
``load_jax_params``, and compares the output and, for one random
cotangent, the gradients of the input and of every parameter that takes
one. Tolerances, f32: forward rtol=1e-5, atol=1e-6; gradients rtol=1e-4,
atol=1e-6; convolutions 1e-4 both ways (other summation orders); the
copying layers (max pools, pads, pixel shuffles, ``Identity``) exactly,
but the reflection pad's gradient (a sum over reflected copies).
"""
import types

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.gluon.contrib.nn as jcontrib
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import contrib as tcontrib
from mxnet_tpu_torch.gluon import nn

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
CONV = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=0, atol=0)

JAX = types.SimpleNamespace(nn=mx.gluon.nn, contrib=jcontrib)
PORT = types.SimpleNamespace(nn=nn, contrib=tcontrib.nn)


def _x(*shape, seed=0):
    return (onp.random.RandomState(seed).randn(*shape) * 2).astype("float32")


def _params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def run_pair(build, shapes, init="normal", train=False, fwd=FWD, bwd=GRAD):
    """``build(pkg)`` in both packages, the JAX one initialized (Normal(0.5)
    or its own initializers), the port's loaded from it; outputs, input
    gradients and parameter gradients compared (the output alone when
    ``bwd`` is None: the JAX package cannot differentiate a block that
    returns its input)."""
    mx.random.seed(0)
    jb, tb = build(JAX), build(PORT)
    jb.initialize(mx.init.Normal(0.5) if init == "normal" else None)
    load_jax_params(tb, _params(jb))
    xs = [_x(*s, seed=i) for i, s in enumerate(shapes)]
    jx = [mx.np.array(x) for x in xs]
    for a in jx:
        a.attach_grad()
    with mx.autograd.record(train_mode=train):
        jy = jb(*jx)
    if bwd is None:
        ty = tb(*[torch.from_numpy(x) for x in xs])
        onp.testing.assert_array_equal(ty.numpy(), jy.asnumpy())
        return jb, tb
    cot = _x(*jy.shape, seed=99)
    jy.backward(mx.np.array(cot))
    tx = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    with autograd.record(train_mode=train):
        ty = tb(*tx)
    ty.backward(torch.from_numpy(cot))
    assert tuple(ty.shape) == jy.shape
    onp.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), **fwd)
    for i, (a, b) in enumerate(zip(tx, jx)):
        onp.testing.assert_allclose(a.grad.numpy(), b.grad.asnumpy(), **bwd,
                                    err_msg=f"input {i}")
    tparams = tb.collect_params()
    for name, p in jb.collect_params().items():
        if p.grad_req != "null":
            onp.testing.assert_allclose(tparams[name].grad().numpy(),
                                        p.grad().asnumpy(), **bwd,
                                        err_msg=name)
    return jb, tb


def _case(cid, build, shapes, **kw):
    return pytest.param(build, shapes, kw, id=cid)


X3 = [(3, 4, 5)]
CASES = [
    _case("LeakyReLU", lambda m: m.nn.LeakyReLU(0.2), X3),
    _case("PReLU", lambda m: m.nn.PReLU(), X3, init=None),
    _case("PReLU-5", lambda m: m.nn.PReLU(in_channels=5), X3),
    _case("ELU", lambda m: m.nn.ELU(0.5), X3),
    _case("SELU", lambda m: m.nn.SELU(), X3),
    _case("GELU", lambda m: m.nn.GELU(), X3),
    _case("GELU-tanh", lambda m: m.nn.GELU("tanh"), X3),
    _case("Swish", lambda m: m.nn.Swish(), X3),
    _case("Swish-2", lambda m: m.nn.Swish(2.0), X3),
    _case("SiLU", lambda m: m.nn.SiLU(), X3),
    _case("Mish", lambda m: m.nn.Mish(), X3),
    _case("HardSigmoid", lambda m: m.nn.HardSigmoid(), X3),
    _case("HardSigmoid-ab", lambda m: m.nn.HardSigmoid(0.3, 0.4), X3),
    _case("HardSwish", lambda m: m.nn.HardSwish(), X3),
    # basic layers
    _case("SyncBatchNorm", lambda m: m.nn.SyncBatchNorm(in_channels=4),
          [(2, 4, 3, 3)], init=None, train=True),
    _case("SyncBatchNorm-eval", lambda m: m.nn.SyncBatchNorm(
        in_channels=4, num_devices=1), [(2, 4, 3, 3)], init=None),
    _case("GroupNorm", lambda m: m.nn.GroupNorm(2, in_channels=4),
          [(2, 4, 3, 3)]),
    _case("GroupNorm-eps", lambda m: m.nn.GroupNorm(
        4, epsilon=1e-3, in_channels=4), [(2, 4, 5)], init=None),
    _case("InstanceNorm", lambda m: m.nn.InstanceNorm(in_channels=4),
          [(2, 4, 3, 3)]),
    _case("Identity", lambda m: m.nn.Identity(), X3, bwd=None),
    _case("Lambda-name", lambda m: m.nn.Lambda("tanh"), X3),
    _case("Lambda", lambda m: m.nn.Lambda(lambda x: x * x), X3),
    _case("HybridLambda-name", lambda m: m.nn.HybridLambda("exp"),
          [(3, 4)]),
    _case("HybridLambda", lambda m: m.nn.HybridLambda(lambda x: x * 3 + 1),
          X3),
    # convolutions, channels-first, weights (out, in / groups, k...) and,
    # transposed, (in, out / groups, k...)
    _case("Conv1D", lambda m: m.nn.Conv1D(6, 3, strides=2, padding=1,
                                          in_channels=4), [(2, 4, 9)],
          fwd=CONV, bwd=CONV),
    _case("Conv1D-groups", lambda m: m.nn.Conv1D(
        6, 3, dilation=2, groups=2, in_channels=4, activation="relu"),
        [(2, 4, 9)], fwd=CONV, bwd=CONV),
    _case("Conv3D", lambda m: m.nn.Conv3D(5, 3, padding=1, in_channels=3),
          [(2, 3, 4, 5, 6)], fwd=CONV, bwd=CONV),
    _case("Conv3D-strided", lambda m: m.nn.Conv3D(
        4, (2, 3, 3), strides=(1, 2, 2), use_bias=False, in_channels=3),
        [(1, 3, 4, 7, 6)], fwd=CONV, bwd=CONV),
    _case("Conv1DTranspose", lambda m: m.nn.Conv1DTranspose(
        5, 4, strides=2, padding=1, in_channels=4), [(2, 4, 7)],
        fwd=CONV, bwd=CONV),
    _case("Conv1DTranspose-adj", lambda m: m.nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, in_channels=4),
        [(2, 4, 7)], fwd=CONV, bwd=CONV),
    _case("Conv2DTranspose", lambda m: m.nn.Conv2DTranspose(
        3, 4, 2, 1, use_bias=False, in_channels=4), [(2, 4, 5, 5)],
        fwd=CONV, bwd=CONV),
    _case("Conv2DTranspose-adj", lambda m: m.nn.Conv2DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, in_channels=4,
        activation="tanh"), [(2, 4, 5, 6)], fwd=CONV, bwd=CONV),
    _case("Conv2DTranspose-dcgan-first", lambda m: m.nn.Conv2DTranspose(
        8, 4, 1, 0, use_bias=False, in_channels=6), [(2, 6, 1, 1)],
        fwd=CONV, bwd=CONV),
    _case("Conv3DTranspose", lambda m: m.nn.Conv3DTranspose(
        2, 3, strides=2, padding=1, output_padding=1, in_channels=3),
        [(1, 3, 3, 4, 4)], fwd=CONV, bwd=CONV),
    # pools and pads
    _case("MaxPool1D", lambda m: m.nn.MaxPool1D(3, 2, 1), [(2, 3, 9)],
          fwd=EXACT, bwd=EXACT),
    _case("AvgPool1D", lambda m: m.nn.AvgPool1D(), [(2, 3, 8)]),
    _case("AvgPool1D-pad", lambda m: m.nn.AvgPool1D(
        3, 1, 1, count_include_pad=False), [(2, 3, 8)]),
    _case("MaxPool3D", lambda m: m.nn.MaxPool3D(), [(2, 3, 4, 6, 4)],
          fwd=EXACT, bwd=EXACT),
    _case("AvgPool3D", lambda m: m.nn.AvgPool3D((2, 3, 2), padding=1),
          [(2, 3, 4, 6, 4)]),
    _case("GlobalMaxPool1D", lambda m: m.nn.GlobalMaxPool1D(), [(2, 3, 9)],
          fwd=EXACT, bwd=EXACT),
    _case("GlobalMaxPool2D", lambda m: m.nn.GlobalMaxPool2D(),
          [(2, 3, 5, 6)], fwd=EXACT, bwd=EXACT),
    _case("GlobalMaxPool3D", lambda m: m.nn.GlobalMaxPool3D(),
          [(2, 3, 4, 5, 3)], fwd=EXACT, bwd=EXACT),
    _case("GlobalAvgPool1D", lambda m: m.nn.GlobalAvgPool1D(), [(2, 3, 9)]),
    _case("GlobalAvgPool3D", lambda m: m.nn.GlobalAvgPool3D(),
          [(2, 3, 4, 5, 3)]),
    _case("ReflectionPad2D", lambda m: m.nn.ReflectionPad2D(2),
          [(2, 3, 5, 6)], fwd=EXACT),
    # gluon.contrib.nn
    _case("Identity-contrib", lambda m: m.contrib.Identity(), X3, bwd=None),
    _case("PixelShuffle1D", lambda m: m.contrib.PixelShuffle1D(2),
          [(2, 6, 5)], fwd=EXACT, bwd=EXACT),
    _case("PixelShuffle2D", lambda m: m.contrib.PixelShuffle2D((2, 3)),
          [(2, 12, 3, 4)], fwd=EXACT, bwd=EXACT),
    _case("PixelShuffle3D", lambda m: m.contrib.PixelShuffle3D(2),
          [(1, 16, 2, 3, 2)], fwd=EXACT, bwd=EXACT),
]


@pytest.mark.parametrize("build,shapes,kw", CASES)
def test_layer_matches_jax(build, shapes, kw):
    run_pair(build, shapes, **kw)


def _branches(m, cls, axis=1):
    net = cls(axis=axis)
    net.add(m.nn.Conv2D(3, 1, in_channels=4), m.nn.Identity(),
            m.nn.Conv2D(2, 3, padding=1, in_channels=4))
    return net


@pytest.mark.parametrize("where,cls", [
    ("nn", "HybridConcatenate"), ("nn", "Concatenate"),
    ("contrib", "HybridConcurrent"), ("contrib", "Concurrent")])
def test_concatenating_containers_match_jax(where, cls):
    run_pair(lambda m: _branches(m, getattr(getattr(m, where), cls)),
             [(2, 4, 5, 5)], fwd=CONV, bwd=CONV)


def _mlp(m, cls):
    net = cls()
    net.add(m.nn.Dense(8, in_units=5), m.nn.LeakyReLU(0.1),
            m.nn.Dense(3, in_units=8), m.nn.Activation("tanh"))
    return net


@pytest.mark.parametrize("cls", ["Sequential", "HybridSequential"])
def test_sequential_matches_jax_and_slices(cls):
    jb, tb = run_pair(lambda m: _mlp(m, getattr(m.nn, cls)), [(4, 5)])
    assert len(tb) == len(jb) == 4
    assert [type(b).__name__ for b in tb] == [type(b).__name__ for b in jb]
    assert isinstance(tb[1], nn.LeakyReLU) and tb[-1] is list(tb)[-1]
    tail = tb[2:]
    assert type(tail) is type(tb) and len(tail) == 2 and tail[0] is tb[2]
    h = _x(4, 8)
    onp.testing.assert_allclose(
        tail(torch.from_numpy(h)).detach().numpy(),
        jb[2:](mx.np.array(h)).asnumpy(), **FWD)


def test_sequential_hybridize_reaches_hybrid_children():
    net = nn.Sequential()
    inner = nn.HybridSequential()
    inner.add(nn.Dense(3, in_units=2))
    net.add(inner, nn.Lambda(lambda x: x))
    net.hybridize()
    assert inner._active
    net.hybridize(False)
    assert not inner._active


def test_sync_batch_norm_updates_running_statistics_as_jax():
    jb, tb = run_pair(lambda m: m.nn.SyncBatchNorm(in_channels=4),
                      [(3, 4, 2, 2)], init=None, train=True)
    for name in ("running_mean", "running_var"):
        onp.testing.assert_allclose(
            getattr(tb, name).data().numpy(),
            getattr(jb, name).data().asnumpy(), **FWD)


def test_transposed_weight_layout_is_in_out():
    """(in_channels, channels / groups, k...): what ``load_jax_params``
    copies by name and shape, and ``F.conv_transpose*``'s layout."""
    for cls, k in ((nn.Conv1DTranspose, (3,)), (nn.Conv2DTranspose, (3, 3)),
                   (nn.Conv3DTranspose, (3, 3, 3))):
        assert cls(6, 3, in_channels=4).weight.shape == (4, 6) + k
        assert getattr(mx.gluon.nn, cls.__name__)(
            6, 3, in_channels=4).weight.shape == (4, 6) + k


def test_pixel_shuffle_and_lambda_refusals():
    with pytest.raises(MXNetError, match="divisible"):
        tcontrib.nn.PixelShuffle2D(2)(torch.zeros(1, 6, 2, 2))
    with pytest.raises(MXNetError, match="elements"):
        tcontrib.nn.PixelShuffle2D((2, 2, 2))
    with pytest.raises(MXNetError, match="no_such_fn"):
        nn.Lambda("no_such_fn")
