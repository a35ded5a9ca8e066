"""The port's namespaces, the reference's arguments and ``npx.pick`` out of
range, against the JAX package on the CPU.

- Namespaces: every name of the JAX package's lazy table
  (``mxnet_tpu._LAZY``), of its top level and of the ``__all__`` of its
  ``gluon``, ``gluon.nn`` and ``npx`` resolves on the port, or raises
  :class:`MXNetError` naming the ROADMAP Queue A item that ports it.
- Arguments and methods of the reference that the port used to reject:
  each is accepted and computes what the JAX package computes, or, where
  its non-default value needs a module the port lacks, raises
  :class:`MXNetError` naming the Queue A item.
- ``npx.pick``: an index in [-L, L) counts from the end when negative, any
  other reads NaN (the JAX package's ``take_along_axis`` fill).

Values copied between the packages and integer picks compare exactly;
computed f32 values at rtol=1e-6, atol=1e-7 (the same formula), and the
normalizations (LayerNorm, log-softmax) at rtol=1e-5, atol=1e-6.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.gluon as jgluon
import mxnet_tpu.gluon.nn as jnn
import mxnet_tpu.npx as jnpx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, npx
from mxnet_tpu_torch.base import UNPORTED, MXNetError
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import Parameter, Trainer, nn

F32 = dict(rtol=1e-6, atol=1e-7)

# the JAX package's top level: its lazy table, the modules its __init__
# imports, and its other public names
TOP = sorted(set(mx._LAZY) | set(
    "autograd base bulk context engine faults metrics nd ndarray ndarray_io "
    "np npx numpy ops random tracing util Context MXNetError NDArray cpu "
    "cpu_pinned current_context gpu is_np_array is_np_shape num_gpus "
    "num_tpus set_np tpu waitall".split()))
# namespaces of the JAX package, the port's counterpart, the names to walk
NAMESPACES = [
    ("mxnet_tpu", tmx, TOP),
    ("mxnet_tpu.gluon", tmx.gluon, list(jgluon.__all__)),
    ("mxnet_tpu.gluon.nn", tmx.gluon.nn, list(jnn.__all__)),
    ("mxnet_tpu.npx", tmx.npx, list(jnpx.__all__)),
]
# names whose modules are ported: each must resolve
PORTED = {
    "mxnet_tpu": "gluon optimizer initializer init lr_scheduler rtc serving "
                 "metrics faults tracing autograd base context nd ndarray ndarray_io np npx numpy "
                 "ops random util Context MXNetError NDArray cpu cpu_pinned "
                 "current_context gpu is_np_array is_np_shape num_gpus "
                 "num_tpus set_np tpu waitall",
    "mxnet_tpu.gluon": "Block HybridBlock Parameter Trainer nn loss Loss "
                       "model_zoo",
    "mxnet_tpu.gluon.nn": "HybridSequential Dense Dropout BatchNorm "
                          "LayerNorm Embedding Flatten Conv2D MaxPool2D "
                          "AvgPool2D GlobalAvgPool2D Activation Block "
                          "HybridBlock",
    "mxnet_tpu.npx": "activation dropout embedding fully_connected gelu "
                     "layer_norm log_softmax pick take_positions "
                     "dot_product_attention multi_head_attention relu "
                     "convolution pooling batch_norm conv_fusion_enabled "
                     "batch_norm_relu_conv1x1 relu_conv1x1 set_np reset_np "
                     "is_np_array is_np_shape use_np cpu gpu tpu num_gpus "
                     "num_tpus current_context waitall one_hot topk pad "
                     "arange reshape gather_nd scatter_nd sigmoid tanh "
                     "reshape_like broadcast_like batch_dot depth_to_space "
                     "space_to_depth shuffle spatial_transformer khatri_rao",
}


@pytest.mark.parametrize("jname,port,names", NAMESPACES,
                         ids=[n[0] for n in NAMESPACES])
def test_every_reference_name_resolves_or_names_its_queue_item(jname, port,
                                                               names):
    ported = set(PORTED[jname].split())
    table = UNPORTED[port.__name__]
    for name in names:
        if name in ported:
            assert getattr(port, name) is not None, name
            assert name not in table, name
            continue
        assert name in table, f"{jname}.{name}: neither ported nor listed"
        with pytest.raises(MXNetError, match=f"Queue A {table[name]}\\b"):
            getattr(port, name)
    assert set(table) <= set(names), set(table) - set(names)
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")


def test_lazy_modules_are_the_ported_modules():
    assert tmx.init is tmx.initializer
    assert tmx.gluon.model_zoo.vision.get_model is not None
    assert tmx.npx.one_hot is tmx.nd.one_hot
    assert tmx.gluon.nn.HybridBlock is tmx.gluon.HybridBlock
    assert issubclass(tmx.gluon.loss.SoftmaxCrossEntropyLoss, tmx.gluon.Loss)
    assert tmx.npx.num_tpus() == 0 and tmx.npx.is_np_array()
    with pytest.raises(MXNetError, match="gpu"):
        tmx.npx.tpu()


# ---------------------------------------------------------------- npx.pick
@pytest.mark.parametrize("index", [[0, -1, 2], [0, 4, 2], [-4, 3, -5]])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_pick_out_of_range_matches_jax(index, dtype):
    data = onp.arange(12).reshape(3, 4).astype(dtype)
    idx = onp.array(index, "float32")
    want = mx.npx.pick(mx.np.array(data, dtype=dtype),
                       mx.np.array(idx)).asnumpy()
    got = npx.pick(torch.from_numpy(data), torch.from_numpy(idx)).numpy()
    onp.testing.assert_array_equal(got, want)
    for mode in ("clip", "wrap"):
        onp.testing.assert_array_equal(
            npx.pick(torch.from_numpy(data), torch.from_numpy(idx),
                     mode=mode).numpy(), want)


def test_pick_keepdims_and_axis_match_jax():
    rng = onp.random.RandomState(0)
    data = rng.randn(2, 5, 3).astype("float32")
    idx = onp.array([[0, 4, -1], [5, 2, -6]], "float32")
    want = mx.npx.pick(mx.np.array(data), mx.np.array(idx), axis=1,
                       keepdims=True).asnumpy()
    got = npx.pick(torch.from_numpy(data), torch.from_numpy(idx), axis=1,
                   keepdims=True).numpy()
    onp.testing.assert_array_equal(got, want)


# ------------------------------------------------------- layer arguments
def _copy(jblock, tblock):
    params = {k: p.data().asnumpy() for k, p in
              jblock.collect_params().items()}
    load_jax_params(tblock, params)


def test_layer_norm_center_scale_match_jax():
    jl = mx.gluon.nn.LayerNorm(center=False, scale=False, in_channels=6)
    jl.initialize()
    rng = onp.random.RandomState(1)
    for p in jl.collect_params().values():
        p.set_data(mx.np.array(rng.randn(6).astype("float32")))
    tl = nn.LayerNorm(center=False, scale=False, in_channels=6)
    _copy(jl, tl)
    x = rng.randn(3, 6).astype("float32")
    onp.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                                jl(mx.np.array(x)).asnumpy(), rtol=1e-5,
                                atol=1e-6)


@pytest.mark.parametrize("axes", [(), (1,), (0, 2)])
def test_dropout_axes_and_mode_match_jax(axes):
    """The mask is random in both packages; its shape is not: shared along
    ``axes``, kept values scaled by 1/(1-p); identity outside training
    unless ``mode='always'``."""
    x = onp.random.RandomState(2).rand(4, 6, 5).astype("float32") + 1
    jd, td = mx.gluon.nn.Dropout(0.5, axes=axes), nn.Dropout(0.5, axes=axes)
    with mx.autograd.record():
        jy = jd(mx.np.array(x)).asnumpy()
    with autograd.record():
        ty = td(torch.from_numpy(x)).numpy()
    for y in (jy, ty):
        kept = y != 0
        onp.testing.assert_allclose(y[kept], x[kept] * 2, rtol=1e-6)
        for ax in axes:
            assert (kept == kept.take([0], axis=ax)).all()
    onp.testing.assert_array_equal(td(torch.from_numpy(x)).numpy(), x)
    onp.testing.assert_array_equal(jd(mx.np.array(x)).asnumpy(), x)
    for y in (mx.npx.dropout(mx.np.array(x), 0.5, mode="always").asnumpy(),
              npx.dropout(torch.from_numpy(x), 0.5, mode="always").numpy()):
        assert (y == 0).any() and not (y == x).all()


def test_embedding_dtype_and_sparse_grad():
    rng = onp.random.RandomState(3)
    w = rng.randn(10, 4).astype("float32")
    idx = onp.array([[1, 9], [0, 3]], "float32")
    want = mx.npx.embedding(mx.np.array(idx), mx.np.array(w), 10, 4,
                            dtype="float32", sparse_grad=False).asnumpy()
    got = npx.embedding(torch.from_numpy(idx), torch.from_numpy(w), 10, 4,
                        dtype="float32", sparse_grad=False).numpy()
    onp.testing.assert_array_equal(got, want)
    emb = nn.Embedding(10, 4, sparse_grad=False)
    assert tuple(emb.weight.shape) == (10, 4)
    with pytest.raises(MXNetError, match="Queue A 10"):
        nn.Embedding(10, 4, sparse_grad=True)
    with pytest.raises(MXNetError, match="Queue A 10"):
        npx.embedding(torch.from_numpy(idx), torch.from_numpy(w),
                      sparse_grad=True)


@pytest.mark.parametrize("cls", ["MaxPool2D", "AvgPool2D"])
def test_pool_ceil_mode_matches_jax(cls):
    x = onp.random.RandomState(4).randn(2, 3, 7, 7).astype("float32")
    jp = getattr(mx.gluon.nn, cls)(pool_size=2, strides=2, ceil_mode=True)
    tp = getattr(nn, cls)(pool_size=2, strides=2, ceil_mode=True)
    want = jp(mx.np.array(x)).asnumpy()
    got = tp(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, **F32)


def test_log_softmax_temperature_matches_jax():
    x = onp.random.RandomState(5).randn(3, 7).astype("float32")
    for t in (None, 1.0, 2.5):
        want = mx.npx.log_softmax(mx.np.array(x), temperature=t).asnumpy()
        got = npx.log_softmax(torch.from_numpy(x), temperature=t).numpy()
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ Parameter, Block
def test_parameter_arguments_cast_and_is_initialized():
    kw = dict(shape=(3, 2), allow_deferred_init=False, differentiable=False,
              stype="default", grad_stype="default")
    jp, tp = mx.gluon.Parameter("w", **kw), Parameter("w", **kw)
    assert jp.grad_req == tp.grad_req == "null"
    assert jp.is_initialized is False and tp.is_initialized is False
    jp.initialize(init="ones")
    tp.initialize(init="ones", device="cpu")
    assert jp.is_initialized is True and tp.is_initialized is True
    jp.cast("float16")
    tp.cast("float16")
    assert str(jp.data().dtype) == "float16" and tp.dtype == torch.float16
    onp.testing.assert_array_equal(tp.data().numpy(), jp.data().asnumpy())
    for pkg in (mx.gluon, tmx.gluon):
        with pytest.raises(ValueError):
            pkg.Parameter("w", shape=(2,), stype="row_sparse")
    with pytest.raises(MXNetError, match="Queue A 10"):
        Parameter("w", shape=(2,), grad_stype="row_sparse")
    with pytest.raises(MXNetError, match="Queue A 8"):
        Parameter("w", shape=(0, 2))


def _block_pair():
    jb = mx.gluon.nn.Dense(3, in_units=2)
    jb.initialize()
    tb = nn.Dense(3, in_units=2)
    _copy(jb, tb)
    for b in (jb, tb):
        extra = type(jb.weight)("extra", shape=(4,), init="zeros") \
            if b is jb else Parameter("extra", shape=(4,), init="zeros")
        assert b.register_parameter("extra", extra) is extra
    jb.extra.initialize()
    tb.extra.initialize(device="cpu")
    return jb, tb


def test_block_register_parameter_params_reset_ctx_summary():
    jb, tb = _block_pair()
    assert list(tb.params) == list(jb.params) == ["weight", "bias", "extra"]
    assert list(tb.collect_params()) == list(jb.collect_params())
    assert "extra" in dict(tb.named_parameters())
    tb.reset_ctx(tmx.cpu())
    jb.reset_ctx(mx.cpu())
    assert tb.weight.data().device.type == "cpu"
    assert tb.summary() == jb.summary()
    tb.register_parameter("plain", torch.nn.Parameter(torch.zeros(1)))
    assert "plain" in dict(tb.named_parameters())


def test_ndarray_softmax_methods_match_jax():
    x = onp.random.RandomState(6).randn(3, 5).astype("float32")
    with tmx.cpu():
        tx = tmx.nd.array(x)
    for axis in (-1, 0):
        onp.testing.assert_allclose(
            tx.softmax(axis=axis).asnumpy(),
            mx.npx.softmax(mx.np.array(x), axis=axis).asnumpy(), **F32)
        onp.testing.assert_allclose(
            tx.log_softmax(axis=axis).asnumpy(),
            mx.npx.log_softmax(mx.np.array(x), axis=axis).asnumpy(),
            rtol=1e-5, atol=1e-6)


def test_trainer_allreduce_grads_takes_ignore_stale_grad():
    tb = nn.Dense(3, in_units=2)
    tb.initialize(device="cpu")
    tr = Trainer(tb.collect_params(), "sgd", {"learning_rate": 0.1})
    tr.allreduce_grads(ignore_stale_grad=True)
    tr.allreduce_grads()
