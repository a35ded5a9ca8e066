"""The port's namespaces, the reference's arguments and ``npx.pick`` out of
range, against the JAX package on the CPU.

- Namespaces: every name of the JAX package's lazy table
  (``mxnet_tpu._LAZY``), of its top level and of the ``__all__`` of its
  ``gluon``, ``gluon.nn``, ``gluon.loss``, ``gluon.contrib``,
  ``gluon.contrib.nn``, ``initializer`` and ``npx`` resolves on the port,
  or raises :class:`MXNetError` naming the ROADMAP Queue A item that ports
  it.
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
import mxnet_tpu.gluon.contrib as jcontrib
import mxnet_tpu.gluon.contrib.nn as jcontrib_nn
import mxnet_tpu.gluon.loss as jloss
import mxnet_tpu.gluon.nn as jnn
import mxnet_tpu.initializer as jinit
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
    ("mxnet_tpu.gluon.loss", tmx.gluon.loss, list(jloss.__all__)),
    ("mxnet_tpu.gluon.contrib", tmx.gluon.contrib, list(jcontrib.__all__)),
    ("mxnet_tpu.gluon.contrib.nn", tmx.gluon.contrib.nn,
     list(jcontrib_nn.__all__)),
    ("mxnet_tpu.initializer", tmx.initializer, list(jinit.__all__)),
    ("mxnet_tpu.npx", tmx.npx, list(jnpx.__all__)),
]
# names whose modules are ported: each must resolve (rnn, ROADMAP Queue A
# 9, is not)
PORTED = {
    "mxnet_tpu": "gluon optimizer initializer init lr_scheduler rtc serving "
                 "metrics faults tracing autograd base context nd ndarray ndarray_io np npx numpy "
                 "ops random util contrib Context MXNetError NDArray cpu cpu_pinned "
                 "current_context gpu is_np_array is_np_shape num_gpus "
                 "num_tpus set_np tpu waitall",
    "mxnet_tpu.gluon": "Block HybridBlock Parameter Constant Trainer nn loss "
                       "Loss model_zoo contrib",
    "mxnet_tpu.gluon.nn": " ".join(jnn.__all__),
    "mxnet_tpu.gluon.loss": " ".join(jloss.__all__),
    "mxnet_tpu.gluon.contrib": "nn",
    "mxnet_tpu.gluon.contrib.nn": " ".join(jcontrib_nn.__all__),
    "mxnet_tpu.initializer": " ".join(jinit.__all__),
    "mxnet_tpu.npx": " ".join(n for n in jnpx.__all__ if n != "rnn"),
}


@pytest.mark.parametrize("jname,port,names", NAMESPACES,
                         ids=[n[0] for n in NAMESPACES])
def test_every_reference_name_resolves_or_names_its_queue_item(jname, port,
                                                               names):
    ported = set(PORTED[jname].split())
    table = UNPORTED.get(port.__name__, {})
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


# ------------------------------------------- serving, zoo, init and random
def test_served_model_takes_the_jax_argument_order():
    """``ServedModel(fn, input_signature, fixed_batch, name)``."""
    from mxnet_tpu.serving import ServedModel as JServed
    from mxnet_tpu_torch.serving import ServedModel as TServed
    sig = [((4,), onp.float32)]
    for fixed in (8, None):
        j = JServed(lambda a: [], sig, fixed, "m")
        t = TServed(lambda a: [], sig, fixed, "m")
        assert (t.name, t.fixed_batch) == (j.name, j.fixed_batch) \
            == ("m", fixed)
        assert t.describe()["fixed_batch"] == j.describe()["fixed_batch"]
        assert t.default_policy().batch_buckets == \
            j.default_policy().batch_buckets


def _dense_pair():
    jb = mx.gluon.nn.Dense(3, in_units=4, flatten=False)
    jb.initialize()
    tb = nn.Dense(3, in_units=4, flatten=False)
    _copy(jb, tb)
    return jb, tb


def test_load_served_block_and_export_match_jax(tmp_path):
    from mxnet_tpu.serving import load_served as jload
    from mxnet_tpu_torch.serving import load_served as tload
    jb, tb = _dense_pair()
    x = onp.random.RandomState(7).randn(2, 4).astype("float32")
    jb.hybridize()
    jb(mx.np.array(x))
    tb.hybridize()
    tb(torch.from_numpy(x))
    want = jload(jb).predict([x])[0]
    got = tload(tb, device="cpu").predict([x])[0]
    onp.testing.assert_allclose(got, want, **F32)
    jprefix, tprefix = str(tmp_path / "j"), str(tmp_path / "t")
    jb.export(jprefix)
    tb.export(tprefix)
    for prefix in (tprefix, tprefix + "-symbol.json"):
        served = tload(prefix, device="cpu")
        assert served.fixed_batch == jload(jprefix).fixed_batch == 2
        onp.testing.assert_allclose(served.predict([x])[0], want, **F32)
    # the packages' export formats are their own (a documented contract)
    with pytest.raises(MXNetError, match="framework"):
        tload(jprefix, device="cpu")

    class Module:
        params_initialized = True

    with pytest.raises(MXNetError, match="Queue A 15"):
        tload(Module())
    for load in (jload, tload):
        with pytest.raises(mx.MXNetError if load is jload else MXNetError):
            load(3)


def test_replica_supervisor_state_queries_match_jax():
    from mxnet_tpu.serving import ReplicaSupervisor as JSup
    from mxnet_tpu_torch.serving import ReplicaSupervisor as TSup
    states = []
    for cls in (JSup, TSup):
        alive = {0: True, 1: True}
        sup = cls("s", 2, spawn=lambda rid: None,
                  on_degraded=lambda exc: None, alive_fn=alive.__getitem__,
                  max_restarts=0, backoff_ms=1.0)
        seen = [(sup.degraded, sup.tripped(0), sup.restart_pending(0))]
        alive[0] = False
        sup.notify_death(0, RuntimeError("x"))
        seen.append((sup.degraded, sup.tripped(0), sup.tripped(1),
                     sup.restart_pending(0), sup.tripped(9)))
        alive[1] = False
        sup.notify_death(1, RuntimeError("y"))
        seen.append((sup.degraded, sup.tripped(1)))
        sup.reset()
        seen.append((sup.degraded, sup.tripped(0), sup.tripped(1)))
        slow = cls("p", 1, spawn=lambda rid: None,
                   on_degraded=lambda exc: None, alive_fn=lambda rid: False,
                   max_restarts=1, backoff_ms=60_000.0)
        slow.notify_death(0, RuntimeError("z"))
        seen.append((slow.restart_pending(0), slow.tripped(0),
                     slow.degraded))
        slow.stop()
        seen.append((slow.restart_pending(0),))
        states.append(seen)
    assert states[0] == states[1]
    assert states[1][2] == (True, True) and states[1][4] == (True, False,
                                                             False)


def test_paged_kv_cache_layers_match_jax():
    from mxnet_tpu.serving import PagedKVCache as JCache
    from mxnet_tpu_torch.serving import PagedKVCache as TCache
    j = JCache(3, 2, 4, max_slots=2, buckets=[8])
    t = TCache(3, 2, 4, max_slots=2, buckets=[8], device="cpu")
    jl, tl = j.layers(), t.layers()
    assert len(tl) == len(jl) == 3
    for (jk, jv), (tk, tv), i in zip(jl, tl, range(3)):
        assert tuple(tk.shape) == tuple(jk.shape) == (2, 8, 2, 4)
        assert tk is t.k(i) and tv is t.v(i)
        onp.testing.assert_array_equal(tv.numpy(), onp.asarray(jv))


@pytest.mark.parametrize("init", ["zeros", "ones"])
def test_initializer_init_array_matches_jax(init):
    jarr = mx.np.array(onp.full((3, 2), 5.0, "float32"))
    mx.initializer.get(init).init_array("w", jarr)
    with tmx.cpu():
        tarr = tmx.nd.array(onp.full((3, 2), 5.0, "float32"))
    tmx.initializer.get(init).init_array("w", tarr)
    onp.testing.assert_array_equal(tarr.asnumpy(), jarr.asnumpy())
    t = torch.full((4,), 5.0, dtype=torch.bfloat16)
    tmx.init.Normal(0.5).init_array("w", t)
    assert t.dtype == torch.bfloat16 and not (t == 5.0).any()


def test_random_seed_takes_ctx():
    for pkg in (mx, tmx):
        pkg.random.seed(3, ctx="all")
        pkg.random.seed(3, ctx=pkg.cpu())
    tmx.random.seed(11, ctx="all")
    a = tmx.nd.random.uniform(shape=(5,), ctx=tmx.cpu()).asnumpy()
    tmx.random.seed(11)
    b = tmx.nd.random.uniform(shape=(5,), ctx=tmx.cpu()).asnumpy()
    onp.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("factory", ["get_resnet", "resnet18_v1"])
def test_resnet_factories_place_the_net_on_ctx(factory):
    """``ctx=`` places (and, as in the JAX package, initializes) the net
    there; ``device=`` is the same argument under the port's name."""
    from mxnet_tpu.gluon.model_zoo import vision as jvision
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
    args = (1, 18) if factory == "get_resnet" else ()
    jnet = getattr(jvision, factory)(*args, ctx=mx.cpu(), classes=10)
    tnet = getattr(tvision, factory)(*args, ctx=tmx.cpu(), classes=10)
    assert type(tnet).__name__ == type(jnet).__name__ == "ResNetV1"
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert {p.data().device.type for p in
            tnet.collect_params().values()} == {"cpu"}
    assert all(p.is_initialized for p in tnet.collect_params().values())
    with pytest.raises(MXNetError, match="not both"):
        getattr(tvision, factory)(*args, ctx=tmx.cpu(), device="cpu",
                                  classes=10)
    net = tvision.get_model("resnet18_v1", device="cpu", classes=10)
    assert not net.output.weight.data().detach().any()


def test_get_bert_refuses_ctx_as_jax_does():
    from mxnet_tpu.gluon.model_zoo.bert import get_bert as jget
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert as tget
    cfg = dict(num_layers=1, units=32, hidden_size=64, num_heads=2,
               vocab_size=50)
    for get, ctx in ((jget, mx.cpu()), (tget, tmx.cpu())):
        with pytest.raises(TypeError, match="ctx"):
            get(ctx=ctx, **cfg)
