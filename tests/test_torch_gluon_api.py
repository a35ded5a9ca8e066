"""MXNet's Gluon surface in the port against the JAX package: the same
calls through both packages on numpy-made inputs.

``Block.initialize`` with MXNet's arguments (``init``, ``ctx``,
``verbose``, ``force_reinit``), ``collect_params(select)`` and the
``ParameterDict`` batch operations, the ``Parameter`` accessors
(``data``, ``grad``, ``set_data``, ``list_data``, ``list_ctx``, ``name``)
and ``Trainer``'s ``compression_params``.

Tolerances: values copied between the packages compare exactly; one
AdamW step in f32 compares at rtol=1e-5, atol=1e-7 (XLA's fused update
against eager torch: rounding order only), as in
``tests/test_torch_training.py``; gradients of a Dense layer at the same
rtol.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import Trainer, nn
from mxnet_tpu_torch.gluon.block import ParameterDict

F32 = dict(rtol=1e-5, atol=1e-7)


def _pair(seed=0):
    """The same two-layer net in both packages, weights from numpy."""
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(5, in_units=4, activation="relu"),
             mx.gluon.nn.Dense(3, in_units=5))
    jnet.initialize()
    rng = onp.random.RandomState(seed)
    params = {k: rng.normal(0, 0.5, p.shape).astype("float32")
              for k, p in jnet.collect_params().items()}
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(params[k]))
    tnet = nn.HybridSequential()
    tnet.add(nn.Dense(5, in_units=4, activation="relu"),
             nn.Dense(3, in_units=5))
    load_jax_params(tnet, params)
    return jnet, tnet, params


def _backward(jnet, tnet, x):
    with mx.autograd.record():
        jl = (jnet(mx.np.array(x)) ** 2).sum()
    jl.backward()
    with autograd.record():
        tl = (tnet(torch.from_numpy(x)) ** 2).sum()
    autograd.backward(tl)


@pytest.mark.parametrize("how", ["no arguments in a cpu scope", "ctx=cpu()",
                                 "ctx=[cpu()]", "device='cpu'"])
def test_initialize_takes_mxnet_arguments(how):
    """Both packages fill every parameter with the same shapes, the
    default Uniform(0.07) for weights and each layer's own initializer
    (zeros) for biases; the port on the device asked for."""
    jnet = mx.gluon.nn.Dense(6, in_units=5)
    jnet.initialize()
    net = nn.Dense(6, in_units=5)
    if how == "no arguments in a cpu scope":
        with cpu():
            assert net.initialize() is net
    elif how == "ctx=cpu()":
        net.initialize(ctx=cpu())
    elif how == "ctx=[cpu()]":
        net.initialize(None, [cpu()], False, False)
    else:
        net.initialize(device="cpu")
    jp, tp = jnet.collect_params(), net.collect_params()
    assert list(jp) == list(tp) == ["weight", "bias"]
    for k in jp:
        assert tp[k].shape == tuple(jp[k].shape)
        assert tp[k].initialized and tp[k].data().device.type == "cpu"
        assert tp[k].list_ctx() == [cpu()]
    for p in (jp["weight"].data().asnumpy(),
              tp["weight"].data().detach().numpy()):
        assert 0 < onp.abs(p).max() <= 0.07
    assert not tp["bias"].data().any() and \
        not jp["bias"].data().asnumpy().any()


def test_initialize_draws_from_the_framework_stream():
    """Without a generator, initialize() draws from the framework
    generator of the device: mx.random.seed(n) repeats the weights,
    another seed moves them; force_reinit redraws, a second call without
    it keeps the weights."""
    def draw(seed):
        tmx.random.seed(seed)
        net = nn.Dense(6, in_units=5)
        net.initialize(ctx=cpu())
        return net

    a, b, c = draw(3), draw(3), draw(4)
    wa = a.weight.data().clone()
    assert torch.equal(wa, b.weight.data())
    assert not torch.equal(wa, c.weight.data())
    a.initialize(ctx=cpu())
    assert torch.equal(a.weight.data(), wa)
    a.initialize(ctx=cpu(), force_reinit=True)
    assert not torch.equal(a.weight.data(), wa)


def test_initialize_without_ctx_means_the_card():
    """The current context is gpu(0): on a machine without CUDA,
    initialize() with no arguments raises rather than falling back to the
    CPU; ctx and device together raise."""
    net = nn.Dense(2, in_units=2)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            net.initialize()
    with pytest.raises(MXNetError, match="ctx or device"):
        net.initialize(ctx=cpu(), device="cpu")


@pytest.mark.parametrize("select,names", [
    (None, ["0.weight", "0.bias", "1.weight", "1.bias"]),
    (".*weight", ["0.weight", "1.weight"]),
    ("1\\.", ["1.weight", "1.bias"]),
    ("bias", []),
])
def test_collect_params_select_matches_jax(select, names):
    jnet, tnet, _ = _pair()
    got = tnet.collect_params(select)
    assert isinstance(got, ParameterDict)
    assert list(got) == list(jnet.collect_params(select)) == names


def test_setattr_lr_mult_then_a_trainer_step_matches_jax():
    """collect_params('.*weight').setattr('lr_mult', 0) freezes the
    weights through one AdamW step in both packages; the biases move, and
    equally."""
    jnet, tnet, params = _pair(1)
    for net in (jnet, tnet):
        net.collect_params(".*weight").setattr("lr_mult", 0.0)
    assert all(p.lr_mult == 0.0 for p in
               tnet.collect_params(".*weight").values())
    hp = {"learning_rate": 0.1, "wd": 0.01}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(hp))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(hp))
    x = onp.random.RandomState(2).normal(0, 1, (6, 4)).astype("float32")
    _backward(jnet, tnet, x)
    jtr.step(6)
    ttr.step(6)
    for k, p in tnet.collect_params().items():
        got = p.data().detach().numpy()
        onp.testing.assert_allclose(
            got, jnet.collect_params()[k].data().asnumpy(), **F32)
        if k.endswith("weight"):
            assert onp.array_equal(got, params[k])
        else:
            assert not onp.array_equal(got, params[k])


def test_parameter_accessors_match_jax():
    jnet, tnet, params = _pair(3)
    jp, tp = jnet.collect_params(), tnet.collect_params()
    x = onp.random.RandomState(4).normal(0, 1, (3, 4)).astype("float32")
    for k in tp:
        # before any backward: a zero gradient buffer in both
        assert not tp[k].grad().any()
        assert not jp[k].grad().asnumpy().any()
    _backward(jnet, tnet, x)
    for k in tp:
        p, q = tp[k], jp[k]
        assert p.name == q.name == k.split(".")[-1]
        assert p.data() is p.list_data()[0] and p.data() is p._var
        onp.testing.assert_array_equal(p.data().detach().numpy(),
                                       q.data().asnumpy())
        onp.testing.assert_allclose(p.grad().numpy(), q.grad().asnumpy(),
                                    **F32)
        assert torch.equal(p.list_grad()[0], p.grad())
        assert p.list_ctx() == [cpu()]
        assert p.data(cpu()) is p.data()
    # set_data keeps the tensor (and so the registration) and the grad_req
    w = tp["0.weight"]
    var = w.data()
    new = onp.full(w.shape, 0.25, "float32")
    w.set_data(torch.from_numpy(new))
    jp["0.weight"].set_data(mx.np.array(new))
    assert w.data() is var and dict(tnet.named_parameters())[
        "0.weight"] is var
    onp.testing.assert_array_equal(w.data().detach().numpy(),
                                   jp["0.weight"].data().asnumpy())
    with pytest.raises(MXNetError, match="shape"):
        w.set_data(torch.zeros(2, 2))
    w.grad_req = "null"
    with pytest.raises(MXNetError, match="null"):
        w.grad()


def test_to_and_cast_keep_parameters_bound():
    """.to() and cast() leave each Parameter bound to the live tensor:
    what the module computes with is what the accessors return."""
    _, tnet, _ = _pair()
    tnet.cast("float64")
    for k, p in tnet.collect_params().items():
        assert p.dtype == torch.float64
        assert dict(tnet.named_parameters())[k] is p.data()
    x = torch.ones(2, 4, dtype=torch.float64)
    with autograd.record():
        autograd.backward(tnet(x).sum())
    assert tnet[1].bias.grad().dtype == torch.float64
    assert torch.equal(tnet[1].bias.grad(), torch.full((3,), 2.0,
                                                       dtype=torch.float64))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parameter_dict_save_load_round_trip(tmp_path, writer):
    """ParameterDict.save by either package, load by both: the values come
    back bit for bit, and a missing name raises unless allowed."""
    jnet, tnet, params = _pair(5)
    path = str(tmp_path / "net.params")
    (tnet if writer == "port" else jnet).collect_params().save(path)
    jnet2, tnet2, _ = _pair(6)
    tnet2.collect_params().load(path)
    jnet2.collect_params().load(path)
    for k, v in params.items():
        onp.testing.assert_array_equal(
            tnet2.collect_params()[k].data().detach().numpy(), v)
        onp.testing.assert_array_equal(
            jnet2.collect_params()[k].data().asnumpy(), v)
    tnet.collect_params(".*weight").save(path)
    with pytest.raises(MXNetError, match="missing"):
        tnet2.collect_params().load(path)
    tnet2.collect_params().load(path, allow_missing=True)
    with pytest.raises(MXNetError, match="extra"):
        tnet2.collect_params("0\\.").load(path, allow_missing=True)
    tnet2.collect_params().zero_grad()
    tnet2.collect_params().reset_ctx(cpu())


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_trainer_takes_compression_params_none(how):
    """compression_params is the fifth parameter in both packages; None
    (or an empty dict) is accepted, a request for compression raises."""
    jnet, tnet, _ = _pair()
    for pkg, net in ((mx.gluon, jnet), (tmx.gluon, tnet)):
        args = (net.collect_params(), "sgd", {"learning_rate": 0.1})
        if how == "positional":
            tr = pkg.Trainer(*args, "device", None, None)
        else:
            tr = pkg.Trainer(*args, compression_params=None)
        assert tr.learning_rate == 0.1
    Trainer(tnet.collect_params(), "sgd", compression_params={})
    with pytest.raises(MXNetError, match="Queue A 13"):
        Trainer(tnet.collect_params(), "sgd",
                compression_params={"type": "2bit", "threshold": 0.5})
