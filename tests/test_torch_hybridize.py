"""``HybridBlock.hybridize()`` and ``ServedModel.from_block`` on the CPU,
against the JAX package.

CUDA graphs are captured only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``): here a hybridized block runs CPU tensors eagerly, the
port's plain path, so these tests hold the bookkeeping around the graphs:
the flags, what clears the cache, ``_last_sig``, the signature
``from_block`` takes from it (as the JAX package's), and a small BERT's
three AdamW steps with the net hybridized and the trainer grouping by 4,
held to the JAX package at ``tests/test_torch_training.py``'s tolerances
(per-step losses rel 1e-5, weights relative Frobenius 1e-4).
"""
import importlib

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon import HybridBlock, Trainer, nn
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.block import Block
from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert
from mxnet_tpu_torch.serving import ServedModel

# the module itself: mx.random (and the package's ``random``) is the
# namespace of ndarray/random.py
port_random = importlib.import_module("mxnet_tpu_torch.random")

BERT_CFG = dict(vocab_size=512, num_layers=2, units=64, hidden_size=128,
                num_heads=4, max_length=64, dropout=0.0, use_pooler=False,
                use_classifier=False)


class Twice(HybridBlock):
    def forward(self, x):
        return x * 2


class JTwice(mx.gluon.HybridBlock):
    def forward(self, x):
        return x * 2


def _dense():
    net = nn.HybridSequential()
    net.add(nn.Dense(5, in_units=4), nn.Dense(3, in_units=5))
    net.initialize(device="cpu")
    return net


def test_hybridize_flags_and_clearing():
    net = _dense()
    child = net[0] if hasattr(net, "__getitem__") else \
        list(net.children())[0]
    assert not net._active
    net.hybridize(static_alloc=True, static_shape=True, inline_limit=2)
    assert net._active and not child._active
    assert net._flags == dict(static_alloc=True, static_shape=True,
                              inline_limit=2)
    # the cache's bookkeeping: a warmed signature and a child's entry
    net._cached_graph["sig"] = True
    child._cached_graph["sig"] = True
    net.hybridize()
    assert net._cached_graph == {} and child._cached_graph == {}
    net._cached_graph["sig"] = True
    net.hybridize(False)
    assert not net._active and net._cached_graph == {}


def test_block_hybridize_reaches_hybrid_children():
    class Plain(Block):
        def __init__(self):
            super().__init__()
            self.inner = Twice()

        def forward(self, x):
            return self.inner(x)

    net = Plain()
    net.hybridize()
    assert net.inner._active
    net.hybridize(False)
    assert not net.inner._active


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "uint8",
                                   "bool"])
def test_last_sig_and_from_block_match_jax(dtype):
    x = onp.ones((3, 4), dtype)
    jnet = JTwice()
    jnet.hybridize()
    jnet(mx.np.array(x))
    net = Twice()
    net.hybridize()
    assert net._last_sig is None
    net(torch.from_numpy(x))
    assert net._last_sig == jnet._last_sig
    want = mx.serving.ServedModel.from_block(jnet).input_signature
    model = ServedModel.from_block(net, device="cpu")
    assert model.input_signature == want == [((4,), onp.dtype(dtype))]


def test_from_block_hybridizes_and_needs_a_call_or_a_signature():
    from mxnet_tpu_torch.base import MXNetError
    net = Twice()
    with pytest.raises(MXNetError, match="run the block once"):
        ServedModel.from_block(net, device="cpu")
    assert net._active
    model = ServedModel.from_block(Twice(), [((4,), "float32")],
                                   device="cpu")
    out = model.predict([onp.ones((2, 4), "float32")])
    onp.testing.assert_array_equal(out[0], onp.full((2, 4), 2, "float32"))


def test_warmup_runs_each_bucket_twice():
    """A hybridized block's bucket is ready after two calls (its warm-up,
    then its capture), and so is each hybridized child of a plain block:
    warmup makes both, whatever the block."""
    from mxnet_tpu_torch.serving import BucketPolicy
    calls = []
    model = ServedModel(lambda arrays: calls.append(arrays[0].shape) or [],
                        [((4,), onp.float32)], None, "f")
    assert model.warmup(BucketPolicy(batch_buckets=(1, 2))) == 2
    assert calls == [(1, 4), (1, 4), (2, 4), (2, 4)]


def test_hybridized_block_on_cpu_equals_eager():
    params = {k: onp.random.RandomState(0).normal(0, 0.05, p.shape)
              .astype("float32") for k, p in get_bert(
                  "bert_12_768_12", device="cpu", **BERT_CFG)
              .collect_params().items()}
    tok = torch.from_numpy(onp.random.RandomState(1).randint(0, 512, (2, 32)))
    vl = torch.tensor([32, 20])
    outs = []
    for hybrid in (False, True):
        net = load_jax_params(get_bert("bert_12_768_12", device="cpu",
                                       **BERT_CFG), params)
        net.hybridize(hybrid)
        with torch.no_grad():
            outs.append(net(tok, None, vl))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_seed_and_replaced_parameters_drop_the_graphs():
    """Captures need the card; the cache's bookkeeping does not: a seed or
    a parameter replaced by another tensor changes the fingerprint the
    graphs were captured against, and the next check drops them."""
    net = _dense()
    net.hybridize()
    net._check_cache()
    net._cached_graph["sig"] = True
    net._check_cache()
    assert net._cached_graph == {"sig": True}      # nothing changed
    try:
        port_random.seed(3)
        net._check_cache()
        assert net._cached_graph == {}
    finally:
        port_random.seed(0)
    net._cached_graph["sig"] = True
    net.cast("float16")                            # new parameter tensors
    net._check_cache()
    assert net._cached_graph == {}
    net._cached_graph["sig"] = True
    with torch.no_grad():                          # in place: graphs stay
        for p in net.collect_params().values():
            p.data().mul_(2)
    net._check_cache()
    assert net._cached_graph == {"sig": True}


def test_freezing_or_unfreezing_a_parameter_drops_the_graphs():
    """A backward graph computes the gradients of the parameters that took
    one at capture: a grad_req changed to or from 'null' drops the
    graphs; 'write' to 'add' keeps them (the graphs return fresh
    gradients, and autograd accumulates them)."""
    net = _dense()
    net.hybridize()
    p = next(iter(net.collect_params().values()))
    net._check_cache()
    net._cached_graph["sig"] = True
    p.grad_req = "add"
    net._check_cache()
    assert net._cached_graph == {"sig": True}
    for req in ("null", "write"):
        p.grad_req = req
        net._check_cache()
        assert net._cached_graph == {}
        net._cached_graph["sig"] = True


@pytest.mark.parametrize("rows", [2, 50, 5000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 4e-3)])
def test_embedding_backward_sums_every_row_once(dtype, tol, rows):
    """The card's embedding (``ops/nn.py:_Embedding``, whose backward a
    graph can capture) gives ``F.embedding``'s rows, and a gradient of the
    table summed in f32 and rounded once, by chunks (2 and 50 rows) or by
    one accumulator (5000 rows > 4200 indices): relative Frobenius against
    a float64 sum, f32 1e-6 (sum order only), bf16 4e-3 (one rounding)."""
    from mxnet_tpu_torch.ops.nn import _Embedding
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(rows, 8, generator=gen).to(dtype).requires_grad_()
    idx = torch.randint(0, rows, (6, 700), generator=gen)   # > 3072
    dout = torch.randn(6, 700, 8, generator=gen).to(dtype)
    out = _Embedding.apply(idx, w)
    assert torch.equal(out, torch.nn.functional.embedding(idx, w))
    got = torch.autograd.grad(out, w, dout)[0]
    want = torch.zeros(rows, 8, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), dout.reshape(-1, 8).double())
    assert got.dtype == dtype
    assert float((got.double() - want).norm() / want.norm()) <= tol


def test_batch_norm_graph_readiness_follows_its_centered_step():
    bn = nn.BatchNorm(in_channels=3)
    bn.initialize(device="cpu")
    assert bn._graph_ready()                       # predict mode
    with autograd.train_mode():
        assert not bn._graph_ready()               # the centered step ahead
        bn(torch.randn(4, 3, 5, 5))
        assert bn._graph_ready()
    bn.stat_shift.data().zero_()                   # as a load leaves it
    with autograd.train_mode():
        assert not bn._graph_ready()


def _mlm_batch(seed, B=2, T=32, P=5, vocab=512):
    rng = onp.random.RandomState(seed)
    tok = rng.randint(0, vocab, (B, T)).astype("int32")
    typ = rng.randint(0, 2, (B, T)).astype("int32")
    vl = onp.array([T, 20], "int32")
    pos = rng.randint(0, 20, (B, P)).astype("int32")
    lab = rng.randint(0, vocab, (B, P)).astype("int32")
    return tok, typ, vl, pos, lab


def test_small_bert_hybridized_three_adamw_steps_match_jax(monkeypatch):
    """tests/test_torch_training.py's three AdamW steps, with both nets
    hybridized and the trainers grouping by 4."""
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "4")
    mx.random.seed(0)
    jnet = jax_get_bert("bert_12_768_12", **BERT_CFG)
    jnet.initialize(mx.init.Normal(0.05))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = load_jax_params(get_bert("bert_12_768_12", device="cpu",
                                    **BERT_CFG), params)
    jnet.hybridize()
    tnet.hybridize()
    tok, typ, vl, pos, lab = _mlm_batch(0)
    B = tok.shape[0]
    hp = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(hp))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(hp))
    assert ttr.optimizer.aggregate_num == 4
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = port_loss.SoftmaxCrossEntropyLoss()
    arr = mx.np.array
    tin = [torch.from_numpy(x).long() for x in (tok, typ, vl, pos, lab)]
    for step in range(3):
        with mx.autograd.record():
            jl = jloss_fn(jnet(arr(tok), arr(typ), arr(vl), arr(pos))[-1],
                          arr(lab))
        jl.backward()
        jtr.step(B)
        with autograd.record():
            tl = tloss_fn(tnet(*tin[:4])[-1], tin[4])
        autograd.backward(tl)
        ttr.step(B)
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    rtol=1e-5, err_msg=f"step {step}")
    i64 = onp.dtype("int64")
    assert tnet._last_sig == [((B, 32), i64), ((B, 32), i64), ((B,), i64),
                              ((B, 5), i64)]
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tp = export_params(tnet)
    worst = max((float(onp.linalg.norm(tp[k] - jp[k])
                       / max(onp.linalg.norm(jp[k]), 1e-30)), k) for k in jp)
    assert worst[0] <= 1e-4, worst
