"""The port's training path on CPU tensors against the JAX package.

``autograd.record`` -> BERT with the MLM head -> ``SoftmaxCrossEntropyLoss``
-> ``autograd.backward`` -> ``Trainer.step`` -> ``AdamW``, and the pieces on
their own (losses, optimizers, learning-rate schedules), on numpy-made
inputs given to both packages.

Tolerances:
- a small BERT (2 layers, units 64, 4 heads, vocab 512, T=32, B=2, dropout
  0, f32), three AdamW steps: per-step losses rel 1e-5; every weight after
  step 3 within relative Frobenius error 1e-4 (Adam's first step turns the
  sign of near-zero gradients into +-lr, so element-wise bounds are the
  wrong test);
- losses and optimizer updates in f32: rtol=1e-5, atol=1e-7 (XLA's fused
  update vs eager torch: rounding order only); bf16 weights of a
  multi-precision update: within one bf16 rounding (rtol=8e-3) of the JAX
  package's, and their f32 masters rtol=1e-5.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
from mxnet_tpu_torch import autograd, lr_scheduler, optimizer
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon import Trainer, loss as port_loss, nn
from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert

F32 = dict(rtol=1e-5, atol=1e-7)
BERT_CFG = dict(vocab_size=512, num_layers=2, units=64, hidden_size=128,
                num_heads=4, max_length=64, dropout=0.0, use_pooler=False,
                use_classifier=False)


def _rel(a, b):
    return float(onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30))


def _mlm_batch(seed, B=2, T=32, P=5, vocab=512):
    rng = onp.random.RandomState(seed)
    tok = rng.randint(0, vocab, (B, T)).astype("int32")
    typ = rng.randint(0, 2, (B, T)).astype("int32")
    vl = onp.array([T, 20], "int32")
    pos = rng.randint(0, 20, (B, P)).astype("int32")
    lab = rng.randint(0, vocab, (B, P)).astype("int32")
    return tok, typ, vl, pos, lab


def test_small_bert_three_adamw_steps_match_jax():
    mx.random.seed(0)
    jnet = jax_get_bert("bert_12_768_12", **BERT_CFG)
    jnet.initialize(mx.init.Normal(0.05))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = load_jax_params(get_bert("bert_12_768_12", device="cpu",
                                    **BERT_CFG), params)
    tok, typ, vl, pos, lab = _mlm_batch(0)
    B = tok.shape[0]
    hp = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(hp))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(hp))
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
        assert tl.shape == (B,)
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    rtol=1e-5, err_msg=f"step {step}")
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tp = export_params(tnet)
    assert sorted(jp) == sorted(tp)
    worst = max((_rel(tp[k], jp[k]), k) for k in jp)
    assert worst[0] <= 1e-4, worst
    # the weights moved: three steps are not a no-op
    assert max(_rel(tp[k], params[k]) for k in jp) > 1e-3


@pytest.mark.parametrize("kw", [
    dict(), dict(weight=0.5), dict(sample_weight=True),
    dict(sparse_label=False), dict(from_logits=True), dict(axis=1)])
def test_softmax_ce_loss_matches_jax(kw):
    kw = dict(kw)
    rng = onp.random.RandomState(3)
    pred = rng.normal(0, 2, (4, 7, 5)).astype("float32")
    axis = kw.get("axis", -1)
    n = pred.shape[axis]
    if kw.get("sparse_label", True):
        shape = list(pred.shape)
        del shape[axis]
        label = rng.randint(0, n, shape).astype("int32")
    else:
        label = rng.dirichlet(onp.ones(n), (4, 7)).astype("float32")
    sw = rng.uniform(0, 1, (4, 7)).astype("float32") \
        if kw.pop("sample_weight", False) else None
    if kw.get("from_logits"):
        pred = onp.log(onp.exp(pred) / onp.exp(pred).sum(-1, keepdims=True))
    want = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        mx.np.array(pred), mx.np.array(label),
        None if sw is None else mx.np.array(sw)).asnumpy()
    got = port_loss.SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label),
        None if sw is None else torch.from_numpy(sw))
    assert tuple(got.shape) == want.shape == (4,)
    onp.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("weight,batch_axis", [(1.0, 0), (2.0, 0), (1.0, 1)])
def test_l2_loss_matches_jax(weight, batch_axis):
    rng = onp.random.RandomState(4)
    pred = rng.normal(0, 1, (3, 6, 2)).astype("float32")
    label = rng.normal(0, 1, (3, 12)).astype("float32")
    want = mx.gluon.loss.L2Loss(weight, batch_axis)(
        mx.np.array(pred), mx.np.array(label)).asnumpy()
    got = port_loss.L2Loss(weight, batch_axis)(torch.from_numpy(pred),
                                               torch.from_numpy(label))
    onp.testing.assert_allclose(got.numpy(), want, **F32)


OPT_CASES = [
    ("sgd", dict(learning_rate=0.1, wd=0.01)),
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01, clip_gradient=0.5,
                 rescale_grad=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.01)),
    ("adamw", dict(learning_rate=0.01, wd=0.01, clip_gradient=1.0,
                   rescale_grad=0.25, beta1=0.8)),
]


@pytest.mark.parametrize("name,kw", OPT_CASES)
def test_optimizer_updates_match_jax(name, kw):
    """Five updates of two parameters, one with lr/wd multipliers."""
    rng = onp.random.RandomState(5)
    w0 = [rng.normal(0, 1, (6, 3)).astype("float32") for _ in range(2)]
    grads = [[rng.normal(0, 2, (6, 3)).astype("float32") for _ in range(2)]
             for _ in range(5)]
    jo, to = mx.optimizer.create(name, **kw), optimizer.create(name, **kw)
    for o in (jo, to):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({1: 0.0})
    jw = [mx.np.array(w) for w in w0]
    tw = [torch.from_numpy(w.copy()) for w in w0]
    js = [jo.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ts = [to.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for g in grads:
        for i in range(2):
            js[i] = jo.update_multi_precision(i, jw[i], mx.np.array(g[i]),
                                              js[i])
            ts[i] = to.update_multi_precision(i, tw[i], torch.from_numpy(g[i]),
                                              ts[i])
    assert to.num_update == jo.num_update == 5
    for i in range(2):
        onp.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(), **F32)


def test_adamw_multi_precision_bf16_matches_jax():
    rng = onp.random.RandomState(6)
    w0 = rng.normal(0, 1, (8, 4)).astype("float32")
    kw = dict(learning_rate=0.01, wd=0.1, multi_precision=True)
    jo, to = mx.optimizer.create("adamw", **kw), optimizer.create("adamw", **kw)
    jw = mx.np.array(w0).astype("bfloat16")
    tw = torch.from_numpy(w0).to(torch.bfloat16)
    js, ts = jo.create_state_multi_precision(0, jw), \
        to.create_state_multi_precision(0, tw)
    assert isinstance(ts, optimizer.MasterWeightState)
    for _ in range(4):
        g = rng.normal(0, 1, w0.shape).astype("float32")
        js = jo.update_multi_precision(
            0, jw, mx.np.array(g).astype("bfloat16"), js)
        ts = to.update_multi_precision(0, tw, torch.from_numpy(g).to(
            torch.bfloat16), ts)
    assert tw.dtype == torch.bfloat16 and ts.master.dtype == torch.float32
    onp.testing.assert_allclose(ts.master.numpy(), onp.asarray(js.master),
                                **F32)
    onp.testing.assert_allclose(tw.float().numpy(),
                                jw.astype("float32").asnumpy(), rtol=8e-3)


@pytest.mark.parametrize("cls,kw", [
    ("FactorScheduler", dict(step=7, factor=0.5, warmup_steps=3,
                             warmup_begin_lr=0.001)),
    ("MultiFactorScheduler", dict(step=[5, 12, 30], factor=0.3)),
    ("PolyScheduler", dict(max_update=40, pwr=2, final_lr=0.001,
                           warmup_steps=5)),
    ("CosineScheduler", dict(max_update=40, final_lr=0.0, warmup_steps=4,
                             warmup_mode="constant")),
])
def test_lr_schedulers_match_jax(cls, kw):
    want = getattr(mx.lr_scheduler, cls)(base_lr=0.1, **kw)
    got = getattr(lr_scheduler, cls)(base_lr=0.1, **kw)
    for n in range(0, 50):
        assert got(n) == pytest.approx(want(n), rel=1e-12, abs=1e-15), n
    # an optimizer's learning rate follows its schedule by num_update
    o = optimizer.create("sgd", learning_rate=0.2,
                         lr_scheduler=getattr(lr_scheduler, cls)(**kw))
    jo = mx.optimizer.create("sgd", learning_rate=0.2,
                             lr_scheduler=getattr(mx.lr_scheduler, cls)(**kw))
    for n in (0, 2, 9, 45):
        o.num_update = jo.num_update = n
        assert o.learning_rate == pytest.approx(jo.learning_rate, rel=1e-12)


# ------------------------------------------------- autograd and grad_req
def _dense(units=3, in_units=4, seed=0):
    net = nn.Dense(units, in_units=in_units)
    net.initialize(generator=torch.Generator().manual_seed(seed),
                   device="cpu")
    return net


def test_grad_req_write_add_null():
    net = _dense()
    x = torch.ones(2, 4)
    for _ in range(2):
        with autograd.record():
            y = net(x)
        autograd.backward(y)       # non-scalar head: seeded with ones
    # write: the second backward replaced the first
    torch.testing.assert_close(net.weight.grad(), torch.full((3, 4), 2.0))
    net.weight.grad_req = "add"
    net.weight.zero_grad()
    for _ in range(3):
        with autograd.record():
            autograd.backward(net(x).sum())
    torch.testing.assert_close(net.weight.grad(), torch.full((3, 4), 6.0))
    net.bias.grad_req = "null"
    assert net.bias.data().grad is None and not net.bias.data().requires_grad
    with pytest.raises(MXNetError, match="null"):
        net.bias.list_grad()
    with autograd.record():
        autograd.backward(net(x).sum())
    assert net.bias.data().grad is None
    with pytest.raises(ValueError, match="grad_req"):
        net.bias.grad_req = "sometimes"


def test_record_pause_and_training_flags():
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not autograd.is_recording() and not autograd.is_training()
            assert not torch.is_grad_enabled()
        with autograd.predict_mode():
            assert autograd.is_recording() and not autograd.is_training()
    with autograd.record(train_mode=False):
        assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    assert not autograd.is_recording() and not autograd.is_training()


def test_backward_without_record_raises():
    net = _dense()
    with torch.no_grad():
        y = net(torch.ones(1, 4)).sum()
    with pytest.raises(MXNetError, match="record"):
        autograd.backward(y)


def test_zoo_dropout_follows_record():
    """The BERT zoo's dropout is active under record() only, and repeats
    under the same framework seed."""
    net = get_bert("bert_12_768_12", device="cpu",
                   **dict(BERT_CFG, dropout=0.3))
    net.initialize(generator=torch.Generator().manual_seed(1), device="cpu")
    tok, typ, vl, pos, _ = (torch.from_numpy(x).long()
                            for x in _mlm_batch(2))

    def run():
        return net(tok, typ, vl, pos)[-1].detach()

    plain = run()
    assert torch.equal(plain, run())
    mx_random.seed(3)
    with autograd.record():
        a = run()
    mx_random.seed(3)
    with autograd.record():
        b = run()
    assert torch.equal(a, b) and not torch.allclose(a, plain)


def _trained(steps, seed=0, trainer_states=None):
    net = _dense(seed=seed)
    tr = Trainer(net.collect_params(), "adamw", {"learning_rate": 0.05})
    if trainer_states is not None:
        net.load_state_dict(trainer_states[0])
        tr.load_states(trainer_states[1])
    rng = onp.random.RandomState(7)
    xs = [torch.from_numpy(rng.normal(0, 1, (5, 4)).astype("float32"))
          for _ in range(4)]
    for x in xs[len(xs) - steps:] if trainer_states else xs[:steps]:
        with autograd.record():
            autograd.backward((net(x) ** 2).sum())
        tr.step(5)
    return net, tr


def test_trainer_refuses_a_stale_gradient():
    net, tr = _trained(1)
    with pytest.raises(MXNetError, match="has not been updated"):
        tr.step(5)
    tr.step(5, ignore_stale_grad=True)      # skips, does not raise
    with pytest.raises(MXNetError, match="not ported"):
        Trainer(net.collect_params(), "sgd", kvstore="dist_sync")


def test_trainer_save_load_states_round_trip(tmp_path):
    """Four steps in one go equal two steps, save, restore, two more."""
    full, _ = _trained(4)
    half, tr = _trained(2)
    fname = str(tmp_path / "trainer.states")
    tr.save_states(fname)
    resumed, tr2 = _trained(2, seed=9,
                            trainer_states=(half.state_dict(), fname))
    assert tr2.optimizer.num_update == 4
    for a, b in zip(resumed.parameters(), full.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------- trainer state files across packages
def _mp_pair(seed=0):
    """One bf16 Dense layer in both packages with the same weights, each
    with a multi-precision AdamW trainer (MasterWeightState for both
    parameters)."""
    rng = onp.random.RandomState(seed)
    params = {"weight": rng.normal(0, 0.5, (3, 4)).astype("float32"),
              "bias": rng.normal(0, 0.5, (3,)).astype("float32")}
    jnet = mx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(params[k]))
    jnet.cast("bfloat16")
    tnet = load_jax_params(nn.Dense(3, in_units=4), params,
                           dtype="bfloat16")
    hp = {"learning_rate": 0.01, "wd": 0.1, "multi_precision": True}
    return (jnet, mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(hp)),
            tnet, Trainer(tnet.collect_params(), "adamw", dict(hp)))


# Inputs and output weights of small integers and halves: the gradients
# (r^T x for the weight, the sum of r for the bias) are exact in bf16 in
# both packages, so only the optimizer's arithmetic is compared.
_XS = [onp.random.RandomState(20 + i).randint(-2, 3, (4, 4)).astype("float32")
       for i in range(4)]
_RS = [onp.random.RandomState(30 + i).randint(-2, 3, (4, 3)).astype("float32")
       / 2 for i in range(4)]


def _jax_steps(jnet, jtr, steps):
    for x, r in zip(_XS[steps], _RS[steps]):
        with mx.autograd.record():
            loss = (jnet(mx.np.array(x).astype("bfloat16"))
                    * mx.np.array(r).astype("bfloat16")).sum()
        loss.backward()
        jtr.step(4)


def _port_steps(tnet, ttr, steps):
    for x, r in zip(_XS[steps], _RS[steps]):
        with autograd.record():
            loss = (tnet(torch.from_numpy(x).to(torch.bfloat16))
                    * torch.from_numpy(r).to(torch.bfloat16)).sum()
        autograd.backward(loss)
        ttr.step(4)


def _compare_to_jax(tnet, ttr, jnet, jtr):
    """bf16 weights within one bf16 rounding, f32 masters, Adam moments
    and update counts as this file's multi-precision test holds them."""
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert ttr.optimizer.num_update == jtr._optimizer.num_update
    for i, (k, p) in enumerate(tnet.collect_params().items()):
        q = jnet.collect_params()[k]
        assert p.dtype == torch.bfloat16
        onp.testing.assert_allclose(
            p.data().detach().float().numpy(),
            q.data().astype("float32").asnumpy(), rtol=8e-3)
        ts, js = ttr._states[i], jtr._states[i]
        assert isinstance(ts, optimizer.MasterWeightState)
        onp.testing.assert_allclose(ts.master.numpy(), onp.asarray(js.master),
                                    **F32)
        for a, b in zip(ts.inner, js.inner):
            onp.testing.assert_allclose(a.numpy(), onp.asarray(b), **F32)


def test_trainer_states_saved_by_jax_resume_in_the_port(tmp_path):
    """The JAX package saves after k=2 multi-precision AdamW steps; the
    port loads the weights and the state file and takes N=2 more; the
    result equals the JAX package's own run of 4 steps. State indices
    follow collect_params(), the same in both packages."""
    jnet, jtr, _, _ = _mp_pair()
    _jax_steps(jnet, jtr, slice(0, 2))
    fname = str(tmp_path / "jax.states")
    jtr.save_states(fname)
    saved = {k: p.data().astype("float32").asnumpy()
             for k, p in jnet.collect_params().items()}
    _jax_steps(jnet, jtr, slice(2, 4))
    _, _, tnet, ttr = _mp_pair(seed=1)
    load_jax_params(tnet, saved)
    ttr.load_states(fname)
    assert ttr.optimizer.num_update == 2
    _port_steps(tnet, ttr, slice(2, 4))
    _compare_to_jax(tnet, ttr, jnet, jtr)


def test_trainer_states_saved_by_the_port_resume_in_jax(tmp_path):
    """The reverse: the port saves after 2 steps, the JAX package loads
    and takes 2 more, equal to the port's own run of 4."""
    _, _, tnet, ttr = _mp_pair()
    _port_steps(tnet, ttr, slice(0, 2))
    fname = str(tmp_path / "port.states")
    ttr.save_states(fname)
    saved = {k: p.data().detach().float().numpy()
             for k, p in tnet.collect_params().items()}
    _port_steps(tnet, ttr, slice(2, 4))
    jnet, jtr, _, _ = _mp_pair(seed=1)
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(saved[k]).astype("bfloat16"))
    jtr.load_states(fname)
    assert jtr._optimizer.num_update == 2
    _jax_steps(jnet, jtr, slice(2, 4))
    _compare_to_jax(tnet, ttr, jnet, jtr)


def test_trainer_state_file_refuses_other_classes(tmp_path):
    """Reading admits numpy arrays, builtin containers and
    MasterWeightState; a pickle naming any other class is refused before
    it is built."""
    import collections
    import pickle
    _, _, tnet, ttr = _mp_pair()
    fname = str(tmp_path / "bad.states")
    with open(fname, "wb") as f:
        pickle.dump({"format": 2, "num_update": 1, "index_update_count": {},
                     "states": {0: collections.OrderedDict()}}, f)
    with pytest.raises(MXNetError, match="collections.OrderedDict"):
        ttr.load_states(fname)


def test_trainer_reads_a_format_1_state_file(tmp_path):
    """A format-1 file kept a master-weight state as a plain (master,
    inner) tuple: both packages rewrap it as MasterWeightState."""
    import pickle
    jnet, jtr, tnet, ttr = _mp_pair()
    rng = onp.random.RandomState(8)
    states = {i: (rng.normal(0, 1, s).astype("float32"),
                  (rng.normal(0, 1, s).astype("float32"),
                   rng.uniform(0, 1, s).astype("float32")))
              for i, s in enumerate([(3, 4), (3,)])}
    fname = str(tmp_path / "v1.states")
    with open(fname, "wb") as f:
        pickle.dump({"num_update": 5, "index_update_count": {0: 5, 1: 5},
                     "states": states}, f)
    ttr.load_states(fname)
    jtr.load_states(fname)
    for i in range(2):
        assert isinstance(ttr._states[i], optimizer.MasterWeightState)
        onp.testing.assert_array_equal(ttr._states[i].master.numpy(),
                                       states[i][0])
        onp.testing.assert_array_equal(onp.asarray(jtr._states[i].master),
                                       states[i][0])
    _port_steps(tnet, ttr, slice(0, 1))
    _jax_steps(jnet, jtr, slice(0, 1))
    _compare_to_jax(tnet, ttr, jnet, jtr)
