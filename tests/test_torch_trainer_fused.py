"""The port's grouped trainer update against the JAX package's ``Trainer``.

Both packages train the same parameters from the same numpy weights with
the same gradients: the loss is ``sum_i sum(p_i * c_i)``, so each step's
gradient of ``p_i`` is the constant ``c_i`` exactly (small integers and
halves, exact in bf16 too). ``MXNET_OPTIMIZER_AGGREGATION_SIZE`` at 1, 4
and 64: the JAX package fuses its groups (it keeps master-weight
parameters out of them), the port groups every parameter by its layout,
master weights included, and on CPU tensors runs the eager per-parameter
update for each member. SGD with momentum 0 and 0.9, Adam and AdamW; f32,
and bf16 with ``multi_precision``; clip_gradient, lr / wd multipliers and
an lr schedule; three steps.

Tolerances, as ``tests/test_torch_training.py`` states them: f32 weights
and states rtol 1e-5 (XLA's fused update against eager torch: rounding
order only); bf16 weights within one bf16 rounding (rtol 8e-3), their f32
masters and the states rtol 1e-5. The group plan is tested as a pure
function, and grouped and per-parameter updates on the CPU give the same
bits.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd, lr_scheduler, optimizer
from mxnet_tpu_torch.gluon import Block, Parameter, Trainer
from mxnet_tpu_torch.gluon.trainer import group_plan
from mxnet_tpu_torch.ops.cuda import multi_tensor as mt

F32 = dict(rtol=1e-5, atol=1e-7)
SHAPES = [(6, 3), (5,), (4, 2, 3), (7,), (3, 3), (2,), (9,)]
MULTS = [(1.0, 1.0), (0.5, 0.0), (2.0, 1.0), (1.0, 0.5), (1.0, 1.0),
         (0.25, 2.0), (1.0, 1.0)]
OPTS = {
    "sgd": ("sgd", dict(learning_rate=0.1, wd=0.01)),
    "sgd_momentum": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01)),
    "adam": ("adam", dict(learning_rate=0.01, wd=0.01)),
    "adamw": ("adamw", dict(learning_rate=0.01, wd=0.05, beta1=0.8)),
}


def _consts(seed):
    """Per step and parameter, the gradient: small integers and halves."""
    rng = onp.random.RandomState(seed)
    return [[(rng.randint(-5, 6, s) / 2).astype("float32") for s in SHAPES]
            for _ in range(3)]


def _weights(seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.normal(0, 0.5, s).astype("float32") for s in SHAPES]


class JNet(mx.gluon.Block):
    def __init__(self):
        super().__init__()
        for k, (s, (lm, wm)) in enumerate(zip(SHAPES, MULTS)):
            setattr(self, f"p{k}", mx.gluon.Parameter(
                f"p{k}", shape=s, lr_mult=lm, wd_mult=wm))

    def forward(self, cs):
        return sum((getattr(self, f"p{k}").data() * c).sum()
                   for k, c in enumerate(cs))


class TNet(Block):
    def __init__(self, dtypes=None):
        """``dtypes``: each parameter's (f32 by default)."""
        super().__init__()
        for k, (s, (lm, wm)) in enumerate(zip(SHAPES, MULTS)):
            dt = dtypes[k] if dtypes else "float32"
            setattr(self, f"p{k}", Parameter(f"p{k}", shape=s, dtype=dt,
                                             lr_mult=lm, wd_mult=wm))

    def forward(self, cs):
        return sum((getattr(self, f"p{k}").data() * c).sum()
                   for k, c in enumerate(cs))


def _jax_run(name, kw, bf16, steps):
    jnet = JNet()
    jnet.initialize()
    for k, w in enumerate(_weights()):
        getattr(jnet, f"p{k}").set_data(mx.np.array(w))
    if bf16:
        jnet.cast("bfloat16")
    kw = dict(kw, lr_scheduler=mx.lr_scheduler.FactorScheduler(
        step=2, factor=0.5), clip_gradient=0.3, multi_precision=bf16)
    tr = mx.gluon.Trainer(jnet.collect_params(), name, kw)
    for cs in steps:
        arrs = [mx.np.array(c) for c in cs]
        if bf16:
            arrs = [a.astype("bfloat16") for a in arrs]
        with mx.autograd.record():
            loss = jnet(arrs)
        loss.backward()
        tr.step(4)
    return jnet, tr


def _port_run(name, kw, bf16, steps):
    tnet = TNet()
    tnet.initialize(device="cpu")
    for k, w in enumerate(_weights()):
        getattr(tnet, f"p{k}").set_data(torch.from_numpy(w))
    if bf16:
        tnet.cast("bfloat16")
    kw = dict(kw, lr_scheduler=lr_scheduler.FactorScheduler(
        step=2, factor=0.5), clip_gradient=0.3, multi_precision=bf16)
    tr = Trainer(tnet.collect_params(), name, kw)
    for cs in steps:
        ts = [torch.from_numpy(c) for c in cs]
        if bf16:
            ts = [t.to(torch.bfloat16) for t in ts]
        with autograd.record():
            loss = tnet(ts)
        autograd.backward(loss)
        tr.step(4)
    return tnet, tr


@pytest.mark.parametrize("agg", [1, 4, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_master"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_grouped_trainer_matches_jax(opt, bf16, agg, monkeypatch):
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", str(agg))
    name, kw = OPTS[opt]
    steps = _consts(1)
    jnet, jtr = _jax_run(name, kw, bf16, steps)
    tnet, ttr = _port_run(name, kw, bf16, steps)
    assert jtr._optimizer.aggregate_num == ttr.optimizer.aggregate_num == agg
    assert ttr.optimizer.num_update == jtr._optimizer.num_update == 3
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(jp) == list(tp)
    for i, k in enumerate(tp):
        got = tp[k].data().detach().float().numpy()
        want = jp[k].data().astype("float32").asnumpy()
        onp.testing.assert_allclose(got, want, **(dict(rtol=8e-3) if bf16
                                                   else F32), err_msg=k)
        ts, js = ttr._states[i], jtr._states[i]
        if bf16:
            assert isinstance(ts, optimizer.MasterWeightState)
            onp.testing.assert_allclose(ts.master.numpy(),
                                        onp.asarray(js.master), **F32)
            ts, js = ts.inner, js.inner
        for a, b in zip(ts, js):
            onp.testing.assert_allclose(a.float().numpy(), onp.asarray(
                b, "float32"), **F32, err_msg=k)


def test_group_plan_one_layout_is_consecutive_chunks():
    assert group_plan(["a"] * 10, 4) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert group_plan(["a"] * 3, 1) == [[0], [1], [2]]
    assert group_plan(["a"] * 3, 64) == [[0, 1, 2]]
    assert group_plan([], 4) == []


def test_group_plan_keeps_layouts_apart_in_order():
    keys = ["m", "f", "m", "m", "f", "m", "m"]
    assert group_plan(keys, 2) == [[0, 2], [1, 4], [3, 5], [6]]
    plan = group_plan(keys, 4)
    assert plan == [[0, 2, 3, 5], [1, 4], [6]]
    assert all(len({keys[k] for k in g}) == 1 for g in plan)


def _spy_groups(monkeypatch):
    """Record the indices of each group the trainer hands the optimizer's
    group update."""
    seen = []
    real = optimizer.Optimizer._update_groups

    def spy(self, groups, hypers):
        seen.append([[e[0] for e in g] for g in groups])
        return real(self, groups, hypers)

    monkeypatch.setattr(optimizer.Optimizer, "_update_groups", spy)
    return seen


def test_master_weight_parameters_group_by_their_master(monkeypatch):
    """bf16 parameters with f32 masters group together (the JAX package
    keeps them out of every group); f32 parameters, whose state has no
    master, form groups of their own; lr / wd multipliers do not split a
    group."""
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "3")
    seen = _spy_groups(monkeypatch)
    dtypes = ["bfloat16", "float32", "bfloat16", "bfloat16", "float32",
              "bfloat16", "float32"]
    tnet = TNet(dtypes)
    tnet.initialize(device="cpu")
    tr = Trainer(tnet.collect_params(), "adamw",
                 dict(OPTS["adamw"][1], multi_precision=True))
    with autograd.record():
        loss = tnet([torch.ones(s, dtype=getattr(torch, d))
                     for s, d in zip(SHAPES, dtypes)])
    autograd.backward(loss)
    tr.step(4)
    assert seen[-1] == [[0, 2, 3], [1, 4, 6], [5]]
    masters = [isinstance(tr._states[i], optimizer.MasterWeightState)
               for i in range(len(SHAPES))]
    assert masters == [d == "bfloat16" for d in dtypes]


def test_an_optimizer_overriding_update_is_not_grouped(monkeypatch):
    class Own(optimizer.SGD):
        def update(self, index, weight, grad, state):
            return super().update(index, weight, grad, state)

    seen = _spy_groups(monkeypatch)
    tnet = TNet()
    tnet.initialize(device="cpu")
    tr = Trainer(tnet.collect_params(), Own(learning_rate=0.1))
    assert not tr._fused_optimizer_ok()
    with autograd.record():
        loss = tnet([torch.ones(s) for s in SHAPES])
    autograd.backward(loss)
    tr.step(1)
    # each parameter alone, through update_multi_precision
    assert seen == [[[i]] for i in range(len(SHAPES))]


def test_an_optimizer_with_its_own_step_is_not_grouped(monkeypatch):
    """A ``_step`` the kernel does not implement: no kernel operation, so
    the trainer updates each parameter alone, through that ``_step``."""
    class Halved(optimizer.SGD):
        @staticmethod
        def _step(w, g, states, lr, wd, t, hp):
            w.sub_(0.5 * lr * g)
            return states

    seen = _spy_groups(monkeypatch)
    tnet = TNet()
    tnet.initialize(device="cpu")
    before = [p.data().clone() for p in tnet.collect_params().values()]
    tr = Trainer(tnet.collect_params(), Halved(learning_rate=0.1))
    assert tr.optimizer._kernel_op() is None
    assert not tr._fused_optimizer_ok()
    with autograd.record():
        loss = tnet([torch.ones(s) for s in SHAPES])
    autograd.backward(loss)
    grads = [p.grad().clone() for p in tnet.collect_params().values()]
    tr.step(1)
    assert seen == [[[i]] for i in range(len(SHAPES))]
    for b, g, p, (lm, _) in zip(before, grads,
                                tnet.collect_params().values(), MULTS):
        torch.testing.assert_close(p.data(), b - 0.05 * lm * g, **F32)


@pytest.mark.parametrize("opt,kw,op", [
    ("sgd", {}, mt.SGD), ("sgd", {"momentum": 0.9}, mt.SGD_MOM),
    ("adam", {}, mt.ADAM), ("adamw", {}, mt.ADAMW)])
def test_optimizer_picks_the_kernel_operation(opt, kw, op):
    o = optimizer.create(opt, **kw)
    assert o._kernel_op() == op
    sub = type("Sub", (type(o),), {"_step": staticmethod(
        lambda w, g, states, lr, wd, t, hp: states)})
    assert sub(**kw)._kernel_op() is None


def test_kernel_numbers_are_rounded_as_the_plain_update_rounds_them():
    """The optimizer hands the kernel numbers only: the group's scalars
    and each tensor's (lr, wd, a, b), rounded on the host as PyTorch
    rounds the plain version's Python scalars."""
    f32 = onp.float32
    o = optimizer.create("adamw", learning_rate=1e-3, wd=0.01, beta1=0.8,
                         clip_gradient=0.3)
    o.rescale_grad = 1 / 3
    hp = o._hyper(0)
    sc = o._kernel_scalars(hp, torch.bfloat16)
    assert sc[0] == float(f32(1 / 3)) and sc[3] == 1
    assert sc[2] == float(torch.tensor(0.3).bfloat16().float()) == -sc[1]
    assert sc[4:] == tuple(float(f32(x)) for x in (0.8, 1 - 0.8, 0.999,
                                                   1 - 0.999, 1e-8))
    lr, wd, a, b = o._kernel_hypers(1e-3, 0.01, 2.0, hp)
    assert a == float(f32(1) / f32(1 - f32(0.8 ** 2)))
    assert b == float(f32(1) / f32(1 - f32(0.999 ** 2)))
    s = optimizer.create("sgd", momentum=0.9)
    assert s._kernel_scalars(s._hyper(0), torch.float32) == (
        1.0, 0.0, 0.0, 0, float(f32(0.9)), 0.0, 0.0, 0.0, 0.0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_master"])
@pytest.mark.parametrize("opt", list(OPTS))
def test_grouped_and_per_parameter_updates_give_the_same_bits(opt, bf16,
                                                               monkeypatch):
    name, kw = OPTS[opt]
    runs = []
    for agg in ("4", "1"):
        monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", agg)
        runs.append(_port_run(name, kw, bf16, _consts(3)))
    (a, ta), (b, tb) = runs
    for (k, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        assert torch.equal(p.data(), q.data()), k
    for i in ta._states:
        sa, sb = ta._states[i], tb._states[i]
        if bf16:
            assert torch.equal(sa.master, sb.master)
            sa, sb = sa.inner, sb.inner
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_aggregate_num_reads_the_environment(monkeypatch):
    monkeypatch.delenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", raising=False)
    assert optimizer.Optimizer().aggregate_num == 4
    assert mx.optimizer.Optimizer().aggregate_num == 4
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "9")
    assert optimizer.SGD().aggregate_num == 9
    assert optimizer.create("adamw").aggregate_num == 9


def test_group_update_on_cpu_is_the_plain_update():
    """update_group on CPU tensors runs _plain_update for each member, with
    the counts taken in order."""
    rng = onp.random.RandomState(4)
    ws = [torch.from_numpy(rng.normal(0, 1, s).astype("float32"))
          for s in SHAPES]
    gs = [torch.from_numpy(rng.normal(0, 1, s).astype("float32"))
          for s in SHAPES]
    o1, o2 = (optimizer.create("adam", learning_rate=0.01, wd=0.01)
              for _ in range(2))
    w1, w2 = [w.clone() for w in ws], [w.clone() for w in ws]
    s1 = [o1.create_state(i, w) for i, w in enumerate(w1)]
    s2 = [o2.create_state(i, w) for i, w in enumerate(w2)]
    o1.update_group([(i, w1[i], gs[i], s1[i]) for i in range(len(ws))])
    for i in range(len(ws)):
        lr, wd, t = o2._next_hypers(i)
        o2._plain_update(i, w2[i], gs[i], s2[i], lr, wd, t)
    assert o1._index_update_count == o2._index_update_count
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
