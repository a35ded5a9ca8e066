"""The port's tracing and fault injection (``mxnet_tpu_torch.tracing``,
``mxnet_tpu_torch.faults``) against the JAX package's on the CPU.

- ``parse_traceparent`` / ``traceparent`` agree on the same headers,
  malformed ones included.
- The same code under both gives the same span tree (names and parent
  links), across nesting, the decorator form, ``child_span``,
  ``record_span``, a thread hand-off through ``capture`` / ``attach``, an
  error, and tail retention of an unsampled trace.
- The same ``MXNET_FAULT_PLAN`` strings parse to the same specs (bad ones
  raise in both), fire at the same call indices over 200 calls, and
  ``maybe_corrupt`` poisons the same index.
- ``Trainer.step``'s ``trainer.step`` site raises ``FaultInjected`` in both,
  and a ``kind=nan`` plan reaches the same gradient and weight element;
  ``invoke``'s ``dispatch.op`` site fires in both.
"""
import threading

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.faults as jf
import mxnet_tpu.tracing as jt
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.faults as tf
import mxnet_tpu_torch.tracing as tt

HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00",
    "  00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-03 ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473g-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-extra",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-1",
    "", None, "garbage",
]


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (jt, tt):
        mod.configure(sample=1.0, buffer_spans=256, slow_ms=100.0)
    yield
    for mod in (jt, tt):
        mod.configure()
    jf.disarm()
    tf.disarm()


@pytest.mark.parametrize("header", HEADERS)
def test_traceparent_parse_and_render_agree(header):
    got = [mod.parse_traceparent(header) for mod in (jt, tt)]
    if got[0] is None:
        assert got[1] is None
        return
    j, t = got
    assert (t.trace_id, t.span_id, t.sampled, t.traceparent) == \
        (j.trace_id, j.span_id, j.sampled, j.traceparent)
    for mod, ctx in ((jt, j), (tt, t)):
        with mod.attach(ctx):
            assert mod.traceparent() == ctx.traceparent
            assert mod.current_trace_id() == ctx.trace_id
        assert mod.traceparent() is None


def test_tracing_off_parses_nothing_and_records_nothing():
    for mod in (jt, tt):
        mod.configure(sample=0.0)
        assert mod.parse_traceparent(HEADERS[0]) is None
        with mod.span("x") as sp:
            assert sp.trace_id is None
        assert mod.spans() == []


def _program(mod):
    """One traced piece of work, the same for both packages."""

    @mod.span("decorated", kind="fn")
    def leaf(x):
        with mod.child_span("inner"):
            return x + 1

    with mod.child_span("orphan"):          # no trace: not recorded
        pass
    with mod.span("root", n=1) as root:
        leaf(1)
        with mod.span("mid"):
            mod.record_span("waited", 0.0, 0.001)
            ctx = mod.capture()
            out = []

            def worker():
                with mod.attach(ctx):
                    with mod.span("in_thread"):
                        out.append(mod.current_trace_id())

            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=10)
        try:
            with mod.span("fails"):
                raise ValueError("boom")
        except ValueError:
            pass
        root.set_attr(done=True)
    assert out == [root.trace_id]
    return root.trace_id


def _tree(mod, trace_id):
    spans = mod.spans(trace_id)
    names = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], names.get(s["parent_id"], ""), s["status"])
            for s in spans]


def test_same_code_same_span_tree():
    trees = [_tree(mod, _program(mod)) for mod in (jt, tt)]
    assert trees[0] == trees[1]
    assert ("in_thread", "mid", "ok") in trees[1]
    assert ("fails", "root", "error") in trees[1]
    assert not any(n == "orphan" for n, _, _ in trees[1])


def test_unsampled_trace_is_kept_only_when_it_fails():
    trees = []
    for mod in (jt, tt):
        mod.configure(sample=1e-12, slow_ms=1e6)
        with mod.span("quiet"):
            with mod.span("child"):
                pass
        assert mod.spans() == []
        with pytest.raises(KeyError):
            with mod.span("loud") as sp:
                with mod.span("ok_child"):
                    pass
                raise KeyError("x")
        trees.append(_tree(mod, sp.trace_id))
    assert trees[0] == trees[1] == [("ok_child", "loud", "ok"),
                                    ("loud", "", "error")]


def test_export_and_open_span_tree_shapes_agree():
    shapes, trees = [], []
    for mod in (jt, tt):
        with mod.span("outer", a=1):
            with mod.span("inner"):
                trees.append([line.split()[0].strip()
                              for line in mod.active_spans_tree()])
        ev = mod.export_trace_events()
        shapes.append((sorted(ev), [(e["name"], e["ph"], sorted(e))
                                    for e in ev["traceEvents"][1:]]))
    assert shapes[0] == shapes[1]
    assert trees[0] == trees[1] == ["outer", "inner"]


# ------------------------------------------------------------------ faults
PLANS = [
    "dispatch.op",
    "dispatch.op:p=0.1",
    "serving.execute:p=0.5:after=10:times=7",
    "serving.worker:p=0.25:seed=7",
    "kvstore.recv:p=0.3:kind=timeout;checkpoint.write:p=0.05:times=2",
    "trainer.step:p=0.02:after=3",
    " dispatch.op : p=0.7 ; ",
]


def _spec(s):
    return (s.site, s.p, s.kind, s.after, s.times, s.delay_ms)


@pytest.mark.parametrize("plan", PLANS)
def test_plans_parse_alike(plan):
    assert [_spec(s) for s in tf.parse_plan(plan)] == \
        [_spec(s) for s in jf.parse_plan(plan)]


@pytest.mark.parametrize("plan", [
    "nowhere.site", "dispatch.op:p=2", "dispatch.op:kind=melt",
    "dispatch.op:p", "dispatch.op:speed=3", "dispatch.op:after=x"])
def test_bad_plans_raise_alike(plan):
    with pytest.raises((mx.MXNetError, ValueError)):
        jf.parse_plan(plan)
    with pytest.raises((tmx.MXNetError, ValueError)):
        tf.parse_plan(plan)


def _fired(mod, plan, calls=200):
    hits = []
    with mod.fault_plan(plan) as fp:
        sites = [s.site for s in fp.specs]
        for i in range(calls):
            for site in sites:
                try:
                    mod.maybe_fault(site, i=i)
                except (mod.FaultInjected, TimeoutError):
                    hits.append((i, site))
    return hits


@pytest.mark.parametrize("plan", PLANS)
def test_plans_fire_at_the_same_calls(plan, monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_SEED", "3")
    want = _fired(jf, plan)
    assert _fired(tf, plan) == want
    assert want or "p=" in plan


def test_disarmed_sites_cost_a_flag():
    assert not tf._ARMED
    tf.maybe_fault("dispatch.op")
    spec = tf.arm("dispatch.op", times=1)
    assert tf._ARMED and tf.armed_sites() == ["dispatch.op"]
    with pytest.raises(tf.FaultInjected, match="dispatch.op"):
        tf.maybe_fault("dispatch.op")
    tf.maybe_fault("dispatch.op")
    assert (spec.hits, spec.injected, tf.injected_count("dispatch.op")) == \
        (2, 1, 1)
    tf.disarm("dispatch.op")
    assert not tf._ARMED
    assert tf.known_sites() == jf.known_sites()


@pytest.mark.parametrize("kinds", [("int32", "float32", "float32"),
                                   ("float32",), ("int64", "float16"),
                                   ("int32",)])
def test_maybe_corrupt_poisons_the_same_index(kinds):
    arrays = [onp.arange(6, dtype=k).reshape(2, 3) + 1 for k in kinds]
    out = []
    for mod, conv in ((jf, lambda a: a), (tf, torch.from_numpy)):
        with mod.fault_plan("trainer.step:kind=nan"):
            try:
                out.append([onp.asarray(x) for x in mod.maybe_corrupt(
                    "trainer.step", [conv(a.copy()) for a in arrays])])
            except (mx.MXNetError, tmx.MXNetError) as e:
                out.append(type(e).__name__)
    if not any(k.startswith("float") for k in kinds):
        assert out == ["MXNetError", "MXNetError"]
        return
    for j, t in zip(*out):
        onp.testing.assert_array_equal(t, j)


def _nets():
    """A Dense in each package with the same weights and one gradient."""
    from mxnet_tpu_torch.convert import load_jax_params
    mx.random.seed(0)
    jnet = mx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize(mx.init.Normal(0.5))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    tnet = load_jax_params(tmx.gluon.nn.Dense(3, in_units=4), params)
    x = onp.random.RandomState(1).randn(2, 4).astype("float32")
    with mx.autograd.record():
        jl = jnet(mx.np.array(x)).sum()
    jl.backward()
    with tmx.autograd.record():
        tl = tnet(torch.from_numpy(x)).sum()
    tmx.autograd.backward(tl)
    return jnet, tnet


def test_trainer_step_site_raises_in_both():
    jnet, tnet = _nets()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with jf.fault_plan("trainer.step:times=1"):
        with pytest.raises(jf.FaultInjected, match="trainer.step"):
            jtr.step(2)
    with tf.fault_plan("trainer.step:times=1"):
        with pytest.raises(tf.FaultInjected, match="trainer.step"):
            ttr.step(2)


def test_nan_plan_reaches_the_gradient_in_both():
    jnet, tnet = _nets()
    jtr = mx.gluon.Trainer(jnet.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    ttr = tmx.gluon.Trainer(tnet.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    grad = tnet.weight.data().grad
    with jf.fault_plan("trainer.step:kind=nan"):
        jtr.step(2)
    with tf.fault_plan("trainer.step:kind=nan"):
        ttr.step(2)
    assert tnet.weight.data().grad is grad       # poisoned in place
    assert onp.isnan(grad[0, 0].item())
    for name in ("weight", "bias"):
        j = jnet.collect_params()[name].data().asnumpy()
        t = tnet.collect_params()[name].data().detach().numpy()
        onp.testing.assert_array_equal(onp.isnan(t), onp.isnan(j))
    assert onp.isnan(t).sum() == 0 and onp.isnan(
        tnet.weight.data().detach().numpy()).sum() == 1


def test_dispatch_site_fires_in_both():
    for mod, pkg in ((jf, mx), (tf, tmx)):
        a = pkg.nd.ones((2, 2), ctx=pkg.cpu())
        with mod.fault_plan("dispatch.op:times=1"):
            with pytest.raises(mod.FaultInjected, match="dispatch.op"):
                a + a
            a + a
