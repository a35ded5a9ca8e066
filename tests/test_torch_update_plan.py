"""The multi-tensor update's launch plan (``ops/cuda/multi_tensor.py``
``launch_plan``), a pure host function, on CPU tensors: one launch a layout
(weight dtype, f32 master or none) whatever the groups, layouts in the
order they first appear, a record a tensor in the groups' order carrying
its group's scalars and its lr / wd / bias terms as f32, chunks that
cover every element of every tensor once (a numpy replay of the kernel's
walk, ``csrc/multi_tensor.cu`` ``update``: its 16-byte vectors where the
record is aligned, scalar accesses for the rest), and the alignment flag
cleared for a view whose address is not 16-byte aligned. The optimizer's
``_update_groups`` hands the plan what ``_plain_update`` would use: the
records' numbers equal the rounded hyperparameters of the JAX package's
order. The kernel itself runs on the card only
(``tests/test_torch_cuda.py -k update``)."""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import optimizer as mo
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.trainer import group_plan
from mxnet_tpu_torch.ops.cuda import multi_tensor as mt


def _param(n, dtype, master, states=1, offset=0):
    """(weight, grad, master or None, states) of n elements; ``offset``
    elements into a larger buffer (a view that may be unaligned)."""
    def buf(dt):
        return torch.zeros(n + offset, dtype=dt)[offset:]
    w = buf(dtype)
    m = buf(torch.float32) if master else None
    return (w, buf(dtype), m,
            tuple(buf(torch.float32) for _ in range(states)))


def _group(params, scalars, lr=0.1):
    hyps = [(lr * (k + 1), 0.01, 0.5, 0.25) for k in range(len(params))]
    return params, hyps, scalars


SC_A = (0.125, -0.2, 0.2, 1, 0.9, 0.1, 0.999, 0.001, 1e-8)
SC_B = (0.25, 0.0, 0.0, 0, 0.8, 0.2, 0.99, 0.01, 1e-6)


def test_one_layout_is_one_launch_whatever_the_groups():
    groups = [_group([_param(n, torch.bfloat16, True, 2) for n in ns], sc)
              for ns, sc in (((40, 7), SC_A), ((100000, 3, 1), SC_B),
                             ((16,), SC_A))]
    plan = mt.launch_plan(groups, chunk=4096)
    assert len(plan) == 1
    lp = plan[0]
    assert (lp.wdtype, lp.master) == (torch.bfloat16, True)
    assert list(lp.recs["n"]) == [40, 7, 100000, 3, 1, 16]
    # every record carries its own group's scalars, rounded to f32
    want = [SC_A, SC_A, SC_B, SC_B, SC_B, SC_A]
    for rec, sc in zip(lp.recs, want):
        assert rec["rescale"] == np.float32(sc[0])
        assert (rec["lo"], rec["hi"]) == (np.float32(sc[1]),
                                          np.float32(sc[2]))
        assert rec["clip"] == sc[3]
        assert list(rec["p"]) == list(np.float32(sc[4:9]))
    # and its tensor's lr, wd, a, b
    assert lp.recs["lr"][3] == np.float32(0.2)
    assert lp.recs["lr"][4] == np.float32(0.30000000000000004)
    assert (lp.recs["wd"] == np.float32(0.01)).all()
    # addresses: the weight, gradient, master and both states
    params = [p for g in groups for p in g[0]]
    for rec, (w, g, m, st) in zip(lp.recs, params):
        assert (rec["w"], rec["g"], rec["master"], rec["s1"], rec["s2"]) == (
            w.data_ptr(), g.data_ptr(), m.data_ptr(), st[0].data_ptr(),
            st[1].data_ptr())


def test_layouts_stay_apart_in_order():
    groups = [
        _group([_param(10, torch.float16, True)], SC_A),
        _group([_param(20, torch.float32, False)], SC_A),
        _group([_param(30, torch.float16, True),
                _param(31, torch.float16, True)], SC_B),
        _group([_param(40, torch.bfloat16, False)], SC_B),
        _group([_param(50, torch.float32, False)], SC_B),
    ]
    plan = mt.launch_plan(groups)
    assert [(lp.wdtype, lp.master) for lp in plan] == [
        (torch.float16, True), (torch.float32, False),
        (torch.bfloat16, False)]
    assert [list(lp.recs["n"]) for lp in plan] == [[10, 30, 31], [20, 50],
                                                   [40]]
    # no master: its address is 0; one state: the second is 0
    assert (plan[1].recs["master"] == 0).all()
    assert (plan[1].recs["s2"] == 0).all()


@pytest.mark.parametrize("chunk", [8, 64, 16384])
def test_chunks_cover_every_element_once(chunk):
    sizes = (1, 7, 8, 9, 63, 64, 65, 1000, 16384, 16385, 40000)
    groups = [_group([_param(n, torch.bfloat16, True) for n in sizes[:5]],
                     SC_A),
              _group([_param(0, torch.bfloat16, True)], SC_A),
              _group([_param(n, torch.bfloat16, True) for n in sizes[5:]],
                     SC_B)]
    (lp,) = mt.launch_plan(groups, chunk=chunk)
    assert list(lp.recs["n"]) == list(sizes)       # the empty one dropped
    seen = [np.zeros(n, np.int64) for n in sizes]
    vec = [np.zeros(n, np.int64) for n in sizes]
    # the kernel's walk: chunk c covers [index * chunk, min(.. + chunk, n));
    # whole 8-element vectors of an aligned record, scalars for the rest
    for c in lp.chunks:
        rec = lp.recs[c["rec"]]
        begin = int(c["index"]) * chunk
        end = min(begin + chunk, int(rec["n"]))
        assert begin < end
        vend = begin + (end - begin) // 8 * 8 if rec["aligned"] else begin
        seen[c["rec"]][begin:end] += 1
        vec[c["rec"]][begin:vend] += 1
        assert begin % 8 == 0            # vectors start 16-byte aligned
    for n, s, v in zip(sizes, seen, vec):
        assert (s == 1).all()
        assert v.sum() == n // chunk * chunk + (n % chunk) // 8 * 8
    # chunks of a record are in order, records in order
    order = [(int(c["rec"]), int(c["index"])) for c in lp.chunks]
    assert order == sorted(order)


def test_alignment_flags_of_views():
    groups = [_group([_param(64, torch.bfloat16, True),
                      _param(64, torch.bfloat16, True, offset=1),
                      _param(64, torch.bfloat16, True, offset=8),
                      _param(64, torch.float32, False, offset=2),
                      _param(64, torch.float32, False, offset=4)], SC_A)]
    plan = mt.launch_plan(groups)
    flags = [list(lp.recs["aligned"]) for lp in plan]
    # bf16 at 1 element (2 bytes) off: not aligned; 8 elements: aligned;
    # f32 at 2 elements (8 bytes) off: not; at 4 (16 bytes): aligned
    assert flags == [[1, 0, 1], [0, 1]]
    # one state at an unaligned address clears the flag too
    w, g, m, (s,) = _param(64, torch.bfloat16, True)
    odd = torch.zeros(65)[1:]
    (lp,) = mt.launch_plan([_group([(w, g, m, (odd,))], SC_A)])
    assert list(lp.recs["aligned"]) == [0]
    assert w.data_ptr() % 16 == 0 and odd.data_ptr() % 16 != 0


def test_chunk_must_be_a_multiple_of_eight():
    groups = [_group([_param(64, torch.float32, False)], SC_A)]
    for bad in (0, 4, 12):
        with pytest.raises(MXNetError, match="multiple of 8"):
            mt.launch_plan(groups, chunk=bad)
    assert mt.launch_plan([]) == []
    assert mt.launch_plan([_group([_param(0, torch.float32, False)],
                                  SC_A)]) == []


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
             "clip_gradient": 0.3}),
    ("adamw", {"learning_rate": 1e-3, "wd": 0.01}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-4, "clip_gradient": 0.2})])
def test_optimizer_hands_the_plan_its_rounded_numbers(monkeypatch, opt, kw):
    """``Optimizer._update_groups`` on tensors the kernel takes: one
    ``update_groups`` call for every group, whose plan holds, per tensor,
    the f32 lr / wd / bias terms of the plain version's order and the
    group's scalars; groups of 4 of one layout give one launch."""
    o = mo.create(opt, multi_precision=True, **kw)
    o.rescale_grad = 1.0 / 8
    o.set_lr_mult({1: 0.5})
    shapes = [(3, 5), (7,), (9, 2), (4,), (11,), (6,)]
    ws = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    st = [o.create_state_multi_precision(i, w) for i, w in enumerate(ws)]
    entries = [(i, w, torch.ones_like(w), st[i]) for i, w in enumerate(ws)]
    plan_of = group_plan([o._group_key(i, w, s) for i, w, _, s in entries], 4)
    hyp = [o._next_hypers(i) for i in range(len(ws))]
    calls = []
    monkeypatch.setattr(mt, "update_groups",
                        lambda op, work: calls.append((op, work)))
    # the route is taken for CUDA tensors; here the spy sees the tables
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    o._update_groups([[entries[k] for k in g] for g in plan_of],
                     [[hyp[k] for k in g] for g in plan_of])
    assert len(calls) == 1
    op, work = calls[0]
    assert op == o._kernel_op()
    (lp,) = mt.launch_plan(work)
    assert len(plan_of) == 2 and len(lp.recs) == len(shapes)
    for k, rec in enumerate(lp.recs):
        lr, wd, t = hyp[k]
        want = o._kernel_hypers(lr, wd, t, o._hyper(k))
        assert [rec["lr"], rec["wd"], rec["a"], rec["b"]] == \
            list(np.float32(want))
        assert rec["rescale"] == np.float32(1.0 / 8)
        assert rec["clip"] == int(kw.get("clip_gradient") is not None)
    assert lp.recs["lr"][1] == np.float32(hyp[1][0])
