"""The port's bounding-box operators (``ops/boxes.py``) against the JAX
package on the CPU, on the same numpy inputs from a seed.

Every operator in both box formats where it takes one, and ``box_nms``
with ``topk``, ``force_suppress``, class ids, a background class,
``valid_thresh``, both output formats and the 2-d input; SSD's anchors,
training targets (with hard negative mining) and detection; greedy
bipartite matching ascending and descending. Masks, indices, matches and
the -1 rows compare equal; floats within 1e-6 relative (the same f32
formulas in the same order; where the JAX package divides by a constant
(a variance), XLA may multiply by its reciprocal, and exp and log may
differ by an ulp). The gradients of ``box_nms`` (through its gather) and
``multibox_detection`` (through the gather, the decode and the best class
score) for one random cotangent, within 1e-6 relative. Then the NDArray
operators (``mx.nd.contrib.box_nms``) on the port's autograd.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.ops  # noqa: F401  (registers the box operators)
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import boxes

FLOAT = dict(rtol=1e-6, atol=1e-7)


def _rng(seed):
    return onp.random.RandomState(seed)


def _boxes(shape, seed, fmt="corner"):
    rng = _rng(seed)
    xy = rng.uniform(0, 1, shape + (2,))
    wh = rng.uniform(0.02, 0.4, shape + (2,))
    if fmt == "center":
        return onp.concatenate([xy, wh], -1).astype("float32")
    return onp.concatenate([xy, xy + wh], -1).astype("float32")


def _jax(name, *arrays, grad=None, **kw):
    xs = [mx.np.array(a) for a in arrays]
    for i in grad or ():
        xs[i].attach_grad()
    if grad:
        with mx.autograd.record():
            out = getattr(mx.nd.contrib, name)(*xs, **kw)
        cot = _rng(99).randn(*out.shape).astype("float32")
        out.backward(mx.np.array(cot))
        return out.asnumpy(), [xs[i].grad.asnumpy() for i in grad], cot
    out = getattr(mx.nd.contrib, name)(*xs, **kw)
    return [o.asnumpy() for o in out] if isinstance(out, tuple) \
        else out.asnumpy()


def _port(name, *arrays, grad=None, cot=None, **kw):
    xs = [torch.from_numpy(onp.ascontiguousarray(a)) for a in arrays]
    for i in grad or ():
        xs[i].requires_grad_(True)
    out = getattr(boxes, name)(*xs, **kw)
    if grad:
        gs = torch.autograd.grad(out, [xs[i] for i in grad],
                                 torch.from_numpy(cot))
        return out.detach().numpy(), [g.numpy() for g in gs]
    return [o.numpy() for o in out] if isinstance(out, tuple) \
        else out.numpy()


def _same_rows(got, want):
    """The -1 rows in the same places, the rest within FLOAT."""
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_array_equal(got == -1, want == -1)
    onp.testing.assert_allclose(got, want, **FLOAT)


@pytest.mark.parametrize("fmt", ["corner", "center"])
@pytest.mark.parametrize("lhs,rhs", [((5,), (7,)), ((3, 6), (3, 4)),
                                     ((1, 9), (4, 5))])
def test_box_iou_equals_jax(fmt, lhs, rhs):
    a, b = _boxes(lhs, 1, fmt), _boxes(rhs, 2, fmt)
    a[0] = b[(0,) * (b.ndim - 1)]          # one identical pair (IoU 1)
    got, want = _port("box_iou", a, b, format=fmt), \
        _jax("box_iou", a, b, format=fmt)
    onp.testing.assert_allclose(got, want, **FLOAT)


def _nms_data(B, N, seed, fmt="corner", classes=3):
    rng = _rng(seed)
    cls = rng.randint(0, classes, (B, N, 1)).astype("float32")
    score = rng.uniform(0, 1, (B, N, 1)).astype("float32")
    k = score[:, 1::7].shape[1]
    score[:, ::7][:, :k] = score[:, 1::7]                  # tied scores
    return onp.concatenate([cls, score, _boxes((B, N), seed + 1, fmt)], -1)


NMS_CASES = [
    dict(),
    dict(id_index=0),
    dict(id_index=0, force_suppress=True),
    dict(id_index=0, background_id=1),
    dict(topk=10, id_index=0),
    dict(topk=100),
    dict(valid_thresh=0.4, overlap_thresh=0.3),
    dict(out_format="center"),
    dict(in_format="center", out_format="center"),
    dict(in_format="center"),
]


@pytest.mark.parametrize("kw", NMS_CASES, ids=[str(i) for i in
                                               range(len(NMS_CASES))])
@pytest.mark.parametrize("B,N", [(2, 40), (1, 130)])
def test_box_nms_equals_jax(kw, B, N):
    data = _nms_data(B, N, 3, kw.get("in_format", "corner"))
    kw = dict(kw, coord_start=2, score_index=1)
    _same_rows(_port("box_nms", data, **kw), _jax("box_nms", data, **kw))


def test_box_nms_2d_and_other_columns_equal_jax():
    d = _nms_data(1, 30, 4)[0][:, [1, 2, 3, 4, 5, 0]]    # score first
    for kw in (dict(coord_start=1, score_index=0),
               dict(coord_start=1, score_index=0, id_index=5, topk=12)):
        _same_rows(_port("box_nms", d, **kw), _jax("box_nms", d, **kw))


@pytest.mark.parametrize("kw", [dict(id_index=0), dict(topk=20, id_index=0,
                                                       out_format="center")])
def test_box_nms_gradient_equals_jax(kw):
    data = _nms_data(2, 50, 5)
    kw = dict(kw, coord_start=2, score_index=1)
    want, (gw,), cot = _jax("box_nms", data, grad=(0,), **kw)
    got, (gg,) = _port("box_nms", data, grad=(0,), cot=cot, **kw)
    _same_rows(got, want)
    onp.testing.assert_allclose(gg, gw, **FLOAT)
    assert onp.abs(gg).sum() > 0


@pytest.mark.parametrize("is_ascend,threshold,topk", [
    (False, 0.1, -1), (False, 0.6, -1), (True, 0.5, -1), (False, 0.0, 3)])
@pytest.mark.parametrize("shape", [(2, 6, 9), (9, 4), (1, 12, 12)])
def test_bipartite_matching_equals_jax(shape, is_ascend, threshold, topk):
    s = _rng(6).uniform(0, 1, shape).astype("float32")
    s.reshape(-1)[::11] = 0.5                             # ties
    kw = dict(threshold=threshold, is_ascend=is_ascend, topk=topk)
    for g, w in zip(_port("bipartite_matching", s, **kw),
                    _jax("bipartite_matching", s, **kw)):
        onp.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2)),
    dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5, 3, 1 / 3)),
    dict(sizes=(1.5,), clip=True),
    dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5), steps=(8 / 300, 8 / 300)),
    dict(sizes=(0.3,), ratios=(1, 0.7), offsets=(0.25, 0.75)),
])
def test_multibox_prior_equals_jax(kw):
    x = onp.zeros((2, 3, 5, 7), "float32")
    onp.testing.assert_allclose(_port("multibox_prior", x, **kw),
                                _jax("multibox_prior", x, **kw), **FLOAT)


def _ssd(B, N, M, C, seed):
    rng = _rng(seed)
    anchor = _boxes((1, N), seed)
    lab = onp.full((B, M, 5), -1.0, "float32")
    for b in range(B):
        k = rng.randint(1, M + 1)
        lab[b, :k, 0] = rng.randint(0, C - 1, k)
        lab[b, :k, 1:] = _boxes((k,), seed + b + 1)
    lab[0, 0, 1:] = anchor[0, 0]                          # an exact match
    logits = rng.randn(B, C, N).astype("float32")
    prob = (onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True))
    loc = (rng.randn(B, N * 4) * 0.3).astype("float32")
    return anchor, lab, logits, prob.astype("float32"), loc


@pytest.mark.parametrize("kw", [
    dict(),
    dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=2.0, negative_mining_thresh=0.3,
         minimum_negative_samples=5, overlap_threshold=0.3,
         ignore_label=-2.0, variances=(0.1, 0.1, 0.3, 0.3)),
])
def test_multibox_target_equals_jax(kw):
    anchor, lab, logits, _, _ = _ssd(3, 60, 6, 4, 7)
    got = _port("multibox_target", anchor, lab, logits, **kw)
    want = _jax("multibox_target", anchor, lab, logits, **kw)
    onp.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        onp.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(nms_topk=20, nms_threshold=0.3),
    dict(force_suppress=True, threshold=0.2, clip=False),
    dict(background_id=-1, variances=(0.1, 0.1, 0.2, 0.2)),
])
def test_multibox_detection_equals_jax(kw):
    anchor, _, _, prob, loc = _ssd(2, 80, 1, 5, 8)
    _same_rows(_port("multibox_detection", prob, loc, anchor, **kw),
               _jax("multibox_detection", prob, loc, anchor, **kw))
    with pytest.raises(ValueError):
        boxes.multibox_detection(*(torch.from_numpy(a) for a in
                                   (prob, loc, anchor)), background_id=2)


def test_multibox_detection_gradient_equals_jax():
    anchor, _, _, prob, loc = _ssd(2, 60, 1, 4, 9)
    kw = dict(nms_topk=30, nms_threshold=0.4)
    want, gw, cot = _jax("multibox_detection", prob, loc, anchor,
                         grad=(0, 1), **kw)
    got, gg = _port("multibox_detection", prob, loc, anchor, grad=(0, 1),
                    cot=cot, **kw)
    _same_rows(got, want)
    for g, w in zip(gg, gw):
        assert onp.abs(g).sum() > 0
        onp.testing.assert_allclose(g, w, **FLOAT)


def test_ndarray_box_nms_records_and_backpropagates():
    """``mx.nd.contrib.box_nms`` over NDArrays on the port's autograd: the
    gather's gradient, as ``tests/test_boxes.py`` asks of the JAX
    package."""
    d = tmx.nd.array(onp.array([[[0.9, 0.0, 0.0, 2.0, 2.0],
                                 [0.8, 0.1, 0.1, 2.1, 2.1]]], "float32"),
                     ctx=tmx.cpu())
    d.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.contrib.box_nms(d, coord_start=1, score_index=0)
    out.backward()
    assert out.asnumpy()[0, 1].tolist() == [-1.0] * 5
    assert d.grad.asnumpy()[0, 0].tolist() == [1.0] * 5
    assert d.grad.asnumpy()[0, 1].tolist() == [0.0] * 5
