"""The port's losses (``gluon.loss``) and initializers (``initializer``,
``gluon.Constant``) against the JAX package on the CPU.

Losses: each class on the same numpy inputs, plain, with ``sample_weight``
and with another ``batch_axis`` or ``weight`` where the loss reduces by
them; the per-sample loss and its gradient for every float input but the
label, for one random cotangent. Tolerances, f32: the loss rtol=1e-5,
atol=1e-6, gradients rtol=1e-4, atol=1e-6; ``CTCLoss`` 1e-4 both ways
(a log-domain recursion over 24 steps). The JAX package reads a CTC label
as (N, L) whatever ``label_layout`` says; the port transposes a 'TN'
label, so that case is held against the JAX package's 'NT' call on the
same labels.

Initializers: the draws differ by contract (threefry against Philox), so
``Orthogonal`` is held by its property (``q q^T`` or ``q^T q`` equal to
``scale^2 I``, rtol=1e-5, atol=1e-5) and ``MSRAPrelu`` by its variance
against Xavier's formula (within 5 % over 294,912 draws: ~3.5 standard
errors); ``Constant``, ``Bilinear``, ``LSTMBias`` and ``gluon.Constant``
equal to the JAX package's values to the bit.
"""
import math

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon import loss as tloss

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
CTC = dict(rtol=1e-4, atol=1e-4)


def _x(*shape, seed=0, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale).astype(
        "float32")


def _u(*shape, seed=0, lo=0.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype(
        "float32")


def _signs(*shape, seed=0):
    return onp.where(_u(*shape, seed=seed) > 0.5, 1.0, -1.0).astype(
        "float32")


def _run(cls, ctor, args, grad):
    """The loss ``cls(**ctor)`` on ``args`` (None for an argument left
    out) in both packages: output and the gradients of ``args[i]`` for i
    in ``grad``."""
    jx = [None if a is None else mx.np.array(a, dtype=a.dtype)
          for a in args]
    for i in grad:
        jx[i].attach_grad()
    with mx.autograd.record():
        jy = getattr(mx.gluon.loss, cls)(**ctor)(*jx)
    cot = _x(*jy.shape, seed=99) if jy.ndim else onp.float32(1.5)
    jy.backward(mx.np.array(cot))
    tx = [None if a is None else torch.from_numpy(a.copy()) for a in args]
    for i in grad:
        tx[i].requires_grad_(True)
    ty = getattr(tloss, cls)(**ctor)(*tx)
    tg = torch.autograd.grad(ty, [tx[i] for i in grad],
                             torch.as_tensor(cot))
    return (ty.detach().numpy(), jy.asnumpy(), [g.numpy() for g in tg],
            [jx[i].grad.asnumpy() for i in grad])


P = _x(4, 3, 5, scale=2.0)
SW = _u(4, 1, 1, seed=7)
CASES = [
    ("L1Loss", {}, [P, _x(4, 3, 5, seed=1)], (0, 1)),
    ("L1Loss", {"weight": 0.5, "batch_axis": 1},
     [P, _x(4, 3, 5, seed=1), SW], (0,)),
    ("SigmoidBinaryCrossEntropyLoss", {}, [P, _u(4, 3, 5, seed=1)], (0,)),
    ("SigmoidBinaryCrossEntropyLoss", {}, [P, _u(4, 3, 5, seed=1), SW],
     (0,)),
    ("SigmoidBCELoss", {"from_sigmoid": True},
     [_u(4, 3, 5, lo=0.05, hi=0.95), _u(4, 3, 5, seed=1)], (0,)),
    ("SigmoidBCELoss", {"batch_axis": 1}, [P, _u(4, 3, 5, seed=1)], (0,)),
    ("KLDivLoss", {}, [onp.log(_u(4, 3, 5, lo=0.1)), _u(4, 3, 5, seed=1)],
     (0, 1)),
    ("KLDivLoss", {"from_logits": False, "axis": 1},
     [P, _u(4, 3, 5, seed=1), SW], (0,)),
    ("HuberLoss", {}, [P, _x(4, 3, 5, seed=1)], (0, 1)),
    ("HuberLoss", {"rho": 0.5, "weight": 2.0},
     [P, _x(4, 3, 5, seed=1), SW], (0,)),
    ("HingeLoss", {}, [P, _signs(4, 3, 5, seed=1)], (0,)),
    ("HingeLoss", {"margin": 2.0, "batch_axis": 2},
     [P, _signs(4, 3, 5, seed=1), SW], (0,)),
    ("SquaredHingeLoss", {}, [P, _signs(4, 3, 5, seed=1)], (0,)),
    ("SquaredHingeLoss", {"margin": 0.5}, [P, _signs(4, 3, 5, seed=1), SW],
     (0,)),
    ("LogisticLoss", {}, [P, _signs(4, 3, 5, seed=1)], (0,)),
    ("LogisticLoss", {"label_format": "binary"},
     [P, (_signs(4, 3, 5, seed=1) > 0).astype("float32"), SW], (0,)),
    ("TripletLoss", {}, [_x(4, 6), _x(4, 6, seed=1), _x(4, 6, seed=2)],
     (0, 1, 2)),
    ("TripletLoss", {"margin": 3.0},
     [_x(4, 2, 3), _x(4, 2, 3, seed=1), _x(4, 2, 3, seed=2), _u(4, seed=3)],
     (0, 1, 2)),
    ("CosineEmbeddingLoss", {}, [_x(4, 6), _x(4, 6, seed=1),
                                 _signs(4, seed=2)], (0, 1)),
    ("CosineEmbeddingLoss", {"margin": 0.2, "weight": 0.5},
     [_x(4, 2, 3), _x(4, 2, 3, seed=1), _signs(4, seed=2), _u(4, seed=3)],
     (0, 1)),
    ("PoissonNLLLoss", {}, [P * 0.5, _u(4, 3, 5, seed=1, hi=4.0)], (0,)),
    ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
     [_u(4, 3, 5, lo=0.1, hi=3.0), onp.floor(_u(4, 3, 5, seed=1, hi=5.0)),
      SW], (0,)),
    ("SDMLLoss", {}, [_x(5, 6), _x(5, 6, seed=1)], (0, 1)),
    ("SDMLLoss", {"smoothing_parameter": 0.1}, [_x(5, 6), _x(5, 6, seed=1)],
     (0, 1)),
    ("SoftmaxCELoss", {"sparse_label": False},
     [P, _u(4, 3, 5, seed=1), SW.reshape(4, 1)], (0, 1)),
]


@pytest.mark.parametrize("cls,ctor,args,grad", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_loss_matches_jax(cls, ctor, args, grad):
    ty, jy, tg, jg = _run(cls, ctor, args, grad)
    assert ty.shape == jy.shape
    onp.testing.assert_allclose(ty, jy, **FWD)
    for i, (a, b) in enumerate(zip(tg, jg)):
        onp.testing.assert_allclose(a, b, **GRAD, err_msg=f"grad {i}")


def test_loss_aliases_are_the_classes():
    assert tloss.SigmoidBCELoss is tloss.SigmoidBinaryCrossEntropyLoss
    assert tloss.SoftmaxCELoss is tloss.SoftmaxCrossEntropyLoss
    assert sorted(tloss.__all__) == sorted(mx.gluon.loss.__all__)


@pytest.mark.parametrize("ctor", [{}, {"from_sigmoid": True}])
def test_sigmoid_bce_pos_weight_matches_jax(ctor):
    pred = _u(4, 3, 5, lo=0.05, hi=0.95) if ctor else P
    args = [pred, _u(4, 3, 5, seed=1), None, _u(5, seed=4, lo=0.5, hi=3.0)]
    ty, jy, tg, jg = _run("SigmoidBCELoss", ctor, args, (0,))
    onp.testing.assert_allclose(ty, jy, **FWD)
    onp.testing.assert_allclose(tg[0], jg[0], **GRAD)


LOGITS = _x(3, 24, 7, scale=2.0)
LABELS = onp.array([[1, 2, 2, 3, 0, 0], [4, 4, 4, 0, 0, 0],
                    [5, 6, 1, 2, 3, 6]], "int32")


@pytest.mark.parametrize("layout,lengths,weighted", [
    ("NTC", False, False), ("TNC", False, False), ("NTC", True, False),
    ("TNC", True, True), ("NTC", "pred", False)])
def test_ctc_loss_matches_jax(layout, lengths, weighted):
    logits = LOGITS if layout == "NTC" else \
        onp.ascontiguousarray(LOGITS.swapaxes(0, 1))
    args = [logits, LABELS]
    if lengths:
        args += [onp.array([24, 20, 17], "int32")]
        if lengths is True:
            args += [onp.array([4, 3, 6], "int32")]
    if weighted:
        args += [_u(3, seed=5)]
    ty, jy, tg, jg = _run("CTCLoss", {"layout": layout}, args, (0,))
    assert ty.shape == jy.shape == (3,)
    onp.testing.assert_allclose(ty, jy, **CTC)
    onp.testing.assert_allclose(tg[0], jg[0], **CTC)


def test_ctc_label_layout_tn_is_the_transposed_label():
    jy = mx.gluon.loss.CTCLoss(label_layout="NT")(
        mx.np.array(LOGITS), mx.np.array(LABELS)).asnumpy()
    t2 = tloss.CTCLoss(label_layout="TN")(
        torch.from_numpy(LOGITS), torch.from_numpy(LABELS.T.copy()))
    onp.testing.assert_allclose(t2.numpy(), jy, **CTC)
    onp.testing.assert_allclose(tmx.npx.ctc_loss(
        torch.from_numpy(LOGITS), torch.from_numpy(LABELS)).numpy(), jy,
        **CTC)


# ------------------------------------------------------------ initializers
@pytest.mark.parametrize("name,args,shape", [
    ("Constant", (0.25,), (3, 4)), ("Constant", (-2,), (5,)),
    ("Bilinear", (), (2, 3, 4, 4)), ("Bilinear", (), (1, 2, 3, 5)),
    ("LSTMBias", (), (16,)), ("LSTMBias", (2.5,), (12,)),
    ("Zero", (), (2, 3)), ("One", (), (4,))])
def test_deterministic_initializers_equal_jax(name, args, shape):
    want = getattr(mx.init, name)(*args)(shape).asnumpy()
    gen = torch.Generator().manual_seed(0)
    got = getattr(tinit, name)(*args)(shape, gen).numpy()
    onp.testing.assert_array_equal(got, want)
    assert type(tinit.get(name.lower())) is getattr(tinit, name)


@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (8, 8), (4, 3, 2, 2)])
@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
def test_orthogonal_is_orthonormal_to_scale(shape, rand_type):
    scale = 1.7
    gen = torch.Generator().manual_seed(1)
    q = tinit.Orthogonal(scale, rand_type)(shape, gen).double()
    m = q.reshape(shape[0], -1)
    g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    onp.testing.assert_allclose(g.numpy(), scale ** 2 * onp.eye(g.shape[0]),
                                rtol=1e-5, atol=1e-5)
    # the JAX package's draw has the same property
    jq = mx.init.Orthogonal(scale, rand_type)(shape).asnumpy().astype(
        "float64").reshape(shape[0], -1)
    jg = jq @ jq.T if jq.shape[0] <= jq.shape[1] else jq.T @ jq
    onp.testing.assert_allclose(jg, scale ** 2 * onp.eye(jg.shape[0]),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor_type,slope", [("avg", 0.25), ("in", 0.0),
                                               ("out", 1.0)])
def test_msra_prelu_variance_is_xaviers(factor_type, slope):
    shape = (128, 256, 3, 3)
    fan_in, fan_out = 256 * 9, 128 * 9
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in}.get(factor_type,
                                                               fan_out)
    var = 2.0 / (1 + slope ** 2) / factor
    got = tinit.MSRAPrelu(factor_type, slope)(
        shape, torch.Generator().manual_seed(2)).double()
    jgot = mx.init.MSRAPrelu(factor_type, slope)(shape).asnumpy()
    for w in (got.numpy(), jgot):
        assert abs(float(w.var()) / var - 1) < 0.05
        assert abs(float(w.mean())) < 5 * math.sqrt(var / w.size)


def test_gluon_constant_holds_its_value():
    value = _x(2, 3)
    jc = mx.gluon.Constant(value)
    jc.initialize()
    tc = tmx.gluon.Constant(value)
    tc.initialize(init=tinit.One(), device="cpu")
    onp.testing.assert_array_equal(tc.data().numpy(), jc.data().asnumpy())
    assert tc.grad_req == jc.grad_req == "null"
    assert tc.name == jc.name == "const"
    assert tc.shape == (2, 3) and tc.dtype == torch.float32
    assert tmx.gluon.Constant(torch.ones(4), name="c").name == "c"
