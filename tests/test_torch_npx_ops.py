"""The port's ``npx`` operators (``ops/nn.py``, ``ops/transformer.py``)
against the JAX package on the CPU, on the same numpy inputs from a seed.

Every case runs the operator forward in both packages and, where the JAX
operator has a gradient, its gradient for one random cotangent (the JAX
package's ``backward(head_grad)``, torch's ``autograd.grad``) with respect
to each float input. Tolerances, f32: forward rtol=1e-5, atol=1e-6;
gradients rtol=1e-4, atol=1e-6 (the same formulas, other summation
orders); convolutions 1e-4 both ways (cuDNN-style and XLA algorithms sum
in other orders); ``up_sampling``'s bilinear forward atol=1e-5 (XLA resizes
by a weight matrix, PyTorch by linear interpolation: one rounding of a
value of ~4); masks, integer outputs and the copying operators (the
sequence operators, ``topk_mask``, ``arange_like``, nearest up-sampling,
``roi_pooling``) are compared exactly.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import npx
from mxnet_tpu_torch.base import MXNetError

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
CONV = dict(rtol=1e-4, atol=1e-4)
EXACT = dict(rtol=0, atol=0)


def _rng(seed=0):
    return onp.random.RandomState(seed)


def _x(*shape, seed=0, scale=2.0):
    return (_rng(seed).randn(*shape) * scale).astype("float32")


def _jax(name, arrays, grad, kw):
    xs = [mx.np.array(a, dtype=a.dtype) for a in arrays]
    for i in grad:
        xs[i].attach_grad()
    with mx.autograd.record():
        y = getattr(mx.npx, name)(*xs, **kw)
    if not grad:
        return y.asnumpy(), []
    cot = _x(*y.shape, seed=99, scale=1.0)
    y.backward(mx.np.array(cot))
    return y.asnumpy(), [xs[i].grad.asnumpy() for i in grad]


def _port(name, arrays, grad, kw):
    xs = [torch.from_numpy(a.copy()) for a in arrays]
    for i in grad:
        xs[i].requires_grad_(True)
    y = getattr(npx, name)(*xs, **kw)
    if not grad:
        return y.numpy(), []
    cot = torch.from_numpy(_x(*y.shape, seed=99, scale=1.0))
    gs = torch.autograd.grad(y, [xs[i] for i in grad], cot)
    return y.detach().numpy(), [g.numpy() for g in gs]


_IDS: dict = {}


def _case(name, arrays, grad=(0,), fwd=FWD, bwd=GRAD, **kw):
    _IDS[name] = _IDS.get(name, -1) + 1
    return pytest.param(name, arrays, grad, fwd, bwd, kw,
                        id=f"{name}-{_IDS[name]}")


X = _x(3, 4, 5)
CASES = []
# activations: every act_type of activation(), then each operator
for act in ("relu", "sigmoid", "log_sigmoid", "tanh", "softrelu", "softplus",
            "softsign", "gelu", "silu", "swish", "mish", "identity"):
    CASES.append(_case("activation", [X], act_type=act))
for act, slope in (("leaky", 0.1), ("rrelu", 0.3), ("elu", 0.7),
                   ("gelu", 0.25), ("selu", 0.25)):
    CASES.append(_case("leaky_relu", [X], slope=slope, act_type=act))
CASES += [
    _case("prelu", [_x(4, 6), _x(6, seed=1, scale=0.3)], grad=(0, 1)),
    _case("prelu", [X, _x(1, seed=1, scale=0.3)], grad=(0, 1)),
    _case("elu", [X], alpha=0.7),
    _case("selu", [X]), _case("silu", [X]), _case("swish", [X]),
    _case("mish", [X]), _case("softrelu", [X]), _case("softsign", [X]),
    _case("log_sigmoid", [X]), _case("hard_sigmoid", [X]),
    _case("hard_sigmoid", [X], alpha=0.3, beta=0.4),
    _case("hard_swish", [_x(3, 4, 5, scale=4.0)]),
]
# the softmax family
LEN = onp.array([5, 2, 3], "int32")
MASK = _rng(2).rand(3, 4, 5) > 0.4
MASK[0, 1] = False                      # a row masked whole
MASK_SOME = MASK.copy()
MASK_SOME[..., 0] = True                # every row keeps a position
CASES += [
    _case("softmax", [X]), _case("softmax", [X], axis=1, temperature=2.0),
    _case("softmax", [X], temperature=3.0),
    _case("log_softmax", [X], axis=0, temperature=0.5),
    _case("masked_softmax", [X, MASK]),
    _case("masked_softmax", [X, MASK], axis=1),
    _case("masked_log_softmax", [X, MASK_SOME]),
]
# convolutions
CASES += [
    _case("deconvolution", [_x(2, 4, 5, 5), _x(4, 3, 3, 3, seed=1),
                            _x(3, seed=2)], grad=(0, 1, 2), fwd=CONV,
          bwd=CONV, kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
          num_filter=3, no_bias=False),
    _case("deconvolution", [_x(2, 4, 5, 6), _x(4, 3, 4, 4, seed=1)],
          grad=(0, 1), fwd=CONV, bwd=CONV, kernel=(4, 4), stride=(2, 2),
          pad=(1, 1), num_filter=3),
    _case("deconvolution", [_x(2, 4, 7), _x(4, 5, 3, seed=1)], grad=(0, 1),
          fwd=CONV, bwd=CONV, kernel=(3,), stride=(3,), dilate=(2,),
          num_filter=5, layout="NCW"),
    _case("deconvolution", [_x(1, 3, 3, 4, 5), _x(3, 2, 2, 3, 3, seed=1)],
          grad=(0, 1), fwd=CONV, bwd=CONV, kernel=(2, 3, 3), stride=(1, 2, 2),
          pad=(0, 1, 1), adj=(0, 1, 0), num_filter=2, layout="NCDHW"),
    _case("adaptive_avg_pool2d", [_x(2, 3, 8, 6)], output_size=(2, 3)),
    _case("adaptive_avg_pool2d", [_x(2, 8, 6, 3)], output_size=2,
          layout="NHWC"),
]
# normalizations
G6 = _x(6, seed=3, scale=0.5) + 1
CASES += [
    _case("group_norm", [_x(2, 6, 4, 5), G6, _x(6, seed=4)], grad=(0, 1, 2),
          num_groups=3),
    _case("group_norm", [_x(2, 6, 7), G6, _x(6, seed=4)], grad=(0, 1, 2),
          num_groups=6, eps=1e-3),
    _case("instance_norm", [_x(2, 6, 4, 5), G6, _x(6, seed=4)],
          grad=(0, 1, 2)),
    _case("rms_norm", [_x(3, 4, 6), G6], grad=(0, 1)),
    _case("rms_norm", [_x(3, 6, 4), G6], grad=(0, 1), axis=1, eps=1e-3),
    _case("lrn", [_x(2, 7, 4, 4)], alpha=0.1, beta=0.75, knorm=2.0,
          nsize=5),
    _case("lrn", [_x(2, 4, 3, 3)], nsize=3),
]
for mode in ("instance", "channel", "spatial"):
    CASES.append(_case("l2_normalization", [_x(2, 3, 4, 5)], mode=mode))
# sequences
TNC = _x(6, 3, 4)
SEQ_LEN = onp.array([6, 2, 4], "int32")
for axis, data in ((0, TNC), (1, onp.ascontiguousarray(TNC.swapaxes(0, 1)))):
    for name in ("sequence_mask", "sequence_last", "sequence_reverse"):
        CASES.append(_case(name, [data, SEQ_LEN], fwd=EXACT, bwd=EXACT,
                           use_sequence_length=True, axis=axis,
                           **({"value": -1.0} if name == "sequence_mask"
                              else {})))
    CASES.append(_case("sequence_last", [data], fwd=EXACT, bwd=EXACT,
                       axis=axis))
CASES += [
    _case("sequence_reverse", [TNC], fwd=EXACT, bwd=EXACT),
    _case("sequence_mask", [TNC], grad=(), fwd=EXACT),
    _case("topk_mask", [X], grad=(), fwd=EXACT, k=2),
    _case("topk_mask", [X], grad=(), fwd=EXACT, k=3, axis=0),
    _case("smooth_l1", [_x(4, 5, scale=1.0)]),
    _case("smooth_l1", [_x(4, 5, scale=1.0)], scalar=2.0),
    _case("arange_like", [X], grad=(), fwd=EXACT),
    _case("arange_like", [X], grad=(), fwd=EXACT, start=2.0, step=0.5,
          axis=1),
]
# the loss heads: the backward injects the loss gradient
LAB = onp.array([1, 4, -1, 0], "int32")
CASES += [
    _case("softmax_output", [_x(4, 5), LAB], grad=(0,)),
    _case("softmax_output", [_x(4, 5), LAB.astype("float32")], grad=(0,),
          grad_scale=2.0, use_ignore=True, normalization="valid",
          smooth_alpha=0.1),
    _case("softmax_output", [_x(4, 5), LAB], grad=(0,), use_ignore=True,
          ignore_label=4, normalization="batch"),
    _case("softmax_output", [_x(4, 5), LAB], grad=(0,),
          normalization="valid"),
    _case("softmax_output", [_x(2, 3, 4), onp.array([[0, 2, 1, 2],
                                                      [1, 1, 0, 2]],
                                                     "int32")],
          grad=(0,), multi_output=True),
    _case("linear_regression_output", [_x(4, 3), _x(4, 3, seed=1)],
          grad=(0,), grad_scale=0.5),
    _case("mae_regression_output", [_x(4, 3), _x(4, 3, seed=1)], grad=(0,)),
    _case("logistic_regression_output", [_x(4, 3), _x(4, 3, seed=1)],
          grad=(0,), grad_scale=3.0),
    _case("logistic_regression_output", [_x(5), _x(5, seed=1)], grad=(0,)),
    _case("make_loss", [_x(4, 3)], grad=()),
]
# up-sampling, ROI pooling, CTC
ROIS = onp.array([[0, 1, 2, 20, 15], [1, 0, 0, 31, 23], [0, 5, 5, 5, 5],
                  [1, 10.5, 3.5, 26.5, 30], [0, -4, -4, 8, 2]], "float32")
CASES += [
    _case("up_sampling", [_x(2, 3, 4, 5)], fwd=EXACT, scale=2),
    _case("up_sampling", [_x(2, 3, 4, 5)], fwd=EXACT, scale=3,
          sample_type="nearest"),
    _case("up_sampling", [_x(2, 3, 4, 5)], fwd=dict(rtol=1e-5, atol=1e-5),
          scale=2, sample_type="bilinear"),
    _case("up_sampling", [_x(2, 3, 4, 5)], fwd=dict(rtol=1e-5, atol=1e-5),
          scale=3, sample_type="bilinear"),
    _case("roi_pooling", [_x(2, 3, 12, 16), ROIS], fwd=EXACT, bwd=EXACT,
          pooled_size=(3, 2), spatial_scale=0.5),
    _case("roi_pooling", [_x(2, 3, 12, 16), ROIS[:3]], fwd=EXACT, bwd=EXACT,
          pooled_size=2, spatial_scale=1.0),
    _case("ctc_loss", [_x(2, 12, 6), onp.array([[1, 2, 2, 0], [3, 4, 0, 0]],
                                               "int32")]),
    _case("ctc_loss", [_x(12, 2, 6), onp.array([[1, 2, 2, 5], [3, 4, 0, 1]],
                                               "int32"),
                       onp.array([12, 9], "int32"),
                       onp.array([4, 2], "int32")], layout="TNC"),
]
# MXNet's interleaved (T, N, 3 * H * D) attention products
CASES += [
    _case("interleaved_matmul_selfatt_qk", [_x(5, 2, 24)], heads=2),
    _case("interleaved_matmul_selfatt_valatt", [_x(5, 2, 24),
                                                _x(4, 5, 5, seed=1)],
          grad=(0, 1), heads=2),
    _case("interleaved_matmul_encdec_qk", [_x(3, 2, 8), _x(5, 2, 16, seed=1)],
          grad=(0, 1), heads=2),
    _case("interleaved_matmul_encdec_valatt", [_x(5, 2, 16),
                                               _x(4, 3, 5, seed=1)],
          grad=(0, 1), heads=2),
]


@pytest.mark.parametrize("name,arrays,grad,fwd,bwd,kw", CASES)
def test_npx_operator_matches_jax(name, arrays, grad, fwd, bwd, kw):
    jy, jg = _jax(name, arrays, grad, kw)
    ty, tg = _port(name, arrays, grad, kw)
    assert ty.shape == jy.shape and ty.dtype == jy.dtype, (ty.shape,
                                                           jy.shape)
    onp.testing.assert_allclose(ty, jy, **fwd)
    for i, (a, b) in enumerate(zip(tg, jg)):
        onp.testing.assert_allclose(a, b, **bwd, err_msg=f"grad {i}")


@pytest.mark.parametrize("temperature", [None, 2.0])
def test_softmax_length_masks_and_ignores_temperature(temperature):
    """With ``length`` the positions past each length are masked out and
    ``temperature`` is not applied, as in the JAX package."""
    jy = mx.npx.softmax(mx.np.array(X), temperature=temperature,
                        length=mx.np.array(LEN)).asnumpy()
    ty = npx.softmax(torch.from_numpy(X), temperature=temperature,
                     length=torch.from_numpy(LEN)).numpy()
    onp.testing.assert_allclose(ty, jy, **FWD)
    assert (ty[1, :, 2:] == 0).all()


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_deconvolution_is_the_groups_side_by_side(groups):
    """The JAX package refuses ``num_group > 1``; the port's grouped
    transposed convolution equals the JAX package's ungrouped one on each
    group's channels, concatenated."""
    x, w = _x(2, 8, 5, 5), _x(8, 3, 3, 3, seed=1)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1))
    got = npx.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                            num_group=groups, num_filter=3 * groups,
                            **kw).numpy()
    c = 8 // groups
    want = onp.concatenate([mx.npx.deconvolution(
        mx.np.array(x[:, g * c:(g + 1) * c]),
        mx.np.array(w[g * c:(g + 1) * c]), num_filter=3, **kw).asnumpy()
        for g in range(groups)], axis=1)
    onp.testing.assert_allclose(got, want, **CONV)
    with pytest.raises(mx.MXNetError):
        mx.npx.deconvolution(mx.np.array(x), mx.np.array(w), num_group=2,
                             **kw)


def test_deconvolution_target_shape_sets_adj():
    x, w = _x(2, 4, 5, 5), _x(4, 3, 3, 3, seed=1)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    want = mx.npx.deconvolution(mx.np.array(x), mx.np.array(w), adj=(1, 0),
                                **kw).asnumpy()
    got = npx.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                            target_shape=(10, 9), **kw).numpy()
    onp.testing.assert_allclose(got, want, **CONV)
    with pytest.raises(MXNetError, match="target_shape"):
        npx.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                          target_shape=(8, 8), **kw)


def test_operators_refuse_what_the_jax_package_refuses():
    x = torch.from_numpy(X)
    with pytest.raises(ValueError):
        npx.leaky_relu(x, act_type="prelu")
    with pytest.raises(ValueError):
        npx.adaptive_avg_pool2d(torch.zeros(1, 2, 5, 6), output_size=2)
    with pytest.raises(MXNetError, match="sample_type"):
        npx.up_sampling(torch.zeros(1, 2, 3, 3), sample_type="cubic")
    with pytest.raises(MXNetError, match="nsize"):
        npx.lrn(torch.zeros(1, 4, 2, 2), nsize=4)


def test_a_dtype_torch_lacks_raises_mxnet_error_without_a_cast():
    """An operator that torch does not implement for a dtype raises
    MXNetError naming the operator; nothing is cast to run it."""
    with pytest.raises(MXNetError, match="npx.softmax"):
        npx.softmax(torch.arange(6).reshape(2, 3))
    with pytest.raises(MXNetError, match="npx.masked_softmax"):
        npx.masked_softmax(torch.arange(6).reshape(2, 3),
                           torch.ones(2, 3, dtype=torch.bool))


@pytest.mark.parametrize("normalization,want", [("null", 2.0),
                                                ("batch", 0.5)])
def test_make_loss_injects_its_gradient(normalization, want):
    """The JAX package's ``make_loss`` backward fails (its residual holds a
    numpy dtype, which JAX refuses), so its gradient is held to the
    formula of its ``_bwd``: ``grad_scale`` (over the batch for 'batch')
    whatever the cotangent."""
    x = torch.from_numpy(_x(4, 3)).requires_grad_(True)
    y = npx.make_loss(x, grad_scale=2.0, normalization=normalization)
    (g,) = torch.autograd.grad(y, x, torch.from_numpy(_x(4, 3, seed=5)))
    onp.testing.assert_array_equal(y.detach().numpy(), _x(4, 3))
    onp.testing.assert_array_equal(g.numpy(), onp.full((4, 3), want,
                                                       "float32"))
