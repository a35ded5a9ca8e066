"""The port's prologue-fused 1x1 convolution on CPU tensors against the JAX
package's Pallas kernels run in interpret mode.

``mxnet_tpu_torch/ops/cuda/conv_fused.py`` holds the plain versions of the
three Hopper kernels (fwd, dgrad, wgrad) and the autograd Function around
them; on the CPU the Function runs the plain versions, which these tests
hold against ``mxnet_tpu/ops/pallas/conv_fused.py`` (``_fwd``, ``_dgrad``,
``_wgrad`` with ``interpret=True``, and ``fused_prologue_conv1x1`` with its
custom VJP) on the same numpy inputs.

Tolerances: f32 against f32, summation order only: rtol=atol=1e-5 for the
forward and dgrad (sums over at most 80 channels), atol=1e-4 for wgrad
(sums over N*M up to 4100 products) and for gradients through a sin(y)
loss; bf16 inputs: one bf16 rounding of the output (rtol=8e-3).
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas import conv_fused as jcf
from mxnet_tpu_torch.ops.cuda import conv_fused as cf

F32 = dict(rtol=1e-5, atol=1e-5)
F32_SUM = dict(rtol=1e-5, atol=1e-4)


def _case(seed, N, Ci, Co, M, affine, bias=False):
    rng = onp.random.RandomState(seed)
    x = rng.randn(N, Ci, M).astype("float32")
    w = (rng.randn(Co, Ci) * 0.1).astype("float32")
    dy = rng.randn(N, Co, M).astype("float32")
    scale = (rng.rand(Ci) + 0.5).astype("float32") if affine else None
    shift = (rng.randn(Ci) * 0.1).astype("float32") if affine else None
    b = (rng.randn(Co) * 0.1).astype("float32") if bias else None
    return x, w, dy, scale, shift, b


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, shape=None, dtype=jnp.float32):
    if a is None:
        return None
    a = jnp.asarray(a, dtype)
    return a if shape is None else a.reshape(shape)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_plain_forward_matches_pallas(affine, relu, bias):
    N, Ci, Co, M = 2, 16, 24, 35
    x, w, _, s, t, b = _case(0, N, Ci, Co, M, affine, bias)
    want = jcf._fwd(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(w), relu, True,
                    _j(b, (Co, 1)))
    got = cf.conv1x1_fwd_reference(_t(x), _t(s), _t(t), _t(w), relu, _t(b))
    assert got.dtype == torch.float32 and got.shape == (N, Co, M)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_dgrad_matches_pallas(affine, relu):
    N, Ci, Co, M = 2, 16, 24, 35
    x, w, dy, s, t, _ = _case(1, N, Ci, Co, M, affine)
    want = jcf._dgrad(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(w), _j(dy),
                      relu, True)
    got = cf.conv1x1_dgrad_reference(_t(x), _t(s), _t(t), _t(w), _t(dy),
                                     relu)
    assert got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_wgrad_matches_pallas(affine, relu):
    N, Ci, Co, M = 2, 16, 24, 35
    x, _, dy, s, t, _ = _case(2, N, Ci, Co, M, affine)
    want = jcf._wgrad(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(dy), relu,
                      True, jnp.float32)
    got = cf.conv1x1_wgrad_reference(_t(x), _t(s), _t(t), _t(dy), relu,
                                     torch.float32)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32_SUM)


def test_plain_versions_match_pallas_in_bf16():
    """bf16 x, w, dy: f(x) rounded to bf16 before the product in fwd and
    wgrad, the output rounded once; dgrad's f32 output sums exact
    products."""
    N, Ci, Co, M = 2, 32, 16, 50
    x, w, dy, s, t, b = _case(3, N, Ci, Co, M, True, True)
    bf = jnp.bfloat16
    jx, jw, jdy = _j(x, dtype=bf), _j(w, dtype=bf), _j(dy, dtype=bf)
    tx, tw, tdy = (_t(a, torch.bfloat16) for a in (x, w, dy))
    js, jt = _j(s, (Ci, 1)), _j(t, (Ci, 1))
    y = cf.conv1x1_fwd_reference(tx, _t(s), _t(t), tw, True, _t(b))
    assert y.dtype == torch.bfloat16
    onp.testing.assert_allclose(
        y.float().numpy(),
        onp.asarray(jcf._fwd(jx, js, jt, jw, True, True, _j(b, (Co, 1))),
                    "float32"), rtol=8e-3, atol=1e-2)
    da = cf.conv1x1_dgrad_reference(tx, _t(s), _t(t), tw, tdy, True)
    onp.testing.assert_allclose(
        da.numpy(), onp.asarray(jcf._dgrad(jx, js, jt, jw, jdy, True, True)),
        **F32)
    dw = cf.conv1x1_wgrad_reference(tx, _t(s), _t(t), tdy, True,
                                    torch.bfloat16)
    assert dw.dtype == torch.bfloat16
    onp.testing.assert_allclose(
        dw.float().numpy(),
        onp.asarray(jcf._wgrad(jx, js, jt, jdy, True, True, bf), "float32"),
        rtol=8e-3, atol=1e-2)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_op_and_gradients_match_jax(affine, relu, bias):
    """fused_prologue_conv1x1's output and its gradients in x, w, scale,
    shift and bias (loss sum(sin(y))) through the port's autograd Function
    against jax.grad through the JAX package's custom VJP."""
    N, Ci, Co, H, W = 2, 16, 24, 5, 7
    x, w, _, s, t, b = _case(4, N, Ci, Co, H * W, affine, bias)
    x = x.reshape(N, Ci, H, W)
    w4 = w.reshape(Co, Ci, 1, 1)

    def jloss(x, w, s, t, b):
        return jnp.sum(jnp.sin(jcf.fused_prologue_conv1x1(x, w, s, t, relu,
                                                          b)))

    args = [_j(a) for a in (x, w4, s, t, b)]
    live = [i for i, a in enumerate(args) if a is not None]
    jy = jcf.fused_prologue_conv1x1(*args[:4], relu, args[4])
    jg = jax.grad(lambda *a: jloss(*[dict(zip(live, a)).get(i)
                                     for i in range(5)]),
                  argnums=tuple(range(len(live))))(*[args[i] for i in live])

    targs = [None if a is None else _t(a).requires_grad_(True)
             for a in (x, w4, s, t, b)]
    ty = cf.fused_prologue_conv1x1(*targs[:4], relu, targs[4])
    torch.sin(ty).sum().backward()
    onp.testing.assert_allclose(ty.detach().numpy(), onp.asarray(jy), **F32)
    for i, g in zip(live, jg):
        onp.testing.assert_allclose(targs[i].grad.numpy(), onp.asarray(g),
                                    rtol=1e-4, atol=1e-4, err_msg=str(i))


def test_nondivisible_channels():
    """Ci and Co that do not divide the JAX kernels' blocks (48 % 32, 80 %
    32) nor the Hopper kernels' 64-wide tiles, and a ragged M."""
    N, Ci, Co, M = 2, 48, 80, 33
    x, w, dy, s, t, _ = _case(5, N, Ci, Co, M, False)
    kw = dict(block_co=32, block_m=16, block_ci=32)
    y = jcf._fwd(_j(x), None, None, _j(w), True, True, **kw)
    onp.testing.assert_allclose(
        cf.conv1x1_fwd_reference(_t(x), None, None, _t(w), True).numpy(),
        onp.asarray(y), **F32)
    da = jcf._dgrad(_j(x), None, None, _j(w), _j(dy), True, True, **kw)
    onp.testing.assert_allclose(
        cf.conv1x1_dgrad_reference(_t(x), None, None, _t(w), _t(dy),
                                   True).numpy(), onp.asarray(da), **F32)
    dw = jcf._wgrad(_j(x), None, None, _j(dy), True, True, jnp.float32, **kw)
    onp.testing.assert_allclose(
        cf.conv1x1_wgrad_reference(_t(x), None, None, _t(dy), True,
                                   torch.float32).numpy(),
        onp.asarray(dw), **F32_SUM)


@pytest.mark.parametrize("affine", [True, False])
def test_wgrad_ragged_large_m(affine):
    """M = 4100 > 4096: the JAX wgrad tiles M by 512 with a ragged 4-lane
    last block masked on both operands; the sum must match and be finite."""
    N, Ci, Co, M = 1, 8, 8, 4100
    x, _, dy, s, t, _ = _case(12, N, Ci, Co, M, affine)
    dy = dy * 0.1
    want = jcf._wgrad(_j(x), _j(s, (Ci, 1)), _j(t, (Ci, 1)), _j(dy), True,
                      True, jnp.float32)
    got = cf.conv1x1_wgrad_reference(_t(x), _t(s), _t(t), _t(dy), True,
                                     torch.float32)
    assert torch.isfinite(got).all()
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), **F32_SUM)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU no kernel is launched: the counters stay where they are,
    and the result is the plain version's."""
    before = dict(cf.launches)
    x, w, _, s, t, b = _case(6, 2, 8, 8, 9, True, True)
    xt = _t(x).reshape(2, 8, 3, 3).requires_grad_(True)
    y = cf.fused_prologue_conv1x1(xt, _t(w), _t(s), _t(t), True, _t(b))
    y.sum().backward()
    assert cf.launches == before
    want = cf.conv1x1_fwd_reference(_t(x), _t(s), _t(t), _t(w), True, _t(b))
    assert torch.equal(y.detach().reshape(2, 8, 9), want)


@pytest.mark.parametrize("ci,co,m", [(64, 256, 3136), (128, 512, 784),
                                     (256, 1024, 196), (512, 2048, 49),
                                     (256, 64, 3136), (512, 128, 784),
                                     (1024, 256, 196), (2048, 512, 49)])
def test_wgrad_splits_fill_the_card(ci, co, m):
    """At ResNet-50's b128 junctions wgrad's split count puts about 528
    blocks in flight (never more splits than reduction steps), and is a
    pure function of the shape, so the partial sums add in one order."""
    n = 128
    tiles = -(-co // 64) * -(-ci // 64)
    for dtype, step in ((torch.bfloat16, 32), (torch.float32, 16)):
        s = cf.wgrad_splits(n, ci, co, m, dtype)
        assert s == cf.wgrad_splits(n, ci, co, m, dtype)
        assert 1 <= s <= n * -(-m // step)
        assert s * tiles >= min(528, n * -(-m // step) * tiles)
        assert (s - 1) * tiles < 528
