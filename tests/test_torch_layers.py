"""The port's layers and ops (mxnet_tpu_torch) against the JAX package on
the same numpy inputs and parameters, in f32.

Parameters go from the JAX block to the port block through
``load_jax_params``, keyed by ``collect_params()`` names.
"""
import numpy as onp
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops.transformer import _mask_to_bias as jax_mask_to_bias
from mxnet_tpu_torch import npx as tnpx
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops.transformer import _mask_to_bias

TOL = dict(rtol=1e-5, atol=1e-6)


def _params(block):
    return {k: p.data().asnumpy() for k, p in block.collect_params().items()}


def _pair(jblock, tblock, seed=0):
    mx.random.seed(seed)
    jblock.initialize(mx.init.Normal(0.5))
    load_jax_params(tblock, _params(jblock))
    return jblock, tblock


@pytest.mark.parametrize("flatten,shape", [(False, (2, 5, 8)),
                                           (True, (3, 2, 4)),
                                           (True, (4, 8))])
@pytest.mark.parametrize("activation", [None, "tanh"])
def test_dense(flatten, shape, activation):
    in_units = int(onp.prod(shape[1:])) if flatten else shape[-1]
    j, t = _pair(jnn.Dense(6, in_units=in_units, flatten=flatten,
                           activation=activation),
                 tnn.Dense(6, in_units=in_units, flatten=flatten,
                           activation=activation))
    x = onp.random.RandomState(1).normal(0, 1, shape).astype("float32")
    onp.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                                j(mx.np.array(x)).asnumpy(), **TOL)


def test_layer_norm_eps_1e12():
    j, t = _pair(jnn.LayerNorm(epsilon=1e-12, in_channels=16),
                 tnn.LayerNorm(epsilon=1e-12, in_channels=16))
    x = onp.random.RandomState(2).normal(3, 2, (2, 7, 16)).astype("float32")
    onp.testing.assert_allclose(t(torch.from_numpy(x)).detach().numpy(),
                                j(mx.np.array(x)).asnumpy(),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu(approximate):
    x = onp.random.RandomState(3).normal(0, 2, (4, 33)).astype("float32")
    want = mx.npx.gelu(mx.np.array(x), approximate=approximate).asnumpy()
    got = tnpx.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    onp.testing.assert_allclose(got, want, **TOL)


def test_embedding_and_take_positions():
    j, t = _pair(jnn.Embedding(20, 8), tnn.Embedding(20, 8))
    idx = onp.random.RandomState(4).randint(0, 20, (3, 5)).astype("int32")
    want = j(mx.np.array(idx)).asnumpy()
    got = t(torch.from_numpy(idx)).detach().numpy()
    onp.testing.assert_allclose(got, want, **TOL)
    pos = onp.array([[0, 4], [2, 2], [1, 3]], "int32")
    onp.testing.assert_allclose(
        tnpx.take_positions(torch.from_numpy(got), torch.from_numpy(pos))
        .numpy(),
        mx.npx.take_positions(mx.np.array(want), mx.np.array(pos))
        .asnumpy(), **TOL)


def test_dropout_is_identity_outside_training():
    x = torch.randn(4, 4)
    assert tnpx.dropout(x, 0.5) is x
    d = tnn.Dropout(0.5)
    assert not d.training and d(x) is x


B, TQ, TK = 3, 5, 5


@pytest.mark.parametrize("shape", [(B, TK), (TQ, TK), (B, TQ, TK),
                                   (B, 1, 1, TK), (1, 2, TQ, TK), (4, 7)])
@pytest.mark.parametrize("kind", ["bool", "float"])
def test_mask_to_bias_every_rank(shape, kind):
    """(B, Tk) key padding, (Tq, Tk) score mask, (B, Tq, Tk), rank 4; a
    (4, 7) mask with B=4 != Tq reads as key padding only when Tq == Tk."""
    batch, tq, tk = (4, 7, 7) if shape == (4, 7) else (B, TQ, TK)
    rng = onp.random.RandomState(5)
    m = rng.rand(*shape) > 0.4 if kind == "bool" \
        else rng.normal(0, 1, shape).astype("float32")
    want = onp.asarray(jax_mask_to_bias(jnp.asarray(m), jnp.float32,
                                        batch, tq, tk))
    got = _mask_to_bias(torch.from_numpy(m), torch.float32, batch, tq,
                        tk).numpy()
    assert got.shape == want.shape and got.ndim == 4
    onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mask_shape", [None, (2, 12), (2, 1, 1, 12),
                                        (12, 12)])
def test_multi_head_attention_with_mask(mask_shape):
    rng = onp.random.RandomState(6)
    q, k, v = (rng.normal(0, 1, (2, 12, 32)).astype("float32")
               for _ in range(3))
    mask = None
    if mask_shape is not None:
        mask = rng.rand(*mask_shape) > 0.3
        mask[..., 0] = True            # every query row sees a key
    want = mx.npx.multi_head_attention(
        mx.np.array(q), mx.np.array(k), mx.np.array(v), 4,
        mask=None if mask is None else mx.np.array(mask)).asnumpy()
    got = tnpx.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 4,
        mask=None if mask is None else torch.from_numpy(mask)).numpy()
    onp.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_initialize_is_seeded_and_keeps_param_inits():
    """initialize() draws from the caller's generator (same seed, same
    weights), and a parameter's own initializer wins over the default,
    as in the JAX package (LayerNorm gamma ones, beta zeros)."""
    from mxnet_tpu_torch import initializer

    def build(seed):
        net = tnn.HybridSequential()
        net.add(tnn.Dense(5, in_units=4), tnn.LayerNorm(in_channels=5))
        return net.initialize(generator=torch.Generator().manual_seed(seed),
                              device="cpu")

    a, b, c = build(1), build(1), build(2)
    pa, pb, pc = (n.collect_params() for n in (a, b, c))
    assert list(pa) == ["0.weight", "0.bias", "1.gamma", "1.beta"]
    pa, pb, pc = ({k: p.data() for k, p in d.items()} for d in (pa, pb, pc))
    torch.testing.assert_close(pa["0.weight"], pb["0.weight"])
    assert not torch.equal(pa["0.weight"], pc["0.weight"])
    assert pa["0.weight"].abs().max() <= 0.07          # Uniform(0.07)
    torch.testing.assert_close(pa["1.gamma"], torch.ones(5))
    torch.testing.assert_close(pa["1.beta"], torch.zeros(5))
    torch.testing.assert_close(pa["0.bias"], torch.zeros(5))
    x = initializer.Xavier()((6, 4), torch.Generator().manual_seed(0))
    assert x.abs().max() <= (3.0 / 5.0) ** 0.5
