"""The port's imperative NDArray front end against the JAX package.

Every public function of ``mxnet_tpu/ndarray/ops.py`` (aliases included) is
called through ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd`` on the same
numpy-made inputs, one parametrised case per op (a few ops have more than
one), on the CPU. Values, shapes and dtype names are compared.

Tolerances (per case, by kind):
- ``ulp``, elementwise: |port - jax| <= 1 ulp of the JAX value (torch's and
  XLA's CPU math libraries round differently in the last place). Where
  the two libraries' functions differ by more, the case says so and takes
  ``ulp4``: 4 ulp (``cbrt``: torch has no cube root, the port takes
  ``|x| ** (1/3)``; ``erfinv``, ``tan``, ``sinh``, ``tanh``, ``expm1``,
  ``log1p``, ``logaddexp``, ``arctanh``, ``arccosh``, ``rcbrt``: measured
  2-4 ulp apart). ``gamma`` and ``gammaln`` take ``ulp64``: XLA's float32
  ``lgamma`` is itself up to 57 ulp off a float64 evaluation on
  x in [2.5, 4] (torch's: 0.5 ulp), so the two agree to 64 ulp;
- ``red``, reductions and other sums: relative 1e-6 of the largest value;
- ``mm``, the matmul family: relative 1e-5 of the largest value;
- ``exact``: integer and boolean results, moves, gathers and sorts.

Also: gradients through ``autograd.record`` / ``backward`` for the
differentiable ops (relative 1e-5), ``grad_req='add'``, ``x.grad`` staying
the same object, writes never showing through another array (the JAX
package's immutability), and the random samplers' moments over 1e5 draws.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ndarray import ops as jops
from mxnet_tpu_torch.base import MXNetError

rng = onp.random.RandomState(0)
X = rng.uniform(-1, 1, (3, 4)).astype("float32")
Y = rng.uniform(-1, 1, (3, 4)).astype("float32")
P = rng.uniform(0.5, 2.0, (3, 4)).astype("float32")
U = rng.uniform(-0.9, 0.9, (3, 4)).astype("float32")
I = rng.randint(-5, 6, (3, 4)).astype("int32")
J = rng.randint(1, 6, (3, 4)).astype("int32")
B = rng.uniform(size=(3, 4)) > 0.5
C = rng.uniform(size=(3, 4)) > 0.5
V = rng.uniform(-1, 1, (5,)).astype("float32")
W = rng.uniform(-1, 1, (5,)).astype("float32")
M = rng.uniform(-1, 1, (4, 5)).astype("float32")
T3 = rng.uniform(-1, 1, (2, 3, 4)).astype("float32")
T3b = rng.uniform(-1, 1, (2, 4, 5)).astype("float32")
SQ = rng.uniform(-1, 1, (4, 4)).astype("float32")
IMG = rng.uniform(-1, 1, (2, 8, 4, 6)).astype("float32")
IDX = onp.array([[0, 2], [1, 3]], "int32")
SORTED = onp.sort(rng.uniform(-1, 1, 6)).astype("float32")
TIES = onp.array([[3, 1, 3, 2, 1], [0, 0, 5, 5, 1]], "float32")
NANS = onp.array([onp.nan, onp.inf, -onp.inf, 1.5], "float32")


def _binary(name, tol="ulp", a=X, b=Y):
    return [(name, tol, lambda nd: getattr(nd, name)(nd.array(a),
                                                     nd.array(b))),
            (f"{name}-scalar", tol,
             lambda nd: getattr(nd, name)(nd.array(a), 0.5)),
            (f"{name}-rscalar", tol,
             lambda nd: getattr(nd, name)(1.5, nd.array(b)))]


def _unary(name, tol="ulp", a=X):
    return [(name, tol, lambda nd: getattr(nd, name)(nd.array(a)))]


CASES = [
    # creation
    ("array", "exact", lambda nd: nd.array(X.astype("float64"))),
    ("array-int64", "exact", lambda nd: nd.array(onp.arange(5))),
    ("asarray", "exact", lambda nd: nd.asarray([[1, 2], [3, 4]])),
    ("zeros", "exact", lambda nd: nd.zeros((2, 3))),
    ("ones", "exact", lambda nd: nd.ones(4, dtype="int32")),
    ("full", "exact", lambda nd: nd.full((2, 2), 7.5)),
    ("empty", "exact", lambda nd: nd.empty((2, 2))),
    ("arange", "exact", lambda nd: nd.arange(2, 11, 3)),
    ("arange-int", "exact", lambda nd: nd.arange(5, dtype="int32")),
    ("linspace", "ulp", lambda nd: nd.linspace(-1, 2, 7)),
    ("linspace-open", "ulp", lambda nd: nd.linspace(0, 1, 5, endpoint=False)),
    ("eye", "exact", lambda nd: nd.eye(3, 4, k=1)),
    ("zeros_like", "exact", lambda nd: nd.zeros_like(nd.array(I))),
    ("ones_like", "exact", lambda nd: nd.ones_like(nd.array(X), dtype="int32")),
    ("full_like", "exact", lambda nd: nd.full_like(nd.array(X), 2.5)),
    # unary
    *_unary("negative"),
    *_unary("abs"), *_unary("absolute", "exact", I), *_unary("sign"),
    *_unary("rint", a=X * 3), *_unary("floor", a=X * 3),
    *_unary("ceil", a=X * 3), *_unary("trunc", a=X * 3),
    *_unary("fix", a=X * 3), *_unary("square"), *_unary("sqrt", a=P),
    *_unary("cbrt", "ulp4"), *_unary("exp"), *_unary("expm1", "ulp4"),
    *_unary("log", a=P), *_unary("log2", a=P), *_unary("log10", a=P),
    *_unary("log1p", "ulp4", a=P), *_unary("sin"), *_unary("cos"),
    *_unary("tan", "ulp4"), *_unary("arcsin", a=U), *_unary("arccos", a=U),
    *_unary("arctan"), *_unary("sinh", "ulp4"), *_unary("cosh"), *_unary("tanh", "ulp4"),
    *_unary("arcsinh"), *_unary("arccosh", "ulp4", a=P + 1),
    *_unary("arctanh", "ulp4", a=U), *_unary("degrees"), *_unary("radians"),
    *_unary("reciprocal", a=P), *_unary("logical_not", "exact", B),
    *_unary("isnan", "exact", NANS), *_unary("isinf", "exact", NANS),
    *_unary("isfinite", "exact", NANS), *_unary("erf"),
    *_unary("erfinv", "ulp4", a=U), *_unary("gamma", "ulp64", a=P + 2),
    *_unary("gammaln", "ulp64", a=P + 2), *_unary("sigmoid"), *_unary("relu"),
    *_unary("softsign"), *_unary("rsqrt", a=P), *_unary("rcbrt", "ulp4", a=P),
    ("round", "ulp", lambda nd: nd.round(nd.array(X * 10), 1)),
    ("sqrt-int", "ulp", lambda nd: nd.sqrt(nd.array(J))),
    # binary
    *_binary("add"), *_binary("subtract"), *_binary("multiply"),
    *_binary("divide"), *_binary("true_divide"),
    ("floor_divide", "ulp", lambda nd: nd.floor_divide(nd.array(X * 5),
                                                       nd.array(P))),
    ("floor_divide-int", "exact",
     lambda nd: nd.floor_divide(nd.array(I), nd.array(J))),
    ("mod", "ulp", lambda nd: nd.mod(nd.array(X * 5), nd.array(P))),
    ("mod-int", "exact", lambda nd: nd.mod(nd.array(I), 3)),
    ("fmod", "ulp", lambda nd: nd.fmod(nd.array(X * 5), nd.array(P))),
    ("remainder", "ulp", lambda nd: nd.remainder(nd.array(X * 5), 0.7)),
    ("power", "ulp", lambda nd: nd.power(nd.array(P), nd.array(X))),
    ("power-scalar", "ulp", lambda nd: nd.power(nd.array(X), 2)),
    ("power-int", "exact", lambda nd: nd.power(nd.array(J), 2)),
    *_binary("maximum"), *_binary("minimum"), *_binary("fmax", "exact"),
    *_binary("fmin", "exact"), *_binary("hypot"), *_binary("arctan2"),
    *_binary("logaddexp", "ulp4"), *_binary("copysign", "exact"),
    *_binary("equal", "exact"), *_binary("not_equal", "exact"),
    *_binary("less", "exact"), *_binary("less_equal", "exact"),
    *_binary("greater", "exact"), *_binary("greater_equal", "exact"),
    ("logical_and", "exact", lambda nd: nd.logical_and(nd.array(B),
                                                       nd.array(C))),
    ("logical_or", "exact", lambda nd: nd.logical_or(nd.array(B),
                                                     nd.array(C))),
    ("logical_xor", "exact", lambda nd: nd.logical_xor(nd.array(B),
                                                       nd.array(C))),
    ("add-int-float", "ulp", lambda nd: nd.add(nd.array(I), nd.array(X))),
    ("add-int-scalar", "exact", lambda nd: nd.add(nd.array(I), 3)),
    ("multiply-int-fscalar", "ulp", lambda nd: nd.multiply(nd.array(I), 2.5)),
    ("divide-int", "ulp", lambda nd: nd.divide(nd.array(I), nd.array(J))),
    ("add-bool-scalar", "exact", lambda nd: nd.add(nd.array(B), 1)),
    ("clip", "exact", lambda nd: nd.clip(nd.array(X), -0.5, 0.25)),
    ("clip-int", "exact", lambda nd: nd.clip(nd.array(I), 0, 3)),
    ("where", "exact", lambda nd: nd.where(nd.array(B), nd.array(X),
                                           nd.array(Y))),
    ("where-scalar", "exact", lambda nd: nd.where(nd.array(B), nd.array(X),
                                                  0.0)),
    ("where-idx", "exact", lambda nd: nd.where(nd.array(B))),
    # reductions
    ("sum", "red", lambda nd: nd.sum(nd.array(X))),
    ("sum-axis", "red", lambda nd: nd.sum(nd.array(T3), axis=(0, 2),
                                          keepdims=True)),
    ("sum-int", "exact", lambda nd: nd.sum(nd.array(I), axis=1)),
    ("sum-bool", "exact", lambda nd: nd.sum(nd.array(B))),
    ("mean", "red", lambda nd: nd.mean(nd.array(T3), axis=1)),
    ("mean-int", "red", lambda nd: nd.mean(nd.array(I))),
    ("prod", "red", lambda nd: nd.prod(nd.array(P), axis=0)),
    ("prod-axes", "red", lambda nd: nd.prod(nd.array(T3), axis=(0, 2))),
    ("prod-all", "red", lambda nd: nd.prod(nd.array(P))),
    ("max", "exact", lambda nd: nd.max(nd.array(T3), axis=(1, 2))),
    ("min", "exact", lambda nd: nd.min(nd.array(X), axis=0, keepdims=True)),
    ("amax", "exact", lambda nd: nd.amax(nd.array(I))),
    ("amin", "exact", lambda nd: nd.amin(nd.array(X), axis=1)),
    ("all", "exact", lambda nd: nd.all(nd.array(B), axis=1)),
    ("any", "exact", lambda nd: nd.any(nd.array(B))),
    ("var", "red", lambda nd: nd.var(nd.array(T3), axis=2)),
    ("var-ddof", "red", lambda nd: nd.var(nd.array(X), ddof=1)),
    ("std", "red", lambda nd: nd.std(nd.array(X), axis=0, keepdims=True)),
    ("argmax", "exact", lambda nd: nd.argmax(nd.array(X), axis=1)),
    ("argmax-all", "exact", lambda nd: nd.argmax(nd.array(T3))),
    ("argmin", "exact", lambda nd: nd.argmin(nd.array(T3), axis=0,
                                             keepdims=True)),
    ("norm", "red", lambda nd: nd.norm(nd.array(X))),
    ("norm-3d", "red", lambda nd: nd.norm(nd.array(T3))),
    ("norm-axis", "red", lambda nd: nd.norm(nd.array(X), ord=1, axis=1)),
    ("cumsum", "red", lambda nd: nd.cumsum(nd.array(X), axis=1)),
    ("cumsum-flat-int", "exact", lambda nd: nd.cumsum(nd.array(I))),
    ("cumprod", "red", lambda nd: nd.cumprod(nd.array(P), axis=0)),
    ("logsumexp", "red", lambda nd: nd.logsumexp(nd.array(T3), axis=2)),
    # shape and layout
    ("reshape", "exact", lambda nd: nd.reshape(nd.array(T3), (4, -1))),
    ("transpose", "exact", lambda nd: nd.transpose(nd.array(T3))),
    ("transpose-axes", "exact", lambda nd: nd.transpose(nd.array(T3),
                                                        (1, 0, 2))),
    ("swapaxes", "exact", lambda nd: nd.swapaxes(nd.array(T3), 0, 2)),
    ("moveaxis", "exact", lambda nd: nd.moveaxis(nd.array(T3), 0, -1)),
    ("expand_dims", "exact", lambda nd: nd.expand_dims(nd.array(X), 1)),
    ("squeeze", "exact", lambda nd: nd.squeeze(nd.array(X[None, :, None]))),
    ("broadcast_to", "exact", lambda nd: nd.broadcast_to(nd.array(V),
                                                         (3, 5))),
    ("ravel", "exact", lambda nd: nd.ravel(nd.array(T3))),
    ("flatten", "exact", lambda nd: nd.flatten(nd.array(T3))),
    ("concatenate", "exact", lambda nd: nd.concatenate(
        [nd.array(X), nd.array(Y)], axis=1)),
    ("concat", "exact", lambda nd: nd.concat(nd.array(X), nd.array(Y), dim=0)),
    ("stack", "exact", lambda nd: nd.stack([nd.array(X), nd.array(Y)],
                                           axis=1)),
    ("split", "exact", lambda nd: nd.split(nd.array(T3), 2, axis=2)),
    ("split-indices", "exact", lambda nd: nd.split(nd.array(X), [1, 3],
                                                   axis=1)),
    ("slice_channel", "exact", lambda nd: nd.slice_channel(
        nd.array(T3), 3, axis=1, squeeze_axis=True)),
    ("array_split", "exact", lambda nd: nd.array_split(nd.array(V), 3)),
    ("tile", "exact", lambda nd: nd.tile(nd.array(X), (2, 1))),
    ("repeat", "exact", lambda nd: nd.repeat(nd.array(X), 2, axis=0)),
    ("flip", "exact", lambda nd: nd.flip(nd.array(T3), 1)),
    ("roll", "exact", lambda nd: nd.roll(nd.array(X), 2, axis=1)),
    ("pad", "exact", lambda nd: nd.pad(nd.array(X), ((1, 0), (2, 1)),
                                       constant_values=3.0)),
    ("pad-reflect", "exact", lambda nd: nd.pad(nd.array(X), 1,
                                               mode="reflect")),
    ("pad-edge", "exact", lambda nd: nd.pad(nd.array(X), ((0, 2), (1, 1)),
                                            mode="edge")),
    ("slice_axis", "exact", lambda nd: nd.slice_axis(nd.array(T3), 2, 1, -1)),
    ("slice_like", "exact", lambda nd: nd.slice_like(nd.array(T3),
                                                     nd.array(T3[:1, :2, :3]),
                                                     axes=(1, 2))),
    ("atleast_1d", "exact", lambda nd: nd.atleast_1d(nd.array(2.0))),
    ("atleast_2d", "exact", lambda nd: nd.atleast_2d(nd.array(V))),
    ("tril", "exact", lambda nd: nd.tril(nd.array(SQ), -1)),
    ("triu", "exact", lambda nd: nd.triu(nd.array(SQ), 1)),
    ("diag", "exact", lambda nd: nd.diag(nd.array(SQ), 1)),
    ("diag-1d", "exact", lambda nd: nd.diag(nd.array(V))),
    # indexing
    ("take", "exact", lambda nd: nd.take(nd.array(X), nd.array(IDX),
                                         axis=1)),
    ("take-clip", "exact", lambda nd: nd.take(nd.array(V),
                                              nd.array([-2, 0, 9]))),
    ("take-wrap", "exact", lambda nd: nd.take(nd.array(X), nd.array([4, -1]),
                                              axis=1, mode="wrap")),
    ("take_along_axis", "exact", lambda nd: nd.take_along_axis(
        nd.array(X), nd.array(onp.argsort(X, axis=1).astype("int32")), 1)),
    ("gather_nd", "exact", lambda nd: nd.gather_nd(nd.array(X),
                                                   nd.array(IDX))),
    ("scatter_nd", "exact", lambda nd: nd.scatter_nd(
        nd.array([1.0, 2.0, 3.0]), nd.array([[0, 1, 0], [2, 0, 2]]), (2, 3))),
    ("one_hot", "exact", lambda nd: nd.one_hot(nd.array([0, 2, 1, 5]), 3,
                                               on_value=2.0,
                                               off_value=-1.0)),
    ("unique", "exact", lambda nd: nd.unique(nd.array(I), return_counts=True,
                                             return_inverse=True)),
    ("nonzero", "exact", lambda nd: nd.nonzero(nd.array(I))),
    ("boolean_mask", "exact", lambda nd: nd.boolean_mask(nd.array(X),
                                                         nd.array(B))),
    # ordering
    ("sort", "exact", lambda nd: nd.sort(nd.array(X))),
    ("sort-desc", "exact", lambda nd: nd.sort(nd.array(T3), axis=1,
                                              is_ascend=False)),
    ("argsort", "exact", lambda nd: nd.argsort(nd.array(TIES))),
    ("argsort-desc", "exact", lambda nd: nd.argsort(nd.array(TIES),
                                                    is_ascend=False,
                                                    dtype="int32")),
    ("topk", "exact", lambda nd: nd.topk(nd.array(TIES), k=3)),
    ("topk-both", "exact", lambda nd: nd.topk(nd.array(TIES), axis=0, k=1,
                                              ret_typ="both")),
    ("topk-asc-value", "exact", lambda nd: nd.topk(
        nd.array(TIES), k=2, ret_typ="value", is_ascend=True)),
    ("searchsorted", "exact", lambda nd: nd.searchsorted(
        nd.array(SORTED), nd.array(V))),
    ("searchsorted-right", "exact", lambda nd: nd.searchsorted(
        nd.array(SORTED), nd.array(SORTED[1:3]), side="right")),
    # linear algebra
    ("dot", "mm", lambda nd: nd.dot(nd.array(X), nd.array(M))),
    ("dot-1d", "mm", lambda nd: nd.dot(nd.array(V), nd.array(W))),
    ("dot-3d", "mm", lambda nd: nd.dot(nd.array(T3), nd.array(M))),
    ("matmul", "mm", lambda nd: nd.matmul(nd.array(T3), nd.array(T3b))),
    ("batch_dot", "mm", lambda nd: nd.batch_dot(nd.array(T3), nd.array(T3),
                                                transpose_b=True)),
    ("tensordot", "mm", lambda nd: nd.tensordot(nd.array(T3), nd.array(T3b),
                                                axes=([0, 2], [0, 1]))),
    ("einsum", "mm", lambda nd: nd.einsum("bij,bjk->bik", nd.array(T3),
                                          nd.array(T3b))),
    ("inner", "mm", lambda nd: nd.inner(nd.array(X), nd.array(Y))),
    ("outer", "mm", lambda nd: nd.outer(nd.array(V), nd.array(W))),
    ("kron", "mm", lambda nd: nd.kron(nd.array(X[:2, :2]), nd.array(SQ))),
    ("vdot", "mm", lambda nd: nd.vdot(nd.array(X), nd.array(Y))),
    ("trace", "mm", lambda nd: nd.trace(nd.array(SQ), 1)),
    # misc
    ("cast", "exact", lambda nd: nd.cast(nd.array(X * 5), "int32")),
    ("astype", "exact", lambda nd: nd.astype(nd.array(I), "float16")),
    ("cast-bf16", "exact", lambda nd: nd.cast(nd.array(X), "bfloat16")),
    ("identity", "exact", lambda nd: nd.identity(nd.array(X))),
    ("identity-bool", "exact", lambda nd: nd.identity(nd.array(B))),
    ("stop_gradient", "exact", lambda nd: nd.stop_gradient(nd.array(X))),
    ("BlockGrad", "exact", lambda nd: nd.BlockGrad(nd.array(X))),
    ("add_n", "red", lambda nd: nd.add_n(nd.array(X), nd.array(Y),
                                         nd.array(P))),
    ("ElementWiseSum", "red", lambda nd: nd.ElementWiseSum(
        [nd.array(X), nd.array(Y)])),
    ("maximum_n", "exact", lambda nd: nd.maximum_n(nd.array(X), nd.array(Y),
                                                   nd.array(U))),
    ("isclose", "exact", lambda nd: nd.isclose(nd.array(X),
                                               nd.array(X + 1e-7))),
    ("nan_to_num", "exact", lambda nd: nd.nan_to_num(nd.array(NANS),
                                                     posinf=9.0)),
    ("diff", "ulp", lambda nd: nd.diff(nd.array(X), 2)),
    ("meshgrid", "exact", lambda nd: nd.meshgrid(nd.array(V), nd.array(W[:3]),
                                                 indexing="ij")),
    ("histogram", "ulp", lambda nd: nd.histogram(nd.array(X), bins=4)),
    ("histogram-range", "ulp", lambda nd: nd.histogram(
        nd.array(X), bins=3, range=(-0.5, 0.5))),
    ("interp", "ulp", lambda nd: nd.interp(nd.array(V * 1.5),
                                           nd.array(SORTED),
                                           nd.array(SORTED * 2 + 1))),
    ("waitall", "exact", lambda nd: nd.waitall()),
    # legacy names
    ("broadcast_add", "ulp", lambda nd: nd.broadcast_add(nd.array(X),
                                                         nd.array(V[:4]))),
    ("broadcast_plus", "ulp", lambda nd: nd.broadcast_plus(nd.array(X), 1.0)),
    ("broadcast_sub", "ulp", lambda nd: nd.broadcast_sub(nd.array(X),
                                                         nd.array(Y[:1]))),
    ("broadcast_minus", "ulp", lambda nd: nd.broadcast_minus(nd.array(X),
                                                             nd.array(Y))),
    ("broadcast_mul", "ulp", lambda nd: nd.broadcast_mul(nd.array(X),
                                                         nd.array(Y))),
    ("broadcast_div", "ulp", lambda nd: nd.broadcast_div(nd.array(X),
                                                         nd.array(P))),
    ("broadcast_mod", "ulp", lambda nd: nd.broadcast_mod(nd.array(X),
                                                         nd.array(P))),
    ("broadcast_power", "ulp", lambda nd: nd.broadcast_power(nd.array(P),
                                                             nd.array(Y))),
    ("broadcast_maximum", "exact", lambda nd: nd.broadcast_maximum(
        nd.array(X), nd.array(Y))),
    ("broadcast_minimum", "exact", lambda nd: nd.broadcast_minimum(
        nd.array(X), nd.array(Y))),
    ("broadcast_equal", "exact", lambda nd: nd.broadcast_equal(
        nd.array(I), nd.array(J))),
    ("broadcast_not_equal", "exact", lambda nd: nd.broadcast_not_equal(
        nd.array(I), nd.array(J))),
    ("broadcast_greater", "exact", lambda nd: nd.broadcast_greater(
        nd.array(X), nd.array(Y))),
    ("broadcast_greater_equal", "exact", lambda nd: nd.broadcast_greater_equal(
        nd.array(I), nd.array(J))),
    ("broadcast_lesser", "exact", lambda nd: nd.broadcast_lesser(
        nd.array(X), nd.array(Y))),
    ("broadcast_lesser_equal", "exact", lambda nd: nd.broadcast_lesser_equal(
        nd.array(I), nd.array(J))),
    ("broadcast_logical_and", "exact", lambda nd: nd.broadcast_logical_and(
        nd.array(B), nd.array(C))),
    ("broadcast_logical_or", "exact", lambda nd: nd.broadcast_logical_or(
        nd.array(B), nd.array(C))),
    ("broadcast_logical_xor", "exact", lambda nd: nd.broadcast_logical_xor(
        nd.array(B), nd.array(C))),
    ("elemwise_add", "ulp", lambda nd: nd.elemwise_add(nd.array(X),
                                                       nd.array(Y))),
    ("elemwise_sub", "ulp", lambda nd: nd.elemwise_sub(nd.array(X),
                                                       nd.array(Y))),
    ("elemwise_mul", "ulp", lambda nd: nd.elemwise_mul(nd.array(X),
                                                       nd.array(Y))),
    ("elemwise_div", "ulp", lambda nd: nd.elemwise_div(nd.array(X),
                                                       nd.array(P))),
    ("broadcast_axis", "exact", lambda nd: nd.broadcast_axis(
        nd.array(X[:, :1]), axis=1, size=5)),
    ("broadcast_axes", "exact", lambda nd: nd.broadcast_axes(
        nd.array(T3[:1, :, :1]), axis=(0, 2), size=(3, 2))),
    ("broadcast_like", "exact", lambda nd: nd.broadcast_like(
        nd.array(V[:4]), nd.array(X))),
    ("broadcast_like-axes", "exact", lambda nd: nd.broadcast_like(
        nd.array(X[:1]), nd.array(T3), lhs_axes=(0,), rhs_axes=(1,))),
    ("reshape_like", "exact", lambda nd: nd.reshape_like(nd.array(X),
                                                         nd.array(I.T))),
    ("reverse", "exact", lambda nd: nd.reverse(nd.array(T3), (0, 2))),
    ("slice", "exact", lambda nd: nd.slice(nd.array(T3), (0, 1, 0),
                                           (2, 3, 4), (1, 1, 2))),
    ("slice-negative-step", "exact", lambda nd: nd.slice(
        nd.array(X), (2, 3), (None, None), (-1, -2))),
    ("softmin", "ulp", lambda nd: nd.softmin(nd.array(X))),
    ("moments", "red", lambda nd: nd.moments(nd.array(T3), axes=(0, 2))),
    ("shape_array", "exact", lambda nd: nd.shape_array(nd.array(T3))),
    ("size_array", "exact", lambda nd: nd.size_array(nd.array(T3))),
    ("batch_take", "exact", lambda nd: nd.batch_take(nd.array(X),
                                                     nd.array([3, 0, 2]))),
    ("grid_generator", "red", lambda nd: nd.grid_generator(
        nd.array(X[:2, :3].reshape(1, 6)), "affine", (3, 5))),
    ("grid_generator-warp", "red", lambda nd: nd.grid_generator(
        nd.array(IMG[:, :2]), "warp")),
    ("bilinear_sampler", "red", lambda nd: nd.bilinear_sampler(
        nd.array(IMG), nd.array(IMG[:, :2] * 1.1))),
    ("depth_to_space", "exact", lambda nd: nd.depth_to_space(nd.array(IMG),
                                                             2)),
    ("space_to_depth", "exact", lambda nd: nd.space_to_depth(nd.array(IMG),
                                                             2)),
    ("spatial_transformer", "red", lambda nd: nd.spatial_transformer(
        nd.array(IMG), nd.array(onp.tile([[1.0, 0.1, 0.0, -0.1, 0.9, 0.2]],
                                         (2, 1)).astype("float32")),
        target_shape=(3, 5))),
    ("khatri_rao", "mm", lambda nd: nd.khatri_rao(nd.array(X),
                                                  nd.array(Y[:2]))),
]
# shuffle is random: it is held to being a permutation of the rows
RANDOM_OPS = {"shuffle"}

ULP = {"ulp": 1, "ulp4": 4, "ulp64": 64}
REL = {"red": 1e-6, "mm": 1e-5}


def _flat(r):
    if r is None:
        return []
    return list(r) if isinstance(r, (tuple, list)) else [r]


def _compare(got, want, tol, what):
    g_list, w_list = _flat(got), _flat(want)
    assert len(g_list) == len(w_list), what
    for g, w in zip(g_list, w_list):
        assert str(g.dtype) == str(w.dtype), f"{what}: dtype {g.dtype} vs {w.dtype}"
        gn = g.asnumpy()
        wn = onp.asarray(w.asnumpy(), dtype="float32") \
            if str(w.dtype) == "bfloat16" else w.asnumpy()
        assert gn.shape == wn.shape, f"{what}: shape {gn.shape} vs {wn.shape}"
        if tol == "exact" or wn.dtype.kind in "biu":
            onp.testing.assert_array_equal(gn, wn, err_msg=what)
        elif tol in ULP:
            assert (onp.isnan(gn) == onp.isnan(wn)).all(), what
            ok = ~onp.isnan(wn)
            err = onp.abs(gn[ok].astype("float64") - wn[ok])
            lim = ULP[tol] * onp.spacing(onp.abs(wn[ok]).astype(wn.dtype))
            assert (err <= lim).all(), \
                f"{what}: {(err / onp.spacing(onp.abs(wn[ok]))).max():.1f} ulp"
        else:
            scale = float(onp.abs(wn).max()) if wn.size else 0.0
            onp.testing.assert_allclose(gn, wn, rtol=REL[tol],
                                        atol=REL[tol] * scale, err_msg=what)


@pytest.mark.parametrize("name,tol,fn", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(name, tol, fn):
    want = fn(jmx.nd)
    with tmx.cpu():
        got = fn(tmx.nd)
    _compare(got, want, tol, name)


def test_every_op_has_a_case():
    covered = {c[0].split("-")[0] for c in CASES} | RANDOM_OPS
    missing = sorted(set(jops.__all__) - covered)
    assert not missing, missing
    assert sorted(tmx.nd.ops.__all__) == sorted(jops.__all__)


def test_shuffle_permutes_rows():
    tmx.random.seed(3)
    with tmx.cpu():
        x = tmx.nd.array(onp.arange(40, dtype="float32").reshape(20, 2))
        y = tmx.nd.shuffle(x)
        z = tmx.nd.shuffle(x)
    yn = y.asnumpy()
    assert not (yn == x.asnumpy()).all() and not (yn == z.asnumpy()).all()
    onp.testing.assert_array_equal(onp.sort(yn, axis=0), x.asnumpy())
    tmx.random.seed(3)
    with tmx.cpu():
        onp.testing.assert_array_equal(tmx.nd.shuffle(x).asnumpy(), yn)


# ---------------------------------------------------------------------------
# gradients through record / backward
# ---------------------------------------------------------------------------

GRAD_CASES = [
    ("negative", X, lambda nd, x: nd.negative(x)),
    ("abs", X, lambda nd, x: nd.abs(x)),
    ("square", X, lambda nd, x: nd.square(x)),
    ("sqrt", P, lambda nd, x: nd.sqrt(x)),
    ("exp", X, lambda nd, x: nd.exp(x)),
    ("log", P, lambda nd, x: nd.log(x)),
    ("sin", X, lambda nd, x: nd.sin(x)),
    ("tanh", X, lambda nd, x: nd.tanh(x)),
    ("sigmoid", X, lambda nd, x: nd.sigmoid(x)),
    ("relu", X, lambda nd, x: nd.relu(x)),
    ("erf", X, lambda nd, x: nd.erf(x)),
    ("softsign", X, lambda nd, x: nd.softsign(x)),
    ("add", X, lambda nd, x: x + nd.array(Y)),
    ("multiply", X, lambda nd, x: x * nd.array(Y) * 3.0),
    ("divide", P, lambda nd, x: nd.array(Y) / x),
    ("power", P, lambda nd, x: x ** 1.5),
    ("maximum", X, lambda nd, x: nd.maximum(x, nd.array(Y))),
    ("sum", T3, lambda nd, x: nd.sum(x, axis=(0, 2))),
    ("mean", T3, lambda nd, x: nd.mean(x, axis=1)),
    ("prod", P, lambda nd, x: nd.prod(x, axis=1)),
    ("max", X, lambda nd, x: nd.max(x, axis=0)),
    ("norm", X, lambda nd, x: nd.norm(x)),
    ("logsumexp", X, lambda nd, x: nd.logsumexp(x, axis=1)),
    ("cumsum", X, lambda nd, x: nd.cumsum(x, axis=1) * nd.array(Y)),
    ("reshape", T3, lambda nd, x: nd.reshape(x, (4, 6)) * nd.arange(6)),
    ("transpose", T3, lambda nd, x: nd.transpose(x) * nd.array(T3.T)),
    ("broadcast_to", V, lambda nd, x: nd.broadcast_to(x, (3, 5))),
    ("concatenate", X, lambda nd, x: nd.concatenate([x, x * 2], axis=1)),
    ("stack", X, lambda nd, x: nd.stack([x, nd.square(x)], axis=0)),
    ("split", X, lambda nd, x: nd.split(x, 2, axis=1)[1] * 2),
    ("tile", X, lambda nd, x: nd.tile(x, (2, 2)) * nd.arange(8)),
    ("repeat", X, lambda nd, x: nd.repeat(x, 3, axis=1) * nd.arange(12)),
    ("flip", X, lambda nd, x: nd.flip(x, 1) * nd.array(Y)),
    ("pad", X, lambda nd, x: nd.pad(x, 1) * nd.arange(6)),
    ("slice_axis", T3, lambda nd, x: nd.slice_axis(x, 2, 1, 3)),
    ("take", X, lambda nd, x: nd.take(x, nd.array([2, 2, 0]), axis=1)),
    ("gather_nd", X, lambda nd, x: nd.gather_nd(x, nd.array(IDX))),
    ("getitem", X, lambda nd, x: x[1:, ::2] * 5),
    ("dot", X, lambda nd, x: nd.dot(x, nd.array(M))),
    ("matmul", T3, lambda nd, x: nd.matmul(x, nd.array(T3b))),
    ("batch_dot", T3, lambda nd, x: nd.batch_dot(x, x, transpose_b=True)),
    ("einsum", T3, lambda nd, x: nd.einsum("bij,bjk->bik", x,
                                           nd.array(T3b))),
    ("clip", X, lambda nd, x: nd.clip(x, -0.5, 0.5)),
    ("where", X, lambda nd, x: nd.where(nd.array(B), x * 2, x * x)),
    ("softmin", X, lambda nd, x: nd.softmin(x) * nd.array(Y)),
    ("add_n", X, lambda nd, x: nd.add_n(x, x * x, nd.array(Y))),
]


def _grad(pkg, a, fn, grad_req="write"):
    nd = pkg.nd
    x = nd.array(a)
    x.attach_grad(grad_req)
    with pkg.autograd.record():
        y = fn(nd, x)
    y.backward()
    return x.grad.asnumpy()


@pytest.mark.parametrize("name,a,fn", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_gradient_matches_jax(name, a, fn):
    want = _grad(jmx, a, fn)
    with tmx.cpu():
        got = _grad(tmx, a, fn)
    onp.testing.assert_allclose(got, want, rtol=1e-5,
                                atol=1e-5 * onp.abs(want).max())


def test_grad_is_the_same_object_and_write_overwrites():
    with tmx.cpu():
        x = tmx.nd.array(X)
        x.attach_grad()
        g = x.grad
        for k in (1.0, 3.0):
            with tmx.autograd.record():
                y = (x * k).sum()
            y.backward()
            assert x.grad is g
            onp.testing.assert_array_equal(g.asnumpy(), onp.full_like(X, k))


def test_grad_req_add_accumulates_like_jax():
    def run(pkg):
        x = pkg.nd.array(X)
        x.attach_grad("add")
        g = x.grad
        for k in (1.0, 2.0, 0.5):
            with pkg.autograd.record():
                y = (x * x * k).sum()
            y.backward()
        assert x.grad is g
        return g.asnumpy()
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    onp.testing.assert_allclose(got, want, rtol=1e-6)


def test_head_outside_record_raises():
    with tmx.cpu():
        x = tmx.nd.array(X)
        x.attach_grad()
        y = (x * 2).sum()
        with pytest.raises(MXNetError, match="record"):
            y.backward()


def test_ops_outside_record_build_no_graph():
    with tmx.cpu():
        x = tmx.nd.array(X)
        x.attach_grad()
        y = x * 2
        assert not y._data.requires_grad and y._data.grad_fn is None
        with tmx.autograd.record():
            z = x * 2
            with tmx.autograd.pause():
                w = x * 2
        assert z._data.grad_fn is not None and w._data.grad_fn is None


def test_autograd_grad_and_mark_variables_match_jax():
    def run(pkg):
        x = pkg.nd.array(X)
        gbuf = pkg.nd.zeros(X.shape)
        pkg.autograd.mark_variables([x], [gbuf])
        with pkg.autograd.record():
            y = pkg.nd.sum(pkg.nd.exp(x) * x)
        g = pkg.autograd.grad(y, x, retain_graph=True)
        y.backward()
        return g.asnumpy(), x.grad.asnumpy(), x.grad is gbuf
    jg, jb, _ = run(jmx)
    with tmx.cpu():
        tg, tb, same = run(tmx)
    assert same
    onp.testing.assert_allclose(tg, jg, rtol=1e-6)
    onp.testing.assert_allclose(tb, jb, rtol=1e-6)


def test_backward_head_grads_and_tuple_heads():
    def run(pkg):
        x = pkg.nd.array(X)
        x.attach_grad()
        with pkg.autograd.record():
            a, b = x * 2, pkg.nd.sin(x)
        pkg.autograd.backward([a, b], [pkg.nd.array(Y), None])
        return x.grad.asnumpy()
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    onp.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# value semantics: no write shows through another array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda a: a[1:3],
    lambda a: a.reshape(2, 6),
    lambda a: a.T,
    lambda a: tmx.nd.transpose(a),
    lambda a: a.astype("float32"),
    lambda a: tmx.nd.stop_gradient(a),
    lambda a: tmx.nd.atleast_1d(a),
    lambda a: a.detach(),
], ids=["slice", "reshape", "T", "transpose", "astype-same", "stop_gradient",
        "atleast_1d", "detach"])
def test_a_write_never_shows_through_another_array(make):
    with tmx.cpu():
        a = tmx.nd.array(onp.arange(12, dtype="float32").reshape(3, 4))
        b = make(a)
        before = b.asnumpy().copy()
        a[1] = 7
        a += 1
        a[:, ::-1] = a.asnumpy()
        onp.testing.assert_array_equal(b.asnumpy(), before)
        c = b.copy()
        b[0] = -1
        assert a.asnumpy().min() >= 1 and c.asnumpy().min() >= 0


def test_numpy_input_is_copied_and_asnumpy_is_a_copy():
    src = X.copy()
    with tmx.cpu():
        a = tmx.nd.array(src)
        src[:] = 0
        out = a.asnumpy()
        out[:] = 5
        onp.testing.assert_array_equal(a.asnumpy(), X)


def test_setitem_and_getitem_match_jax():
    def run(pkg):
        a = pkg.nd.array(T3)
        a[0, 1] = 5.0
        a[:, :, ::-2] = 0.5
        a[1] = pkg.nd.array(X)
        a[pkg.nd.array([0]), 2] = -3.0
        idx = pkg.nd.array([[1, 0], [0, 1]])
        return [a.asnumpy(), a[1, ::-1].asnumpy(), a[idx].asnumpy(),
                a[..., 2].asnumpy(), a[:, None, 1].asnumpy()]
    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for g, w in zip(got, want):
        onp.testing.assert_array_equal(g, w)


def test_inplace_operators_keep_a_variable_a_variable():
    with tmx.cpu():
        x = tmx.nd.array(X)
        x.attach_grad()
        x += 1.0
        x *= 2.0
        with tmx.autograd.record():
            y = (x * x).sum()
        y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), 4 * (X + 1), rtol=1e-6)


def test_dtypes_follow_the_jax_package():
    with tmx.cpu():
        cases = {
            "arange": tmx.nd.arange(5),
            "argmax": tmx.nd.argmax(tmx.nd.array(X)),
            "randint": tmx.random.randint(0, 5, shape=(3,)),
            "float64 in": tmx.nd.array(onp.zeros(3)),
            "int64 in": tmx.nd.array(onp.zeros(3, "int64")),
            "python floats": tmx.nd.array([1.5, 2.5]),
            "sum int": tmx.nd.array(I).sum(),
            "bool + int": tmx.nd.array(B) + 1,
        }
        want = {"arange": "float32", "argmax": "int32", "randint": "int32",
                "float64 in": "float32", "int64 in": "int32",
                "python floats": "float32", "sum int": "int32",
                "bool + int": "int32"}
    assert {k: str(v.dtype) for k, v in cases.items()} == want
    assert str(jmx.nd.argmax(jmx.nd.array(X)).dtype) == "int32"


def test_bfloat16_arrays():
    with tmx.cpu():
        a = tmx.nd.array(X, dtype=tmx.np.bfloat16)
        assert a.dtype == "bfloat16"
        j = jmx.nd.array(X, dtype="bfloat16")
        onp.testing.assert_array_equal(
            a.asnumpy(), onp.asarray(j.asnumpy(), "float32"))
        onp.testing.assert_array_equal((a * 2).asnumpy(),
                                       onp.asarray((j * 2).asnumpy(),
                                                   "float32"))


def test_cpu_context_and_default_gpu_context():
    with tmx.cpu():
        a = tmx.nd.ones((2,))
    assert a.context == tmx.cpu() and a._data.device.type == "cpu"
    assert (a + 1).context == tmx.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            tmx.nd.ones((2,))


def test_registry_and_namespaces():
    assert tmx.nd.get_op("add") is tmx.nd.add
    assert "khatri_rao" in tmx.nd.list_ops()
    assert tmx.np.add is tmx.nd.add and tmx.np.ndarray is tmx.nd.NDArray
    for k in ("float16", "float32", "float64", "int8", "int32", "int64",
              "uint8", "bool_", "pi", "e", "inf", "nan", "newaxis",
              "bfloat16"):
        assert getattr(tmx.np, k) == getattr(jmx.np, k) or \
            (onp.isnan(getattr(tmx.np, k)) and onp.isnan(getattr(jmx.np, k)))


# ---------------------------------------------------------------------------
# random: distributional parity over 1e5 draws (threefry vs Philox)
# ---------------------------------------------------------------------------

N_DRAWS = 100_000

RANDOM_CASES = [
    ("uniform", lambda r: r.uniform(-1.0, 3.0, shape=(N_DRAWS,))),
    ("rand", lambda r: r.rand(N_DRAWS)),
    ("normal", lambda r: r.normal(0.5, 2.0, shape=(N_DRAWS,))),
    ("randn", lambda r: r.randn(N_DRAWS)),
    ("randint", lambda r: r.randint(-3, 7, shape=(N_DRAWS,))),
    ("bernoulli", lambda r: r.bernoulli(0.3, shape=(N_DRAWS,))),
    ("multinomial", lambda r: r.multinomial(
        r_nd(r).array([0.1, 0.2, 0.3, 0.4]), shape=N_DRAWS)),
]


def r_nd(r):
    return tmx.nd if r is tmx.random else jmx.nd


@pytest.mark.parametrize("name,fn", RANDOM_CASES,
                         ids=[c[0] for c in RANDOM_CASES])
def test_random_moments_match_jax(name, fn):
    jmx.random.seed(1)
    want = fn(jmx.random)
    tmx.random.seed(1)
    with tmx.cpu():
        got = fn(tmx.random)
    assert str(got.dtype) == str(want.dtype) and got.shape == want.shape
    g, w = got.asnumpy().astype("float64"), want.asnumpy().astype("float64")
    sd = max(w.std(), 1e-12)
    # two independent means of N draws: 6 standard errors apart at most
    assert abs(g.mean() - w.mean()) <= 6 * sd * onp.sqrt(2.0 / N_DRAWS)
    assert abs(g.var() / w.var() - 1) <= 0.03
    assert g.min() >= w.min() - 6 * sd and g.max() <= w.max() + 6 * sd


def test_random_streams_repeat_after_seed_and_ignore_torch_seed():
    with tmx.cpu():
        tmx.random.seed(7)
        a = tmx.random.normal(shape=(5,)).asnumpy()
        torch.manual_seed(123)
        tmx.random.seed(7)
        b = tmx.random.normal(shape=(5,)).asnumpy()
        c = tmx.random.normal(shape=(5,)).asnumpy()
    onp.testing.assert_array_equal(a, b)
    assert not (a == c).all()


def test_multinomial_get_prob():
    tmx.random.seed(0)
    with tmx.cpu():
        p = tmx.nd.array([[0.5, 0.5, 0.0], [0.0, 0.25, 0.75]])
        idx, logp = tmx.random.multinomial(p, shape=4, get_prob=True)
    assert idx.shape == (2, 4) and str(idx.dtype) == "int32"
    with onp.errstate(divide="ignore"):     # log(0): the two zero entries
        want = onp.log(p.asnumpy())[onp.arange(2)[:, None], idx.asnumpy()]
    onp.testing.assert_allclose(logp.asnumpy(), want, rtol=1e-6)
