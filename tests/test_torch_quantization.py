"""The port's int8 quantization operators (``ops/quantization.py``) and
``quantize_net`` (``contrib/quantization.py``) against the JAX package on
the CPU, on the same numpy inputs from a seed.

- Every operator on the same int8 / uint8 / int32 inputs and ranges:
  every integer output (the codes, the int32 accumulators with their
  rescaled bias, the pooled codes) equal to the bit: the int8 products are
  exact in both packages, and the f32 arithmetic around them is the same
  operations in the same order. The f32 outputs (the ranges, dequantized
  values) within 2^-22 of the array's largest magnitude (two ulps of it):
  the JAX package's eager f32 arithmetic on the CPU
  rounds a division by a constant either as a division or, where XLA
  compiles several operations together, as a product by the constant's
  reciprocal (which the port does), and contracts uint8 ``dequantize``'s
  ``q * scale + min`` into one fused multiply-add (which PyTorch does not:
  74 of that test's 150 values, ~half, differ, by up to 8 ulps of a value
  near 0, where the sum cancels).
- ``quantize`` / ``quantize_v2`` on the same f32 inputs: the codes equal to
  the bit (the scale is one IEEE division of the same f32 numbers in both,
  the product, round-half-even and clamp the same), the ranges as above.
- ``quantize_net`` on a narrow ResNet-18 v1 (10 classes, 32x32) and a Dense
  stack, naive, entropy and dynamic ('none') calibration, the weights
  through ``load_jax_params``: every quantized layer's int8 weight and bias
  and their ranges equal to the bit, its calibrated input range within
  1e-5 relative (the f32 activations that calibration observes come from
  convolutions and BatchNorms that sum in other orders); each quantized
  layer given the same input gives the JAX layer's output within two ulps
  (its int32 accumulator exact, the dequantizing scale as above); and
  the logits within 1e-4 relative (relative Frobenius) of the JAX net's:
  the f32 operations between the int8 layers round at other places, and
  an activation an ulp from a code boundary may take the neighbouring
  code, 1/127 of its layer's range (measured: at most 1.8e-7); then the
  JAX test file's exclude_layers, calibration on a hybridized net and
  error cases.
- The plain int8 product is exact at the worst case, K * 127^2 for K =
  4608 (ResNet-50's 3x3x512 convolution), past f32's 2^24.
- ``optimal_threshold_entropy`` (the port vectorizes the JAX package's
  inner loop) equals the JAX package's on the same histograms.
"""
import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.ops import quantization as jqop
from mxnet_tpu_torch import npx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
from mxnet_tpu_torch.ops import quantization as tqop
from mxnet_tpu_torch.ops.cuda import int8_conv

RANGE = dict(rtol=1e-5, atol=0)
LOGITS_REL = 1e-4
F32_ULPS = 2.0 ** -22


def _rng(seed):
    return onp.random.RandomState(seed)


def _codes(shape, seed, dtype="int8"):
    lo, hi = (-127, 128) if dtype == "int8" else (0, 256)
    return _rng(seed).randint(lo, hi, shape).astype(dtype)


def _jax(name, *args, **kw):
    arr = [a if a is None or isinstance(a, (int, float))
           else mx.np.array(a, dtype=a.dtype) for a in args]
    out = getattr(jqop, name)(*arr, **kw)
    return [o.asnumpy() for o in out] if isinstance(out, tuple) \
        else out.asnumpy()


def _port(name, *args, **kw):
    arr = [a if a is None or isinstance(a, (int, float))
           else torch.from_numpy(onp.ascontiguousarray(a)) for a in args]
    out = getattr(npx, name)(*arr, **kw)
    return [o.numpy() for o in out] if isinstance(out, tuple) \
        else out.numpy()


def _close_f32(got, want, what=""):
    """Within two ulps of the array's largest magnitude."""
    onp.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                                atol=F32_ULPS * float(onp.abs(want).max()))


def _same(got, want, what=""):
    """Integer outputs equal to the bit, f32 ones within an ulp (see the
    module's docstring)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (what, g.dtype, w.dtype, g.shape, w.shape)
        if g.dtype.kind == "f":
            _close_f32(g, w, what)
        else:
            onp.testing.assert_array_equal(g, w, err_msg=what)


def _f32(*vals):
    return [onp.float32(v).reshape(()) for v in vals]


# ----------------------------------------------------------------- operators
@pytest.mark.parametrize("out_type", ["int8", "uint8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_equals_jax(out_type, seed):
    x = (_rng(seed).randn(4, 33) * (seed + 1)).astype("float32")
    mn, mx_ = _f32(x.min() * 0.8, x.max() * 0.9)
    _same(_port("quantize", x, mn, mx_, out_type=out_type),
          _jax("quantize", x, mn, mx_, out_type=out_type), out_type)


@pytest.mark.parametrize("calib", [None, (-1.5, 2.25), (-0.3, 0.3)])
@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize_v2_equals_jax(calib, out_type):
    x = (_rng(3).randn(2, 3, 5, 7) * 1.7).astype("float32")
    kw = dict(out_type=out_type)
    if calib:
        kw.update(min_calib_range=calib[0], max_calib_range=calib[1])
    _same(_port("quantize_v2", x, **kw), _jax("quantize_v2", x, **kw))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_dequantize_equals_jax(dtype):
    if dtype == "int32":
        q = _rng(4).randint(-2 ** 30, 2 ** 30, (3, 50)).astype("int32")
    else:
        q = _codes((3, 50), 4, dtype)
    mn, mx_ = _f32(-3.7, 2.9)
    _same([_port("dequantize", q, mn, mx_)], [_jax("dequantize", q, mn, mx_)])


@pytest.mark.parametrize("calib", [None, (-4.0, 3.0)])
def test_requantize_equals_jax(calib):
    q = _rng(5).randint(-2 ** 28, 2 ** 28, (6, 40)).astype("int32")
    mn, mx_ = _f32(-96.5, 101.25)
    kw = {} if calib is None else dict(min_calib_range=calib[0],
                                       max_calib_range=calib[1])
    _same(_port("requantize", q, mn, mx_, **kw),
          _jax("requantize", q, mn, mx_, **kw))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape,flatten", [((8, 32), True),
                                           ((4, 3, 5, 6), True),
                                           ((2, 3, 24), False),
                                           ((5, 147), True)])
def test_quantized_fully_connected_equals_jax(shape, flatten, with_bias):
    K = shape[-1] if not flatten else int(onp.prod(shape[1:]))
    x, w = _codes(shape, 6), _codes((16, K), 7)
    b = _codes((16,), 8) if with_bias else None
    ranges = _f32(-1.2, 0.9, -0.4, 0.5)
    branges = _f32(-0.2, 0.15) if with_bias else [None, None]
    kw = dict(num_hidden=16, flatten=flatten, no_bias=not with_bias)
    _same(_port("quantized_fully_connected", x, w, b, *ranges, *branges,
                **kw),
          _jax("quantized_fully_connected", x, w, b, *ranges, *branges,
               **kw))


# (layout, data, weight, kernel args): every layout of _CONV_DIMNUMS, 1-3
# spatial dims, stride, padding, dilation, groups, C = 3
CONV_CASES = [
    ("NCHW", (2, 3, 9, 9), (8, 3, 7, 7), dict(stride=(2, 2), pad=(3, 3))),
    ("NCHW", (2, 8, 7, 6), (12, 2, 3, 3),
     dict(stride=(1, 2), pad=(1, 0), dilate=(2, 1), num_group=4)),
    ("NHWC", (2, 7, 6, 8), (3, 3, 8, 10), dict(pad=(1, 1))),
    ("NCW", (3, 6, 17), (5, 6, 3), dict(stride=(2,), pad=(1,))),
    ("NWC", (2, 15, 4), (3, 2, 6), dict(dilate=(3,), num_group=2)),
    ("NCDHW", (1, 4, 5, 6, 5), (6, 4, 3, 2, 3),
     dict(stride=(1, 2, 1), pad=(1, 0, 1))),
    ("NDHWC", (2, 4, 4, 3, 6), (2, 2, 1, 3, 4),
     dict(pad=(1, 0, 0), num_group=2)),
    ("NCHW", (1, 16, 4, 4), (8, 16, 1, 1), dict(stride=(2, 2))),
]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("layout,xs,ws,kw", CONV_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONV_CASES)])
def test_quantized_conv_equals_jax(layout, xs, ws, kw, with_bias):
    x, w = _codes(xs, 9), _codes(ws, 10)
    O = ws[0] if layout.startswith("NC") else ws[-1]
    b = _codes((O,), 11) if with_bias else None
    ranges = _f32(-2.0, 1.5, -0.3, 0.31)
    branges = _f32(-0.5, 0.4) if with_bias else [None, None]
    kw = dict(kw, layout=layout, no_bias=not with_bias, num_filter=O)
    _same(_port("quantized_conv", x, w, b, *ranges, *branges, **kw),
          _jax("quantized_conv", x, w, b, *ranges, *branges, **kw))


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("layout,shape,kw", [
    ("NCHW", (2, 3, 7, 8), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1))),
    ("NCHW", (2, 3, 6, 6), dict(kernel=(2, 2), stride=(2, 2))),
    ("NHWC", (2, 6, 5, 4), dict(kernel=(3, 2))),
    ("NCW", (2, 4, 11), dict(kernel=(3,), stride=(2,), pad=(1,))),
    ("NCDHW", (1, 2, 4, 5, 6), dict(kernel=(2, 3, 2), pad=(1, 1, 0))),
    ("NCHW", (2, 5, 7, 7), dict(global_pool=True)),
])
@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_quantized_pooling_equals_jax(layout, shape, kw, pool_type, dtype):
    q = _codes(shape, 12, dtype)
    mn, mx_ = _f32(-1.0, 3.0)
    kw = dict(kw, pool_type=pool_type, layout=layout)
    _same(_port("quantized_pooling", q, mn, mx_, **kw),
          _jax("quantized_pooling", q, mn, mx_, **kw))


def test_quantized_act_and_flatten_equal_jax():
    q = _codes((2, 3, 4, 5), 13)
    for mn in (-1.25, 0.5):
        rng_ = _f32(mn, 2.0)
        _same(_port("quantized_act", q, *rng_), _jax("quantized_act", q,
                                                      *rng_))
        _same(_port("quantized_flatten", q, *rng_),
              _jax("quantized_flatten", q, *rng_))
    with pytest.raises(MXNetError):
        npx.quantized_act(torch.zeros(2, dtype=torch.int8), 0.0, 1.0,
                          act_type="tanh")
    with pytest.raises(MXNetError):
        npx.quantized_pooling(torch.zeros(1, 1, 2, 2, dtype=torch.int8),
                              0.0, 1.0, kernel=(2, 2), pool_type="sum")
    with pytest.raises(MXNetError):
        npx.quantize(torch.zeros(2), 0.0, 1.0, out_type="int4")


def test_int8_plain_product_is_exact_at_the_worst_case():
    """K = 4608 of -127 x -127: 74322432, past 2^24, exact in the plain
    version (float64), where f32 would round."""
    x = torch.full((1, 512, 3, 3), -127, dtype=torch.int8)
    w = torch.full((4, 512, 3, 3), -127, dtype=torch.int8)
    y = int8_conv.conv(x, w, None, (1, 1), (0, 0), (1, 1), 1, "NCHW")
    assert y.dtype == torch.int32
    assert torch.equal(y, torch.full((1, 4, 1, 1), 4608 * 127 * 127,
                                     dtype=torch.int32))
    fc = int8_conv.fully_connected(x.reshape(1, -1), w.reshape(4, -1))
    assert torch.equal(fc, y.reshape(1, 4))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_optimal_threshold_entropy_equals_jax(seed):
    rng = _rng(seed)
    vals = onp.abs(rng.standard_t(3, 40000) * (seed + 1))
    if seed == 1:
        vals = onp.concatenate([vals, [50.0 * vals.max()]])
    hist, edges = onp.histogram(vals, bins=2048, range=(0, vals.max()))
    if seed == 2:
        hist = hist.astype(float)
        hist[::3] = 0
    if seed == 3:       # an observer's rescaled (weighted) histogram
        c = (edges[:-1] + edges[1:]) / 2
        hist, edges = onp.histogram(c, bins=2048, range=(0, 1.7 * edges[-1]),
                                    weights=hist.astype(float))
    assert tq.optimal_threshold_entropy(hist, edges) == \
        jq.optimal_threshold_entropy(hist, edges)


# -------------------------------------------------------------- quantize_net
def _resnet18_pair(seed=0):
    """A narrow ResNet-18 v1 (channels 8-64, 10 classes) in both packages
    with the JAX net's parameters; BatchNorm statistics and gammas from the
    seed, so each layer's normalization matters."""
    mx.random.seed(seed)
    layers, channels = [2, 2, 2, 2], [8, 8, 16, 32, 64]
    jnet = jresnet.ResNetV1(jresnet.BasicBlockV1, layers, channels,
                            classes=10)
    jnet.initialize(mx.init.Xavier(magnitude=2.0))
    jnet(mx.np.zeros((1, 3, 32, 32)))
    rng = _rng(seed + 50)
    params = {}
    for k, p in jnet.collect_params().items():
        a = p.data().asnumpy()
        if k.endswith(("running_mean", "beta")):
            a = (rng.randn(*a.shape) * 0.1).astype("float32")
        elif k.endswith(("running_var", "gamma")):
            a = rng.uniform(0.5, 1.5, a.shape).astype("float32")
        p.set_data(mx.np.array(a))
        params[k] = a
    tnet = load_jax_params(resnet.ResNetV1(resnet.BasicBlockV1, layers,
                                           channels, classes=10), params)
    return jnet, tnet


def _dense_pair(seed=0):
    mx.random.seed(seed)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Dense(32, activation="relu"),
             mx.gluon.nn.Dense(24, activation="relu"), mx.gluon.nn.Dense(10))
    jnet.initialize()
    jnet(mx.np.zeros((1, 20)))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = nn.HybridSequential()
    tnet.add(nn.Dense(32, activation="relu", in_units=20),
             nn.Dense(24, activation="relu", in_units=32),
             nn.Dense(10, in_units=24))
    return jnet, load_jax_params(tnet, params)


def _jax_layers(net, prefix=""):
    out = {}
    for name, child in net._children.items():
        path = f"{prefix}{name}"
        if isinstance(child, (jq.QuantizedConv, jq.QuantizedDense)):
            out[path] = child
        else:
            out.update(_jax_layers(child, path + "."))
    return out


def _port_layers(net):
    return {k: m for k, m in net.named_modules()
            if isinstance(m, (tq.QuantizedConv, tq.QuantizedDense))}


def _check_layers(jlayers, tlayers, inputs):
    """Weights and ranges, and each layer on the JAX layer's input."""
    assert sorted(jlayers) == sorted(tlayers)
    for k, jl in jlayers.items():
        tl = tlayers[k]
        onp.testing.assert_array_equal(tl.wq.numpy(), jl.wq.asnumpy(), k)
        assert (float(tl.wmin), float(tl.wmax)) == \
            (onp.float32(jl._wmin), onp.float32(jl._wmax)), k
        if jl.bq is not None:
            onp.testing.assert_array_equal(tl.bq.numpy(), jl.bq.asnumpy(), k)
            assert (float(tl.bmin), float(tl.bmax)) == \
                (onp.float32(jl._bmin), onp.float32(jl._bmax)), k
        else:
            assert tl.bq is None, k
        if jl._in_min is None:
            assert tl._in_min is None, k
        else:
            onp.testing.assert_allclose([tl._in_min, tl._in_max],
                                        [jl._in_min, jl._in_max],
                                        err_msg=k, **RANGE)
        # the same input (the JAX layer's) through the same calibrated range
        x = inputs[k]
        tl._in_min, tl._in_max = jl._in_min, jl._in_max
        if jl._in_min is not None:
            tl.in_min.fill_(jl._in_min)
            tl.in_max.fill_(jl._in_max)
        want = jl(mx.np.array(x)).asnumpy()
        got = tl(torch.from_numpy(x)).detach().numpy()
        _close_f32(got, want, k)


def _record_inputs(jnet):
    """The JAX package's quantized layers' inputs of the next forward."""
    seen = {}
    for k, layer in _jax_layers(jnet).items():
        orig = layer.forward

        def hooked(x, _orig=orig, _k=k):
            seen[_k] = x.asnumpy()
            return _orig(x)
        layer.forward = hooked
    return seen


@pytest.mark.parametrize("mode", ["naive", "entropy", "none"])
@pytest.mark.parametrize("which", ["resnet18", "dense"])
def test_quantize_net_equals_jax(which, mode):
    jnet, tnet = _resnet18_pair() if which == "resnet18" else _dense_pair()
    rng = _rng(20)
    shape = (6, 3, 32, 32) if which == "resnet18" else (16, 20)
    calib = [rng.uniform(-1, 1, shape).astype("float32") for _ in range(2)]
    X = rng.uniform(-1, 1, shape).astype("float32")
    jcal = None if mode == "none" else [mx.np.array(c) for c in calib]
    tcal = None if mode == "none" else [torch.from_numpy(c) for c in calib]
    jq.quantize_net(jnet, calib_data=jcal, calib_mode=mode)
    tq.quantize_net(tnet, calib_data=tcal, calib_mode=mode)
    jl = _jax_layers(jnet)
    assert len(jl) == (21 if which == "resnet18" else 3)
    seen = _record_inputs(jnet)
    want = jnet(mx.np.array(X)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(X)).numpy()
    err = float(onp.linalg.norm(got - want) / onp.linalg.norm(want))
    assert err <= LOGITS_REL, err
    with torch.no_grad():
        _check_layers(jl, _port_layers(tnet), seen)


def test_quantize_net_exclude_layers_and_dense_activation():
    _, tnet = _dense_pair(1)
    X = torch.from_numpy(_rng(21).uniform(-1, 1, (8, 20)).astype("float32"))
    with torch.no_grad():
        ref = tnet(X)
    tq.quantize_net(tnet, calib_data=[X], calib_mode="naive",
                    exclude_layers=["1"])
    assert isinstance(tnet._modules["0"], tq.QuantizedDense)
    assert isinstance(tnet._modules["1"], nn.Dense)        # excluded
    assert isinstance(tnet._modules["2"], tq.QuantizedDense)
    with torch.no_grad():
        out = tnet(X)
    assert (out - ref).abs().max() < 0.1 * ref.abs().max() + 0.05


def test_quantize_net_on_a_hybridized_net():
    """Calibration runs eagerly on a hybridized net (its observers see every
    layer), and the net is hybridized again after."""
    jnet, tnet = _resnet18_pair(2)
    X = _rng(22).uniform(-1, 1, (4, 3, 32, 32)).astype("float32")
    tnet.hybridize()
    jnet.hybridize()
    jnet(mx.np.array(X))
    tq.quantize_net(tnet, calib_data=[torch.from_numpy(X)],
                    calib_mode="naive")
    jq.quantize_net(jnet, calib_data=[mx.np.array(X)], calib_mode="naive")
    assert tnet._active
    for k, jl in _jax_layers(jnet).items():
        tl = _port_layers(tnet)[k]
        assert onp.isfinite([tl._in_min, tl._in_max]).all(), k
        onp.testing.assert_allclose([tl._in_min, tl._in_max],
                                    [jl._in_min, jl._in_max], err_msg=k,
                                    **RANGE)


def test_quantize_net_errors():
    _, tnet = _dense_pair()
    with pytest.raises(MXNetError):
        tq.quantize_net(tnet, quantized_dtype="uint4")
    with pytest.raises(MXNetError):
        tq.quantize_net(tnet, calib_mode="bogus")
    with pytest.raises(MXNetError):
        tq.quantize_net(tnet, calib_mode="naive")       # no calib_data
    with pytest.raises(MXNetError):
        tq.quantize_net(nn.HybridSequential(), calib_mode="none")
    with pytest.raises(MXNetError):
        tqop.quantize(torch.zeros(2), torch.tensor(0.0), torch.tensor(1.0),
                      out_type="int4")
    conv_t = nn.Conv2DTranspose(4, 3, in_channels=2)
    with pytest.raises(MXNetError):
        tq.QuantizedConv(conv_t, (0.0, 1.0))
