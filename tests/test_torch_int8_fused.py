"""The int8 kernel's f32 variant (a whole quantized layer in one launch)
and its launch plan, on the CPU.

- ``conv_f32`` / ``fully_connected_f32``'s plain version (what runs on a
  CPU tensor, and what the card's kernel is held to) equals the unfused
  operator sequence ``quantize_v2`` -> ``quantized_conv`` /
  ``quantized_fully_connected`` -> ``dequantize`` -> relu bit for bit, its
  constants from ``int8_layer_constants``: the six layouts, strides,
  padding, dilation, groups, with and without a bias and the relu, a
  calibrated range (inputs past it, clamped at +-127) and each batch's own
  (dynamic), inputs at x * scale = k + 1/2 (round half to even).
- ``QuantizedConv`` / ``QuantizedDense`` on the CPU equal that sequence run
  on their own buffers (the layers' forward before the kernel ran them
  whole), with every activation; their constants are computed once and
  again when a range is written; the packed weight is left out of
  ``state_dict`` and ``save_parameters``, whose files hold the JAX
  package's names.
- ``pack_weight``'s two reduction orders against the weight's own
  permutations, read in place where the rows already are the packed ones.
- ``int8_plan`` at ResNet-50's shapes and the edges of each route: which
  way A reaches shared memory, the reduction order, the tile and the
  split, and a numpy walk of the split's step ranges and the block index's
  decoding (the kernel's arithmetic) covering every tile and step once.
"""
import os
import tempfile

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import quantization as tqop
from mxnet_tpu_torch.ops.cuda import int8_conv as i8


def _rng(seed):
    return onp.random.RandomState(seed)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _inputs(shape, seed, dynamic):
    """f32 data whose products by the scale 2 (|range| 63.5) are exact:
    many halves k + 1/2; with a calibrated range also values past it (x *
    scale up to +-200, clamped at +-127)."""
    r = _rng(seed)
    top = 63.5 if dynamic else 100.0
    x = r.randint(-int(4 * top), int(4 * top) + 1, shape) / 4.0
    if dynamic:
        x.flat[0], x.flat[1] = 63.5, -63.5       # the range is x's own
    return torch.from_numpy(x.astype("float32"))


def _ranges(dynamic, x):
    if dynamic:
        return x.min().float(), x.max().float()
    return torch.tensor(-63.5), torch.tensor(40.0)


def _weights(ws, O, seed, with_bias):
    r = _rng(seed)
    w = torch.from_numpy(r.randint(-127, 128, ws).astype("int8"))
    b = torch.from_numpy(r.randint(-127, 128, (O,)).astype("int8")) \
        if with_bias else None
    wr = (torch.tensor(-0.31), torch.tensor(0.3))
    br = (torch.tensor(-0.5), torch.tensor(0.4)) if with_bias else (None,
                                                                     None)
    return w, b, wr, br


# (layout, data, weight, stride, pad, dilate, groups): every layout of
# _CONV_DIMNUMS, 1-3 spatial dims, stride, padding, dilation, groups, C = 3
CASES = [
    ("NCHW", (2, 3, 9, 9), (8, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    ("NCHW", (2, 8, 7, 6), (12, 2, 3, 3), (1, 2), (1, 0), (2, 1), 4),
    ("NHWC", (2, 7, 6, 8), (3, 3, 8, 10), (1, 1), (1, 1), (1, 1), 1),
    ("NCW", (3, 6, 17), (5, 6, 3), (2,), (1,), (1,), 1),
    ("NWC", (2, 15, 4), (3, 2, 6), (1,), (0,), (3,), 2),
    ("NCDHW", (1, 4, 5, 6, 5), (6, 4, 3, 2, 3), (1, 2, 1), (1, 0, 1),
     (1, 1, 1), 1),
    ("NDHWC", (2, 4, 4, 3, 6), (2, 2, 1, 3, 4), (1, 1, 1), (1, 0, 0),
     (1, 1, 1), 2),
    ("NCHW", (1, 16, 4, 4), (8, 16, 1, 1), (2, 2), (0, 0), (1, 1), 1),
    ("NCHW", (2, 32, 5, 5), (40, 32, 1, 1), (1, 1), (0, 0), (1, 1), 1),
]


@pytest.mark.parametrize("case", CASES, ids=[f"{c[0]}-{i}"
                                             for i, c in enumerate(CASES)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dynamic", [False, True])
def test_conv_f32_plain_equals_operator_sequence(case, with_bias, relu,
                                                 dynamic):
    layout, xs, ws, stride, pad, dilate, groups = case
    O = ws[0] if layout.startswith("NC") else ws[-1]
    x = _inputs(xs, len(xs) + groups, dynamic)
    w, b, wr, br = _weights(ws, O, 3 + groups, with_bias)
    mn, mx = _ranges(dynamic, x)
    q, qmn, qmx = tqop.quantize_v2(x, None if dynamic else mn,
                                   None if dynamic else mx)
    y, omn, omx = tqop.quantized_conv(q, w, b, qmn, qmx, *wr, *br,
                                      stride=stride, pad=pad, dilate=dilate,
                                      num_group=groups, layout=layout,
                                      no_bias=not with_bias)
    want = tqop.dequantize(y, omn, omx)
    if relu:
        want = tnn.activation(want, "relu")
    scale, step, b32 = tqop.int8_layer_constants(mn, mx, *wr, b, *br)
    got = i8.conv_f32(x, w, b32, scale, step, stride, pad, dilate, groups,
                      layout, relu)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(i8.conv_f32_reference(x, w, b32, scale, step, stride,
                                             pad, dilate, groups, layout,
                                             relu), got)


@pytest.mark.parametrize("shape", [(8, 32), (5, 147), (64, 2048)])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dynamic", [False, True])
def test_fully_connected_f32_plain_equals_operator_sequence(
        shape, with_bias, relu, dynamic):
    N = 24
    x = _inputs(shape, shape[1], dynamic)
    w, b, wr, br = _weights((N, shape[1]), N, 5, with_bias)
    mn, mx = _ranges(dynamic, x)
    q, qmn, qmx = tqop.quantize_v2(x, None if dynamic else mn,
                                   None if dynamic else mx)
    y, omn, omx = tqop.quantized_fully_connected(
        q, w, b, qmn, qmx, *wr, *br, num_hidden=N, no_bias=not with_bias)
    want = tqop.dequantize(y, omn, omx)
    if relu:
        want = tnn.activation(want, "relu")
    scale, step, b32 = tqop.int8_layer_constants(mn, mx, *wr, b, *br)
    got = i8.fully_connected_f32(x, w, b32, scale, step, relu)
    assert torch.equal(_bits(got), _bits(want))


def test_quantization_extremes_round_half_to_even_and_clamp():
    """x * scale at k + 1/2 rounds to the even neighbour, past +-127
    clamps; the codes are what quantize_v2 gives."""
    x = torch.tensor([0.25, 0.75, -0.25, -0.75, 1.25, 63.25, 63.75, -63.75,
                      99.0, -99.0, 63.5, -63.5])
    scale = torch.tensor(2.0)
    want = torch.tensor([0, 2, 0, -2, 2, 126, 127, -127, 127, -127, 127,
                         -127], dtype=torch.int8)
    assert torch.equal(i8._codes(x, scale), want)
    assert torch.equal(tqop.int8_codes(x, scale), want)
    assert torch.equal(tqop.quantize_v2(x, torch.tensor(-63.5),
                                        torch.tensor(63.5))[0], want)


# ------------------------------------------------------------------ layers
def _unfused_layer(layer, x):
    """The quantized layer's forward as the operators ran it, one by one,
    on its buffers."""
    if layer._in_min is None:
        q, mn, mx = tqop.quantize_v2(x)
    else:
        q, mn, mx = tqop.quantize_v2(x, layer.in_min, layer.in_max)
    args = (q, layer.wq, layer.bq, mn, mx, layer.wmin, layer.wmax,
            layer.bmin, layer.bmax)
    if isinstance(layer, tq.QuantizedDense):
        y, mn_o, mx_o = tqop.quantized_fully_connected(
            *args, num_hidden=layer._units, no_bias=layer.bq is None,
            flatten=layer._flatten)
    else:
        y, mn_o, mx_o = tqop.quantized_conv(*args, no_bias=layer.bq is None,
                                            **layer._cfg)
    out = tqop.dequantize(y, mn_o, mx_o)
    return tnn.activation(out, layer._activation) if layer._activation \
        else out


@pytest.mark.parametrize("act", [None, "relu", "sigmoid"])
@pytest.mark.parametrize("calib", [(-2.5, 3.0), None])
@pytest.mark.parametrize("kind", ["conv3x3", "conv1", "dense"])
def test_quantized_layers_equal_the_operator_sequence(kind, calib, act):
    torch.manual_seed(1)
    if kind == "dense":
        layer = nn.Dense(12, activation=act, in_units=40)
        x = torch.randn(6, 5, 8) * 2
    elif kind == "conv1":
        layer = nn.Conv2D(16, 7, strides=2, padding=3, in_channels=3,
                          activation=act)
        x = torch.randn(2, 3, 19, 19) * 2
    else:
        layer = nn.Conv2D(24, 3, padding=1, in_channels=32, activation=act)
        x = torch.randn(2, 32, 6, 6) * 2
    layer.initialize(device="cpu")
    cls = tq.QuantizedDense if kind == "dense" else tq.QuantizedConv
    q = cls(layer, calib if calib else (None, None))
    with torch.no_grad():
        got, want = q(x), _unfused_layer(q, x)
    assert torch.equal(_bits(got), _bits(want))


def test_layer_constants_are_cached_until_a_range_is_written():
    torch.manual_seed(2)
    layer = nn.Conv2D(8, 3, padding=1, in_channels=16, activation="relu")
    layer.initialize(device="cpu")
    q = tq.QuantizedConv(layer, (-1.0, 1.5))
    x = torch.randn(2, 16, 5, 5)
    with torch.no_grad():
        first = q._constants(x)
        assert q._constants(x) is first           # computed once
        q(x)
        assert q._constants(x) is first
        q.in_max.fill_(4.0)                       # a range written
        q._in_max = 4.0
        assert q._constants(x) is not first
        assert torch.equal(_bits(q(x)), _bits(_unfused_layer(q, x)))


@pytest.mark.parametrize("built_inside", [False, True])
@pytest.mark.parametrize("how", ["copy", "load_state_dict"])
def test_ranges_written_in_inference_mode_reach_the_forward(built_inside,
                                                             how):
    """A layer built (or only run) under ``torch.inference_mode`` and whose
    input range and weight are then written there, in place or by
    ``load_state_dict``: the next forward computes with the new values
    (the cached constants and packed weight are not stale)."""
    torch.manual_seed(5)
    layer = nn.Conv2D(8, 3, padding=1, in_channels=16, activation="relu")
    layer.initialize(device="cpu")
    x = torch.randn(2, 16, 5, 5)
    with torch.inference_mode(built_inside):
        q = tq.QuantizedConv(layer, (-1.0, 1.5))
    with torch.inference_mode():
        q(x)
        wq = torch.randint(-127, 128, q.wq.shape, dtype=torch.int8)
        if how == "copy":
            q.in_max.copy_(torch.tensor(4.0))
            q.wq.copy_(wq)
        else:
            state = {k: v.clone() for k, v in q.state_dict().items()}
            state["in_max"], state["wq"] = torch.tensor(4.0), wq
            q.load_state_dict(state)
        q._in_max = 4.0
        got = q(x)
        assert torch.equal(_bits(got), _bits(_unfused_layer(q, x)))
    assert not q.wq.is_inference() and not q.in_max.is_inference()
    assert torch.equal(q.wpack[:, :q.wq[0].numel()],
                       q.wq.movedim(1, -1).reshape(8, -1))


def test_stamp_of_an_inference_tensor_equals_no_other():
    with torch.inference_mode():
        t = torch.zeros(2)
    assert tq._stamp(t) != tq._stamp(t)
    u = torch.zeros(2)
    assert tq._stamp(u) == tq._stamp(u)
    u.add_(1)
    assert tq._stamp(u) != (u.data_ptr(), 0)


def _quantized_pair():
    """A small conv + Dense net in both packages, quantized alike."""
    mx.random.seed(3)
    jnet = mx.gluon.nn.HybridSequential()
    jnet.add(mx.gluon.nn.Conv2D(8, 3, padding=1, activation="relu"),
             mx.gluon.nn.BatchNorm(), mx.gluon.nn.Dense(5))
    jnet.initialize()
    jnet(mx.np.zeros((1, 4, 6, 6)))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = nn.HybridSequential()
    tnet.add(nn.Conv2D(8, 3, padding=1, activation="relu", in_channels=4),
             nn.BatchNorm(in_channels=8), nn.Dense(5, in_units=8 * 36))
    tnet = load_jax_params(tnet, params)
    X = _rng(4).uniform(-1, 1, (2, 4, 6, 6)).astype("float32")
    jq.quantize_net(jnet, calib_data=[mx.np.array(X)], calib_mode="naive")
    tq.quantize_net(tnet, calib_data=[torch.from_numpy(X)],
                    calib_mode="naive")
    return jnet, tnet


def test_packed_weight_is_not_saved():
    jnet, tnet = _quantized_pair()
    packed = [k for k in tnet.state_dict() if k.endswith("wpack")]
    assert not packed, packed
    assert all(hasattr(m, "wpack") for m in tnet.modules()
               if isinstance(m, (tq.QuantizedConv, tq.QuantizedDense)))
    with tempfile.TemporaryDirectory() as d:
        fj, ft = os.path.join(d, "j.params"), os.path.join(d, "t.params")
        jnet.save_parameters(fj)
        tnet.save_parameters(ft)
        assert sorted(mx.nd.load(ft)) == sorted(mx.nd.load(fj))


# ----------------------------------------------------------------- packing
@pytest.mark.parametrize("layout,ws", [("NCHW", (6, 4, 3, 2)),
                                       ("NHWC", (3, 2, 4, 6)),
                                       ("NCW", (5, 3, 7)),
                                       ("NCDHW", (4, 2, 2, 3, 2))])
@pytest.mark.parametrize("cf", [False, True])
def test_pack_weight_orders(layout, ws, cf):
    w = torch.from_numpy(_rng(7).randint(-127, 128, ws).astype("int8"))
    p, copied = i8.pack_weight(w, layout, cf)
    wc = w if layout.startswith("NC") else \
        w.permute(w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))
    rows = (wc if cf else wc.movedim(1, -1)).reshape(wc.shape[0], -1)
    K = rows.shape[1]
    assert copied and p.Kp % 16 == 0 and p.Kp - K < 16 and p.cf == cf
    assert torch.equal(p.w[:, :K], rows)
    assert not p.w[:, K:].any()


def test_pack_weight_reads_packed_rows_in_place():
    w = torch.zeros((8, 32, 1, 1), dtype=torch.int8)
    p, copied = i8.pack_weight(w, "NCHW", False)
    assert not copied and p.w.data_ptr() == w.data_ptr() and p.Kp == 32
    w3 = torch.zeros((8, 4, 2, 2), dtype=torch.int8)      # OIHW, K = 16
    p, copied = i8.pack_weight(w3, "NCHW", True)
    assert not copied and p.w.data_ptr() == w3.data_ptr()


# -------------------------------------------------------------------- plan
# (M, C, Og, G, K, one, esize, channels first) -> (route, cf, bn, split)
PLANS = [
    # ResNet-50 at B = 64, f32 in: conv1, a 1x1, a 3x3, a strided 1x1,
    # the 7x7 stage's 3x3, the FC
    ((802816, 3, 64, 1, 147, False, 4, True), ("elem", True, 64, 1)),
    ((200704, 64, 256, 1, 64, True, 4, True), ("tma", False, 128, 1)),
    ((200704, 64, 64, 1, 576, False, 4, True), ("runs", False, 64, 1)),
    ((50176, 256, 128, 1, 256, False, 4, True), ("runs", False, 128, 1)),
    ((3136, 512, 512, 1, 4608, False, 4, True), ("runs", False, 128, 1)),
    ((64, 2048, 1000, 1, 2048, True, 4, False), ("tma", False, 128, 8)),
    # int8 in: conv1, a grouped 3x3 of 8 channels a group (NCHW, NHWC), 16
    ((802816, 3, 64, 1, 147, False, 1, True), ("elem", True, 64, 1)),
    ((50176, 256, 8, 32, 72, False, 1, True), ("elem", True, 64, 1)),
    ((50176, 256, 8, 32, 72, False, 1, False), ("elem", False, 64, 1)),
    ((50176, 512, 16, 32, 144, False, 1, True), ("chunk", False, 64, 1)),
    # rows of 16-byte multiples or not, channels in whole pieces or not
    ((81, 40, 24, 1, 40, True, 1, True), ("elem", True, 64, 1)),
    ((81, 40, 24, 1, 40, True, 4, True), ("tma", False, 64, 1)),
    ((81, 20, 24, 1, 180, False, 4, True), ("chunk", False, 64, 1)),
    ((81, 96, 24, 3, 288, False, 4, True), ("runs", False, 64, 1)),
    ((81, 6, 24, 1, 6, True, 4, True), ("elem", True, 64, 1)),
    ((81, 6, 24, 1, 6, True, 4, False), ("elem", False, 64, 1)),
    # few tiles, a long reduction: split, never past the steps
    ((64, 4096, 64, 1, 4096, True, 1, False), ("tma", False, 64, 8)),
    ((64, 512, 64, 1, 512, True, 1, False), ("tma", False, 64, 4)),
    ((64, 256, 64, 1, 256, True, 1, False), ("tma", False, 64, 1)),
    ((64, 64, 64, 1, 64, True, 1, False), ("tma", False, 64, 1)),
]


@pytest.mark.parametrize("args,want", PLANS, ids=[str(a) for a, _ in PLANS])
def test_int8_plan(args, want):
    p = i8.int8_plan(*args)
    assert (p.route, p.cf, p.bn, p.split) == want
    M, C, Og, G, K = args[:5]
    assert p.steps == -(-K // 128) and p.split <= p.steps
    assert p.tiles == -(-M // 128) * -(-Og // p.bn) * G


@pytest.mark.parametrize("M,Og,G,steps,split", [(300, 130, 1, 9, 4),
                                                (64, 1000, 1, 16, 8),
                                                (200, 24, 3, 5, 2),
                                                (129, 64, 2, 1, 1)])
def test_split_walk_covers_every_tile_and_step_once(M, Og, G, steps, split):
    """The kernel's decoding of blockIdx.x (split fastest, then the output
    channel tile, the group, the positions) and its step range [s0, s1)
    of each split, replayed in numpy: every (tile, step) once."""
    bn = 64 if Og <= 64 else 128
    n_tiles, m_tiles = -(-Og // bn), -(-M // 128)
    seen = onp.zeros((m_tiles, G, n_tiles, steps), int)
    for b in range(m_tiles * G * n_tiles * split):
        s, t = b % split, b // split
        nt, t = t % n_tiles, t // n_tiles
        g, mt = t % G, t // G
        s0, s1 = steps * s // split, steps * (s + 1) // split
        assert s1 > s0
        seen[mt, g, nt, s0:s1] += 1
    assert (seen == 1).all()


def _walk_offsets(shape, ks, stride, pad, dil, G, cf, m, g, k0, n):
    """csrc/int8_conv.cu's element walk (walk_at, walk_next) replayed in
    Python for output position m of group g, reduction elements k0 ..
    k0 + n - 1: x's flat offsets, -1 in the padding."""
    N, C, D, H, W = shape
    KD, KH, KW = ks
    Cg = C // G
    OD, OH, OW = [(i + 2 * p - d * (k - 1) - 1) // s + 1 for i, k, s, p, d
                  in zip((D, H, W), ks, stride, pad, dil)]
    ow, t = m % OW, m // OW
    oh, t = t % OH, t // OH
    od, img = t % OD, t // OD
    r = dict(img=img * D * H * W * C, id0=od * stride[0] - pad[0],
             ih0=oh * stride[1] - pad[1], iw0=ow * stride[2] - pad[2])
    if cf:
        kw, k = k0 % KW, k0 // KW
        kh, k = k % KH, k // KH
        kd, c = k % KD, k // KD
    else:
        c, k = k0 % Cg, k0 // Cg
        kw, k = k % KW, k // KW
        kh, kd = k % KH, k // KH
    w = dict(kd=kd, kh=kh, kw=kw, c=c, inn=kw if cf else c)

    def run_at():
        i_d, i_h = r["id0"] + w["kd"] * dil[0], r["ih0"] + w["kh"] * dil[1]
        ok = 0 <= i_d < D and 0 <= i_h < H
        if cf:
            w["base"] = r["img"] + (((g * Cg + w["c"]) * D + i_d) * H +
                                    i_h) * W + r["iw0"]
        else:
            i_w = r["iw0"] + w["kw"] * dil[2]
            ok = ok and 0 <= i_w < W
            w["base"] = r["img"] + ((i_d * H + i_h) * W + i_w) * C + g * Cg
        w["ok"] = ok
    run_at()
    out = []
    for _ in range(n):
        if cf:
            i_w = r["iw0"] + w["inn"] * dil[2]
            out.append(w["base"] + w["inn"] * dil[2]
                       if w["ok"] and 0 <= i_w < W else -1)
            w["inn"] += 1
            if w["inn"] == KW:
                w["inn"] = 0
                w["kh"] += 1
                if w["kh"] == KH:
                    w["kh"] = 0
                    w["kd"] += 1
                    if w["kd"] == KD:
                        w["kd"], w["c"] = 0, w["c"] + 1
                run_at()
        else:
            out.append(w["base"] + w["inn"] if w["ok"] else -1)
            w["inn"] += 1
            if w["inn"] == Cg:
                w["inn"] = 0
                w["kw"] += 1
                if w["kw"] == KW:
                    w["kw"] = 0
                    w["kh"] += 1
                    if w["kh"] == KH:
                        w["kh"], w["kd"] = 0, w["kd"] + 1
                run_at()
    return out


@pytest.mark.parametrize("cf", [True, False])
@pytest.mark.parametrize("shape,ks,stride,pad,dil,G", [
    ((2, 3, 1, 11, 11), (1, 7, 7), (1, 2, 2), (0, 3, 3), (1, 1, 1), 1),
    ((1, 6, 4, 5, 6), (3, 2, 3), (1, 2, 1), (1, 0, 1), (1, 1, 2), 3),
    ((2, 8, 1, 7, 6), (1, 3, 3), (1, 1, 2), (0, 1, 0), (1, 2, 1), 4)])
def test_elem_walk_visits_the_packed_order(shape, ks, stride, pad, dil, G,
                                           cf):
    """The element walk's offsets, started anywhere in the reduction, are
    the packed weight's order read off an index tensor laid out as the
    route reads x (NCDHW for cf, NDHWC otherwise), -1 in the padding."""
    N, C, D, H, W = shape
    Cg = C // G
    idx = torch.arange(N * C * D * H * W, dtype=torch.float64)
    x = idx.reshape(N, C, D, H, W) if cf else \
        idx.reshape(N, D, H, W, C).permute(0, 4, 1, 2, 3)
    xp = torch.nn.functional.pad(x + 1, [p for v in pad[::-1]
                                         for p in (v, v)])
    K = Cg * ks[0] * ks[1] * ks[2]
    r = _rng(9)
    for _ in range(12):
        g = int(r.randint(G))
        xs = xp[:, g * Cg:(g + 1) * Cg]
        # every window of the group: (N, Cg, kd, kh, kw, OD, OH, OW)
        win = xs.unfold(2, (ks[0] - 1) * dil[0] + 1, stride[0]) \
            .unfold(3, (ks[1] - 1) * dil[1] + 1, stride[1]) \
            .unfold(4, (ks[2] - 1) * dil[2] + 1, stride[2])
        win = win[..., ::dil[0], ::dil[1], ::dil[2]]
        win = win.permute(0, 2, 3, 4, 1, 5, 6, 7)   # N OD OH OW Cg k...
        rows = win.reshape(-1, Cg, *ks)
        rows = rows if cf else rows.permute(0, 2, 3, 4, 1)
        rows = rows.reshape(rows.shape[0], K) - 1    # the packed order
        m = int(r.randint(rows.shape[0]))
        k0 = int(r.randint(K))
        got = _walk_offsets(shape, ks, stride, pad, dil, G, cf, m, g, k0,
                            K - k0)
        assert got == [int(v) for v in rows[m, k0:]], (m, g, k0)
