"""``HybridBlock.export`` and ``ServedModel.from_export`` of the port against
``from_block`` and the JAX package's exports, on the CPU.

A 2-layer, 64-unit BERT with the JAX package's weights
(``convert.load_jax_params``), exported by the port with and without
``dynamic_batch``:

- ``from_export``'s answers match ``from_block``'s at rtol=1e-6,
  atol=1e-6 at every batch bucket (the same f32 operations), and the JAX
  package's own export of the same weights at rtol=1e-5, atol=1e-5;
- the exported graph holds the ``mxnet_tpu_torch::flash_attention_fwd``
  node, and the parameters are arguments of the program, not constants;
- a truncated or bit-flipped program or ``.params`` file raises
  :class:`MXNetError` before anything is deserialised;
- a static export serves only its traced batch;
- a JAX export artifact is refused by its framework's name (and the JAX
  package refuses the port's);
- tied parameters are traced once, and a forward that writes a parameter
  raises.
"""
import base64
import json

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.gluon import HybridBlock as JHybridBlock
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import HybridBlock, Parameter, nn
from mxnet_tpu_torch.serving import BucketPolicy, ModelServer, ServedModel
from torch_port_util import bert_pair

T = 16
SIG = [((2, T), onp.int32), ((2,), onp.int32)]
F32 = dict(rtol=1e-6, atol=1e-6)
CROSS = dict(rtol=1e-5, atol=1e-5)


class _Encode(HybridBlock):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, tokens, valid_length):
        return self.bert(tokens, None, valid_length)


class _JEncode(JHybridBlock):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, tokens, valid_length):
        return self.bert(tokens, None, valid_length)


@pytest.fixture(scope="module")
def nets():
    jnet, tnet, _ = bert_pair(seed=2)
    return _JEncode(jnet), _Encode(tnet)


@pytest.fixture(scope="module")
def exported(nets, tmp_path_factory):
    """{"dynamic" | "static": (symbol file, params file)}."""
    folder = tmp_path_factory.mktemp("export")
    tnet = nets[1]
    return {"dynamic": tnet.export(str(folder / "dyn"), input_signature=SIG,
                                   dynamic_batch=True),
            "static": tnet.export(str(folder / "static"), epoch=3,
                                  input_signature=[((4, T), onp.int32),
                                                   ((4,), onp.int32)])}


def _batch(B, seed=0):
    rng = onp.random.RandomState(seed + B)
    return [rng.randint(0, 100, (B, T)).astype("int32"),
            rng.randint(1, T + 1, (B,)).astype("int32")]


@pytest.mark.parametrize("B", [1, 2, 3, 8])
def test_dynamic_export_answers_as_from_block(nets, exported, B):
    model = ServedModel.from_export(exported["dynamic"][0], device="cpu")
    live = ServedModel.from_block(nets[1], [((T,), "int32"), ((), "int32")],
                                  device="cpu")
    assert model.fixed_batch is None
    assert model.input_signature == live.input_signature
    x = _batch(B)
    got, want = model.predict(x), live.predict(x)
    assert [g.shape for g in got] == [(B, T, 64), (B, 64)]
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, **F32)


def test_export_answers_as_the_jax_export(nets, exported, tmp_path):
    jsym, _ = nets[0].export(str(tmp_path / "jax"), input_signature=SIG,
                             dynamic_batch=True)
    jmodel = jserving.ServedModel.from_export(jsym)
    model = ServedModel.from_export(exported["dynamic"][0], device="cpu")
    for B in (1, 4):
        x = _batch(B, seed=7)
        for g, w in zip(model.predict(x), jmodel.predict(x)):
            onp.testing.assert_allclose(g, w, **CROSS)


def test_served_export_answers_requests(nets, exported):
    model = ServedModel.from_export(exported["dynamic"][0], device="cpu")
    live = ServedModel.from_block(nets[1], [((T,), "int32"), ((), "int32")],
                                  device="cpu")
    policy = BucketPolicy(batch_buckets=(1, 2, 4), pad_axis=0,
                          length_buckets=(T,))
    rng = onp.random.RandomState(3)
    samples = [(rng.randint(0, 100, L).astype("int32"), onp.int32(L))
               for L in (3, 16, 9, 1, 12)]
    with ModelServer(model, policy, warmup=True, timeout_ms=1) as srv:
        assert srv.warmed == 3
        got = [srv.infer(*s, timeout=60.0) for s in samples]
        stats = srv.describe()["exec_cache"]
    # warmup runs each bucket twice: 3 first runs, 3 + 5 on a seen one
    assert stats == {"size": 3, "hits": 3 + len(samples), "misses": 3}
    with ModelServer(live, policy, timeout_ms=1) as srv:
        want = [srv.infer(*s, timeout=60.0) for s in samples]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            onp.testing.assert_allclose(a, b, **F32)


def test_symbol_file_and_graph(exported):
    sym, params = exported["dynamic"]
    meta = json.load(open(sym))
    assert meta["framework"] == "mxnet_tpu_torch"
    assert meta["format_version"] == 1 and meta["dynamic_batch"] is True
    assert meta["inputs"] == [{"shape": [2, T], "dtype": "int32"},
                              {"shape": [2], "dtype": "int32"}]
    assert len(meta["param_order"]) == len(set(meta["param_order"]))
    assert {"program", "program_sha256", "params_sha256"} <= set(meta)
    assert params.endswith("dyn-0000.params")
    import io
    ep = torch.export.load(io.BytesIO(base64.b64decode(meta["program"])))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("mxnet_tpu_torch.flash_attention_fwd.default") == 2
    assert not ep.state_dict and not ep.constants
    assert ep.example_inputs is None      # no weights in the program
    user = [s for s in ep.graph_signature.input_specs
            if s.kind.name == "USER_INPUT"]
    assert len(user) == len(meta["param_order"]) + 2


def _rewrite_program(sym, tmp_path, edit):
    meta = json.load(open(sym))
    blob = edit(bytearray(base64.b64decode(meta["program"])))
    meta["program"] = base64.b64encode(bytes(blob)).decode("ascii")
    out = tmp_path / "bad-symbol.json"
    out.write_text(json.dumps(meta))
    return str(out)


def _flip(blob):
    blob[len(blob) // 2] ^= 0x01
    return blob


@pytest.mark.parametrize("what,edit", [
    ("program", _flip), ("program", lambda b: b[:len(b) // 2]),
    ("params", _flip), ("params", lambda b: b[:len(b) - 100])],
    ids=["program_flipped", "program_truncated", "params_flipped",
         "params_truncated"])
def test_garbled_artifacts_raise_before_loading(exported, tmp_path, what,
                                                edit):
    sym, params = exported["dynamic"]
    if what == "program":
        sym = _rewrite_program(sym, tmp_path, edit)
        match = "program checksum"
    else:
        bad = tmp_path / "bad-0000.params"
        bad.write_bytes(bytes(edit(bytearray(open(params, "rb").read()))))
        params = str(bad)
        match = "failed its checksum"
    with pytest.raises(MXNetError, match=match):
        ServedModel.from_export(sym, param_file=params, device="cpu")


def test_static_export_serves_its_batch_only(nets, exported):
    sym, params = exported["static"]
    assert params.endswith("static-0003.params")
    model = ServedModel.from_export(sym, device="cpu")
    assert model.fixed_batch == 4
    assert model.default_policy().batch_buckets == (4,)
    with pytest.raises(MXNetError, match="static export"):
        ModelServer(model, BucketPolicy(batch_buckets=(1, 4)))
    with pytest.raises(MXNetError, match="static export"):
        model.warmup(BucketPolicy(batch_buckets=(2,)))
    live = ServedModel.from_block(nets[1], [((T,), "int32"), ((), "int32")],
                                  device="cpu")
    x = _batch(4)
    for g, w in zip(model.predict(x), live.predict(x)):
        onp.testing.assert_allclose(g, w, **F32)
    with pytest.raises(Exception):
        model.predict(_batch(2))


def test_exports_do_not_cross_packages(nets, exported, tmp_path):
    jsym, _ = nets[0].export(str(tmp_path / "jax"), input_signature=SIG)
    with pytest.raises(MXNetError, match="framework 'mxnet_tpu'"):
        ServedModel.from_export(jsym, device="cpu")
    with pytest.raises(mx.MXNetError, match="not an mxnet_tpu export"):
        jserving.ServedModel.from_export(exported["dynamic"][0])


def test_export_needs_a_signature():
    net = nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    with pytest.raises(MXNetError, match="input signature"):
        net.export("unused")


class _Tied(HybridBlock):
    def __init__(self):
        super().__init__()
        self.a = nn.Dense(4, in_units=4, use_bias=False)
        self.b = nn.Dense(4, in_units=4, use_bias=False)
        self.b.weight = self.a.weight

    def forward(self, x):
        return self.b(self.a(x))


def test_tied_parameters_are_traced_once(tmp_path):
    from mxnet_tpu_torch.ndarray_io import read_tensors
    net = _Tied()
    net.initialize(device="cpu")
    sym, params = net.export(str(tmp_path / "tied"),
                             input_signature=[((2, 4), "float32")],
                             dynamic_batch=True)
    assert json.load(open(sym))["param_order"] == ["a.weight"]
    assert sorted(read_tensors(params)) == ["a.weight", "b.weight"]
    x = onp.random.RandomState(0).randn(3, 4).astype("float32")
    got = ServedModel.from_export(sym, device="cpu").predict([x])[0]
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, want, **F32)


class _Writes(HybridBlock):
    def __init__(self):
        super().__init__()
        self.count = Parameter("count", shape=(1,), init="zeros",
                               grad_req="null")

    def forward(self, x):
        self.count.data().add_(1)
        return x * 2


def test_a_forward_that_writes_a_parameter_raises(tmp_path):
    net = _Writes()
    net.initialize(device="cpu")
    with pytest.raises(MXNetError, match="mutates parameter state"):
        net.export(str(tmp_path / "w"), input_signature=[((2, 3),
                                                          "float32")])
    assert not (tmp_path / "w-0000.params").exists()
