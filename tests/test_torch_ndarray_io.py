"""``.params`` files between the JAX package and the port.

Both packages write the same ``MXTPU001`` format: a file either writes loads
in the other, and the same dict gives byte-identical files (f32, bf16,
int32, bool, 0-d). A small BERT (``num_layers=2, units=64``) saved by the
JAX package's ``save_parameters`` and loaded by the port's
``load_parameters`` answers as the JAX net does (``seq`` and ``pooled``
within relative 1e-5: the same weights, two CPU math libraries); the port's
file of the same net loads back into the JAX package bit for bit.
"""
import os

import numpy as onp
import jax  # noqa: F401  (JAX on the CPU before the JAX package loads)
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert

from torch_port_util import SMALL_BERT, bert_pair, inputs, jax_forward

rng = onp.random.RandomState(0)
ARRAYS = {
    "f32": rng.standard_normal((3, 5)).astype("float32"),
    "bf16": rng.standard_normal((4, 2)).astype("float32"),
    "i32": rng.randint(-9, 9, (7,)).astype("int32"),
    "scalar": onp.array(2.5, "float32"),
    "flags": rng.uniform(size=(2, 3)) > 0.5,
    "empty": onp.zeros((0, 3), "float32"),
}


def _nd(pkg, name, a):
    return pkg.nd.array(a, dtype="bfloat16" if name == "bf16" else None)


def _values(d):
    return {k: onp.asarray(v.asnumpy(), "float32") if str(v.dtype) ==
            "bfloat16" else v.asnumpy() for k, v in d.items()}


def _save_both(tmp_path):
    jpath, tpath = str(tmp_path / "jax.params"), str(tmp_path / "port.params")
    jmx.nd.save(jpath, {k: _nd(jmx, k, a) for k, a in ARRAYS.items()})
    with tmx.cpu():
        tmx.nd.save(tpath, {k: _nd(tmx, k, a) for k, a in ARRAYS.items()})
    return jpath, tpath


def test_files_are_byte_identical(tmp_path):
    jpath, tpath = _save_both(tmp_path)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


def test_jax_file_loads_in_the_port(tmp_path):
    jpath, _ = _save_both(tmp_path)
    with tmx.cpu():
        got = tmx.nd.load(jpath)
    want = jmx.nd.load(jpath)
    assert {k: str(v.dtype) for k, v in got.items()} == \
        {k: str(v.dtype) for k, v in want.items()}
    gv, wv = _values(got), _values(want)
    for k in ARRAYS:
        assert gv[k].shape == wv[k].shape
        onp.testing.assert_array_equal(gv[k], wv[k])


def test_port_file_loads_in_the_jax_package(tmp_path):
    _, tpath = _save_both(tmp_path)
    want = _values(jmx.nd.load(tpath))
    for k, a in ARRAYS.items():
        ref = onp.asarray(_nd(jmx, k, a).asnumpy(), want[k].dtype)
        onp.testing.assert_array_equal(want[k], ref)


def test_list_form_and_bad_magic(tmp_path):
    path = str(tmp_path / "list.params")
    with tmx.cpu():
        tmx.nd.save(path, [tmx.nd.array(ARRAYS["f32"]),
                           tmx.nd.array(ARRAYS["i32"])])
        back = tmx.nd.load(path)
    assert isinstance(back, list) and len(back) == 2
    onp.testing.assert_array_equal(back[1].asnumpy(), ARRAYS["i32"])
    assert [a.asnumpy().tolist() for a in jmx.nd.load(path)] == \
        [a.asnumpy().tolist() for a in back]
    bad = tmp_path / "bad.params"
    bad.write_bytes(b"NOTMAGIC" + bytes(8))
    with pytest.raises(MXNetError, match="magic"):
        tmx.nd.load(str(bad))


def test_bert_saved_by_jax_answers_the_same_in_the_port(tmp_path):
    jnet, _, _ = bert_pair(seed=3)
    path = str(tmp_path / "bert.params")
    jnet.save_parameters(path)
    tnet = get_bert("bert_12_768_12", device="cpu", **SMALL_BERT)
    tnet.load_parameters(path)
    tokens, types, vl = inputs(5, 2, 16, [16, 9])
    want = jax_forward(jnet, tokens, vl, types)
    with torch.no_grad():
        got = tnet(torch.from_numpy(tokens), torch.from_numpy(types),
                   torch.from_numpy(vl))
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        assert onp.linalg.norm(g - w) <= 1e-5 * onp.linalg.norm(w)
    # and back: the port's file of the same net loads into the JAX package
    back = str(tmp_path / "bert_port.params")
    tnet.save_parameters(back)
    jnet2, _, _ = bert_pair(seed=4)
    jnet2.load_parameters(back)
    for k, p in jnet.collect_params().items():
        onp.testing.assert_array_equal(
            jnet2.collect_params()[k].data().asnumpy(), p.data().asnumpy())


def test_bf16_block_round_trip_keeps_dtype_and_bits(tmp_path):
    net = nn.Dense(3, in_units=4)
    net.initialize(generator=torch.Generator().manual_seed(0), device="cpu")
    net.cast("bfloat16")
    path = str(tmp_path / "dense.params")
    net.save_parameters(path)
    fresh = nn.Dense(3, in_units=4)
    fresh.initialize(generator=torch.Generator().manual_seed(1),
                     device="cpu")
    fresh.load_parameters(path)
    for k, p in net.collect_params().items():
        q = fresh.collect_params()[k]
        assert q.dtype == torch.bfloat16 and torch.equal(q, p)
    x = torch.randn(2, 4).to(torch.bfloat16)
    assert torch.equal(net(x), fresh(x))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_parameters_is_strict(tmp_path, fault):
    net = nn.Dense(3, in_units=4)
    net.initialize(generator=torch.Generator().manual_seed(0), device="cpu")
    params = {k: p.detach() for k, p in net.collect_params().items()}
    if fault == "missing":
        params.pop("bias")
    elif fault == "extra":
        params["other"] = torch.zeros(2)
    else:
        params["weight"] = torch.zeros(3, 5)
    path = str(tmp_path / "f.params")
    tmx.ndarray_io.save_params(path, params)
    with pytest.raises(MXNetError):
        net.load_parameters(path)
    if fault == "missing":
        net.load_parameters(path, allow_missing=True)
    if fault == "extra":
        net.load_parameters(path, ignore_extra=True)


def test_batchnorm_state_is_rebuilt_on_load(tmp_path):
    jbn = jmx.gluon.nn.BatchNorm(in_channels=4)
    jbn.initialize()
    jbn.running_mean.set_data(jmx.nd.array(onp.arange(4, dtype="float32")))
    path = str(tmp_path / "bn.params")
    jbn.save_parameters(path)
    bn = nn.BatchNorm(in_channels=4)
    bn.initialize(generator=torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        bn.stat_shift.fill_(3.0)
    bn.load_parameters(path)
    assert torch.equal(bn.stat_shift, torch.zeros(4))
    onp.testing.assert_array_equal(bn.running_mean.detach().numpy(),
                                   onp.arange(4, dtype="float32"))
    assert "stat_shift" not in tmx.ndarray_io.read_tensors(path)
    assert os.path.getsize(path) > 0
