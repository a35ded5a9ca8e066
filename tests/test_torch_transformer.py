"""The port's encoder-decoder Transformer
(mxnet_tpu_torch/gluon/model_zoo/transformer.py) and its KV-cache decoding
(transformer_generation.py) against the JAX package's, on the same
parameters (``convert.load_jax_params``) and inputs, in f32 on the CPU:
a small model of 2 + 2 layers, 32 units, 4 heads, vocabulary 61,
``max_length`` 48.

Logits at rtol=1e-5, atol=1e-5, with and without ``src_valid_length``
(a valid length of 0 among them), shared and separate vocabularies;
gradients of one step at 1e-5 relative Frobenius; each weight after
three Adam steps at 1e-4 relative Frobenius, as the small BERT's AdamW
steps in ``test_torch_training.py`` (Adam's step lr * m / sqrt(v) scales
a gradient entry's summation-order noise by 1 / |g|, so a bias that
starts at 0 moves with ~1e-5 relative noise, and single entries are not
compared); greedy ``translate`` and ``beam_translate``
tokens equal to the JAX package's, beam scores within 1e-5. Sampling
cannot match (threefry against the port's Philox key), so sampled tokens
are held to the port's own rules: the same seed gives the same tokens,
``top_k=1`` is greedy.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.transformer import \
    get_transformer as jget_transformer
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch import cpu as tcpu
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon import Trainer
from mxnet_tpu_torch.gluon import loss as port_loss
from mxnet_tpu_torch.gluon.model_zoo import get_transformer
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerModel
from torch_port_util import TINY_TRANSFORMER, transformer_pair

TOL = dict(rtol=1e-5, atol=1e-5)
V = TINY_TRANSFORMER["src_vocab_size"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's own initializers (Uniform(0.07), positions
    Normal(0.01)): the regime of the logits and gradient comparisons."""
    return transformer_pair(seed=0)


@pytest.fixture(scope="module")
def strong_pair():
    """Weights at a scale where greedy streams do not settle on one token
    (``strong_transformer_params``), for the decoding comparisons."""
    return transformer_pair(seed=1, strong=True)


def _toks(seed, B, T, vocab=V):
    return onp.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        "int32")


def _t(a):
    return torch.from_numpy(onp.asarray(a)).long()


def _rel(a, b):
    return float(onp.linalg.norm(a - b) / max(onp.linalg.norm(b), 1e-30))


VALID = {"none": None, "ragged": [9, 4, 1], "zero": [9, 0, 5]}


@pytest.mark.parametrize("valid", list(VALID))
@pytest.mark.parametrize("share", [True, False])
def test_logits_match_jax(valid, share):
    cfg = {} if share else dict(src_vocab_size=31, tgt_vocab_size=41)
    jnet, tnet, _ = transformer_pair(seed=2, **cfg)
    assert (tnet.src_embed is tnet.tgt_embed) == share
    src = _toks(3, 3, 9, cfg.get("src_vocab_size", V))
    tgt = _toks(4, 3, 7, cfg.get("tgt_vocab_size", V))
    vl = VALID[valid]
    want = jnet(mx.np.array(src), mx.np.array(tgt),
                None if vl is None else mx.np.array(vl)).asnumpy()
    with torch.inference_mode():
        got = tnet(_t(src), _t(tgt), None if vl is None else _t(vl)).numpy()
    assert got.shape == want.shape == (3, 7, cfg.get("tgt_vocab_size", V))
    onp.testing.assert_allclose(got, want, **TOL)


def test_collect_params_names_and_the_tie(pair):
    jnet, tnet, params = pair
    tp = tnet.collect_params()
    assert list(tp) == list(params) == list(jnet.collect_params())
    one, _, _ = transformer_pair(num_encoder_layers=1, num_decoder_layers=1)
    assert len(one.collect_params()) == 40
    assert tp["src_embed.weight"] is tp["tgt_embed.weight"]
    assert tp["src_embed.weight"].data().data_ptr() == \
        tp["tgt_embed.weight"].data().data_ptr()
    assert len({id(p) for p in tp.values()}) == len(tp) - 1
    sep = TransformerModel(src_vocab_size=31, tgt_vocab_size=41, units=16,
                           hidden_size=32, num_heads=2, num_encoder_layers=1,
                           num_decoder_layers=1, max_length=8)
    sp = sep.collect_params()
    assert sp["src_embed.weight"] is not sp["tgt_embed.weight"]
    assert tuple(sp["tgt_embed.weight"].shape) == (41, 16)
    with pytest.raises(MXNetError, match="equal vocabularies"):
        TransformerModel(src_vocab_size=31, tgt_vocab_size=41,
                         share_embed=True)


def _loss_batch(seed=5, B=3, Ts=9, Tt=7):
    src = _toks(seed, B, Ts)
    tgt = _toks(seed + 1, B, Tt + 1)
    return src, tgt[:, :-1], tgt[:, 1:], onp.array([9, 4, 6], "int32")


def test_one_step_gradients_match_jax(pair):
    jnet, tnet, _ = pair
    src, tin, lab, vl = _loss_batch()
    jl_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tl_fn = port_loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        jl = jl_fn(jnet(mx.np.array(src), mx.np.array(tin), mx.np.array(vl)),
                   mx.np.array(lab)).mean()
    jl.backward()
    with autograd.record():
        tl = tl_fn(tnet(_t(src), _t(tin), _t(vl)), _t(lab)).mean()
    autograd.backward(tl)
    onp.testing.assert_allclose(tl.item(), float(jl.asnumpy()), rtol=1e-5)
    jp = jnet.collect_params()
    worst = max((_rel(p.grad().numpy(), jp[k].grad().asnumpy()), k)
                for k, p in tnet.collect_params().items())
    assert worst[0] <= 1e-5, worst


def test_three_adam_steps_match_jax():
    jnet, tnet, params = transformer_pair(seed=6)
    src, tin, lab, vl = _loss_batch(seed=7)
    B = src.shape[0]
    hp = {"learning_rate": 1e-3}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adam", dict(hp))
    ttr = Trainer(tnet.collect_params(), "adam", dict(hp))
    # the tied embedding is one tensor: the trainer updates it once a step
    assert len(ttr._params) == len(params) - 1
    jl_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tl_fn = port_loss.SoftmaxCrossEntropyLoss()
    arr = mx.np.array
    for step in range(3):
        with mx.autograd.record():
            jl = jl_fn(jnet(arr(src), arr(tin), arr(vl)), arr(lab))
        jl.backward()
        jtr.step(B)
        with autograd.record():
            tl = tl_fn(tnet(_t(src), _t(tin), _t(vl)), _t(lab))
        autograd.backward(tl)
        ttr.step(B)
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    rtol=1e-5, err_msg=f"step {step}")
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tp = export_params(tnet)
    C = TINY_TRANSFORMER["units"]
    for k in jp:
        got, want = tp[k].copy(), jp[k].copy()
        # the key biases' exact gradient is 0 (a constant added to every
        # key of a row leaves its softmax as it was): what each package
        # gets is rounding noise, which Adam's normalized step turns into
        # moves of up to lr a step; they are held to that bound alone
        noise = slice(C, 2 * C) if k.endswith("attn_qkv.bias") else \
            slice(0, C) if k.endswith("cross_kv.bias") else slice(0, 0)
        for d in (got, want):
            move = d[noise] - params[k][noise]
            assert abs(move).max(initial=0) <= 3 * hp["learning_rate"]
            d[noise] = 0
        assert _rel(got, want) <= 1e-4, (k, _rel(got, want))
    assert max(_rel(tp[k], params[k]) for k in jp) > 1e-3


@pytest.mark.parametrize("valid", list(VALID))
def test_greedy_translate_matches_jax(strong_pair, valid):
    jnet, tnet, _ = strong_pair
    src = _toks(8, 3, 9)
    vl = VALID[valid]
    want = jnet.translate(src, 12, bos_token=1,
                          src_valid_length=vl).asnumpy()
    got = tnet.translate(src, 12, bos_token=1, src_valid_length=vl)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 12)
    onp.testing.assert_array_equal(got.numpy(), want)
    assert all(len(set(row)) > 1 for row in want.tolist()), want


def test_greedy_translate_is_a_teacher_forced_argmax(strong_pair):
    """Each greedy token is the argmax of the full decoder recomputed over
    the prefix (the JAX package's ``test_translate_greedy_matches_full_
    recompute``, on the port alone)."""
    _, tnet, _ = strong_pair
    src = _toks(9, 2, 6)
    vl = onp.array([6, 3], "int32")
    got = tnet.translate(src, 7, bos_token=1, src_valid_length=vl).numpy()
    with torch.inference_mode():
        memory = tnet.encode(_t(src), _t(vl))
        toks = onp.full((2, 1), 1, "int64")
        for i in range(7):
            logits = tnet.decode(_t(toks), memory, _t(vl), src=_t(src))
            nxt = logits[:, -1].argmax(-1).numpy()
            onp.testing.assert_array_equal(got[:, i], nxt)
            toks = onp.concatenate([toks, nxt[:, None]], axis=1)


@pytest.mark.parametrize("valid", ["none", "ragged", "zero"])
@pytest.mark.parametrize("K,eos", [(1, None), (4, None), (3, 7)])
def test_beam_translate_matches_jax(strong_pair, valid, K, eos):
    jnet, tnet, _ = strong_pair
    src = _toks(10, 3, 9)
    vl = VALID[valid]
    jseq, jsc = jnet.beam_translate(src, 8, bos_token=1, beam_size=K,
                                    eos_token=eos, src_valid_length=vl,
                                    alpha=0.8)
    tseq, tsc = tnet.beam_translate(src, 8, bos_token=1, beam_size=K,
                                    eos_token=eos, src_valid_length=vl,
                                    alpha=0.8)
    assert tuple(tseq.shape) == (3, K, 8) and tseq.dtype == torch.int32
    onp.testing.assert_array_equal(tseq.numpy(), jseq.asnumpy())
    onp.testing.assert_allclose(tsc.numpy(), jsc.asnumpy(), rtol=1e-5,
                                atol=1e-5)
    assert (onp.diff(tsc.numpy(), axis=1) <= 0).all()


def test_beam_k1_is_greedy_and_k4_scores_no_lower(strong_pair):
    _, tnet, _ = strong_pair
    src = _toks(11, 2, 5)
    greedy = tnet.translate(src, 6, bos_token=1).numpy()
    s1, c1 = tnet.beam_translate(src, 6, bos_token=1, beam_size=1)
    onp.testing.assert_array_equal(s1.numpy()[:, 0], greedy)
    _, c4 = tnet.beam_translate(src, 6, bos_token=1, beam_size=4)
    assert (c4.numpy()[:, 0] >= c1.numpy()[:, 0] - 1e-4).all()


def test_padded_source_equals_trimmed(strong_pair):
    _, tnet, _ = strong_pair
    short = _toks(12, 1, 4)
    padded = onp.concatenate([short, onp.full((1, 3), 9, "int32")], axis=1)
    a = tnet.translate(short, 5, bos_token=1)
    b = tnet.translate(padded, 5, bos_token=1, src_valid_length=[4])
    onp.testing.assert_array_equal(a.numpy(), b.numpy())
    sa, ca = tnet.beam_translate(short, 5, bos_token=1, beam_size=3)
    sb, cb = tnet.beam_translate(padded, 5, bos_token=1, beam_size=3,
                                 src_valid_length=torch.tensor([4]))
    onp.testing.assert_array_equal(sa.numpy(), sb.numpy())
    onp.testing.assert_allclose(ca.numpy(), cb.numpy(), rtol=1e-5, atol=1e-6)


def test_eos_and_validation_errors_match_jax(strong_pair):
    jnet, tnet, _ = strong_pair
    src = onp.array([[3, 4, 5]], dtype="int32")
    g = tnet.translate(src, 8, bos_token=1).numpy()
    eos = int(g[0, 2])
    e = tnet.translate(src, 8, bos_token=1, eos_token=eos).numpy()
    onp.testing.assert_array_equal(
        e, jnet.translate(src, 8, bos_token=1, eos_token=eos).asnumpy())
    hit = int(onp.argmax(e[0] == eos))
    assert hit <= 2 and (e[0, hit:] == eos).all()
    long_src = onp.zeros((1, 49), "int32")
    bad = [((src, 0, 1), {}), ((src, 49, 1), {}), ((long_src, 4, 1), {}),
           ((src, 4, 1), dict(method="top_k", top_k=0)),
           ((src, 4, 1), dict(method="top_p", top_p=0.0)),
           ((src, 4, 1), dict(method="top_p", top_p=1.5))]
    for args, kw in bad:
        with pytest.raises(mx.MXNetError) as jerr:
            jnet.translate(*args, **kw)
        with pytest.raises(MXNetError) as terr:
            tnet.translate(*args, **kw)
        assert str(terr.value) == str(jerr.value), (args[1:], kw)
    with pytest.raises(mx.MXNetError) as jerr:
        jnet.beam_translate(src, 4, 1, beam_size=0)
    with pytest.raises(MXNetError) as terr:
        tnet.beam_translate(src, 4, 1, beam_size=0)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(MXNetError, match="method"):
        tnet.translate(src, 4, 1, method="beam")


def test_sampling_is_deterministic_by_seed(strong_pair):
    _, tnet, _ = strong_pair
    src = _toks(13, 2, 6)
    for method, kw in (("sample", dict(temperature=0.9)),
                       ("top_k", dict(top_k=5)), ("top_p", dict(top_p=0.8))):
        a = tnet.translate(src, 10, 1, method=method, seed=5, **kw).numpy()
        b = tnet.translate(src, 10, 1, method=method, seed=5, **kw).numpy()
        onp.testing.assert_array_equal(a, b)
        c = tnet.translate(src, 10, 1, method=method, seed=6, **kw).numpy()
        assert (a != c).any(), method
    greedy = tnet.translate(src, 10, 1).numpy()
    onp.testing.assert_array_equal(
        tnet.translate(src, 10, 1, method="top_k", top_k=1, seed=3).numpy(),
        greedy)


def test_get_transformer_specs_and_devices():
    for get, err in ((get_transformer, MXNetError),
                     (jget_transformer, mx.MXNetError)):
        with pytest.raises(err, match="transformer_tiny"):
            get("transformer_tiny")
    cfg = dict(src_vocab_size=50, max_length=16)
    for kw in (dict(device="cpu"), dict(ctx=tcpu())):
        net = get_transformer("transformer_base", **cfg, **kw)
        assert {p.data().device.type for p in
                net.collect_params().values()} == {"cpu"}
        assert len(net.enc_layers) == len(net.dec_layers) == 6
        assert net.enc_layers[0]._units == 512
        assert net.dec_layers[0]._num_heads == 8
    jnet = jget_transformer("transformer_base", **cfg)
    assert sorted(jnet.collect_params()) == sorted(net.collect_params())
    with pytest.raises(MXNetError, match="not both"):
        get_transformer(device="cpu", ctx=tcpu(), **cfg)


def test_hybridized_equals_eager(pair):
    _, _, params = pair
    net = load_jax_params(TransformerModel(**TINY_TRANSFORMER), params)
    src, tin, _, vl = _loss_batch(seed=14)
    with torch.inference_mode():
        eager = [net(_t(src), _t(tin), _t(vl)), net(_t(src), _t(tin))]
        net.hybridize()
        hybrid = [net(_t(src), _t(tin), _t(vl)), net(_t(src), _t(tin))]
    for a, b in zip(eager, hybrid):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_save_load_parameters_keep_the_alias(pair, tmp_path):
    jnet, tnet, _ = pair
    path = str(tmp_path / "nmt.params")
    tnet.save_parameters(path)
    net2 = TransformerModel(**TINY_TRANSFORMER)
    net2.load_parameters(path)
    cp = net2.collect_params()
    assert cp["src_embed.weight"] is cp["tgt_embed.weight"]
    src, tin, _, vl = _loss_batch(seed=15)
    with torch.inference_mode():
        torch.testing.assert_close(net2(_t(src), _t(tin), _t(vl)),
                                   tnet(_t(src), _t(tin), _t(vl)), rtol=0,
                                   atol=0)
    # the JAX package reads the port's file, alias included
    from mxnet_tpu.gluon.model_zoo.transformer import TransformerModel as JT
    jnet2 = JT(**TINY_TRANSFORMER)
    jnet2.load_parameters(path)
    onp.testing.assert_allclose(
        jnet2(mx.np.array(src), mx.np.array(tin), mx.np.array(vl)).asnumpy(),
        jnet(mx.np.array(src), mx.np.array(tin), mx.np.array(vl)).asnumpy(),
        rtol=1e-6, atol=1e-6)
