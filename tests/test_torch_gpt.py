"""The port's GPT (mxnet_tpu_torch/gluon/model_zoo/gpt.py) and its host-side
decoding (model_zoo/generation.py) against the JAX package's, on the same
parameters (``convert.load_jax_params``) and inputs, in f32 on the CPU.

Logits and parameter gradients at rtol=1e-4, atol=1e-5 (summation order
through two layers); greedy ``generate`` and ``beam_search`` tokens equal
to the JAX package's; the top-k and top-p filters equal to the JAX
package's ``_select`` on the same logits (its categorical draw is
intercepted to read the filtered logits). Sampling itself cannot match:
the JAX package draws with threefry, the port with a counter-based Philox
key (model_zoo/generation.py), so sampled tokens are held to the port's own
rules (same seed, same tokens; top_k=1 and a tiny top_p are greedy; top_p=1
is plain sampling).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import generation as tgen
from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel, get_gpt
from torch_port_util import gpt_pair

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are small: torch's intra-op thread pool only adds
    synchronisation here, and more so while other test processes share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return gpt_pair(seed=0)


@pytest.fixture(scope="module")
def small_pair():
    """Normal(0.05) weights (as ``test_torch_bert.py``'s): the regime of
    the elementwise logits and gradient comparisons. The decoding tests
    use Normal(1.0), whose logits reach ~40 and are compared to their
    scale."""
    return gpt_pair(seed=3, sigma=0.05)


def _tokens(seed, B, T, vocab=97):
    return onp.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        "int32")


@pytest.mark.parametrize("B,T", [(1, 1), (2, 10), (3, 64)])
def test_gpt_logits_match_jax(small_pair, pair, B, T):
    toks = _tokens(B * 100 + T, B, T)
    for (jnet, tnet, _), strong in ((small_pair, False), (pair, True)):
        want = jnet(mx.np.array(toks)).asnumpy()
        with torch.inference_mode():
            got = tnet(torch.from_numpy(toks).long()).numpy()
        assert got.shape == (B, T, 97)
        if strong:
            assert abs(got - want).max() <= 1e-5 * abs(want).max()
        else:
            onp.testing.assert_allclose(got, want, **TOL)


def test_collect_params_names_match_jax(pair):
    _, tnet, params = pair
    assert list(tnet.collect_params()) == list(params)
    assert "position_weight" in params


def test_gpt_parameter_gradients_match_jax(small_pair):
    jnet, tnet, _ = small_pair
    toks = _tokens(7, 2, 12)
    w = onp.random.RandomState(8).randn(2, 12, 97).astype("float32")
    with mx.autograd.record():
        jl = (jnet(mx.np.array(toks)) * mx.np.array(w)).sum()
    jl.backward()
    with autograd.record():
        tl = (tnet(torch.from_numpy(toks).long()) * torch.from_numpy(w)
              ).sum()
    autograd.backward(tl)
    onp.testing.assert_allclose(tl.item(), float(jl.asnumpy()), rtol=1e-5)
    jp = jnet.collect_params()
    for k, p in tnet.collect_params().items():
        onp.testing.assert_allclose(p.grad().numpy(), jp[k].grad().asnumpy(),
                                    err_msg=k, **TOL)


def test_gpt_causality(pair):
    _, tnet, _ = pair
    x = torch.from_numpy(_tokens(0, 2, 10)).long()
    x2 = x.clone()
    x2[:, -1] = (x2[:, -1] + 1) % 97
    with torch.inference_mode():
        out, out2 = tnet(x), tnet(x2)
    torch.testing.assert_close(out[:, :-1], out2[:, :-1], rtol=1e-5,
                               atol=1e-6)
    assert not torch.allclose(out[:, -1], out2[:, -1])


def test_gpt_hybridize_equivalence(pair):
    _, tnet, params = pair
    from mxnet_tpu_torch.convert import load_jax_params
    net = load_jax_params(GPTModel(vocab_size=97, num_layers=2, units=32,
                                   hidden_size=48, num_heads=4,
                                   max_length=64, dropout=0.0), params)
    x = torch.from_numpy(_tokens(1, 2, 8)).long()
    with torch.inference_mode():
        eager = net(x)
        net.hybridize()
        hybrid = net(x)
    torch.testing.assert_close(eager, hybrid, rtol=1e-5, atol=1e-6)


def test_gpt_three_adamw_steps_match_jax():
    """The language-model step (``bench.py:bench_gpt``'s, on a small GPT):
    ``SoftmaxCrossEntropyLoss(axis=-1)`` over (B, T, V) logits,
    ``backward``, ``Trainer.step`` with AdamW, three times. Losses at
    rtol=1e-5; each weight after the steps at 1e-4 relative Frobenius (as
    the small BERT's AdamW steps in ``test_torch_training.py``: Adam's
    step scales a gradient entry's rounding noise by 1 / |g|), the key
    biases, whose exact gradient is 0, held to moves of at most lr a
    step."""
    from mxnet_tpu_torch.convert import export_params
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    jnet, tnet, params = gpt_pair(seed=4, sigma=0.05)
    toks = _tokens(21, 2, 17)
    x, y = toks[:, :-1], toks[:, 1:]
    hp = {"learning_rate": 1e-3, "wd": 0.01}
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(hp))
    ttr = Trainer(tnet.collect_params(), "adamw", dict(hp))
    jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=-1)
    tloss = SoftmaxCrossEntropyLoss(axis=-1)
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    for step in range(3):
        with mx.autograd.record():
            jl = jloss(jnet(mx.np.array(x)), mx.np.array(y))
        jl.backward()
        jtr.step(2)
        with autograd.record():
            tl = tloss(tnet(tx), ty)
        autograd.backward(tl)
        ttr.step(2)
        assert tuple(tl.shape) == jl.shape
        onp.testing.assert_allclose(tl.detach().numpy(), jl.asnumpy(),
                                    rtol=1e-5, err_msg=f"step {step}")
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tp = export_params(tnet)
    C = 32
    moved = 0.0
    for k in jp:
        got, want = tp[k].copy(), jp[k].copy()
        if k.endswith("attn_qkv.bias"):
            for d in (got, want):
                move = d[C:2 * C] - params[k][C:2 * C]
                assert abs(move).max() <= 3 * hp["learning_rate"]
                d[C:2 * C] = 0
        err = onp.linalg.norm(got - want) / onp.linalg.norm(want)
        assert err <= 1e-4, (k, err)
        moved = max(moved, onp.linalg.norm(want - params[k])
                    / onp.linalg.norm(params[k]))
    assert moved > 1e-3


def test_gpt_specs_and_max_length_guard(pair):
    from mxnet_tpu.gluon.model_zoo.gpt import _SPECS as JSPECS
    from mxnet_tpu_torch.gluon.model_zoo.gpt import _SPECS
    assert _SPECS == JSPECS
    with pytest.raises(ValueError):
        get_gpt("gpt_unknown", device="cpu")
    _, tnet, _ = pair
    with pytest.raises(MXNetError, match="max_length"):
        tnet(torch.zeros((1, 65), dtype=torch.long))


def test_gpt2_124m_shapes_and_moe_refusal():
    net = get_gpt("gpt2_124m", device="cpu", dropout=0.0)
    shapes = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    assert shapes["word_embed.weight"] == (50257, 768)
    assert shapes["position_weight"] == (1024, 768)
    assert shapes["blocks.11.attn_qkv.weight"] == (2304, 768)
    assert sum(1 for k in shapes if k.endswith("ffn1.weight")) == 12
    with pytest.raises(MXNetError, match="Queue A 13"):
        GPTModel(vocab_size=11, num_layers=2, units=8, hidden_size=16,
                 num_heads=2, max_length=8, moe_every_n=1)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(MXNetError, match="device='cpu'"):
        get_gpt("gpt2_124m", vocab_size=11, num_layers=1)


# ---------------------------------------------------------------------------
# host-side decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T0,n", [(1, 3, 12), (2, 5, 8)])
def test_generate_greedy_matches_jax_and_full_forward(pair, B, T0, n):
    jnet, tnet, _ = pair
    prompt = _tokens(B + T0, B, T0)
    got = tnet.generate(prompt, n)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    onp.testing.assert_array_equal(
        got.numpy(), jnet.generate(prompt, n).asnumpy())
    toks = torch.from_numpy(prompt).long()
    want = []
    with torch.inference_mode():
        for _ in range(n):
            nxt = tnet(toks)[:, -1].argmax(-1)
            want.append(nxt)
            toks = torch.cat([toks, nxt[:, None]], 1)
    onp.testing.assert_array_equal(got.numpy(),
                                   torch.stack(want, 1).numpy())
    assert len(set(got.numpy().ravel().tolist())) > 1, \
        "degenerate fixture: constant stream"


def test_generate_respects_layer_norm_eps():
    jnet, tnet, _ = gpt_pair(seed=5, vocab_size=61, num_layers=1, units=16,
                             hidden_size=32, num_heads=2, max_length=32,
                             layer_norm_eps=1e-2)
    prompt = _tokens(1, 1, 4, vocab=61)
    onp.testing.assert_array_equal(tnet.generate(prompt, 5).numpy(),
                                   jnet.generate(prompt, 5).asnumpy())


def test_generate_eos_pads_the_tail(pair):
    _, tnet, _ = pair
    prompt = onp.array([[1, 2, 3]], dtype="int32")
    gd = tnet.generate(prompt, 8).numpy()
    eos = int(gd[0, 1])
    e = tnet.generate(prompt, 8, eos_token=eos).numpy()
    hit = int(onp.argmax(e[0] == eos))
    assert hit <= 1 and (e[0, hit:] == eos).all()
    onp.testing.assert_array_equal(e[0, :hit], gd[0, :hit])


def test_generate_sampling_rules(pair):
    _, tnet, _ = pair
    prompt = onp.array([[1, 2, 3]], dtype="int32")
    a = tnet.generate(prompt, 8, method="sample", temperature=0.8, seed=7)
    b = tnet.generate(prompt, 8, method="sample", temperature=0.8, seed=7)
    c = tnet.generate(prompt, 8, method="sample", temperature=0.8, seed=8)
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)
    gd = tnet.generate(prompt, 8)
    torch.testing.assert_close(
        tnet.generate(prompt, 8, method="top_k", top_k=1, seed=3), gd)
    torch.testing.assert_close(
        tnet.generate(prompt, 8, method="top_p", top_p=1e-6, seed=5), gd)
    torch.testing.assert_close(
        tnet.generate(prompt, 8, method="top_p", top_p=1.0,
                      temperature=0.8, seed=7), a)


def test_generate_validates_args():
    _, tnet, _ = gpt_pair(seed=0, max_length=16)
    with pytest.raises(MXNetError, match="max_length"):
        tnet.generate(onp.zeros((1, 10), "int32"), 10)
    with pytest.raises(MXNetError, match=">= 1"):
        tnet.generate(onp.zeros((1, 4), "int32"), 0)
    with pytest.raises(MXNetError, match="top_k"):
        tnet.generate(onp.zeros((1, 4), "int32"), 2, method="top_k",
                      top_k=0)
    for bad in (0.0, 1.5):
        with pytest.raises(MXNetError, match="top_p"):
            tnet.generate(onp.zeros((1, 4), "int32"), 2, method="top_p",
                          top_p=bad)
    with pytest.raises(MXNetError, match="method"):
        tnet.generate(onp.zeros((1, 4), "int32"), 2, method="beam")
    # top_k beyond the vocab clamps
    out = tnet.generate(onp.zeros((1, 4), "int32"), 2, method="top_k",
                        top_k=10_000, seed=1)
    assert out.shape == (1, 2)


@pytest.mark.parametrize("k", [1, 3])
def test_beam_search_matches_jax(pair, k):
    jnet, tnet, _ = pair
    prompt = _tokens(3, 2, 4)
    seqs, scores = tnet.beam_search(prompt, 6, beam_size=k)
    jseqs, jscores = jnet.beam_search(prompt, 6, beam_size=k)
    assert seqs.shape == (2, k, 6)
    onp.testing.assert_array_equal(seqs.numpy(), jseqs.asnumpy())
    onp.testing.assert_allclose(scores.numpy(), jscores.asnumpy(),
                                rtol=1e-5, atol=1e-5)
    if k == 1:
        onp.testing.assert_array_equal(seqs[:, 0].numpy(),
                                       tnet.generate(prompt, 6).numpy())


def test_beam_search_eos_matches_jax(pair):
    jnet, tnet, _ = pair
    prompt = onp.array([[5, 6]], dtype="int32")
    eos = int(tnet.generate(prompt, 5)[0, 0])
    seqs, scores = tnet.beam_search(prompt, 5, beam_size=3, eos_token=eos)
    jseqs, jscores = jnet.beam_search(prompt, 5, beam_size=3,
                                      eos_token=eos)
    onp.testing.assert_array_equal(seqs.numpy(), jseqs.asnumpy())
    onp.testing.assert_allclose(scores.numpy(), jscores.asnumpy(),
                                rtol=1e-5, atol=1e-5)
    with pytest.raises(MXNetError, match="beam_size"):
        tnet.beam_search(prompt, 5, beam_size=0)


# ---------------------------------------------------------------------------
# the filters against the JAX package's _select
# ---------------------------------------------------------------------------

def _jax_filtered(monkeypatch, logits, method, temperature, top_k, top_p):
    """The logits the JAX package's ``_select`` hands its categorical
    draw (its filter's output), read by intercepting the draw."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.gluon.model_zoo import generation as jgen
    seen = []

    def fake(key, lg, axis=-1):
        seen.append(onp.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", fake)
    jgen._select(jnp.asarray(logits), method, temperature, top_k, top_p,
                 jax.random.PRNGKey(0))
    return seen[0]


@pytest.mark.parametrize("method,top_k,top_p", [
    ("top_k", 1, 0.9), ("top_k", 7, 0.9), ("top_k", 97, 0.9),
    ("top_p", 40, 0.05), ("top_p", 40, 0.5), ("top_p", 40, 0.9),
    ("top_p", 40, 1.0), ("sample", 40, 0.9)])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_filters_equal_jax_select(monkeypatch, method, top_k, top_p,
                                  temperature):
    logits = (onp.random.RandomState(11).randn(4, 97) * 3).astype("float32")
    want = _jax_filtered(monkeypatch, logits, method, temperature, top_k,
                         top_p)
    code = tgen.METHOD_CODES[method]
    scaled = torch.from_numpy(logits) / temperature
    got = tgen._filter_logits(scaled, torch.full((4,), top_k),
                              torch.full((4,), top_p),
                              torch.full((4,), code))
    # a top_p decision within f32 rounding of the threshold (the tail of
    # a top_p = 1 row, where the mass before a token rounds to 1) rests on
    # each package's cumsum order; every other decision must agree
    srt = onp.sort(logits.astype("float64") / temperature)[:, ::-1]
    prob = onp.exp(srt - srt.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    before = onp.cumsum(prob, -1) - prob
    edge = onp.abs(before - top_p) < 1e-5
    rank = onp.argsort(onp.argsort(-logits, -1), -1)
    decided = ~onp.take_along_axis(edge, rank, -1) | (method != "top_p")
    onp.testing.assert_array_equal(onp.isfinite(got.numpy())[decided],
                                   onp.isfinite(want)[decided])
    assert decided.mean() > 0.5
    keep = onp.isfinite(want) & onp.isfinite(got.numpy())
    onp.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-6)


def test_sampler_depends_only_on_seed_counter_and_logits():
    """The same (seed, counter, logits) give the same token whatever the
    row, the number of rows, or the other rows' methods."""
    rng = onp.random.RandomState(12)
    row = torch.from_numpy(rng.randn(97).astype("float32"))
    for method in (1, 2, 3):
        alone = tgen._sample_tokens(
            row[None], torch.tensor([9]), torch.tensor([5]),
            torch.tensor([1.1]), torch.tensor([7]), torch.tensor([0.8]),
            torch.tensor([method]))
        for S, slot in ((3, 0), (5, 4), (8, 6)):
            lg = torch.from_numpy(rng.randn(S, 97).astype("float32"))
            lg[slot] = row
            seeds = torch.from_numpy(rng.randint(0, 50, S))
            ctrs = torch.from_numpy(rng.randint(0, 50, S))
            meth = torch.from_numpy(rng.randint(0, 4, S))
            seeds[slot], ctrs[slot], meth[slot] = 9, 5, method
            out = tgen._sample_tokens(
                lg, seeds, ctrs, torch.full((S,), 1.1),
                torch.full((S,), 7), torch.full((S,), 0.8), meth)
            assert int(out[slot]) == int(alone[0])
    # another counter or seed draws anew: over many counters the draws
    # are not all one token
    draws = {int(tgen._sample_tokens(
        row[None], torch.tensor([9]), torch.tensor([c]),
        torch.tensor([1.0]), torch.tensor([1]), torch.tensor([1.0]),
        torch.tensor([1]))[0]) for c in range(40)}
    assert len(draws) > 3


def test_gumbel_draw_is_philox_and_uniform():
    """The draw's uniforms are Philox4x32-10 word 0 under key (seed,
    _SAMPLE_KEY1), counter (i, ctr, 0, 0); over a row they look uniform
    (the Gumbel noise has mean ~0.5772)."""
    from mxnet_tpu_torch.ops.cuda.attention import philox4x32_10
    g = tgen._gumbel(torch.tensor([3]), torch.tensor([17]), 4096)
    i = torch.arange(4096)
    w = philox4x32_10(i, torch.tensor(17), torch.tensor(0), torch.tensor(0),
                      torch.tensor(3), torch.tensor(tgen._SAMPLE_KEY1))[0]
    u = ((w >> 8).float() + 0.5) / 2 ** 24
    torch.testing.assert_close(g[0], -torch.log(-torch.log(u)))
    assert abs(float(g.mean()) - 0.5772) < 0.06


def test_lru_bound_and_recency():
    lru = tgen._LRU()
    lru.MAX = 3
    for k in "abc":
        lru[k] = k
    assert lru.get("a") == "a"           # refresh: b is now the oldest
    lru["d"] = "d"
    assert list(lru) == ["c", "a", "d"]
