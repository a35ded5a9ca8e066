"""The port's speculative decoding (mxnet_tpu_torch/serving/speculation.py)
on the CPU: the cases of the JAX package's ``tests/test_speculation.py``
over the same small GPTs (weights carried by ``convert.load_jax_params``).

Speculation is an optimization, never a behavior change: streams are
byte-identical to the port's non-speculative engine at the same seed for
greedy and sampled traffic, under rejections (KV rollback), mixed
spec/plain slots, shared-prefix admission and worker-death resurrection;
greedy speculative streams also equal the JAX package's plain engine.
``PagedKVCache.truncate`` gets standalone bit-exactness coverage, across
bucket migrations too.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import faults, metrics, tracing
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (DecodeModel, GenerationEngine,
                                     GenerationServer, IndependentDraft,
                                     PagedKVCache, SelfSpeculativeDraft,
                                     TokenStream)
from mxnet_tpu_torch.serving.generation import (GenRequest,
                                                make_recovery_request)
from mxnet_tpu_torch.serving.speculation import make_draft
from torch_port_util import gpt_pair

VOCAB = 97
PROMPT_A = onp.array([5, 9, 3, 17], dtype="int32")
PROMPT_B = onp.array([1, 2], dtype="int32")


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
def gpt(pair):
    return pair[1]


@pytest.fixture(scope="module")
def decode_model(gpt):
    return DecodeModel.from_block(gpt, device="cpu")


@pytest.fixture(scope="module")
def draft_gpt():
    """An independent 1-layer draft sharing the target's vocabulary
    (same tokenizer) with context covering the engine's KV grid."""
    return gpt_pair(seed=2, num_layers=1)[1]


def _engine(decode_model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_buckets", (16, 32, 64))
    kw.setdefault("max_tokens", 48)
    eng = GenerationEngine(decode_model, **kw)
    eng.warmup()
    return eng


def _drain(eng, *streams, max_iters=200):
    it = 0
    while not all(s.finished for s in streams) and it < max_iters:
        eng.run_iteration()
        it += 1
    assert it < max_iters, "engine did not finish the sequences"


# the greedy + sampled request mix every identity test replays: same
# seeds on both engines, so streams must match token for token
_SAMPLING = [dict(),
             dict(method="sample", temperature=1.2, seed=31),
             dict(method="top_k", top_k=7, temperature=0.9, seed=32),
             dict(method="top_p", top_p=0.85, temperature=1.1,
                  seed=33)]


def _run_mix(eng, n=12):
    streams = []
    for i, kw in enumerate(_SAMPLING):
        p = (PROMPT_A, PROMPT_B)[i % 2]
        streams.append(eng.submit(p, max_new_tokens=n, **kw))
    _drain(eng, *streams)
    return [s.result(timeout=10) for s in streams]


# ---------------------------------------------------------------------------
# KV rollback primitive: truncate() standalone
# ---------------------------------------------------------------------------

def _rand_rows(rng, n_layers, lp, nh, d):
    ks = [torch.from_numpy(rng.randn(lp, nh, d).astype("float32"))
          for _ in range(n_layers)]
    vs = [torch.from_numpy(rng.randn(lp, nh, d).astype("float32"))
          for _ in range(n_layers)]
    return ks, vs


def _snap(c):
    return ([c.k(i).numpy() for i in range(c.n_layers)]
            + [c.v(i).numpy() for i in range(c.n_layers)])


def test_truncate_rollback_rewrite_bit_exact():
    """Speculate rows in, reject, re-write: the buffer must be
    bit-identical to a cache that never speculated."""
    rng = onp.random.RandomState(0)
    prompt = _rand_rows(rng, 2, 4, 2, 4)
    spec = _rand_rows(rng, 2, 4, 2, 4)
    real = _rand_rows(rng, 2, 4, 2, 4)

    def fresh():
        c = PagedKVCache(n_layers=2, n_heads=2, head_dim=4,
                         max_slots=2, buckets=(8, 16), device="cpu")
        s = c.alloc()
        c.write_prompt(s, prompt[0], prompt[1], 4)
        return c, s

    a, sa = fresh()
    a.write_prompt(sa, spec[0], spec[1], 8, start=4)  # speculated rows
    assert a.truncate(sa, 4) == 4                     # all rejected
    assert int(a.positions[sa]) == 4
    a.write_prompt(sa, real[0], real[1], 8, start=4)  # target's tokens
    b, sb = fresh()
    b.write_prompt(sb, real[0], real[1], 8, start=4)  # never speculated
    for x, y in zip(_snap(a), _snap(b)):
        assert onp.array_equal(x, y), \
            "rollback + re-write left different bits than a clean write"


def test_truncate_across_grow_migration():
    """A speculative write that triggered a bucket grow, then a full
    rollback: re-writing must match a cache that grew without ever
    speculating."""
    rng = onp.random.RandomState(1)
    prompt = _rand_rows(rng, 2, 4, 2, 4)
    spec = _rand_rows(rng, 2, 8, 2, 4)
    real = _rand_rows(rng, 2, 8, 2, 4)

    def fresh():
        c = PagedKVCache(n_layers=2, n_heads=2, head_dim=4,
                         max_slots=2, buckets=(8, 16), device="cpu")
        s = c.alloc()
        c.write_prompt(s, prompt[0], prompt[1], 4)
        return c, s

    m0 = metrics.value("mxnet_gen_kv_migrations_total")
    a, sa = fresh()
    a.write_prompt(sa, spec[0], spec[1], 12, start=4)  # 4+8 > 8: grows
    assert a.bucket == 16
    assert a.truncate(sa, 4) == 8
    a.write_prompt(sa, real[0], real[1], 12, start=4)
    b, sb = fresh()
    b.write_prompt(sb, real[0], real[1], 12, start=4)
    assert b.bucket == 16
    assert metrics.value("mxnet_gen_kv_migrations_total") == m0 + 2
    for x, y in zip(_snap(a), _snap(b)):
        assert onp.array_equal(x, y), \
            "rollback across a grow-migration diverged from clean"


def test_truncate_validation_and_rollback_metric():
    rng = onp.random.RandomState(2)
    c = PagedKVCache(n_layers=1, n_heads=2, head_dim=4, max_slots=2,
                     buckets=(8,), device="cpu")
    with pytest.raises(MXNetError, match="out of range"):
        c.truncate(5, 0)
    with pytest.raises(MXNetError, match="free"):
        c.truncate(0, 0)
    s = c.alloc()
    ks, vs = _rand_rows(rng, 1, 4, 2, 4)
    c.write_prompt(s, ks, vs, 4)
    with pytest.raises(MXNetError, match="rewind"):
        c.truncate(s, 5)                     # forward motion refused
    with pytest.raises(MXNetError):
        c.truncate(s, -1)
    r0 = metrics.value("mxnet_gen_kv_rollbacks_total")
    assert c.truncate(s, 4) == 0             # no-op rewind: not a
    assert metrics.value("mxnet_gen_kv_rollbacks_total") == r0  # rollback
    assert c.truncate(s, 2) == 2
    assert int(c.positions[s]) == 2
    assert metrics.value("mxnet_gen_kv_rollbacks_total") == r0 + 1


# ---------------------------------------------------------------------------
# TokenStream.put_many: chunked emission, same index semantics as put
# ---------------------------------------------------------------------------

def test_put_many_matches_repeated_put():
    a, b = TokenStream(), TokenStream()
    for i, t in enumerate((5, 6, 7)):
        a.put(t, index=i)
    b.put_many([5, 6, 7], start_index=0)
    assert b.tokens == a.tokens == [5, 6, 7]
    # a recovered producer replays an overlapping run: the covered
    # indexes drop as dupes (counted), the novel tail appends
    d0 = metrics.value("mxnet_serving_stream_dupes_dropped_total")
    b.put_many([6, 7, 8, 9], start_index=1)
    assert b.tokens == [5, 6, 7, 8, 9]
    assert metrics.value(
        "mxnet_serving_stream_dupes_dropped_total") == d0 + 2
    for i, t in enumerate((6, 7, 8, 9), start=1):
        a.put(t, index=i)
    assert a.tokens == b.tokens


def test_put_many_gap_fails_stream_like_put():
    g = TokenStream()
    g.put_many([1, 2], start_index=0)
    g.put_many([9, 9], start_index=5)        # indexes 5.. past len 2
    assert g.finished and g.finish_reason == "error"
    with pytest.raises(MXNetError, match="gap"):
        g.result(timeout=1)


# ---------------------------------------------------------------------------
# byte-identity: speculative vs plain engine, greedy AND sampled
# ---------------------------------------------------------------------------

def test_full_draft_streams_identical(decode_model):
    """layers == n_layers: the draft IS the target, so every proposal
    accepts — the pure mechanics (multi-token verify, put_many
    emission, position bookkeeping) under maximum speculation."""
    want = _run_mix(_engine(decode_model))
    j0 = metrics.value("mxnet_gen_spec_rejected_tokens_total")
    eng = _engine(decode_model, spec_mode="self", spec_k=3,
                  spec_draft_layers=2)
    got = _run_mix(eng)
    assert got == want, "speculative streams diverged from plain"
    assert metrics.value(
        "mxnet_gen_spec_rejected_tokens_total") == j0, \
        "a full-layer self-draft rejected its own target's tokens"


def test_truncated_draft_rejections_roll_back_and_match(decode_model):
    """layers=1 of 2: the draft genuinely diverges, so acceptance is
    partial — rejections must roll the KV rows back and the stream
    must STILL match the plain engine byte for byte."""
    want = _run_mix(_engine(decode_model))
    r0 = metrics.value("mxnet_gen_kv_rollbacks_total")
    j0 = metrics.value("mxnet_gen_spec_rejected_tokens_total")
    a0 = metrics.value("mxnet_gen_spec_accepted_tokens_total")
    h0 = metrics.hist_stats("mxnet_gen_spec_accepted_per_step")
    eng = _engine(decode_model, spec_mode="self", spec_k=3,
                  spec_draft_layers=1)
    got = _run_mix(eng)
    assert got == want, \
        "rejection rollback changed the stream — KV state corrupted"
    assert metrics.value("mxnet_gen_spec_rejected_tokens_total") > j0
    assert metrics.value("mxnet_gen_kv_rollbacks_total") > r0
    assert metrics.value("mxnet_gen_spec_accepted_tokens_total") >= a0
    h1 = metrics.hist_stats("mxnet_gen_spec_accepted_per_step")
    assert h1[1] > h0[1], "no accepted-per-step observations"
    rate = metrics.value("mxnet_gen_spec_accept_rate")
    assert 0.0 <= rate <= 1.0


def test_independent_draft_streams_identical(decode_model, draft_gpt):
    want = _run_mix(_engine(decode_model))
    eng = _engine(decode_model, spec_mode="draft", spec_k=3,
                  draft_model=draft_gpt)
    got = _run_mix(eng)
    assert got == want, \
        "independent-draft speculative streams diverged from plain"
    assert eng.describe()["speculation"]["mode"] == "draft"


def test_mixed_spec_and_plain_slots(decode_model):
    """A per-request ``speculative=False`` opt-out rides the same
    iterations as speculating neighbors; both must match plain."""
    plain = _engine(decode_model)
    sa = plain.submit(PROMPT_A, max_new_tokens=12)
    sb = plain.submit(PROMPT_B, max_new_tokens=12,
                      method="top_k", top_k=7, temperature=0.9,
                      seed=41)
    _drain(plain, sa, sb)
    want = [sa.result(timeout=10), sb.result(timeout=10)]
    eng = _engine(decode_model, spec_mode="self", spec_k=3,
                  spec_draft_layers=1)
    ga = eng.submit(PROMPT_A, max_new_tokens=12)     # speculates
    gb = eng.submit(PROMPT_B, max_new_tokens=12,
                    method="top_k", top_k=7, temperature=0.9,
                    seed=41, speculative=False)      # opted out
    _drain(eng, ga, gb)
    assert [ga.result(timeout=10), gb.result(timeout=10)] == want


def test_spec_eos_trims_mid_emission(gpt, decode_model):
    """EOS landing inside a multi-token acceptance run must cut the
    emission at the EOS token, exactly like the plain engine."""
    plain = _engine(decode_model, max_slots=1)
    s = plain.submit(PROMPT_A, max_new_tokens=12)
    _drain(plain, s)
    base = s.result(timeout=10)
    eos = base[5]
    stop_at = base.index(eos)
    eng = _engine(decode_model, max_slots=1, spec_mode="self",
                  spec_k=3, spec_draft_layers=2)
    g = eng.submit(PROMPT_A, max_new_tokens=12, eos_token=eos)
    _drain(eng, g)
    assert g.result(timeout=10) == base[:stop_at + 1]
    assert g.finish_reason == "eos"


def test_shared_prefix_admission_with_rollbacks(decode_model):
    """Rollbacks in slots admitted off a shared prefix must not
    corrupt the refcounted prefix rows: later admissions from the same
    prefix still produce the plain engine's streams."""
    rng = onp.random.RandomState(3)
    system = rng.randint(1, 90, (16,)).astype("int32")  # bucket-aligned
    prompts = [onp.concatenate(
        [system, rng.randint(1, 90, (2 + i,)).astype("int32")])
        for i in range(3)]

    def run(eng):
        outs = []
        for p in prompts:                     # sequential: the first
            s = eng.submit(p, max_new_tokens=10)   # inserts, the rest
            _drain(eng, s)                    # hit the prefix entry
            outs.append(s.result(timeout=10))
        return outs

    want = run(_engine(decode_model, prefix_slots=2))
    h0 = metrics.value("mxnet_gen_prefix_cache_hits_total")
    r0 = metrics.value("mxnet_gen_kv_rollbacks_total")
    eng = _engine(decode_model, prefix_slots=2, spec_mode="self",
                  spec_k=3, spec_draft_layers=1)
    got = run(eng)
    assert got == want, \
        "speculative streams diverged under shared-prefix admission"
    assert metrics.value("mxnet_gen_prefix_cache_hits_total") >= h0 + 2
    assert metrics.value("mxnet_gen_kv_rollbacks_total") > r0, \
        "the leg exercised no rollbacks — weaker than intended"


# ---------------------------------------------------------------------------
# worker-death resurrection stays token-identical with speculation on
# ---------------------------------------------------------------------------

def test_recovery_request_carries_speculative():
    req = GenRequest(onp.array([1, 2, 3], "int32"), 8, None, None,
                     method="top_k", top_k=5, seed=9, speculative=True)
    req.stream.put(4, index=0)
    r = make_recovery_request(req)
    assert r.speculative is True
    req2 = GenRequest(onp.array([1, 2, 3], "int32"), 8, None, None,
                      speculative=False)
    req2.stream.put(4, index=0)
    assert make_recovery_request(req2).speculative is False


def test_speculative_streams_identical_across_worker_death(
        decode_model):
    prompts = [PROMPT_A, PROMPT_B]
    kws = [dict(method="sample", temperature=1.2, seed=21),
           dict(method="top_k", top_k=7, temperature=0.9, seed=22)]
    budgets = [10, 8]

    def collect(with_kill):
        factory = lambda: _engine(decode_model, spec_mode="self",  # noqa: E731
                                  spec_k=3, spec_draft_layers=1)
        gs = GenerationServer(engine_factory=factory, replicas=2,
                              restart_backoff_ms=10)
        gs.start()
        try:
            if with_kill:
                with faults.fault_plan(
                        "serving.worker:after=2:times=1"):
                    streams = [gs.generate(p, max_new_tokens=n, **kw)
                               for p, n, kw in zip(prompts, budgets,
                                                   kws)]
                    return [s.result(timeout=60) for s in streams]
            streams = [gs.generate(p, max_new_tokens=n, **kw)
                       for p, n, kw in zip(prompts, budgets, kws)]
            return [s.result(timeout=60) for s in streams]
        finally:
            gs.stop()

    clean = collect(with_kill=False)
    rec0 = (metrics.value("mxnet_serving_recoveries_total",
                          site="worker")
            + metrics.value("mxnet_serving_recoveries_total",
                            site="queue"))
    killed = collect(with_kill=True)
    recs = (metrics.value("mxnet_serving_recoveries_total",
                          site="worker")
            + metrics.value("mxnet_serving_recoveries_total",
                            site="queue"))
    assert faults.injected_count("serving.worker") == 0
    assert recs > rec0, "the kill recovered nothing (did it fire?)"
    assert killed == clean, \
        "speculative streams diverged across worker death"


# ---------------------------------------------------------------------------
# tracing + exemplars
# ---------------------------------------------------------------------------

def test_draft_and_verify_child_spans(decode_model):
    tracing.configure(sample=1.0)
    try:
        eng = _engine(decode_model, spec_mode="self", spec_k=3,
                      spec_draft_layers=1)
        s = eng.submit(PROMPT_A, max_new_tokens=6)
        _drain(eng, s)
        s.result(timeout=10)
        recs = tracing.spans()
        by_id = {r["span_id"]: r for r in recs}
        drafts = [r for r in recs if r["name"] == "engine.draft"]
        verifies = [r for r in recs if r["name"] == "engine.verify"]
        assert drafts, "no engine.draft spans recorded"
        assert verifies, "no engine.verify spans recorded"
        for r in drafts + verifies:
            parent = by_id.get(r["parent_id"])
            assert parent is not None \
                and parent["name"] == "engine.iteration", \
                f"{r['name']} not a child of engine.iteration"
        # the min-exemplar satellite: the accepted-per-step histogram
        # holds a trace id pointing at the worst-accepting recent step
        ex = metrics.GEN_SPEC_ACCEPTED_PER_STEP._default().exemplar
        assert ex is not None and ex[0], \
            "no trace exemplar on the accepted-per-step histogram"
    finally:
        tracing.configure()


def test_min_exemplar_retains_worst_accepting_step():
    h = metrics.GEN_SPEC_ACCEPTED_PER_STEP
    h.observe(4.0, exemplar="t-high")
    h.observe(1.0, exemplar="t-low")
    h.observe(3.0, exemplar="t-mid")         # higher: must NOT displace
    assert h._default().exemplar[0] == "t-low"


# ---------------------------------------------------------------------------
# configuration surface
# ---------------------------------------------------------------------------

def test_engine_env_defaults_and_describe(decode_model, monkeypatch):
    monkeypatch.setenv("MXNET_GEN_SPEC_MODE", "self")
    monkeypatch.setenv("MXNET_GEN_SPEC_K", "2")
    monkeypatch.setenv("MXNET_GEN_SPEC_DRAFT_LAYERS", "1")
    eng = GenerationEngine(decode_model, max_slots=2,
                           kv_buckets=(16, 32), max_tokens=8)
    assert eng.spec_mode == "self" and eng.spec_k == 2
    assert eng.describe()["speculation"] == {
        "mode": "self", "k": 2, "layers": 1, "target_layers": 2}
    monkeypatch.setenv("MXNET_GEN_SPEC_MODE", "off")
    off = GenerationEngine(decode_model, max_slots=2,
                           kv_buckets=(16, 32), max_tokens=8)
    assert off._draft is None
    assert off.describe()["speculation"] == {"mode": "off"}


def test_make_draft_validation(decode_model, draft_gpt):
    assert make_draft(None, decode_model, 4) is None
    assert make_draft("off", decode_model, 4) is None
    with pytest.raises(MXNetError, match="mode"):
        make_draft("turbo", decode_model, 4)
    with pytest.raises(MXNetError, match="draft_model|draft model"):
        make_draft("draft", decode_model, 4, max_slots=2,
                   buckets=(16,))
    with pytest.raises(MXNetError, match="k must be"):
        SelfSpeculativeDraft(decode_model, k=0)
    with pytest.raises(MXNetError, match="layers"):
        SelfSpeculativeDraft(decode_model, k=2, layers=7)
    # vocabulary mismatch: different tokenizer, refuse at construction
    alien = gpt_pair(seed=4, vocab_size=55, num_layers=1)[1]
    with pytest.raises(MXNetError, match="vocab"):
        make_draft("draft", decode_model, 3, draft_model=alien,
                   max_slots=2, buckets=(16, 32, 64))
    # a draft whose context cannot cover the KV grid is refused
    with pytest.raises(MXNetError, match="context|max_length"):
        IndependentDraft(draft_gpt, k=3, max_slots=2,
                         buckets=(16, 128), device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_greedy_speculative_streams_equal_jax_plain_engine(pair,
                                                           decode_model):
    """Greedy streams of the port's speculating engine (a truncated
    self-draft: rejections and rollbacks) equal the JAX package's plain
    engine's, across a bucket migration."""
    from mxnet_tpu.serving import DecodeModel as JDecodeModel
    from mxnet_tpu.serving import GenerationEngine as JGenerationEngine
    jeng = JGenerationEngine(JDecodeModel.from_block(pair[0]), max_slots=2,
                             kv_buckets=(16, 32, 64), max_tokens=48)
    jeng.warmup()
    eng = _engine(decode_model, spec_mode="self", spec_k=3,
                  spec_draft_layers=1)
    r0 = metrics.value("mxnet_gen_kv_rollbacks_total")
    got, want = [], []
    for e, out in ((eng, got), (jeng, want)):
        streams = [e.submit(p, max_new_tokens=20)
                   for p in (PROMPT_A, PROMPT_B)]
        while not all(s.finished for s in streams):
            e.run_iteration()
        out.extend(s.result(timeout=10) for s in streams)
    assert got == want
    assert metrics.value("mxnet_gen_kv_rollbacks_total") > r0
