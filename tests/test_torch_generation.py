"""The port's continuous-batching generation path on the CPU
(mxnet_tpu_torch/serving: kv_cache, batching.SlotScheduler, model.DecodeModel,
generation, server.GenerationServer, http): the cases of the JAX package's
``tests/test_generation.py`` and ``tests/test_gen_sampling.py`` over the
same small GPT (weights carried by ``convert.load_jax_params``).

The slot/bucket KV cache; greedy parity against the uncompiled full-forward
loop and against the JAX package's engine (across a bucket migration);
no program first-run after warmup; mid-flight admission changes no resident
token (``iteration_log``); EOS / max-token retirement; structured sheds; a
decode fault fails only the sequences in flight; the HTTP front (chunked
streaming, collect mode, 400s, health) and shutdown; same-seed sampled
streams identical across runs and across a worker death; the shared-prefix
cache (suffix pass and whole-prompt hits) equal to the cache off. The
gate that keeps a decode graph's capture apart from the other threads'
prompt passes and steps.
"""
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import faults, metrics, serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (DecodeModel, GenerationEngine,
                                     GenerationServer, OverloadError,
                                     PagedKVCache, PrefixCache)
from mxnet_tpu_torch.serving.generation import (GenRequest,
                                                make_recovery_request)
from mxnet_tpu_torch.serving.kv_cache import prefix_key, round_up_bucket
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


def _reference_greedy(gpt, prompt, n):
    """The uncompiled reference loop: a full forward over the whole
    sequence per token, argmax, append — no KV cache, none of the
    engine's programs."""
    toks = [int(t) for t in prompt]
    out = []
    with torch.inference_mode():
        for _ in range(n):
            logits = gpt(torch.tensor([toks]))
            nxt = int(logits[0, -1].argmax())
            out.append(nxt)
            toks.append(nxt)
    return out


def _engine(decode_model, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_buckets", (16, 32, 64))
    kw.setdefault("max_tokens", 48)
    eng = GenerationEngine(decode_model, **kw)
    eng.warmup()
    return eng


def _drain(eng, *streams, max_iters=300):
    it = 0
    while not all(s.finished for s in streams) and it < max_iters:
        eng.run_iteration()
        it += 1
    assert it < max_iters, "engine did not finish the sequences"


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def test_kv_cache_slots_and_buckets():
    c = PagedKVCache(n_layers=2, n_heads=2, head_dim=4, max_slots=3,
                     buckets=(8, 16, 32), device="cpu")
    assert c.bucket == 8 and c.free_slots() == [0, 1, 2]
    s0, s1 = c.alloc(), c.alloc()
    assert (s0, s1) == (0, 1) and c.occupancy() == 2
    c.positions[s0], c.positions[s1] = 5, 7
    assert c.needed_capacity() == 8
    assert not c.ensure_capacity(8)          # fits the current bucket
    assert c.ensure_capacity(9)              # 9 > 8 -> migrate to 16
    assert c.bucket == 16
    assert c.k(0).shape == (3, 16, 2, 4)
    c.free(s0)
    assert c.free_slots() == [0, 2]
    c.free(s1)
    c.reset_if_empty()
    assert c.bucket == 8                     # shrinks only when empty
    assert round_up_bucket(17, (8, 16, 32)) == 32
    with pytest.raises(MXNetError):
        round_up_bucket(33, (8, 16, 32))
    with pytest.raises(MXNetError):
        c.ensure_capacity(40)                # past the top bucket


def test_capture_gate_orders_captures_against_shared_work():
    from mxnet_tpu_torch.serving.model import _CaptureGate
    gate, log, go = _CaptureGate(), [], threading.Event()

    def share(name, inside):
        with gate.shared():
            log.append(f"{name} in")
            inside.set()
            go.wait(10)
            log.append(f"{name} out")

    def capture(inside):
        with gate.exclusive():
            log.append("capture")
            inside.set()

    ins = {n: threading.Event() for n in ("a", "b", "c", "d")}
    threads = [threading.Thread(target=share, args=(n, ins[n]))
               for n in ("a", "b")]
    threads.append(threading.Thread(target=capture, args=(ins["c"],)))
    threads.append(threading.Thread(target=share, args=("d", ins["d"])))
    threads[0].start()
    threads[1].start()
    assert ins["a"].wait(10) and ins["b"].wait(10)   # shares run together
    threads[2].start()
    assert not ins["c"].wait(0.2)                    # the capture waits
    threads[3].start()
    assert not ins["d"].wait(0.2)    # a new share waits behind it
    go.set()
    for t in threads:
        t.join(10)
    assert log.index("capture") > max(log.index("a out"),
                                      log.index("b out"))
    assert log.index("capture") < log.index("d in")
    # a thread that holds shares may capture: it gives them up meanwhile
    with gate.shared(), gate.shared(), gate.exclusive():
        pass
    with gate.exclusive():                           # and nothing is left
        pass


# ---------------------------------------------------------------------------
# greedy parity (incl. a KV-bucket migration mid-decode)
# ---------------------------------------------------------------------------

def test_greedy_parity_vs_uncompiled_reference(gpt, decode_model):
    eng = _engine(decode_model)
    # 24 new tokens from a 4-token prompt crosses the 16-bucket: the
    # parity window covers prefill, steady decode, AND a live cache
    # migration
    m0 = metrics.value("mxnet_gen_kv_migrations_total")
    s = eng.submit(PROMPT_A, max_new_tokens=24)
    _drain(eng, s)
    got = s.result(timeout=10)
    assert got == _reference_greedy(gpt, PROMPT_A, 24)
    assert s.finish_reason == "length"
    assert metrics.value("mxnet_gen_kv_migrations_total") == m0 + 1


def _compiles(model):
    return {t: metrics.value("mxnet_serving_bucket_compiles_total",
                             bucket=t)
            for t in model.describe()["programs_compiled"]}


def test_decode_zero_compiles_after_warmup(gpt, decode_model):
    """After warmup, traffic inside the grids (mixed prompt lengths,
    sampled lanes, a bucket migration) runs no program for the first
    time: no ``decode:*`` / ``prefill:*`` label moves, no new label
    appears, and no graph is captured (on the CPU none ever is)."""
    eng = _engine(decode_model)
    c0, g0 = _compiles(decode_model), decode_model.captures
    streams = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in
               ((PROMPT_A, 30, {}), (PROMPT_B, 6, dict(method="top_k",
                                                         seed=3)),
                (onp.arange(1, 8, dtype="int32"), 6, {}))]
    _drain(eng, *streams)
    assert [len(s.result(timeout=10)) for s in streams] == [30, 6, 6]
    assert _compiles(decode_model) == c0, "steady-state decode compiled"
    assert decode_model.captures == g0
    assert {"decode:2x16", "decode:2x32", "decode:2x64",
            "prefill:8", "prefill:64"} <= set(c0)


# ---------------------------------------------------------------------------
# the continuous-batching invariant
# ---------------------------------------------------------------------------

def test_midflight_admission_changes_no_resident_tokens(gpt,
                                                        decode_model):
    want_a = _reference_greedy(gpt, PROMPT_A, 20)
    want_b = _reference_greedy(gpt, PROMPT_B, 10)
    eng = _engine(decode_model)
    sa = eng.submit(PROMPT_A, max_new_tokens=20)
    for _ in range(6):                       # A is mid-decode...
        eng.run_iteration()
    sb = eng.submit(PROMPT_B, max_new_tokens=10)   # ...when B arrives
    _drain(eng, sa, sb)
    # neither sequence's tokens moved for the other
    assert sa.result(timeout=10) == want_a
    assert sb.result(timeout=10) == want_b
    # per-iteration slot logs prove B was admitted while A was decoding
    # and the two then shared iterations
    log = list(eng.iteration_log)
    b_admit = next(l["iter"] for l in log[1:] if l["admitted"])
    assert any(l["decoded"] for l in log if l["iter"] < b_admit), \
        "A was not mid-decode at B's admission"
    assert sum(1 for l in log if len(l["decoded"]) == 2) >= 5, \
        "A and B never actually decoded in the same iterations"


# ---------------------------------------------------------------------------
# retirement
# ---------------------------------------------------------------------------

def test_eos_and_max_token_retirement_free_slots(gpt, decode_model):
    base = _reference_greedy(gpt, PROMPT_A, 12)
    assert len(set(base)) > 1, "degenerate fixture: constant sequence"
    eos = base[3]
    stop_at = base.index(eos)                # its FIRST occurrence
    eng = _engine(decode_model, max_slots=1)
    s = eng.submit(PROMPT_A, max_new_tokens=12, eos_token=eos)
    _drain(eng, s)
    got = s.result(timeout=10)
    assert s.finish_reason == "eos"
    assert got == base[:stop_at + 1]         # stops AT the eos token
    # the slot frees at the next iteration's retire phase
    eng.run_iteration()
    assert eng.cache.free_slots() == [0]
    s2 = eng.submit(PROMPT_B, max_new_tokens=3)
    _drain(eng, s2)
    assert s2.finish_reason == "length"      # max-token retirement
    assert len(s2.result(timeout=10)) == 3
    eng.run_iteration()
    assert eng.cache.free_slots() == [0]
    assert metrics.value("mxnet_gen_retirements_total",
                         reason="eos") >= 1
    assert metrics.value("mxnet_gen_retirements_total",
                         reason="length") >= 1


# ---------------------------------------------------------------------------
# overload
# ---------------------------------------------------------------------------

def test_shed_paths_raise_structured_overload(decode_model):
    eng = _engine(decode_model, max_slots=1, queue_limit=2)
    # fill the slot and the bounded admission queue
    s1 = eng.submit(PROMPT_A, max_new_tokens=40)
    eng.run_iteration()                      # s1 occupies the slot
    eng.submit(PROMPT_B, max_new_tokens=4)
    eng.submit(PROMPT_B, max_new_tokens=4)
    with pytest.raises(OverloadError) as ei:
        eng.submit(PROMPT_B, max_new_tokens=4)
    assert ei.value.reason == "queue_full"
    j = ei.value.to_json()
    assert j["error"] == "overloaded" and j["queue_depth"] >= 2 \
        and "retry_after_ms" in j
    # deadline shed: no slot frees within the request's deadline
    eng2 = _engine(decode_model, max_slots=1, queue_limit=4)
    sa = eng2.submit(PROMPT_A, max_new_tokens=40)
    eng2.run_iteration()
    sb = eng2.submit(PROMPT_B, max_new_tokens=4, deadline_ms=5.0)
    time.sleep(0.02)                         # deadline passes queued
    eng2.run_iteration()                     # admission boundary sheds
    with pytest.raises(OverloadError) as ei2:
        sb.result(timeout=5)
    assert ei2.value.reason == "deadline"
    assert not sa.finished                   # the resident one decodes on


# ---------------------------------------------------------------------------
# fault blast radius (the serving.execute site)
# ---------------------------------------------------------------------------

def test_decode_fault_fails_only_affected_sequences(gpt, decode_model):
    want_b = _reference_greedy(gpt, PROMPT_B, 5)
    eng = _engine(decode_model, max_slots=1)
    # site hit #1 is A's prefill, #2/#3 its first decode iterations;
    # after=3:times=1 detonates ONE decode step while A holds the slot
    with faults.fault_plan("serving.execute:after=3:times=1"):
        sa = eng.submit(PROMPT_A, max_new_tokens=30)
        sb = eng.submit(PROMPT_B, max_new_tokens=5)   # queued behind A
        _drain(eng, sa, sb)
    with pytest.raises(MXNetError, match="injected"):
        sa.result(timeout=5)
    assert sa.finish_reason == "error"
    # the queued sequence admitted after the blast and decoded clean
    assert sb.result(timeout=10) == want_b
    assert sb.finish_reason == "length"
    # the engine survived: a fresh request still serves
    s3 = eng.submit(PROMPT_A, max_new_tokens=3)
    _drain(eng, s3)
    assert len(s3.result(timeout=10)) == 3


# ---------------------------------------------------------------------------
# server thread + HTTP streaming
# ---------------------------------------------------------------------------

def test_generation_server_http_stream_and_errors(decode_model):
    eng = _engine(decode_model, max_slots=2)
    with GenerationServer(eng) as gs:
        httpd = serving.make_http_server(None, port=0,
                                         generation_server=gs)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        host, port = httpd.server_address
        try:
            # per-token streaming is OBSERVABLE: read the raw chunked
            # wire and require at least one token line to arrive before
            # the done trailer
            body = json.dumps({"tokens": [int(t) for t in PROMPT_A],
                               "max_new_tokens": 5}).encode()
            with socket.create_connection((host, port),
                                          timeout=30) as sk:
                sk.sendall(
                    b"POST /v1/generate HTTP/1.1\r\n"
                    + f"Host: {host}\r\n".encode()
                    + f"Content-Length: {len(body)}\r\n".encode()
                    + b"Content-Type: application/json\r\n\r\n" + body)
                raw = b""
                sk.settimeout(30)
                while b"\"done\": true" not in raw:
                    chunk = sk.recv(4096)
                    assert chunk, "connection closed before trailer"
                    raw += chunk
            head, _, payload = raw.partition(b"\r\n\r\n")
            assert b"200" in head.split(b"\r\n", 1)[0]
            assert b"chunked" in head.lower()
            lines = [json.loads(l) for l in payload.decode()
                     .replace("\r\n", "\n").split("\n")
                     if l.strip().startswith("{")]
            toks = [l["token"] for l in lines if "token" in l]
            assert len(toks) == 5
            assert lines[-1]["done"] and \
                lines[-1]["finish_reason"] == "length"
            # non-stream mode
            req = urllib.request.Request(
                f"http://{host}:{port}/v1/generate",
                data=json.dumps({"tokens": [1, 2, 3],
                                 "max_new_tokens": 4,
                                 "stream": False}).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                out = json.loads(r.read())
            assert len(out["tokens"]) == 4
            assert out["finish_reason"] == "length"
            # malformed -> 400; an over-long PROMPT (past the KV/
            # position ceiling; max_new_tokens is merely clamped) -> 400
            for bad in ({"tokens": []},
                        {"tokens": [1] * 100, "max_new_tokens": 4}):
                req = urllib.request.Request(
                    f"http://{host}:{port}/v1/generate",
                    data=json.dumps(bad).encode())
                with pytest.raises(urllib.error.HTTPError) as he:
                    urllib.request.urlopen(req, timeout=30)
                assert he.value.code == 400
            # healthz reports generation slots
            with urllib.request.urlopen(
                    f"http://{host}:{port}/healthz", timeout=10) as r:
                h = json.loads(r.read())
            assert h["status"] == "ok"
            assert h["generation"]["slots"]["max"] == 2
        finally:
            httpd.shutdown()
    # stopped server refuses with a structured state error
    with pytest.raises(MXNetError):
        gs.generate([1, 2])


def test_generation_server_shutdown_fails_inflight(decode_model):
    eng = _engine(decode_model, max_slots=1)
    gs = GenerationServer(eng).start()
    s = gs.generate(PROMPT_A, max_new_tokens=40)
    t0 = time.monotonic()
    while s.tokens == [] and time.monotonic() - t0 < 10:
        time.sleep(0.005)                    # admitted and decoding
    gs.stop()
    with pytest.raises(MXNetError, match="shutdown|stopped"):
        # drain whatever streamed, then observe the structured error
        while s.next_token(timeout=5) is not None:
            pass


# ---------------------------------------------------------------------------
# sampling, recovery and the shared-prefix cache
# ---------------------------------------------------------------------------

def test_sampled_streams_identical_across_worker_death(decode_model):
    prompts = [PROMPT_A, PROMPT_B]
    kws = [dict(method="sample", temperature=1.2, seed=21),
           dict(method="top_k", top_k=7, temperature=0.9, seed=22)]
    budgets = [10, 8]

    def collect(with_kill):
        factory = lambda: _engine(decode_model)          # noqa: E731
        gs = GenerationServer(engine_factory=factory, replicas=2,
                              restart_backoff_ms=10)
        gs.start()
        try:
            if with_kill:
                # the third busy worker pass dies with sequences
                # resident — they must resurrect from their stream
                # transcripts, replaying the counter-key stream
                with faults.fault_plan("serving.worker:after=2:times=1"):
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
    assert faults.injected_count("serving.worker") == 0  # left scope
    assert recs > rec0, "the kill recovered nothing (did it fire?)"
    assert killed == clean, \
        "same-seed sampled streams diverged across worker death"


# ---------------------------------------------------------------------------
# shared-prefix KV cache
# ---------------------------------------------------------------------------

def _shared_prompts():
    rng = onp.random.RandomState(3)
    system = rng.randint(1, 90, (16,)).astype("int32")  # bucket-aligned
    return system, [
        onp.concatenate([system,
                         rng.randint(1, 90, (2 + i,)).astype("int32")])
        for i in range(3)]


def test_prefix_hit_skips_prefill_and_matches_cache_off(gpt,
                                                        decode_model):
    system, prompts = _shared_prompts()
    off = _engine(decode_model, prefix_slots=0)
    want = []
    for p in prompts + [system, system]:
        s = off.submit(p, max_new_tokens=6)
        _drain(off, s)
        want.append(s.result(timeout=10))

    eng = _engine(decode_model, prefix_slots=4)
    h0 = metrics.value("mxnet_gen_prefix_cache_hits_total")
    calls = {"prefill": 0}
    real_prefill = eng.model.prefill

    def counting_prefill(*a, **kw):
        calls["prefill"] += 1
        return real_prefill(*a, **kw)

    eng.model.prefill = counting_prefill
    try:
        got = []
        for p in prompts + [system, system]:
            s = eng.submit(p, max_new_tokens=6)
            _drain(eng, s)
            got.append(s.result(timeout=10))
    finally:
        eng.model.prefill = real_prefill
    assert got == want, "prefix-cache streams diverged from cache-off"
    # prompt 1 is the only cold full prefill; 2-3 ride the suffix
    # path, and the 16-token system prompt itself: the first run
    # attaches whole-prompt logits (cold), the second is a pure copy
    assert calls["prefill"] == 2, \
        f"expected 2 cold prefills, saw {calls['prefill']}"
    assert metrics.value("mxnet_gen_prefix_cache_hits_total") \
        - h0 == 3


def test_full_prompt_hit_needs_no_model_call(decode_model):
    system, _ = _shared_prompts()
    eng = _engine(decode_model, prefix_slots=4)
    s = eng.submit(system, max_new_tokens=4)     # cold: inserts+logits
    _drain(eng, s)
    first = s.result(timeout=10)
    calls = {"n": 0}
    real_prefill = eng.model.prefill
    real_suffix = eng.model.prefill_suffix

    def boom(*a, **kw):
        calls["n"] += 1
        raise AssertionError("model invoked on a full-prompt hit")

    eng.model.prefill = boom
    eng.model.prefill_suffix = boom
    try:
        s2 = eng.submit(system, max_new_tokens=4)
        _drain(eng, s2)
        assert s2.result(timeout=10) == first
    finally:
        eng.model.prefill = real_prefill
        eng.model.prefill_suffix = real_suffix
    assert calls["n"] == 0


def test_prefix_cache_refcount_and_lru():
    rows = [onp.zeros((8, 2, 4), "f4")]
    pc = PrefixCache(slots=2)
    k1 = prefix_key(onp.arange(8, dtype="int32"), 8)
    k2 = prefix_key(onp.arange(1, 9, dtype="int32"), 8)
    k3 = prefix_key(onp.arange(2, 10, dtype="int32"), 8)
    assert pc.insert(k1, rows, rows, 8)
    assert pc.insert(k2, rows, rows, 8)
    e1 = pc.lookup(k1, pin=True)             # k1 pinned AND freshest
    assert e1 is not None and e1.refs == 1
    ev0 = metrics.value("mxnet_gen_prefix_cache_evictions_total")
    assert pc.insert(k3, rows, rows, 8)      # evicts k2 (LRU, ref 0)
    assert pc.lookup(k2) is None
    assert pc.lookup(k1) is not None, "a pinned entry was evicted"
    assert metrics.value("mxnet_gen_prefix_cache_evictions_total") \
        == ev0 + 1
    # with every entry pinned, insert refuses rather than evict
    pc.lookup(k3, pin=True)
    k4 = prefix_key(onp.arange(3, 11, dtype="int32"), 8)
    assert not pc.insert(k4, rows, rows, 8)
    pc.unpin(k1)
    pc.unpin(k3)
    assert pc.insert(k4, rows, rows, 8)
    d = pc.describe()
    assert d["entries"] == 2 and d["slots"] == 2
    # disabled cache accepts nothing
    off = PrefixCache(slots=0)
    assert not off.insert(k1, rows, rows, 8)
    assert len(off) == 0


def test_recovery_request_carries_sampling(decode_model):
    req = GenRequest(PROMPT_A, 8, None, None, method="top_p",
                     temperature=1.2, top_k=13, top_p=0.6, seed=99)
    req.stream.put(4, index=0)
    req.stream.put(7, index=1)
    r = make_recovery_request(req)
    assert (r.method, r.temperature, r.top_k, r.top_p, r.seed) \
        == ("top_p", 1.2, 13, 0.6, 99)
    assert r.offset == 2 and r.max_new_tokens == 6
    assert list(r.tokens[-2:]) == [4, 7]


def test_generate_http_sampling_params_and_400s(decode_model):
    eng = _engine(decode_model, max_slots=2)
    with GenerationServer(eng) as gs:
        httpd = serving.make_http_server(None, port=0,
                                         generation_server=gs)
        threading.Thread(target=httpd.serve_forever,
                         daemon=True).start()
        host, port = httpd.server_address
        url = f"http://{host}:{port}/v1/generate"

        def post(body):
            req = urllib.request.Request(url,
                                         data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        try:
            base = {"tokens": [int(t) for t in PROMPT_A],
                    "max_new_tokens": 5, "stream": False,
                    "method": "top_k", "temperature": 0.8,
                    "top_k": 5, "seed": 42}
            out1 = post(base)
            out2 = post(base)
            assert out1["tokens"] == out2["tokens"], \
                "same-seed HTTP requests diverged"
            assert len(out1["tokens"]) == 5
            # out-of-range values: 400 on BOTH paths (the structured
            # error precedes any token either way)
            for stream_mode in (False, True):
                for bad in ({"method": "beam"},
                            {"method": "sample", "temperature": 0},
                            {"method": "top_k", "top_k": 0},
                            {"method": "top_p", "top_p": 0.0},
                            {"method": "top_p", "top_p": 1.5},
                            {"method": 7},
                            {"method": "sample", "seed": "abc"},
                            {"method": "sample", "seed": 2**31},
                            {"method": "sample", "temperature": "x"}):
                    body = dict(base, stream=stream_mode, **bad)
                    with pytest.raises(urllib.error.HTTPError) as he:
                        post(body)
                    assert he.value.code == 400, \
                        f"{bad} on stream={stream_mode} -> " \
                        f"{he.value.code}"
                    detail = json.loads(he.value.read())
                    assert detail["error"] == "bad_request"
        finally:
            httpd.shutdown()


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_engine_greedy_streams_equal_jax_engine(pair, decode_model):
    """The port's engine and the JAX package's, same weights, same
    requests (one crossing two bucket migrations, one admitted mid-flight,
    one with EOS): the same greedy tokens and finish reasons."""
    from mxnet_tpu.serving import DecodeModel as JDecodeModel
    from mxnet_tpu.serving import GenerationEngine as JGenerationEngine
    jeng = JGenerationEngine(JDecodeModel.from_block(pair[0]), max_slots=2,
                             kv_buckets=(16, 32, 64), max_tokens=48)
    jeng.warmup()
    eos = _reference_greedy(pair[1], PROMPT_B, 8)[4]
    out = []
    for eng in (_engine(decode_model), jeng):
        sa = eng.submit(PROMPT_A, max_new_tokens=40)
        for _ in range(5):
            eng.run_iteration()
        sb = eng.submit(PROMPT_B, max_new_tokens=8, eos_token=eos)
        sc = eng.submit(onp.arange(3, 20, dtype="int32"), max_new_tokens=9)
        _drain(eng, sa, sb, sc)
        out.append([(s.result(timeout=10), s.finish_reason)
                    for s in (sa, sb, sc)])
    assert out[0] == out[1]
    assert out[0][1][1] == "eos"


def test_sampled_lane_equals_zoo_select_oracle(gpt, decode_model):
    """A sampled stream equals the host-side oracle: the full forward
    per token and ``model_zoo.generation._select`` under counter = the
    token's index (the port's counter-based key)."""
    from mxnet_tpu_torch.gluon.model_zoo.generation import _select
    kw = dict(method="top_p", temperature=1.1, top_k=40, top_p=0.85,
              seed=77)
    eng = _engine(decode_model)
    s = eng.submit(PROMPT_A, max_new_tokens=12, **kw)
    _drain(eng, s)
    toks, want = [int(t) for t in PROMPT_A], []
    with torch.inference_mode():
        for i in range(12):
            lg = gpt(torch.tensor([toks]))[:, -1]
            nxt = int(_select(lg, kw["method"], kw["temperature"],
                              kw["top_k"], kw["top_p"], kw["seed"], i)[0])
            want.append(nxt)
            toks.append(nxt)
    assert s.result(timeout=10) == want

