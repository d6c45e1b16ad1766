"""The port's decode engine (flat pool) and GENERATE over the wire against
the JAX reference, on the CPU.

Both packages build the demo LM from one numpy seed, so the weights are
bitwise equal, and greedy decode must emit exactly the reference's tokens:
the JAX engine's, and the reference's ``reference_generate``, for the same
prompts.  Held at the reference suite's own small geometry
(``tests/test_decode.py`` ``CFG``): the four decode attention functions at
1e-5 in fp32 (stale pages ignored, a one-key scratch lane NaN-free), the
geometry, and the engine's behaviours that need no ``programs.py``:
bucket-packing invariance, scheduling never changing tokens, long
generations never blocking short ones, request mode, slot reuse, admission
refusals, the queue cap, the ``max_tokens`` clamp, eos, the dispatch budget,
zero retraces after ``warm()``, a KV pool of constant bytes updated in
place, the phases and the token histogram, streaming, the threaded engine.
Over the wire, on two in-process replicas: the round trip, streaming,
a replayed GENERATE answered exactly once, the decode fields of HEALTH,
failover mid-generation, a draining replica's spill and the refusals.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.serve import decode as jdec

from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import ENV_CATALOG, MXNetError
from mxnet_tpu_torch.engine import engine
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.serve import (Overloaded, ServeClient, ServeServer,
                                   serve_forever)
from mxnet_tpu_torch.serve.decode import (DecodeBatcher, DecodeConfig,
                                          DecodeServable, demo_lm_numpy,
                                          demo_lm_params, reference_generate)
from mxnet_tpu_torch.telemetry import registry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

# the reference suite's geometry: 2 prefill + 3 slot buckets to warm
CFG = dict(dim=16, heads=2, layers=2, slots=4, max_tokens=12,
           prompt_buckets=(4, 8))
PROMPTS = [[2, 3, 5], [7, 7], [11, 4, 9, 1, 6], [9, 2, 13], [3, 1, 4],
           [2, 9, 5], [1, 2, 3, 4, 5, 6, 7, 8], [40]]


@pytest.fixture(scope="module")
def shared_sv():
    """One warmed port servable on the CPU; tests build their own sync
    engines on it one after another (the slot bookkeeping is per engine,
    and a prefill resets any slot it reuses)."""
    cfg = DecodeConfig(**CFG)
    return DecodeServable(config=cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX flat engine's tokens for PROMPTS at max_new 10, and the
    reference's oracle per (prompt, max_new) on demand."""
    jcfg = jdec.DecodeConfig(**CFG)
    jsv = jdec.DecodeServable(config=jcfg)
    eng = jdec.DecodeBatcher(jsv, autostart=False)
    gens = [eng.submit(p, max_new=10) for p in PROMPTS]
    eng.drain_sync()
    cache = {}

    def oracle(prompt, n, eos_id=None):
        key = (tuple(prompt), n, eos_id)
        if key not in cache:
            cache[key] = jdec.reference_generate(
                prompt, n, params=jsv.params, config=jcfg, eos_id=eos_id)
        return cache[key]
    return [g.tokens_so_far() for g in gens], oracle


def _sync_engine(sv, **kw):
    return DecodeBatcher(sv, autostart=False, **kw)


# ---------------------------------------------------------------------------
# the decode attention and the model
# ---------------------------------------------------------------------------

def _att_inputs(name, rng):
    B, P, H, D, T = 3, 16, 2, 8, 3
    if name.startswith("paged"):
        n_pages, pl, pps = 9, 4, 4
        k = rng.randn(n_pages, pl, H, D).astype(np.float32)
        v = rng.randn(n_pages, pl, H, D).astype(np.float32)
        tbl = np.stack([rng.permutation(np.arange(1, n_pages))[:pps]
                        for _ in range(B)]).astype(np.int32)
        tbl[0, 2:] = 0                          # a short lane: scratch
        extra = (tbl,)
    else:
        k = rng.randn(B, P, H, D).astype(np.float32)
        v = rng.randn(B, P, H, D).astype(np.float32)
        extra = ()
    if name.endswith("multi"):
        q = rng.randn(B, T, H, D).astype(np.float32)
        last = np.array([0, 6, 15], np.int32)
        pos = (last[:, None] - np.arange(T)[::-1][None, :]).clip(0)
        return (q, k, v) + extra + (pos.astype(np.int32),)
    q = rng.randn(B, H, D).astype(np.float32)
    return (q, k, v) + extra + (np.array([1, 7, 16], np.int32),)


@pytest.mark.parametrize("name", ["cached_attention",
                                  "cached_attention_multi",
                                  "paged_attention",
                                  "paged_attention_multi"])
def test_decode_attention_matches_reference(name):
    args = _att_inputs(name, np.random.RandomState(0))
    got = getattr(tatt, name)(*[torch.from_numpy(a) for a in args]).numpy()
    want = np.asarray(getattr(jatt, name)(*[jnp.asarray(a) for a in args]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cached_attention_ignores_stale_pages_and_stays_finite():
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 2, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 8, 2, 8).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 8, 2, 8).astype(np.float32))
    lens = torch.tensor([3, 1], dtype=torch.int32)
    base = tatt.cached_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[0, 3:], v2[0, 3:] = 99.0, -99.0          # poison the stale region
    k2[1, 1:], v2[1, 1:] = 1e30, 1e30           # a scratch lane, cur_len 1
    out = tatt.cached_attention(q, k2, v2, lens)
    torch.testing.assert_close(out[0], base[0], rtol=0, atol=0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[1], v[1, 0], rtol=0, atol=0)


@pytest.mark.parametrize("kw", [
    dict(slots=8, max_tokens=32, page=16, prompt_buckets=(4, 8, 16)),
    dict(CFG), dict(CFG, kv_page_len=4, prefill_chunk=6, spec_k=20),
    dict(vocab=30522, dim=768, heads=12, layers=12, slots=32,
         max_tokens=128, prompt_buckets=(64, 128, 256), prefill_chunk=64),
], ids=["reference", "small", "paged", "bert_base"])
def test_config_geometry_matches_reference(kw):
    got, want = DecodeConfig(**kw), jdec.DecodeConfig(**kw)
    assert vars(got) == vars(want)
    assert repr(got) == repr(want)
    for n in (1, 3, 5, 8, 17, 300):
        assert got.prompt_bucket_for(n) == want.prompt_bucket_for(n)
        assert got.slot_bucket_for(n) == want.slot_bucket_for(n)
    with pytest.raises(MXNetError):
        DecodeConfig(dim=30, heads=4)


def test_config_reads_the_reference_knobs(monkeypatch):
    for name, val in (("MX_SERVE_DECODE_SLOTS", "6"),
                      ("MX_SERVE_DECODE_MAX_TOKENS", "20"),
                      ("MX_SERVE_DECODE_PAGE", "8"),
                      ("MX_SERVE_DECODE_PROMPT_BUCKETS", "3,9"),
                      ("MX_SERVE_KV_PAGES", "50"),
                      ("MX_SERVE_KV_PAGE_LEN", "4"),
                      ("MX_SERVE_PREFIX_SHARE", "0"),
                      ("MX_SERVE_PREFILL_CHUNK", "5"),
                      ("MX_SERVE_SPEC_K", "3")):
        monkeypatch.setenv(name, val)
        default, doc = ENV_CATALOG[name]
        assert default is not None and doc
    assert vars(DecodeConfig()) == vars(jdec.DecodeConfig())
    assert DecodeConfig().slots == 6 and not DecodeConfig().prefix_share


def test_demo_weights_are_the_references_bit_for_bit():
    cfg = DecodeConfig(**CFG)
    want = jdec.demo_lm_params(jdec.DecodeConfig(**CFG))
    got = demo_lm_params(cfg, device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert set(demo_lm_numpy(cfg)) == set(want)


# ---------------------------------------------------------------------------
# the engine's tokens are the JAX engine's
# ---------------------------------------------------------------------------

def test_flat_engine_emits_the_jax_engines_tokens(shared_sv, jax_tokens):
    sv, cfg = shared_sv
    want, oracle = jax_tokens
    eng = _sync_engine(sv)
    gens = [eng.submit(p, max_new=10) for p in PROMPTS]
    eng.drain_sync()
    assert [g.tokens_so_far() for g in gens] == want
    assert all(g.done() for g in gens)
    for p, w in zip(PROMPTS[:3], want):
        assert reference_generate(p, 10, params=sv.params,
                                  config=cfg) == w == oracle(p, 10)


def test_bucket_packing_invariance(shared_sv, jax_tokens):
    sv, cfg = shared_sv
    ref = jax_tokens[1]([9, 2, 13], 10)
    eng = _sync_engine(sv)
    g_alone = eng.submit([9, 2, 13], max_new=10)
    eng.drain_sync()
    eng2 = _sync_engine(sv)
    packed = [eng2.submit([9, 2, 13], max_new=10)] + \
        [eng2.submit([i + 3, 8], max_new=10) for i in range(3)]
    eng2.drain_sync()
    assert g_alone.tokens_so_far() == packed[0].tokens_so_far() == ref


def test_scheduling_never_changes_tokens(shared_sv, jax_tokens):
    sv, cfg = shared_sv
    prompts = [[3, 1, 4], [1, 5], [9, 2, 6, 5], [3, 5, 8], [9, 7],
               [9, 3, 2]]
    news = [2, 9, 4, 2, 7, 3]

    def run(mode):
        eng = _sync_engine(sv, mode=mode)
        gens = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        eng.drain_sync()
        return [g.tokens_so_far() for g in gens]

    got = run("continuous")
    assert got == run("request")
    assert got == [jax_tokens[1](p, n) for p, n in zip(prompts, news)]


def test_long_generation_never_blocks_short(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    long_g = eng.submit([2], max_new=12)
    shorts = [eng.submit([3], max_new=2) for _ in range(3)]
    for _ in range(5):
        eng.step_sync()
    assert all(g.done() for g in shorts)
    assert not long_g.done()
    late = eng.submit([4], max_new=2)
    for _ in range(4):
        eng.step_sync()
    assert late.done() and not long_g.done()
    eng.drain_sync()
    assert long_g.done() and len(long_g.tokens_so_far()) == 12


def test_request_mode_holds_admissions(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv, mode="request")
    wave1 = [eng.submit([5], max_new=6) for _ in range(cfg.slots)]
    late = eng.submit([6], max_new=2)
    eng.step_sync()
    assert eng.active_count() == cfg.slots
    for _ in range(3):
        eng.step_sync()
    assert not late.done() and eng.queue_depth() == 1
    eng.drain_sync()
    assert late.done() and all(g.done() for g in wave1)
    with pytest.raises(MXNetError):
        DecodeBatcher(sv, mode="bogus", autostart=False)


def test_slot_reuse_after_retire_is_clean(shared_sv, jax_tokens):
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    first = [eng.submit([7, 3], max_new=6) for _ in range(cfg.slots)]
    eng.drain_sync()
    second = eng.submit([2, 8, 4], max_new=8)      # a dirty slot
    eng.drain_sync()
    assert second.tokens_so_far() == jax_tokens[1]([2, 8, 4], 8)
    assert all(g.done() for g in first)


@pytest.mark.parametrize("bad", [[], [1] * 9, [48], [-1], ["nope"]],
                         ids=["empty", "over_bucket", "vocab", "negative",
                              "not_ids"])
def test_admission_refusals(shared_sv, bad):
    sv, cfg = shared_sv
    assert cfg.vocab == 48
    eng = _sync_engine(sv)
    r0 = registry.value("serve.decode.rejected")
    with pytest.raises(MXNetError):
        eng.submit(bad)
    assert registry.value("serve.decode.rejected") == r0 + 1
    assert eng.queue_depth() == 0


def test_queue_cap_sheds_overload(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv, queue_cap=2)
    eng.submit([1], max_new=2)
    eng.submit([1], max_new=2)
    with pytest.raises(Overloaded):
        eng.submit([1], max_new=2)
    eng.drain_sync()


def test_max_tokens_clamps_to_config(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    g = eng.submit([5, 5], max_new=cfg.max_tokens + 50)
    g0 = eng.submit([5, 5], max_new=0)
    eng.drain_sync()
    assert len(g.tokens_so_far()) == cfg.max_tokens
    assert len(g0.tokens_so_far()) == 1


def test_eos_stops_generation(shared_sv, jax_tokens):
    sv, cfg = shared_sv
    oracle = jax_tokens[1]
    ref = oracle([3, 9], 8)
    eos = ref[2]
    eng = _sync_engine(sv)
    g = eng.submit([3, 9], max_new=8, eos_id=eos)
    plain = eng.submit([3, 9], max_new=8)
    eng.drain_sync()
    stop = ref.index(eos) + 1                  # the first occurrence
    assert g.tokens_so_far() == ref[:stop]
    assert plain.tokens_so_far() == ref
    assert reference_generate([3, 9], 8, params=sv.params, config=cfg,
                              eos_id=eos) == ref[:stop] == \
        oracle([3, 9], 8, eos)


def test_dispatch_budget_exact_and_zero_retraces(shared_sv):
    """One dispatch a decode step whatever the active count, one a
    prefill, every dispatch counted, no program built after warm()."""
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    retr0 = sv.retraces
    pre0 = registry.value("serve.decode.prefills")
    st0 = registry.value("serve.decode.steps")
    c0 = engine.snapshot()["dispatches"]
    gens = [eng.submit([2, 4, 6], max_new=5) for _ in range(4)]
    eng.drain_sync()
    dispatches = engine.snapshot()["dispatches"] - c0
    prefills = registry.value("serve.decode.prefills") - pre0
    steps = registry.value("serve.decode.steps") - st0
    assert prefills == 4
    assert steps == 4                   # token 1 comes from the prefill
    assert dispatches == prefills + steps
    assert sv.retraces == retr0 == len(cfg.prompt_buckets) + \
        len(cfg.slot_buckets)
    assert sv.warmed and sv.hits > 0
    assert all(len(g.tokens_so_far()) == 5 for g in gens)


def test_kv_pool_constant_bytes_updated_in_place(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    b0 = sv.kv_state_bytes()
    ptrs = {k: (t, t.data_ptr()) for k, t in sv._state.items()}
    for _ in range(3):
        gens = [eng.submit([3, 3], max_new=7) for _ in range(6)]
        eng.drain_sync()
        assert all(g.done() for g in gens)
    assert sv.kv_state_bytes() == b0
    assert b0 == 2 * 4 * cfg.layers * (cfg.slots + 1) * cfg.max_len * \
        cfg.dim + 2 * 4 * (cfg.slots + 1)
    assert sv.kv_slot_bytes() == b0 // (cfg.slots + 1)
    for k, (t, p) in ptrs.items():
        assert sv._state[k] is t and t.data_ptr() == p
    assert sv.live_bytes() == b0 + sum(p.nbytes for p in sv.params.values())


@pytest.mark.parametrize("method", ["program_prefix", "footprint_bytes"])
def test_census_methods_wait_for_programs_py(shared_sv, method):
    sv, _ = shared_sv
    with pytest.raises(NotImplementedError, match="programs.py"):
        getattr(sv, method)()


def test_phases_and_token_histogram(shared_sv):
    sv, cfg = shared_sv
    snap0 = telemetry.phase_snapshot()
    tok_h = registry.find("serve.decode.token_seconds")
    t0 = tok_h.snapshot()["count"] if tok_h is not None else 0
    eng = _sync_engine(sv)
    gens = [eng.submit([6, 1], max_new=4) for _ in range(5)]
    eng.drain_sync()
    eng.step_sync()                     # a boundary after the harvest
    snap = telemetry.phase_snapshot()

    def count(name):
        now = snap.get(name, {}).get("count", 0)
        return now - snap0.get(name, {}).get("count", 0)

    assert count("prefill") >= 5
    assert count("decode_step") >= 3
    assert count("kv_evict") >= 1
    tok_h = registry.find("serve.decode.token_seconds")
    assert tok_h.snapshot()["count"] - t0 == sum(
        len(g.tokens_so_far()) for g in gens)


def test_streaming_wait_new(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    g = eng.submit([8, 8], max_new=6)
    chunk, done = g.wait_new(0, timeout=0.01)
    assert chunk == [] and not done
    eng.drain_sync()
    chunk, done = g.wait_new(0, timeout=1.0)
    assert done and chunk == g.tokens_so_far() and len(chunk) == 6
    tail, done = g.wait_new(4, timeout=1.0)
    assert done and tail == g.tokens_so_far()[4:]


def test_threaded_engine_smoke(shared_sv, jax_tokens):
    sv, cfg = shared_sv
    oracle = jax_tokens[1]
    eng = DecodeBatcher(sv)
    try:
        prompts = [[5, 6, 7], [2, 2], [9, 1, 3, 8]]
        news = (8, 2, 5)
        gens = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        gens += [eng.submit(prompts[0], max_new=8) for _ in range(5)]
        outs = [g.result(timeout=60) for g in gens]
        assert outs[:3] == [oracle(p, n) for p, n in zip(prompts, news)]
        assert all(o == outs[0] for o in outs[3:])
    finally:
        eng.close()
    eng.close()
    assert not eng._pump.is_alive() and not eng._harvester.is_alive()


def test_a_closed_engine_fails_what_it_held(shared_sv):
    sv, cfg = shared_sv
    eng = _sync_engine(sv)
    g = eng.submit([1, 2], max_new=4)
    eng.close()
    eng._loop()                         # the pump's exit path
    with pytest.raises(MXNetError, match="stopped"):
        g.result(timeout=1)


def test_the_gpu_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(MXNetError, match="cuda"):
        DecodeServable(config=DecodeConfig(**CFG))


# ---------------------------------------------------------------------------
# GENERATE over the wire
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _start_replica(port, sv=None, abort_event=None, on_tick=None):
    sv = sv or DecodeServable(config=DecodeConfig(**CFG), device="cpu")
    state = ServeServer(decode=DecodeBatcher(sv, on_tick=on_tick))
    stop_ev = threading.Event()
    ready = threading.Event()
    t = threading.Thread(
        target=serve_forever,
        kwargs=dict(port=port, state=state, stop_event=stop_ev,
                    bind="127.0.0.1", ready_event=ready,
                    abort_event=abort_event),
        daemon=True)
    t.start()
    assert ready.wait(30)
    return state, sv, stop_ev, t


@pytest.fixture(scope="module")
def wire_replica():
    port = _free_port()
    state, sv, stop_ev, t = _start_replica(port)
    yield "127.0.0.1:%d" % port, state, sv
    stop_ev.set()
    t.join(timeout=15)


def test_wire_generate_round_trip(wire_replica, jax_tokens):
    addr, state, sv = wire_replica
    with ServeClient([addr], timeout=30) as cli:
        version, toks = cli.generate([3, 1, 4], max_tokens=9)
        assert version == sv.version
        assert toks == jax_tokens[1]([3, 1, 4], 9)
        eos = toks[3]
        _v, stopped = cli.generate([3, 1, 4], max_tokens=9, eos=eos)
        assert stopped == toks[:toks.index(eos) + 1]
        with pytest.raises(MXNetError):
            cli.generate([1] * 99)
        with pytest.raises(MXNetError, match="unknown model"):
            cli.generate([1, 2], model="nope")
        stats = cli.decode_stats()
    assert stats["engine"] == "flat" and stats["model"] == sv.name


def test_wire_generate_streaming(wire_replica, jax_tokens):
    addr, state, sv = wire_replica
    got, calls = [], []
    with ServeClient([addr], timeout=30) as cli:
        _v, toks = cli.generate([2, 9, 5], max_tokens=8,
                                on_token=lambda t: (got.extend(t),
                                                    calls.append(t)))
    assert toks == got == jax_tokens[1]([2, 9, 5], 8)
    assert calls and all(calls)


def test_generate_replay_exactly_once(wire_replica):
    addr, state, sv = wire_replica
    pre0 = registry.value("serve.decode.prefills")
    rep0 = registry.value("serve.server_replays")
    msg = ("SEQ", "decode-replay-test", 7,
           ("GENERATE", [4, 4, 4], {"max_tokens": 5}))
    r1 = state.handle_request(msg)
    assert r1[0] is True and len(r1[1][1]) == 5
    pre1 = registry.value("serve.decode.prefills")
    r2 = state.handle_request(msg)
    assert r2 == r1
    assert registry.value("serve.decode.prefills") == pre1 == pre0 + 1
    assert registry.value("serve.server_replays") - rep0 == 1
    assert state.handle(("STREAM", 0, [1]))[0] is False


def test_health_reports_decode(wire_replica):
    addr, state, sv = wire_replica
    deadline = time.monotonic() + 10    # the pump retires at its next tick
    while state.decode.active_count() and time.monotonic() < deadline:
        time.sleep(0.01)
    with ServeClient([addr], timeout=30) as cli:
        h = cli.health()
    assert h["status"] == "serving"
    d = h["decode"]
    assert d["slots"] == sv.config.slots and d["model"] == sv.name
    assert d["retraces"] == sv.retraces and d["engine"] == "flat"
    assert d["active"] == 0 and d["queued"] == 0
    assert d["slot_buckets"] == list(sv.config.slot_buckets)
    assert ServeServer().handle(
        ("GENERATE", [1], {}))[1].startswith("no decode engine")


def test_failover_mid_generation(wire_replica, jax_tokens):
    """Kill a replica while a generation is in flight on it: the client
    fails over, the survivor generates again, and the caller gets the
    exact sequence."""
    addr2, _state2, sv2 = wire_replica
    p1 = _free_port()
    ab1 = threading.Event()
    # throttle replica 1's pump so the generation outlives the abort
    state1, sv1, _st1, t1 = _start_replica(
        p1, sv=DecodeServable(config=DecodeConfig(**CFG), device="cpu"),
        abort_event=ab1, on_tick=lambda: time.sleep(0.025))
    addrs = ["127.0.0.1:%d" % p1, addr2]
    ref = jax_tokens[1]([6, 2, 8], 12)
    fo0 = registry.value("serve.client_failovers")
    result, streamed = {}, []

    def call():
        with ServeClient(addrs, timeout=30) as cli:
            result["out"] = cli.generate([6, 2, 8], max_tokens=12,
                                         on_token=streamed.extend)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if state1.decode.active_count() > 0:
            break
        time.sleep(0.001)
    ab1.set()
    t.join(timeout=60)
    t1.join(timeout=15)
    assert "out" in result, "generation lost in failover"
    assert result["out"][1] == ref == streamed
    assert registry.value("serve.client_failovers") > fo0


def test_a_draining_replica_spills_to_the_next(wire_replica, jax_tokens):
    addr2, _state2, _sv2 = wire_replica
    p1 = _free_port()
    state1, _sv1, stop1, t1 = _start_replica(p1)
    state1._draining.set()
    try:
        with ServeClient(["127.0.0.1:%d" % p1, addr2], timeout=30) as cli:
            assert cli.health(idx=0)["status"] == "draining"
            _v, toks = cli.generate([5, 5, 1], max_tokens=4)
        assert toks == jax_tokens[1]([5, 5, 1], 4)
        with ServeClient(["127.0.0.1:%d" % p1], timeout=30) as cli:
            with pytest.raises(MXNetError, match="draining"):
                cli.generate([5, 5, 1], max_tokens=4)
    finally:
        stop1.set()
        t1.join(timeout=15)
