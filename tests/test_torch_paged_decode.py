"""The port's paged decode engine (``serve/paging.py``, the page heap,
chunked prefill, prefix sharing with copy-on-write) against the JAX
reference, on the CPU, at the reference suite's geometry
(``tests/test_paged_decode.py`` ``PCFG``).

The page hashes and the allocator's whole lifecycle equal the reference's
on the same sequences of calls.  Greedy decode through the heap emits
exactly the JAX paged engine's tokens for the same workload (shared
prefixes, a copy-on-write fork, a partial share, chunked admissions), and
the reference's oracle's; the flat engine agrees.  The behaviours that
need no ``programs.py``: chunk counts, the donor's pages surviving its
retirement, four times the flat pool's concurrency at equal KV bytes, page
exhaustion queueing then admitting, a 10,240-token admission interleaving
with decode, the dispatch budget, zero retraces after ``warm()``, a heap of
constant bytes updated in place, and the engine's surface.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serve import decode as jdec
from mxnet_tpu.serve import paging as jpaging

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.engine import engine
from mxnet_tpu_torch.serve.decode import (DecodeBatcher, DecodeConfig,
                                          DecodeServable, PagedDecodeBatcher,
                                          PagedDecodeServable, demo_lm_numpy,
                                          reference_generate)
from mxnet_tpu_torch.serve.paging import (HASH_SEED, SCRATCH_PAGE,
                                          PageAllocator, chain_hash,
                                          page_hashes)
from mxnet_tpu_torch.telemetry import registry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

# the reference suite's geometry: pages_per_slot = 7, kv_pages = 35
PCFG = dict(dim=16, heads=2, layers=2, slots=4, max_tokens=12,
            prompt_buckets=(4, 8), kv_page_len=4, prefill_chunk=4)
DONOR = [2, 7, 1, 8, 2, 8, 1, 8]
# a burst with shared prefixes: full coverage (copy-on-write), a partial
# share with a divergent suffix, short and single-page prompts
WORKLOAD = [(DONOR, 4), ([3, 1, 4, 1], 6), (DONOR, 6),
            (DONOR[:4] + [5, 5, 3, 1], 6), ([5, 9, 2, 6, 5, 3], 8),
            ([1, 2], 1), ([9, 9, 9, 9, 9, 1, 1], 5), (DONOR, 3)]


@pytest.fixture(scope="module")
def paged_sv():
    cfg = DecodeConfig(**PCFG)
    return PagedDecodeServable(config=cfg, device="cpu"), cfg


@pytest.fixture(scope="module")
def jax_side():
    """The JAX paged engine's tokens for WORKLOAD (admitted in two waves,
    so the second finds the first's pages published) and the reference's
    oracle on demand."""
    jcfg = jdec.DecodeConfig(**PCFG)
    jsv = jdec.PagedDecodeServable(config=jcfg)
    eng = jdec.PagedDecodeBatcher(jsv, autostart=False)
    out = _run_waves(eng)
    cache = {}

    def oracle(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            cache[key] = jdec.reference_generate(prompt, n,
                                                 params=jsv.params,
                                                 config=jcfg)
        return cache[key]
    return out, oracle


def _run_waves(eng):
    first = [eng.submit(p, max_new=n) for p, n in WORKLOAD[:2]]
    eng.drain_sync()
    rest = [eng.submit(p, max_new=n) for p, n in WORKLOAD[2:]]
    eng.drain_sync()
    return [g.tokens_so_far() for g in first + rest]


def _sync_engine(sv, **kw):
    return PagedDecodeBatcher(sv, autostart=False, **kw)


# ---------------------------------------------------------------------------
# host-side bookkeeping: prefix hashes + the page allocator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page_len", [1, 3, 4, 16])
def test_page_hashes_equal_the_references(page_len):
    rng = np.random.RandomState(page_len)
    for n in (0, 3, 8, 17, 64):
        prompt = rng.randint(0, 30522, size=n).tolist()
        assert page_hashes(prompt, page_len) == \
            jpaging.page_hashes(prompt, page_len)
    assert (HASH_SEED, SCRATCH_PAGE) == (jpaging.HASH_SEED,
                                         jpaging.SCRATCH_PAGE)
    assert chain_hash(HASH_SEED, [1, 2, 3]) == \
        jpaging.chain_hash(jpaging.HASH_SEED, [1, 2, 3])


def test_page_hashes_cover_the_whole_prefix():
    a = page_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = page_hashes([1, 2, 3, 4, 9, 6, 7, 8], 4)
    assert len(a) == len(b) == 2
    assert a[0] == b[0] and a[1] != b[1]
    assert page_hashes([9, 2, 3, 4, 5, 6, 7, 8], 4)[1] != a[1]
    assert len(page_hashes([1, 2, 3, 4, 5], 4)) == 1
    assert chain_hash(HASH_SEED, [1, 2, 3, 4]) == a[0]


def _allocator_script(mod):
    """One lifecycle through ``mod.PageAllocator``; every answer and the
    stats after each call."""
    al = mod.PageAllocator(6)
    log = []

    def note(x):
        log.append((x, al.free_pages(), al.shared_extra_refs(),
                    al.stats()))
    held = al.alloc(3)
    note(held)
    note(al.alloc(3))
    note(al.publish(77, held[0]))
    note(al.publish(77, held[1]))
    note(al.lookup(77))
    al.release(held[0])
    note(None)
    al.release(held[0])
    note(al.lookup(77))
    al.release(held[0])
    note(al.alloc(3))
    note(al.lookup(77))
    note(al.evictions)
    for fn in (lambda: al.release(held[0]),
               lambda: al.release(held[0]) or al.release(held[0]),
               lambda: mod.PageAllocator(1)):
        try:
            fn()
            log.append("ok")
        except Exception as e:          # noqa: BLE001 — compared below
            log.append(type(e).__name__)
    return log


def test_allocator_lifecycle_equals_the_references():
    got = _allocator_script(__import__("mxnet_tpu_torch.serve.paging",
                                       fromlist=["x"]))
    want = _allocator_script(jpaging)
    assert got == want
    assert got[1][0] is None and got[-1] == "MXNetError"
    al = PageAllocator(4)
    (p,) = al.alloc(1)
    assert p != SCRATCH_PAGE
    al.release(p)
    with pytest.raises(MXNetError):
        al.release(p)


# ---------------------------------------------------------------------------
# tokens: paged == the JAX paged engine == the oracle == flat
# ---------------------------------------------------------------------------

def test_paged_engine_emits_the_jax_engines_tokens(paged_sv, jax_side):
    sv, cfg = paged_sv
    want, oracle = jax_side
    sh0 = registry.value("serve.decode.shared_page_hits")
    cow0 = registry.value("serve.decode.cow_forks")
    got = _run_waves(_sync_engine(sv))
    assert got == want
    assert got == [oracle(p, n) for p, n in WORKLOAD]
    assert registry.value("serve.decode.cow_forks") - cow0 == 2
    assert registry.value("serve.decode.shared_page_hits") - sh0 >= 5


@pytest.mark.parametrize("max_new", [1, 4, 8])
def test_paged_matches_flat_and_oracle(paged_sv, jax_side, max_new):
    sv, cfg = paged_sv
    flat = DecodeBatcher(DecodeServable(config=DecodeConfig(
        **{k: v for k, v in PCFG.items()
           if k not in ("kv_page_len", "prefill_chunk")}), device="cpu"),
        autostart=False)
    prompts = [[3, 1, 4, 1], [5, 9, 2, 6, 5, 3], DONOR, [1, 2],
               [9, 9, 9, 9, 9, 1, 1]]
    eng = _sync_engine(sv)
    gens = [eng.submit(p, max_new=max_new) for p in prompts]
    fgens = [flat.submit(p, max_new=max_new) for p in prompts]
    eng.drain_sync()
    flat.drain_sync()
    for p, g, f in zip(prompts, gens, fgens):
        ref = jax_side[1](p, max_new)
        assert g.tokens_so_far() == f.tokens_so_far() == ref, p
        assert reference_generate(p, max_new, params=sv.params,
                                  config=cfg) == ref


def test_chunked_admission_identical(paged_sv, jax_side):
    """An 8-token prompt admits as two 4-token chunks."""
    sv, cfg = paged_sv
    eng = _sync_engine(sv)
    c0 = registry.value("serve.decode.prefill_chunks")
    p = [7, 3, 2, 9, 4, 4, 1, 6]
    g = eng.submit(p, max_new=6)
    eng.drain_sync()
    assert g.tokens_so_far() == jax_side[1](p, 6)
    assert registry.value("serve.decode.prefill_chunks") - c0 == 2


def test_cow_and_partial_share_match_oracle(paged_sv, jax_side):
    sv, cfg = paged_sv
    oracle = jax_side[1]
    eng = _sync_engine(sv)
    g0 = eng.submit(DONOR, max_new=4)
    eng.drain_sync()
    assert g0.tokens_so_far() == oracle(DONOR, 4)
    c0 = registry.value("serve.decode.prefill_chunks")
    cow0 = registry.value("serve.decode.cow_forks")
    sh0 = registry.value("serve.decode.shared_page_hits")
    g1 = eng.submit(DONOR, max_new=6)       # full coverage: one replay
    eng.drain_sync()
    assert g1.tokens_so_far() == oracle(DONOR, 6)
    assert registry.value("serve.decode.prefill_chunks") - c0 == 1
    assert registry.value("serve.decode.cow_forks") - cow0 == 1
    c1 = registry.value("serve.decode.prefill_chunks")
    fork = DONOR[:4] + [5, 5, 3, 1]          # shared page + own suffix
    g2 = eng.submit(fork, max_new=6)
    eng.drain_sync()
    assert g2.tokens_so_far() == oracle(fork, 6)
    assert registry.value("serve.decode.prefill_chunks") - c1 == 1
    assert registry.value("serve.decode.shared_page_hits") - sh0 >= 2
    g3 = eng.submit(DONOR, max_new=6)        # the donor is intact
    eng.drain_sync()
    assert g3.tokens_so_far() == g1.tokens_so_far()


def test_shared_pages_survive_donor_retire(paged_sv, jax_side):
    sv, cfg = paged_sv
    eng = _sync_engine(sv)
    donor = [6, 1, 6, 1, 3, 8, 3, 8]
    eng.submit(donor, max_new=2)
    eng.drain_sync()
    assert eng.page_stats()["kv_cached_pages"] >= 2
    c0 = registry.value("serve.decode.prefill_chunks")
    g = eng.submit(donor, max_new=5)
    eng.drain_sync()
    assert g.tokens_so_far() == jax_side[1](donor, 5)
    assert registry.value("serve.decode.prefill_chunks") - c0 == 1


# ---------------------------------------------------------------------------
# capacity: pages, not slots
# ---------------------------------------------------------------------------

_SMALL = dict(dim=8, heads=1, layers=1, max_tokens=16,
              prompt_buckets=(4, 64))


def test_admission_capacity_4x_at_equal_kv_bytes():
    flat_sv = DecodeServable(config=DecodeConfig(slots=2, **_SMALL),
                             device="cpu")
    paged_cfg = DecodeConfig(slots=12, kv_page_len=16, kv_pages=18,
                             **_SMALL)
    paged_sv = PagedDecodeServable(config=paged_cfg, device="cpu")
    flat_pool = flat_sv._state["k"].nbytes + flat_sv._state["v"].nbytes
    paged_pool = paged_sv._state["k"].nbytes + paged_sv._state["v"].nbytes
    assert flat_pool == paged_pool == paged_sv.page_bytes() * 18 == 18432
    eng = PagedDecodeBatcher(paged_sv, autostart=False)
    long_p = list(np.arange(64) % 7 + 1)
    shorts = [[1 + i % 5, 2, 3, 4] for i in range(11)]
    gens = [eng.submit(long_p, max_new=16)]
    gens += [eng.submit(p, max_new=2) for p in shorts]
    eng.step_sync()
    assert eng.active_count() == 12 >= 4 * flat_sv.config.slots
    eng.drain_sync()
    jcfg = jdec.DecodeConfig(slots=12, kv_page_len=16, kv_pages=18,
                             **_SMALL)
    jp = jdec.demo_lm_params(jcfg)
    for g, p, n in zip(gens, [long_p] + shorts, [16] + [2] * 11):
        assert g.tokens_so_far() == jdec.reference_generate(
            p, n, params=jp, config=jcfg)


def test_page_exhaustion_queues_then_admits():
    cfg = DecodeConfig(slots=12, kv_page_len=16, kv_pages=18, **_SMALL)
    sv = PagedDecodeServable(config=cfg, device="cpu")
    eng = PagedDecodeBatcher(sv, autostart=False)
    eng.submit(list(np.arange(64) % 7 + 1), max_new=16)   # 6 pages
    shorts = [eng.submit([2, 2, 2, 2], max_new=2)
              for _ in range(11)]                         # 17 in all
    eng.step_sync()
    assert eng.active_count() == 12
    extra = eng.submit([3, 3, 3, 3], max_new=2)
    eng.step_sync()
    assert not extra.done() and eng.queue_depth() == 1
    assert eng.page_stats()["kv_free_pages"] == 0
    eng.drain_sync()
    assert extra.done()
    assert extra.tokens_so_far() == reference_generate(
        [3, 3, 3, 3], 2, params=sv.params, config=cfg)
    assert all(g.done() for g in shorts)


def test_10k_prefill_interleaves_with_decode():
    """A 10,240-token admission is a train of chunks that alternate with
    decode steps, so short generations admitted beside it finish while it
    is still in flight, and its tokens do not depend on the chunk size."""
    base = dict(dim=8, heads=1, layers=1, slots=4, max_tokens=8,
                prompt_buckets=(32, 10240))
    rs = np.random.RandomState(3)
    long_p = list(rs.randint(1, 40, size=10240))
    short_p = list(rs.randint(1, 40, size=32))

    def run(chunk):
        cfg = DecodeConfig(kv_page_len=64, prefill_chunk=chunk, **base)
        eng = PagedDecodeBatcher(PagedDecodeServable(config=cfg,
                                                     device="cpu"),
                                 autostart=False)
        lg = eng.submit(long_p, max_new=4)
        sg = [eng.submit(short_p, max_new=2) for _ in range(2)]
        ticks_until_shorts = None
        for t in range(1, 9):
            eng.step_sync()
            if ticks_until_shorts is None and all(g.done() for g in sg):
                ticks_until_shorts = t
        assert ticks_until_shorts is not None
        assert not lg.done()
        eng.drain_sync(max_ticks=200)
        return lg.tokens_so_far(), [g.tokens_so_far() for g in sg]

    jcfg = jdec.DecodeConfig(kv_page_len=64, prefill_chunk=512, **base)
    short_ref = jdec.reference_generate(short_p, 2,
                                        params=jdec.demo_lm_params(jcfg),
                                        config=jcfg)
    out_512 = run(512)
    out_1024 = run(1024)
    assert out_512 == out_1024
    assert out_512[1] == [short_ref, short_ref]


# ---------------------------------------------------------------------------
# budgets and the surface
# ---------------------------------------------------------------------------

def test_paged_dispatch_budget_and_zero_retraces(paged_sv):
    sv, cfg = paged_sv
    eng = _sync_engine(sv)
    retr0 = sv.retraces
    c0 = engine.snapshot()["dispatches"]
    ch0 = registry.value("serve.decode.prefill_chunks")
    st0 = registry.value("serve.decode.steps")
    pre0 = registry.value("serve.decode.prefills")
    gens = [eng.submit([2, 4, 6], max_new=5) for _ in range(4)]
    eng.drain_sync()
    dispatches = engine.snapshot()["dispatches"] - c0
    chunks = registry.value("serve.decode.prefill_chunks") - ch0
    steps = registry.value("serve.decode.steps") - st0
    assert chunks == 4
    assert registry.value("serve.decode.prefills") - pre0 == 4
    assert dispatches == chunks + steps
    assert sv.retraces == retr0 == 1 + len(cfg.slot_buckets)
    assert all(len(g.tokens_so_far()) == 5 for g in gens)


def test_heap_constant_bytes_updated_in_place(paged_sv):
    sv, cfg = paged_sv
    eng = _sync_engine(sv)
    b0 = sv.kv_state_bytes()
    ptrs = {k: (t, t.data_ptr()) for k, t in sv._state.items()}
    done = 0
    while done < 40:
        gens = [eng.submit([3, 1 + done % 5], max_new=3)
                for _ in range(4)]
        eng.drain_sync()
        done += len(gens)
    assert sv.kv_state_bytes() == b0
    for k, (t, p) in ptrs.items():
        assert sv._state[k] is t and t.data_ptr() == p
    assert sv.kv_slot_bytes() == sv.page_bytes() * cfg.pages_per_slot


@pytest.mark.parametrize("engine_cls,sv_cls", [
    (DecodeBatcher, DecodeServable),
    (PagedDecodeBatcher, PagedDecodeServable)], ids=["flat", "paged"])
def test_float64_params_give_a_float64_engine(engine_cls, sv_cls):
    """A servable keeps its parameters' dtype for the parameters and the
    KV state: float64 weights give the float64 model through the
    constructor, and its tokens are the float64 oracle's."""
    cfg = DecodeConfig(**PCFG)
    p64 = {k: v.astype(np.float64) for k, v in demo_lm_numpy(cfg).items()}
    sv = sv_cls(params=p64, config=cfg, device="cpu")
    assert {p.dtype for p in sv.params.values()} == {torch.float64}
    assert sv._state["k"].dtype == sv._state["v"].dtype == torch.float64
    assert sv_cls(config=cfg, device="cpu")._state["k"].dtype == \
        torch.float32
    got = _run_waves(engine_cls(sv, autostart=False))
    assert got == [reference_generate(p, n, params=p64, config=cfg,
                                      device="cpu") for p, n in WORKLOAD]


def test_paged_engine_surface(paged_sv):
    sv, cfg = paged_sv
    eng = _sync_engine(sv)
    assert sv.engine == "paged" and sv.census_owner == "kv_pages"
    st = eng.page_stats()
    assert st["engine"] == "paged" and st["kv_pages"] == cfg.kv_pages
    assert st["prefill_chunk"] == cfg.prefill_chunk
    eng.submit([5, 5], max_new=2)
    eng.drain_sync()
    assert registry.value("serve.decode.kv_free_pages") == \
        eng.page_stats()["kv_free_pages"] > 0
    assert super(PagedDecodeBatcher, eng).page_stats() is None
    with pytest.raises(MXNetError):
        PagedDecodeBatcher(sv, mode="request", autostart=False)
    with pytest.raises(MXNetError):
        PagedDecodeBatcher(DecodeServable(config=DecodeConfig(**PCFG),
                                          device="cpu"), autostart=False)
    with pytest.raises(MXNetError):
        sv.prefill_program(8)
    with pytest.raises(MXNetError):
        sv.dispatch_prefill(0, np.zeros(4, np.int32), 2)


def test_threaded_paged_smoke(paged_sv, jax_side):
    sv, cfg = paged_sv
    oracle = jax_side[1]
    eng = PagedDecodeBatcher(sv)
    try:
        prompts = [[5, 6, 7], [2, 2], [9, 1, 3, 8], [9, 1, 3, 8]]
        news = (8, 2, 5, 5)
        gens = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        gens += [eng.submit(prompts[0], max_new=8) for _ in range(5)]
        outs = [g.result(timeout=60) for g in gens]
        assert outs[:4] == [oracle(p, n) for p, n in zip(prompts, news)]
        assert all(o == outs[0] for o in outs[4:])
    finally:
        eng.close()
    eng.close()
    assert not eng._pump.is_alive() and not eng._harvester.is_alive()
