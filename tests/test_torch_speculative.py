"""The port's speculative decode (draft + verify windows over the paged
engine) against the JAX reference, on the CPU, at the reference suite's
geometry (``tests/test_speculative.py`` ``SCFG``).

Every emitted token is the target's own argmax, so at every window width
``spec_k`` (1..8, the overrun margin) the output must equal the
reference's greedy oracle token for token, and at ``spec_k`` = 4 the JAX
speculative engine's and the port's plain paged engine's, with zero
retraces after warm-up.  A corrupted draft (proposals from column
``corrupt_from`` on made wrong after the draft step) degrades only the
number of tokens a window commits, exactly as the acceptance rule says:
``min(corrupt_from, k - 1) + 1``.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu.serve import decode as jdec

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve.decode import (DecodeConfig, DraftDecodeServable,
                                          PagedDecodeBatcher,
                                          PagedDecodeServable,
                                          SpeculativeDecodeBatcher,
                                          demo_spec_pair)
from mxnet_tpu_torch.telemetry import registry

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

SCFG = dict(dim=16, heads=2, layers=2, slots=4, max_tokens=24,
            prompt_buckets=(4, 8), kv_page_len=4, prefill_chunk=4,
            kv_pages=30)
PROMPTS = ([3, 1, 4], [2, 7, 1, 8, 2, 8], [5, 5], [9, 3, 9, 8, 1])
NEWS = (6, 11, 13, 8)


def _pair(spec_k, draft_layers=1):
    cfg = DecodeConfig(spec_k=spec_k, **SCFG)
    tparams, dcfg, dparams = demo_spec_pair(cfg, draft_layers=draft_layers,
                                            device="cpu")
    sv = PagedDecodeServable(params=tparams, config=cfg, device="cpu")
    draft = DraftDecodeServable(params=dparams, config=dcfg,
                                name="demo-lm-draft", device="cpu")
    return sv, draft, cfg


@pytest.fixture(scope="module")
def oracle():
    """The reference's greedy oracle over its own draft-friendly target
    (its jit cache is keyed by geometry, so spec_k changes nothing)."""
    jcfg = jdec.DecodeConfig(spec_k=4, **SCFG)
    jtarget, _dcfg, _dp = jdec.demo_spec_pair(jcfg)
    cache = {}

    def run(prompt, n, draft_layers=1):
        key = (tuple(prompt), n, draft_layers)
        if key not in cache:
            params = jtarget if draft_layers == 1 else \
                jdec.demo_spec_pair(jcfg, draft_layers=draft_layers)[0]
            cache[key] = jdec.reference_generate(list(prompt), n,
                                                 params=params, config=jcfg)
        return cache[key]
    return run


def test_the_draft_pair_is_the_references_bit_for_bit():
    cfg = DecodeConfig(spec_k=4, **SCFG)
    tparams, dcfg, dparams = demo_spec_pair(cfg, device="cpu")
    jt, jdcfg, jd = jdec.demo_spec_pair(jdec.DecodeConfig(spec_k=4, **SCFG))
    assert vars(dcfg) == vars(jdcfg)
    for got, want in ((tparams, jt), (dparams, jd)):
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))


@pytest.mark.parametrize("k", list(range(1, 9)))
def test_speculative_tokens_equal_the_oracle_at_every_k(k, oracle):
    sv, draft, cfg = _pair(k)
    assert cfg.spec_k == k
    eng = SpeculativeDecodeBatcher(sv, draft, autostart=False)
    try:
        r0 = sv.retraces + draft.retraces
        gens = [eng.submit(list(p), max_new=n)
                for p, n in zip(PROMPTS, NEWS)]
        eng.drain_sync()
        assert [g.tokens_so_far() for g in gens] == \
            [oracle(p, n) for p, n in zip(PROMPTS, NEWS)]
        assert sv.retraces + draft.retraces == r0
    finally:
        eng.close()


def test_speculative_equals_the_jax_engine_and_plain_paged(oracle):
    sv, draft, cfg = _pair(4)
    eng = SpeculativeDecodeBatcher(sv, draft, autostart=False)
    gens = [eng.submit(list(p), max_new=n) for p, n in zip(PROMPTS, NEWS)]
    eng.drain_sync()
    spec = [g.tokens_so_far() for g in gens]
    jcfg = jdec.DecodeConfig(spec_k=4, **SCFG)
    jt, jdcfg, jdp = jdec.demo_spec_pair(jcfg)
    jeng = jdec.SpeculativeDecodeBatcher(
        jdec.PagedDecodeServable(params=jt, config=jcfg),
        jdec.DraftDecodeServable(params=jdp, config=jdcfg), autostart=False)
    jgens = [jeng.submit(list(p), max_new=n) for p, n in zip(PROMPTS, NEWS)]
    jeng.drain_sync()
    assert spec == [g.tokens_so_far() for g in jgens]
    plain = PagedDecodeBatcher(
        PagedDecodeServable(params=sv.params, config=cfg, device="cpu"),
        autostart=False)
    pgens = [plain.submit(list(p), max_new=n) for p, n in zip(PROMPTS, NEWS)]
    plain.drain_sync()
    assert [g.tokens_so_far() for g in pgens] == spec
    st = eng.page_stats()
    assert st["engine"] == "speculative" and st["spec_k"] == 4
    assert st["draft_model"] == "demo-lm-draft" and st["draft_layers"] == 1


def test_forced_draft_disagreement(monkeypatch, oracle):
    """Corrupt every proposal column >= ``corrupt_from`` after the draft
    step (a draft as deep as the target, so the other columns agree):
    each window commits ``min(corrupt_from, k - 1) + 1`` tokens, and the
    output still equals the oracle."""
    k = 4
    orig = DraftDecodeServable.dispatch_step
    cell = {"corrupt_from": k}          # no corruption while warming

    def corrupted(self, slot_ids, col):
        props = orig(self, slot_ids, col)
        if col >= cell["corrupt_from"]:
            with torch.no_grad():
                props[:, col] = (props[:, col] + 1) % self.config.vocab
        return props

    monkeypatch.setattr(DraftDecodeServable, "dispatch_step", corrupted)
    sv, draft, cfg = _pair(k, draft_layers=SCFG["layers"])
    eng = SpeculativeDecodeBatcher(sv, draft, autostart=False)
    try:
        for corrupt_from in (0, 1, 2):
            cell["corrupt_from"] = corrupt_from
            n_em = min(corrupt_from, k - 1) + 1
            for prompt, max_new in zip(PROMPTS[:2], (9, 12)):
                w0 = registry.value("serve.decode.spec_windows")
                g = eng.submit(list(prompt), max_new=max_new)
                eng.drain_sync()
                ref = oracle(prompt, max_new, draft_layers=SCFG["layers"])
                assert g.tokens_so_far() == ref
                windows = registry.value("serve.decode.spec_windows") - w0
                assert windows == -(-(len(ref) - 1) // n_em)
    finally:
        eng.close()


def test_mismatched_pairs_are_refused():
    sv, draft, cfg = _pair(4)
    with pytest.raises(MXNetError, match="DraftDecodeServable"):
        SpeculativeDecodeBatcher(sv, sv, autostart=False)
    other = DraftDecodeServable(
        config=DecodeConfig(spec_k=2, **SCFG), device="cpu")
    with pytest.raises(MXNetError, match="mismatch"):
        SpeculativeDecodeBatcher(sv, other, autostart=False)
