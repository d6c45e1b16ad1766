"""The port's serving slice against the JAX reference, on the CPU.

A tiny BERT (as in test_torch_bert.py) is served by ``mxnet_tpu``'s
``Servable`` + ``ModelHost`` + ``Batcher`` in process and by
``mxnet_tpu_torch``'s ``Servable`` / ``ModelHost`` / ``Batcher`` /
``ServeServer`` / ``ServeClient`` on ``device="cpu"`` over a localhost
socket; the answers to the same requests must agree at rtol = atol = 1e-4
(the repo's fp32 bound).  Also: bucket padding, ``Overloaded`` at the queue
cap, the exactly-once PREDICT replay cache, and that the port and
``chip_smoke.py`` import neither JAX nor ``mxnet_tpu``.
"""
import os
import re
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.model_zoo import bert as jbert
from mxnet_tpu.kvstore.wire_codec import encode_array as j_encode_array
from mxnet_tpu.serve import (Batcher as JBatcher, BucketTable as JBuckets,
                             ModelHost as JHost, Servable as JServable)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
from mxnet_tpu_torch.kvstore.wire_codec import (WireCodecError,
                                                decode_array, encode_array,
                                                recv_msg, send_msg)
from mxnet_tpu_torch.serve import (Batcher, BucketTable, ModelHost,
                                   Overloaded, Servable, ServeClient,
                                   ServeServer, serve_forever)

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
CFG = dict(vocab_size=100, max_length=32, dropout=0.0, use_decoder=False)
T = 32
BUCKETS = (1, 2, 4)


def _requests(seed=0):
    """Requests of 1, 2 and 3 rows: (tokens, token_types) int32."""
    rng = np.random.RandomState(seed)
    out = []
    for rows in (1, 2, 3, 1):
        tok = rng.randint(0, CFG["vocab_size"], (rows, T)).astype(np.int32)
        typ = (np.arange(T)[None, :] >= rng.randint(1, T, (rows, 1))) \
            .astype(np.int32)
        out.append([tok, typ])
    return out


@pytest.fixture(scope="module")
def models():
    jnet = jbert.get_bert(2, 64, 1, **CFG)      # head dim 64: flash path
    jnet.initialize(mx.init.Normal(0.02))
    tok, typ = _requests()[0]
    jnet(nd.array(tok, dtype="int32"), nd.array(typ, dtype="int32"))
    rng = np.random.RandomState(2)
    for name, p in jnet.collect_params().items():
        shape = p.data().shape
        val = (1.0 + 0.1 * rng.randn(*shape)) if name.endswith("gamma") \
            else 0.05 * rng.randn(*shape)
        p.set_data(nd.array(val.astype(np.float32)))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    tnet = tbert.get_bert(2, 64, 1, **CFG)
    params_from_mxnet_tpu(named, net=tnet, device="cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def jax_answers(models):
    jnet, _ = models
    host = JHost()
    host.deploy(JServable(jnet, name="bert", buckets=JBuckets(BUCKETS)),
                example=_requests()[0])
    b = JBatcher(host, max_batch=4, max_delay_us=0, queue_cap=64)
    try:
        return [b.submit(r).result(timeout=120) for r in _requests()]
    finally:
        b.close()


def _port_host(tnet, buckets=BUCKETS):
    host = ModelHost()
    sv = Servable(tnet, name="bert", buckets=BucketTable(buckets),
                  device="cpu")
    host.deploy(sv, example=_requests()[0])
    return host, sv


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def replica(models):
    _, tnet = models
    host, sv = _port_host(tnet)
    state = ServeServer(host, max_batch=4, max_delay_us=0, queue_cap=64)
    port = _free_port()
    stop, ready = threading.Event(), threading.Event()
    t = threading.Thread(target=serve_forever, daemon=True,
                         kwargs=dict(port=port, state=state, stop_event=stop,
                                     bind="127.0.0.1", ready_event=ready))
    t.start()
    assert ready.wait(10)
    yield port, state, sv
    stop.set()
    t.join(10)
    assert not t.is_alive()


def test_predict_over_the_wire_matches_reference(replica, jax_answers):
    port, state, sv = replica
    with ServeClient(["127.0.0.1:%d" % port], timeout=60) as cli:
        for req, (jver, jouts) in zip(_requests(), jax_answers):
            version, outs = cli.predict(req)
            assert version == jver == 1
            assert len(outs) == len(jouts) == 3   # seq, pooled, nsp
            for o, j in zip(outs, jouts):
                assert o.shape == np.asarray(j).shape
                np.testing.assert_allclose(o, np.asarray(j), rtol=TOL,
                                           atol=TOL)
        h = cli.health()
    assert h["status"] == "serving" and h["buckets"] == list(BUCKETS)
    assert h["batches"] == sv.batches == len(_requests())
    assert sv.bucket_hits == sv.batches


def test_stop_verb_ends_serve_forever(models):
    _, tnet = models
    host, _ = _port_host(tnet, buckets=(1,))
    port = _free_port()
    ready = threading.Event()
    t = threading.Thread(target=serve_forever, daemon=True,
                         kwargs=dict(port=port, state=ServeServer(host),
                                     bind="127.0.0.1", ready_event=ready))
    t.start()
    assert ready.wait(10)
    cli = ServeClient(["127.0.0.1:%d" % port], timeout=30)
    assert cli.health()["status"] == "serving"
    cli.stop()
    cli.close()
    t.join(10)
    assert not t.is_alive()


def test_bucket_padding_leaves_real_rows_unchanged(models):
    """Three rows pad to bucket 4; each real row equals its unpadded
    single-row answer."""
    _, tnet = models
    host, sv = _port_host(tnet)
    b = Batcher(host, max_batch=4, max_delay_us=0, queue_cap=64)
    try:
        tok, typ = _requests()[2]
        assert tok.shape[0] == 3
        _, outs = b.submit([tok, typ]).result(timeout=60)
        assert b.padding_rows == 1
        for r in range(3):
            _, one = b.submit([tok[r:r + 1], typ[r:r + 1]]).result(timeout=60)
            for o, s in zip(outs, one):
                np.testing.assert_allclose(o[r:r + 1], s, rtol=TOL, atol=TOL)
    finally:
        b.close()
    assert sv.batches == 4


def test_batcher_coalesces_queued_requests_into_one_dispatch(models):
    _, tnet = models
    host, sv = _port_host(tnet)
    b = Batcher(host, max_batch=4, max_delay_us=0, queue_cap=64,
                autostart=False)
    reqs = _requests()
    pend = [b.submit(reqs[0]), b.submit(reqs[1]), b.submit(reqs[3])]
    b.start()
    try:
        outs = [p.result(timeout=60) for p in pend]
    finally:
        b.close()
    assert sv.batches == 1 and b.padding_rows == 0
    assert b.stats()["occupancy"] == {4: 1}
    assert [o[1][0].shape[0] for o in outs] == [1, 2, 1]


def test_overloaded_at_queue_cap_and_admission_refusals(models):
    _, tnet = models
    host, _ = _port_host(tnet)
    b = Batcher(host, max_batch=4, max_delay_us=0, queue_cap=4,
                autostart=False)
    tok, typ = _requests()[1]                      # 2 rows
    p1 = b.submit([tok, typ])
    p2 = b.submit([tok, typ])
    with pytest.raises(Overloaded):
        b.submit([tok[:1], typ[:1]])
    with pytest.raises(MXNetError, match="top bucket"):
        b.submit([np.zeros((5, T), np.int32)] * 2)
    with pytest.raises(MXNetError, match="signature"):
        b.submit([np.zeros((1, T + 1), np.int32)] * 2)
    with pytest.raises(MXNetError, match="disagree"):
        b.submit([np.zeros((1, T), np.int32), np.zeros((2, T), np.int32)])
    assert b.rejected == 4
    b.close()           # fails the queued requests loudly
    for p in (p1, p2):
        with pytest.raises(MXNetError, match="stopped"):
            p.result(timeout=5)


def test_overloaded_is_a_reply_over_the_wire(models):
    _, tnet = models
    host, _ = _port_host(tnet)
    state = ServeServer(host, batcher=Batcher(host, queue_cap=0,
                                              autostart=False))
    ok, msg = state.handle_request(
        ("PREDICT", [encode_array(a) for a in _requests()[0]]))
    assert not ok and msg.startswith("overloaded")
    state.close()


def test_replay_cache_answers_a_repeated_seq_once(replica):
    port, state, sv = replica
    payload = [encode_array(a) for a in _requests()[0]]
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        send_msg(s, ("SEQ", "cid-1", 7, ("PREDICT", payload)))
        first = recv_msg(s, timeout=30)
        batches = sv.batches
        send_msg(s, ("SEQ", "cid-1", 7, ("PREDICT", payload)))
        again = recv_msg(s, timeout=30)
        send_msg(s, ("SEQ", "cid-1", 6, ("PREDICT", payload)))
        stale = recv_msg(s, timeout=30)
    assert first[0] and again[0]
    assert sv.batches == batches, "the replayed PREDICT dispatched again"
    assert state.replays == 1
    for a, b in zip(first[1][1], again[1][1]):
        np.testing.assert_array_equal(decode_array(a), decode_array(b))
    assert not stale[0] and "stale" in stale[1]


def test_wire_codec_bytes_match_reference():
    for arr in (np.arange(12, dtype=np.float32).reshape(3, 4),
                np.zeros((2, 0, 5), np.int32), np.asarray(3.5)):
        enc = encode_array(arr)
        assert enc == j_encode_array(arr)
        out = decode_array(enc)
        assert out.dtype == arr.dtype and out.shape == arr.shape
        out += 1                               # writable
    with pytest.raises(WireCodecError):
        decode_array(("NPX", (2,), "float32", b"\0" * 4))
    with pytest.raises(WireCodecError):
        decode_array(("NOPE", (1,), "float32", b""))


def test_bf16_outputs_are_refused_at_the_wire():
    with pytest.raises(MXNetError, match="bfloat16"):
        Servable.to_host([torch.zeros(2, dtype=torch.bfloat16)])


def test_port_imports_neither_jax_nor_mxnet_tpu():
    code = ("import sys; import mxnet_tpu_torch, mxnet_tpu_torch.convert; "
            "import mxnet_tpu_torch.optimizer, mxnet_tpu_torch.metric, "
            "mxnet_tpu_torch.lr_scheduler, mxnet_tpu_torch.ops.optimizer, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.gluon.utils, "
            "mxnet_tpu_torch.gluon.parameter, mxnet_tpu_torch.amp, "
            "mxnet_tpu_torch.amp.lists, mxnet_tpu_torch.image.detection, "
            "mxnet_tpu_torch.ops.image, mxnet_tpu_torch.ops.spatial, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.ops.rnn, mxnet_tpu_torch.gluon.rnn, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.gluon.model_zoo.model_store, "
            "mxnet_tpu_torch.context, mxnet_tpu_torch.kvstore.kvstore, "
            "mxnet_tpu_torch.kvstore.bucketing, "
            "mxnet_tpu_torch.kvstore.gradient_compression, "
            "mxnet_tpu_torch.ops.quantization, mxnet_tpu_torch.parallel.mesh, "
            "mxnet_tpu_torch.tools.launch, mxnet_tpu_torch.fault, "
            "mxnet_tpu_torch.profiler, mxnet_tpu_torch.telemetry, "
            "mxnet_tpu_torch.engine, mxnet_tpu_torch.kvstore.server, "
            "mxnet_tpu_torch.kvstore.wire_verbs, "
            "mxnet_tpu_torch.checkpoint, mxnet_tpu_torch.health, "
            "mxnet_tpu_torch.parallel.ring, "
            "mxnet_tpu_torch.parallel.pipeline, "
            "mxnet_tpu_torch.parallel.moe, "
            "mxnet_tpu_torch.parallel.collectives, "
            "mxnet_tpu_torch.parallel.speclayout, "
            "mxnet_tpu_torch.parallel.tensor, mxnet_tpu_torch.step, "
            "mxnet_tpu_torch.device, mxnet_tpu_torch.ndarray.ndarray, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.gluon.block, "
            "mxnet_tpu_torch.gluon.nn.basic_layers, "
            "mxnet_tpu_torch.optimizer.optimizer, "
            "mxnet_tpu_torch.ndarray.serialize, "
            "mxnet_tpu_torch.serve.servable, mxnet_tpu_torch.initializer, "
            "mxnet_tpu_torch.gluon.nn.conv_layers, "
            "mxnet_tpu_torch.kvstore.wire_codec, mxnet_tpu_torch.io.prefetch; "
            "import torch.distributed.checkpoint; "
            "import chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.') or m == 'orbax' or "
            "m.startswith('orbax.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_never_import_jax_or_mxnet_tpu():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|from\s+mxnet_tpu\b"
                     r"(?!_torch)|import\s+mxnet_tpu\b(?!_torch))", re.M)
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 10
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_port_never_calls_library_attention_or_compile():
    pat = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                     r"cudnn_attention|flash_attn")
    hits = [str(f) for f in sorted((REPO / "mxnet_tpu_torch").rglob("*"))
            if f.is_file() and f.suffix in (".py", ".cu")
            and pat.search(f.read_text())]
    assert not hits, hits
