"""The port's kvstore against the JAX reference, in one process on the CPU.

* ``plan_buckets`` gives the reference's bucket names, positions and
  offsets on BERT-base's and ResNet-50's parameter descriptors at 4 MB,
  64 KB and 0 (buckets off), packed forwards and in reverse; a store
  names a bucket of bf16 tensors as the reference does (numpy's dtype
  names, never torch's); ``ReadinessPlanner`` closes the same units.
* The single-process stores (``local``, ``device``, ``ici`` outside a
  process group) give the reference's results for ``push``, ``pull``,
  ``pushpull`` and ``broadcast`` over lists of 1-3 values, with
  ``update_on_kvstore`` (SGD), and with 2-bit, int8 and bf16 compression
  over three pushes (values and residuals).
* ``create`` takes the reference's aliases, refuses an unknown name, and
  gives ``dist_async`` without a server the reference's warning and
  store.
* Bucket names under a salt (an elastic job's membership epoch: 0,
  None, 1, 7) on BERT-base's descriptors are the reference's, and a
  store's plan cache is keyed by its salt.
The cross-process cases are in ``tests/test_torch_dist.py``; the
parameter server's in ``tests/test_torch_ps_server.py`` and
``tests/test_torch_ps_dist.py``.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.kvstore import bucketing as jb
from mxnet_tpu.kvstore import kvstore as jkv

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
from mxnet_tpu_torch.kvstore import bucketing as tb
from mxnet_tpu_torch.kvstore import kvstore as tkv

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

STORES = ("local", "device", "ici")
CAPS = (4 << 20, 64 << 10, 0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _descriptors(net, dtype):
    """(keys, shapes, dtypes, itemsizes, stypes) of a model's trainable
    parameters, keyed by the Trainer's indices (sorted names)."""
    ps = net.collect_params()
    names = [n for n in sorted(ps.keys()) if ps[n].grad_req != "null"]
    shapes = [tuple(ps[n].shape) for n in names]
    size = {"float32": 4, "bfloat16": 2}[dtype]
    return (list(range(len(names))), shapes, [dtype] * len(names),
            [size] * len(names), ["default"] * len(names))


@pytest.fixture(scope="module")
def model_descriptors():
    return {
        "bert-base": bert_12_768_12(vocab_size=30522, max_length=512,
                                    dropout=0.0, use_classifier=False),
        "resnet50": vision.resnet50_v1(classes=1000),
    }


def _plan_fields(plan):
    buckets, solo = plan
    return ([(b.name, b.positions, b.keys, b.offsets, b.sizes, b.shapes,
              b.dtype, b.total) for b in buckets], list(solo))


@pytest.mark.parametrize("model", ("bert-base", "resnet50"))
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("reverse", (False, True))
def test_plan_buckets_gives_the_reference_layout(model_descriptors, model,
                                                 cap, dtype, reverse):
    desc = _descriptors(model_descriptors[model], dtype)
    want = _plan_fields(jb.plan_buckets(*desc, cap, reverse=reverse))
    got = _plan_fields(tb.plan_buckets(*desc, cap, reverse=reverse))
    assert got == want
    if cap == 0:
        assert not got[0] and len(got[1]) == len(desc[0])
    else:
        assert got[0], "no bucket planned"


@pytest.mark.parametrize("salt", (0, None, 1, 7))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_salted_bucket_names_are_the_reference_s(model_descriptors, salt,
                                                 dtype):
    """An elastic job's membership epoch salts every bucket's name; 0 and
    None keep the plain names."""
    desc = _descriptors(model_descriptors["bert-base"], dtype)
    want = _plan_fields(jb.plan_buckets(*desc, 4 << 20, salt=salt))
    got = _plan_fields(tb.plan_buckets(*desc, 4 << 20, salt=salt))
    assert got == want
    plain = _plan_fields(tb.plan_buckets(*desc, 4 << 20))
    names = [b[0] for b in got[0]]
    assert (names == [b[0] for b in plain[0]]) == (not salt)


@pytest.mark.parametrize("salt", (0, None, 1, 7))
def test_a_store_plans_under_its_bucket_salt_as_the_reference(salt):
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 2), (7,)]
    vals = [rng.randn(*s).astype(np.float32) for s in shapes]
    keys = [3, "w", 9, "b"]
    jkvs, tkvs = jkv.KVStoreLocal(), tkv.KVStoreLocal()
    jkvs._bucket_salt = tkvs._bucket_salt = salt
    got = _plan_fields(tkvs._bucket_plans(keys, [tnd.array(v)
                                                 for v in vals]))
    assert got == _plan_fields(jkvs._bucket_plans(
        keys, [jnd.array(v) for v in vals]))
    # the cache is keyed by the salt: a new epoch plans anew
    tkvs._bucket_salt = (salt or 0) + 1
    again = _plan_fields(tkvs._bucket_plans(keys, [tnd.array(v)
                                                   for v in vals]))
    assert again[0][0][0] != got[0][0][0]


def test_bucket_bytes_reads_the_knob(monkeypatch):
    assert tb.bucket_bytes() == jb.bucket_bytes() == 4 << 20
    monkeypatch.setenv("MX_KVSTORE_BUCKET_KB", "64")
    assert tb.bucket_bytes() == jb.bucket_bytes() == 64 << 10
    monkeypatch.setenv("MX_KVSTORE_BUCKET_KB", "0")
    assert tb.bucket_bytes() == jb.bucket_bytes() == 0


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_a_store_names_buckets_as_the_reference(dtype):
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 2), (7,)]
    vals = [rng.randn(*s).astype(np.float32) for s in shapes]
    keys = [3, "w", 9, "b"]
    jarrs = [jnd.array(v, dtype=dtype) for v in vals]
    tarrs = [tnd.array(v, dtype=dtype) for v in vals]
    for reverse in (False, True):
        want = _plan_fields(jkv.KVStoreLocal()._bucket_plans(
            keys, jarrs, reverse=reverse))
        got = _plan_fields(tkv.KVStoreLocal()._bucket_plans(
            keys, tarrs, reverse=reverse))
        assert got == want
        assert got[0][0][6] == dtype


def test_readiness_planner_closes_the_same_units():
    desc = ([0, 1, 2, 3, 4], [(4,), (300,), (5,), (6,), (7,)],
            ["float32"] * 5, [4] * 5, ["default"] * 5)
    events = [(4, 0), (4, 1), (3, 0), (1, 0), (3, 1), (2, 0), (2, 1),
              (1, 1), (0, 0), (0, 1), (0, 0)]
    out = []
    for mod in (jb, tb):
        buckets, solo = mod.plan_buckets(*desc, 64, reverse=True)
        planner = mod.ReadinessPlanner(buckets, solo, copies=2)
        closed = [planner.note(p, c) for p, c in events]
        out.append((len(planner), closed, planner.pending(), planner.stale,
                    [planner.unit(u)[0] for u in planner.all_units()]))
    assert out[0] == out[1]
    assert out[1][3] is True                      # the repeated note


def _values(rng, n, shape, dtype):
    if dtype == "int32":
        return [rng.randint(-50, 50, size=shape).astype(np.int32)
                for _ in range(n)]
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _both(name):
    return jkv.create(name), tkv.create(name)


@pytest.mark.parametrize("name", STORES)
@pytest.mark.parametrize("nvals", (1, 2, 3))
@pytest.mark.parametrize("dtype", ("float32", "int32"))
def test_push_pull_pushpull_broadcast_match(name, nvals, dtype):
    rng = np.random.RandomState(nvals)
    jk, tk = _both(name)
    assert tk.type == jk.type and tk.rank == 0 and tk.num_workers == 1
    keys, shapes = [5, "emb", 7], [(4, 3), (6,), (2, 5)]
    inits = [_values(rng, 1, s, dtype)[0] for s in shapes]
    jk.init(keys, [jnd.array(v) for v in inits])
    tk.init(keys, [tnd.array(v) for v in inits])
    for _ in range(2):
        vals = [_values(rng, nvals, s, dtype) for s in shapes]
        jk.push(keys, [[jnd.array(v) for v in vl] for vl in vals])
        tk.push(keys, [[tnd.array(v) for v in vl] for vl in vals])
        jo = [[jnd.zeros(s, dtype=dtype) for _ in range(2)] for s in shapes]
        to = [[tnd.zeros(s, dtype=dtype) for _ in range(2)] for s in shapes]
        jk.pull(keys, out=jo)
        tk.pull(keys, out=to)
        for a, b in zip(jo, to):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
    # single key, fused pushpull and broadcast
    v = _values(rng, nvals, (3,), dtype)
    jk.init("p", jnd.array(v[0]))
    tk.init("p", tnd.array(v[0]))
    jo, to = jnd.zeros((3,), dtype=dtype), tnd.zeros((3,), dtype=dtype)
    jk.pushpull("p", [jnd.array(x) for x in v], out=jo)
    tk.pushpull("p", [tnd.array(x) for x in v], out=to)
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())
    jo, to = jnd.zeros((3,), dtype=dtype), tnd.zeros((3,), dtype=dtype)
    jk.broadcast("q", jnd.array(v[-1]), out=[jo])
    tk.broadcast("q", tnd.array(v[-1]), out=[to])
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())


def test_the_store_does_not_alias_a_pushed_tensor():
    kv = tkv.create("local")
    kv.init(0, tnd.zeros((3,)))
    g = tnd.array(np.ones(3, np.float32))
    kv.push(0, g)
    g[:] = 7.0
    out = tnd.zeros((3,))
    kv.pull(0, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.ones(3))


@pytest.mark.parametrize("name", STORES)
def test_update_on_kvstore_with_sgd_matches(name):
    rng = np.random.RandomState(4)
    jk, tk = _both(name)
    jk.set_optimizer(jopt.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3))
    tk.set_optimizer(topt.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3))
    shapes = [(4, 3), (5,)]
    w = [rng.randn(*s).astype(np.float32) for s in shapes]
    jk.init([0, 1], [jnd.array(x) for x in w])
    tk.init([0, 1], [tnd.array(x) for x in w])
    for _ in range(3):
        g = [[rng.randn(*s).astype(np.float32) for _ in range(2)]
             for s in shapes]
        jk.push([0, 1], [[jnd.array(x) for x in gl] for gl in g])
        tk.push([0, 1], [[tnd.array(x) for x in gl] for gl in g])
        jo = [jnd.zeros(s) for s in shapes]
        to = [tnd.zeros(s) for s in shapes]
        jk.pull([0, 1], out=jo)
        tk.pull([0, 1], out=to)
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=1e-6,
                                       atol=1e-7)


def test_optimizer_states_save_and_load(tmp_path):
    kv = tkv.create("ici")
    kv.set_optimizer(topt.SGD(learning_rate=0.1, momentum=0.9))
    kv.init(0, tnd.ones((3,)))
    kv.push(0, tnd.ones((3,)))
    kv.save_optimizer_states(str(tmp_path / "s"), dump_optimizer=True)
    other = tkv.create("ici")
    other.set_optimizer(topt.SGD(learning_rate=0.1, momentum=0.9))
    other.load_optimizer_states(str(tmp_path / "s"))
    np.testing.assert_array_equal(other._updater.states[0].asnumpy(),
                                  kv._updater.states[0].asnumpy())


@pytest.mark.parametrize("name", STORES)
@pytest.mark.parametrize("mode", ("2bit", "int8"))
def test_compressed_pushes_carry_the_reference_residuals(name, mode):
    rng = np.random.RandomState(11)
    jk, tk = _both(name)
    params = {"type": mode, "threshold": 0.4, "block": 64}
    jk.set_gradient_compression(params)
    tk.set_gradient_compression(params)
    keys, shapes = [0, 1, 2], [(30, 5), (7,), (64,)]
    jk.init(keys, [jnd.zeros(s) for s in shapes])
    tk.init(keys, [tnd.zeros(s) for s in shapes])
    for _ in range(3):
        g = [[(rng.randn(*s) * 0.3).astype(np.float32) for _ in range(2)]
             for s in shapes]
        jo = [jnd.zeros(s) for s in shapes]
        to = [tnd.zeros(s) for s in shapes]
        jk.pushpull(keys, [[jnd.array(x) for x in gl] for gl in g], out=jo)
        tk.pushpull(keys, [[tnd.array(x) for x in gl] for gl in g], out=to)
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=1e-6,
                                       atol=0)
        assert sorted(map(str, tk._gc._residuals)) == \
            sorted(map(str, jk._gc._residuals))
        for k, r in jk._gc._residuals.items():
            np.testing.assert_array_equal(tk._gc._residuals[k].numpy(),
                                          np.asarray(r))


@pytest.mark.parametrize("name", STORES)
def test_bf16_compression_matches(name):
    rng = np.random.RandomState(12)
    jk, tk = _both(name)
    jk.set_gradient_compression({"type": "bf16"})
    tk.set_gradient_compression({"type": "bf16"})
    jk.init("c", jnd.zeros((40,)))
    tk.init("c", tnd.zeros((40,)))
    v = [rng.randn(40).astype(np.float32) for _ in range(3)]
    jo, to = jnd.zeros((40,)), tnd.zeros((40,))
    jk.pushpull("c", [jnd.array(x) for x in v], out=jo)
    tk.pushpull("c", [tnd.array(x) for x in v], out=to)
    assert to.dtype == np.float32
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())


def test_unknown_compression_raises_value_error():
    for kv in _both("ici"):
        with pytest.raises(ValueError, match="1bit"):
            kv.set_gradient_compression({"type": "1bit"})
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.set_gradient_compression({"type": "int8"})


@pytest.mark.parametrize("mode", (None, "2bit", "int8"))
def test_an_overlap_session_matches_the_reference_s(mode):
    """Units notified in backward's order (last key first), one input
    written after its unit launched (a relaunch), then the drain: the
    reference's session results and residuals; without int8 (whose
    buckets are packed in reverse order there) also the serialized
    exchange's."""
    rng = np.random.RandomState(5)
    shapes = [(6, 4), (9,), (3, 3), (5,)]
    keys = list(range(len(shapes)))
    grads = [rng.randn(*s).astype(np.float32) for s in shapes]
    jk, tk, serial_kv = jkv.create("ici"), tkv.create("ici"), \
        tkv.create("ici")
    for kv in (jk, tk, serial_kv):
        if mode:
            kv.set_gradient_compression({"type": mode, "threshold": 0.5})
    jk.init(keys, [jnd.zeros(s) for s in shapes])
    for kv in (tk, serial_kv):
        kv.init(keys, [tnd.zeros(s) for s in shapes])
    jvals = [[jnd.array(g)] for g in grads]
    tvals = [[tnd.array(g)] for g in grads]
    sessions = (jk.begin_exchange(keys, jvals),
                tk.begin_exchange(keys, [lambda v=v: v for v in tvals]))
    for sess in sessions:
        for k in reversed(keys):
            sess.notify_key(k)
    jvals[3][0][:] = jvals[3][0] * 1.0
    tvals[3][0][:] = tvals[3][0] * 1.0
    for sess in sessions:
        sess.drain()
    for a, b in zip(jvals, tvals):
        np.testing.assert_allclose(b[0].asnumpy(), a[0].asnumpy(),
                                   rtol=1e-6, atol=0)
    if mode:
        assert sorted(map(str, tk._gc._residuals)) == \
            sorted(map(str, jk._gc._residuals))
        for k, r in jk._gc._residuals.items():
            np.testing.assert_array_equal(tk._gc._residuals[k].numpy(),
                                          np.asarray(r))
        assert tk._gc._pinned == {}
    if mode != "int8":
        serial = [[tnd.array(g)] for g in grads]
        serial_kv.push(keys, serial)
        serial_kv.pull(keys, out=serial)
        for a, b in zip(serial, tvals):
            np.testing.assert_array_equal(b[0].asnumpy(), a[0].asnumpy())


@pytest.mark.parametrize("name,kind", [
    ("local", "local"), ("device", "device"), ("ici", "ici"),
    ("nccl", "ici"), ("dist", "ici"), ("dist_sync", "ici"),
    ("dist_device_sync", "ici"), ("horovod", "ici"), ("NCCL", "ici")])
def test_create_takes_the_reference_aliases(name, kind):
    assert tkv.create(name).type == jkv.create(name).type == kind


def test_create_refuses_an_unknown_name():
    with pytest.raises(JMXNetError, match="unknown KVStore type"):
        jkv.create("bogus")
    with pytest.raises(MXNetError, match="unknown KVStore type"):
        tkv.create("bogus")
    with pytest.raises(TypeError):
        tkv.create(3)


def test_dist_async_without_a_server_warns_and_gives_ici(monkeypatch):
    for var in ("MX_PS_ROOT", "MX_PS_ROOTS", "DMLC_PS_ROOT_URI"):
        monkeypatch.delenv(var, raising=False)
    kinds = []
    for create in (jkv.create, tkv.create):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            kinds.append(create("dist_async").type)
        assert any("parameter server" in str(x.message) for x in w)
    assert kinds == ["ici", "ici"]


@pytest.mark.parametrize("var", ("MX_PS_ROOT", "MX_PS_ROOTS"))
def test_dist_async_with_a_server_is_not_ported(monkeypatch, var):
    """The parameter-server store is ported now: with ``MX_PS_ROOT`` set,
    both packages build it and try to connect (here to a port where no
    server listens, so both give the connect error once the retry
    deadline passes); ``MX_PS_ROOTS`` alone does not select it in the
    reference's ``create``, which warns and gives the collective store,
    and neither does it in the port's."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    for other in ("MX_PS_ROOT", "MX_PS_ROOTS", "DMLC_PS_ROOT_URI"):
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(var, addr)
    monkeypatch.setenv("MX_KVSTORE_RETRY_DEADLINE", "0.3")
    monkeypatch.setenv("MX_KVSTORE_HEARTBEAT", "0")
    if var == "MX_PS_ROOT":
        for create in (jkv.create, tkv.create):
            with pytest.raises(OSError):
                create("dist_async")
        assert tkv._STORES["dist_async"] is tkv.KVStoreDistAsync
        return
    kinds = []
    for create in (jkv.create, tkv.create):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            kinds.append(create("dist_async").type)
        assert any("parameter server" in str(x.message) for x in w)
    assert kinds == ["ici", "ici"]


def test_row_sparse_pull_is_not_ported():
    kv = tkv.create("local")
    kv.init(0, tnd.zeros((4, 2)))
    with pytest.raises(MXNetError, match="sparse"):
        kv.row_sparse_pull(0, out=tnd.zeros((4, 2)), row_ids=[1])


def test_exports_are_the_reference_s():
    import mxnet_tpu.kvstore as jpkg
    import mxnet_tpu_torch.kvstore as tpkg
    assert sorted(tpkg.__all__) == sorted(jpkg.__all__)
    assert tmx.kvstore is tpkg and jmx.kvstore is jpkg
