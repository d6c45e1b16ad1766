"""The port's ``io.DevicePrefetcher`` against the reference's guarantees
(``mxnet_tpu/io/prefetch.py``; cases of ``tests/test_compile_cache.py``),
on the CPU: bit parity of a training trajectory with and without it, a
queue bounded at ``depth``, a source's error surfaced chained on the
consumer's next ``next()``, an idempotent and bounded ``close`` that a
wedged source cannot wedge, the depth knob, the measured wait (by an
injected clock), the leaf types and dtypes the reference's
``device_put`` gives, and the producer thread running in the context
the prefetcher was made in.  The card's side (pinned staging, the side
stream, the event and ``record_stream``) runs only on the card, where
``chip_smoke.py``'s ``data`` phase holds it.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd, autograd as jag, gluon as jgluon
from mxnet_tpu.io import DevicePrefetcher as JPrefetcher

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag, gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_mxnet_tpu
from mxnet_tpu_torch.io import DevicePrefetcher
from mxnet_tpu_torch.io.prefetch import prefetch_depth, prefetch_enabled

import torch
# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _batches(steps=6):
    rng = np.random.RandomState(7)
    return [(rng.randn(8, 8).astype(np.float32),
             rng.randn(8, 4).astype(np.float32)) for _ in range(steps)]


def _mlp(m):
    net = m.nn.Sequential()
    net.add(m.nn.Dense(16, in_units=8, activation="relu"))
    net.add(m.nn.Dense(4, in_units=16))
    return net


def _reference_start():
    jmx.random.seed(0)
    net = _mlp(jgluon)
    net.initialize(jmx.init.Xavier())
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _loss_trajectory(use_prefetch, start):
    """The reference's MLP parity loop, run by the port from the
    reference's initial parameters."""
    net = _mlp(tgluon)
    params_from_mxnet_tpu(start, net=net, device="cpu")
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = tgluon.loss.L2Loss()

    def one(xb, yb):
        with tag.record():
            loss = loss_fn(net(xb), yb)
        loss.backward()
        tr.step(batch_size=8)
        return float(loss.mean().asnumpy())

    batches = _batches()
    if use_prefetch:
        with DevicePrefetcher(iter(batches)) as pf:
            return [one(tnd.NDArray(xb), tnd.NDArray(yb)) for xb, yb in pf]
    return [one(tnd.array(xb), tnd.array(yb)) for xb, yb in batches]


def test_prefetch_bit_parity_loss_trajectory():
    start = _reference_start()
    with_pf = _loss_trajectory(True, start)
    assert with_pf == _loss_trajectory(False, start)
    # and the reference's own trajectory from the same start (fp32)
    net = _mlp(jgluon)
    net.initialize()
    for n, p in net.collect_params().items():
        p.set_data(jnd.array(start[n]))
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.05, "momentum": 0.9})
    ref = []
    with JPrefetcher(iter(_batches())) as pf:
        for xb, yb in pf:
            with jag.record():
                loss = jgluon.loss.L2Loss()(net(jnd.NDArray(xb)),
                                            jnd.NDArray(yb))
            loss.backward()
            tr.step(batch_size=8)
            ref.append(float(loss.mean().asnumpy()))
    np.testing.assert_allclose(with_pf, ref, rtol=1e-5)


def test_prefetch_bounded_queue_and_order():
    produced = []

    def src():
        for i in range(50):
            produced.append(i)
            yield (np.full((2,), i, np.float32),)

    pf = DevicePrefetcher(src(), depth=2)
    first = next(pf)
    time.sleep(0.3)
    assert len(produced) <= 5           # depth + in-flight margin
    assert float(first[0][0]) == 0.0
    assert [float(b[0][0]) for b in pf] == [float(i) for i in range(1, 50)]
    pf.close()


def test_prefetch_error_surfaces_on_consumer():
    def bad():
        yield (np.zeros((1,)),)
        raise RuntimeError("disk on fire")

    pf = DevicePrefetcher(bad())
    next(pf)
    with pytest.raises(MXNetError, match="disk on fire") as ei:
        next(pf)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "generator" in str(ei.value)          # names the source
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetch_close_idempotent_and_bounded():
    def src():
        while True:
            yield (np.zeros((1,)),)

    pf = DevicePrefetcher(src(), depth=1)
    next(pf)
    t0 = time.monotonic()
    pf.close()
    pf.close()
    assert time.monotonic() - t0 < 5
    with pytest.raises(MXNetError, match="closed"):
        next(pf)


def test_prefetch_close_is_not_wedged_by_a_wedged_source():
    gate = threading.Event()

    def src():
        yield (np.zeros((1,)),)
        gate.wait(30)                   # wedged inside next()
        yield (np.zeros((1,)),)

    pf = DevicePrefetcher(src(), depth=1)
    next(pf)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5
    gate.set()


def test_prefetch_data_wait_is_measured_by_the_clock():
    ticks = iter(range(100))
    with DevicePrefetcher([(np.zeros((1,)),)] * 3,
                          clock=lambda: float(next(ticks))) as pf:
        assert pf.data_wait() == (0.0, 0)
        for _ in pf:
            pass
        seconds, calls = pf.data_wait()
    assert calls == 4                   # three batches and the end
    assert seconds == 4.0               # one tick a call


def test_prefetch_leaves_match_the_references_types_and_dtypes():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"nd": None, "f64": x.astype(np.float64),
            "i64": np.arange(3, dtype=np.int64),
            "u8": x.astype(np.uint8), "list": [x, (x * 2,)]}
    with DevicePrefetcher([dict(tree, nd=tnd.array(x))]) as pf:
        got = next(pf)
    with JPrefetcher([dict(tree, nd=jnd.array(x))]) as jpf:
        want = next(jpf)
    assert isinstance(got["nd"], tnd.NDArray)
    np.testing.assert_array_equal(got["nd"].asnumpy(), x)
    for key in ("f64", "i64", "u8"):
        assert str(got[key].numpy().dtype) == str(want[key].dtype), key
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_array_equal(got["list"][1][0].numpy(), x * 2)
    assert isinstance(got["list"], list) and isinstance(got["list"][1],
                                                        tuple)


def test_prefetch_transform_and_producer_run_in_the_makers_context():
    """The producer thread enters the context current where the prefetcher
    was made: a source or transform that makes arrays without ``ctx``
    puts them there, not on the GPU default of a new thread."""
    def src():
        for i in range(3):
            yield tnd.full((2,), float(i))           # the current context

    seen = []

    def transform(batch):
        seen.append(tmx.current_context())
        return (batch, tnd.zeros((1,)))

    with DevicePrefetcher(src(), transform=transform) as pf:
        out = list(pf)
    assert seen == [tmx.cpu()] * 3
    assert all(b.context == tmx.cpu() for pair in out for b in pair)
    assert [float(b[0].asnumpy()[0]) for b in out] == [0.0, 1.0, 2.0]


def test_prefetch_depth_env(monkeypatch):
    monkeypatch.setenv("MX_PREFETCH_DEPTH", "5")
    assert prefetch_depth() == 5
    monkeypatch.setenv("MX_PREFETCH_DEPTH", "0")
    assert prefetch_depth() == 1
    monkeypatch.setenv("MX_PREFETCH_DEPTH", "many")
    assert prefetch_depth() == 2
    assert prefetch_enabled()
    monkeypatch.setenv("MX_PREFETCH", "0")
    assert not prefetch_enabled()
    with pytest.raises(MXNetError, match="depth"):
        DevicePrefetcher([], depth=0)


def test_prefetch_defaults_to_the_gpu_and_raises_without_one():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with tmx.gpu(0):
        with pytest.raises(MXNetError, match="cuda"):
            DevicePrefetcher([])
