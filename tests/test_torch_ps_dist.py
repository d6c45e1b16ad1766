"""The dist_async parameter server across processes, on the CPU.

The port's counterparts of ``tests/test_dist_kvstore.py``'s parameter-
server cases (less ``row_sparse_pull``, which waits for sparse storage)
and of ``tests/test_examples.py``'s dist_async example: every test starts
``python -m mxnet_tpu_torch.tools.launch ... -s S --launcher local`` on a
worker script under a time limit, so a hang fails the test.  The launcher
starts the servers (``python -m mxnet_tpu_torch.kvstore.server``), the
workers run on the CPU, and every process logs its imports
(``PYTHONPROFILEIMPORTTIME``): neither a server nor a worker ever imports
``jax`` or ``mxnet_tpu``.
"""
import os
import re
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120

_PRELUDE = """
import os, sys, time
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, fault, gluon, kvstore, nd, optimizer
mx.cpu().__enter__()


def clean_exit(tag):
    bad = [m for m in sys.modules
           if m == "jax" or m.startswith("jax.") or m == "mxnet_tpu"
           or m.startswith("mxnet_tpu.")]
    assert not bad, bad
    print(tag, "rank", kv.rank, flush=True)
"""

_FOREIGN = re.compile(r"\|\s+(jax|mxnet_tpu)(\.\S+)?\s*$", re.M)


def _launch(tmp_path, body, n=2, s=1, args=(), env=None, expect_rc=0,
            command=None):
    """Run ``body`` (after the prelude), or ``command``, as ``n`` workers
    beside ``s`` servers through the port's launcher."""
    if command is None:
        script = tmp_path / "worker.py"
        script.write_text(textwrap.dedent(_PRELUDE) + textwrap.dedent(body))
        command = [sys.executable, str(script)]
    full_env = dict(os.environ, PYTHONPATH=REPO, MX_KVSTORE_HEARTBEAT="0",
                    PYTHONPROFILEIMPORTTIME="1", **(env or {}))
    for var in ("MX_PS_ROOT", "MX_PS_ROOTS", "DMLC_PS_ROOT_URI",
                "MX_FAULT_INJECT", "MXNET_KVSTORE_BIGARRAY_BOUND"):
        if var not in (env or {}):
            full_env.pop(var, None)
    r = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
                        "-n", str(n), "-s", str(s), "--launcher", "local",
                        *args, "--", *command],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=TIMEOUT, env=full_env)
    assert r.returncode == expect_rc, (r.stdout[-3000:], r.stderr[-3000:])
    foreign = _FOREIGN.findall(r.stderr)
    assert not foreign, foreign
    assert "mxnet_tpu_torch.kvstore.server" in r.stderr   # servers logged
    return r


def test_each_worker_progresses_alone_and_the_barrier_sees_both_pushes(
        tmp_path):
    snap = tmp_path / "snap"
    spec = "server.handle:delay:delay=0.1,count=-1"
    r = _launch(tmp_path, """
        kv = kvstore.create("dist_async")
        assert kv.type == "dist_async" and kv.num_workers == 2
        rank = kv.rank
        # --fault reached this worker (its site never fires here) and the
        # server, which it delays on every request
        assert os.environ["MX_FAULT_INJECT"] == SPEC
        assert "server.handle" in fault._default._rules
        t0 = time.monotonic()
        kv.init("w", nd.ones((4,)))
        assert time.monotonic() - t0 > 0.09
        kv.set_optimizer(optimizer.SGD(learning_rate=0.5))
        # asynchronous: this worker pushes and pulls without the other
        kv.push("w", nd.array(np.full(4, 1.0, np.float32)))
        out = nd.zeros((4,))
        kv.pull("w", out=out)
        v = out.asnumpy()
        k = round(float((1.0 - v[0]) / 0.5))
        assert k >= 1 and np.allclose(v, 1.0 - 0.5 * k), v
        # after both workers pass the barrier, exactly 2 pushes are in
        kv._barrier()
        kv.pull("w", out=out)
        np.testing.assert_allclose(out.asnumpy(), 0.0)
        kv._barrier()
        kv.close()
        clean_exit("ALONE_OK")
    """.replace("SPEC", repr(spec)),
        args=("--ps-snapshot-dir", str(snap), "--fault", spec))
    assert r.stdout.count("ALONE_OK") == 2
    # the snapshot the server wrote when the launcher stopped it
    import pickle
    with open(snap / "server_0.pkl", "rb") as f:
        blob = pickle.load(f)
    np.testing.assert_allclose(blob["store"]["w"], 0.0)
    assert blob["opt_blob"] is not None


def test_keys_shard_by_hash_and_big_arrays_split_across_two_servers(
        tmp_path):
    r = _launch(tmp_path, """
        kv = kvstore.create("dist_async")
        assert len(kv._socks) == 2 and kv._bigarray_bound == 10
        rank = kv.rank
        kv.set_optimizer(optimizer.SGD(learning_rate=0.5))
        keys = list(range(8))
        servers = {k: kv._server_of(k) for k in keys}
        assert set(servers.values()) == {0, 1}, servers
        for k in keys:
            kv.init(k, nd.ones((3,)) * (k + 1))
        big = np.arange(24, dtype=np.float32).reshape(4, 6)
        kv.init("big", nd.array(big))
        kv._barrier()
        p0 = np.asarray(kv._rpc_on(0, "PULL", "big::part0")).ravel()
        p1 = np.asarray(kv._rpc_on(1, "PULL", "big::part1")).ravel()
        np.testing.assert_allclose(p0, np.arange(12, dtype=np.float32))
        np.testing.assert_allclose(p1, np.arange(12, 24, dtype=np.float32))
        for k in keys:
            kv.push(k, nd.array(np.full(3, 2.0, np.float32)))
        kv.push("big", nd.ones((4, 6)))
        kv._barrier()
        for k in keys:
            out = nd.zeros((3,))
            kv.pull(k, out=out)
            np.testing.assert_allclose(out.asnumpy(), (k + 1) - 2.0,
                                       rtol=1e-6)
        out = nd.zeros((4, 6))
        kv.pull("big", out=out)
        np.testing.assert_allclose(out.asnumpy(), big - 1.0, rtol=1e-6)
        kv._barrier()
        kv.close()
        clean_exit("SHARDED_OK")
    """, s=2, env={"MXNET_KVSTORE_BIGARRAY_BOUND": "10"})
    assert r.stdout.count("SHARDED_OK") == 2


def test_the_port_s_dist_async_example_converges(tmp_path):
    r = _launch(tmp_path, None, command=[
        sys.executable, os.path.join(REPO, "chip_smoke.py"),
        "--train-dist-async", "--steps", "25", "--device", "cpu"])
    finals = [float(line.split("loss")[1].split("(")[0])
              for line in r.stdout.splitlines() if "FINAL" in line]
    assert len(finals) == 2, (r.stdout, r.stderr[-3000:])
    assert all(v < 1.0 for v in finals), finals


def test_a_trainer_on_the_parameter_server_takes_the_batched_exchange(
        tmp_path):
    """With MX_EXCHANGE_OVERLAP=1 the store cannot overlap (its
    begin_exchange is None): the Trainer turns overlap off and pushes and
    pulls the whole key set, as the reference does."""
    r = _launch(tmp_path, """
        from mxnet_tpu_torch.parallel import init_process_group
        init_process_group(device="cpu")
        kv = kvstore.create("dist_async")
        calls = []
        for name in ("push", "pull", "begin_exchange"):
            def spy(*a, _f=getattr(kv, name), _n=name, **k):
                calls.append((_n, len(a[0]) if isinstance(a[0], list)
                              else 1))
                return _f(*a, **k)
            setattr(kv, name, spy)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(4, in_units=3, activation="tanh"),
                gluon.nn.Dense(2, in_units=4))
        net.initialize(mx.init.Xavier(), device="cpu", seed=0)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}, kvstore=kv)
        rng = np.random.RandomState(0)
        x = nd.array(rng.randn(5, 3).astype(np.float32))
        y = nd.array(rng.randn(5, 2).astype(np.float32))
        w0 = {n: p.detach().clone() for n, p in net.named_parameters()}
        with autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        grads = {n: p.grad.detach().clone()
                 for n, p in net.named_parameters()}
        trainer.step(1)
        assert not trainer._overlap and trainer._exchange_session is None
        assert ("push", 4) in calls and ("pull", 4) in calls, calls
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       (w0[n] - 0.1 * grads[n]).numpy(),
                                       rtol=1e-6, atol=1e-7)
        kv.close()
        clean_exit("TRAINER_OK")
    """, n=1, env={"MX_EXCHANGE_OVERLAP": "1"})
    assert "TRAINER_OK" in r.stdout


def test_a_failing_server_fails_the_job(tmp_path):
    r = _launch(tmp_path, """
        kv = kvstore.create("dist_async")
        kv.init("w", nd.ones((4,)))
        time.sleep(60)
    """, n=1, args=("--fault", "server.handle:crash"),
        env={"MX_KVSTORE_RETRY_DEADLINE": "30"}, expect_rc=17)
    assert "server 0 exited with 17" in r.stderr
