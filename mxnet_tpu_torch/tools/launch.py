"""Start a training job: N worker processes, and parameter servers, on
this host.

Counterpart of ``tools/launch.py`` (reference: tools/launch.py and
ps-lite's dmlc tracker)::

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local -- \\
        python train.py
    python -m mxnet_tpu_torch.tools.launch -n 2 -s 2 --launcher local -- \\
        python train_dist_async.py

Every worker gets the reference's environment contract, which
``mxnet_tpu_torch.parallel.init_process_group`` reads:

  MX_COORDINATOR    host:port of rank 0 (a free port of this host)
  MX_NUM_PROCESSES  the world size
  MX_PROCESS_ID     this worker's rank

and the reference-era ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID`` and
``DMLC_ROLE=worker``.  ``-s N`` starts N parameter servers
(``python -m mxnet_tpu_torch.kvstore.server``, each with
``DMLC_ROLE=server``, ``DMLC_NUM_WORKER``, ``MX_PS_PORT`` and
``MX_FORCE_CPU=1``: a server's role is the host) and gives every worker
their addresses (``MX_PS_ROOT``, ``MX_PS_ROOTS``, ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_SERVER``), which
``kvstore.create("dist_async")`` reads.  ``--ps-snapshot-dir DIR`` gives
server ``s`` the snapshot ``DIR/server_<s>.pkl`` (``MX_PS_SNAPSHOT``),
and ``--fault SPEC`` arms ``MX_FAULT_INJECT`` in every process.

``--launcher local`` spawns the processes and waits.  When one exits
nonzero (a worker or a server), the launcher stops the others and exits
with that code.  When every worker has exited 0, it sends each server the
wire STOP (the server drains its requests in flight and writes its
snapshot), waits for it, and folds a server's nonzero exit into the job's
code.  ``--launcher manual`` prints each rank's environment and command.

Not ported yet, and refused with a message that says so: ``--launcher
ssh`` with ``-H`` and the reference's supervision (``--restart``,
``--max-restarts``, ``--hang-timeout``, ``--status-interval``,
``--elastic``, ``--resize-file``, ``--drain-timeout``) come with part (b)
of the parameter-server slice; the serving fleet's ``--serve-port-base``,
``--route``, ``--autoscale`` and ``--compile-cache`` with ROADMAP Queue 1
item 6.
"""
from __future__ import annotations

import argparse
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import time

#: the reference launcher's flags that wait for part (b) of the
#: parameter-server slice (its ssh mode and supervision) and for the
#: serving fleet (ROADMAP Queue 1 item 6): refused by name
PART_B = ("-H", "--hostfile", "--restart", "--max-restarts",
          "--hang-timeout", "--status-interval", "--elastic",
          "--resize-file", "--drain-timeout")
ITEM_6 = ("--serve-port-base", "--route", "--autoscale", "--compile-cache")

STOP_TIMEOUT = 10.0     # seconds a server may take to exit after STOP
#: the directory that holds the package, for the servers' PYTHONPATH
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(rank: int, coordinator: str, n: int) -> dict:
    """The launcher contract: the ``MX_*`` names and the reference-era
    ``DMLC_*`` ones."""
    return {
        "MX_COORDINATOR": coordinator,
        "MX_NUM_PROCESSES": str(n),
        "MX_PROCESS_ID": str(rank),
        "DMLC_NUM_WORKER": str(n),
        "DMLC_WORKER_ID": str(rank),
        "DMLC_ROLE": "worker",
    }


def server_env(port: int, n_workers: int) -> dict:
    """A parameter server's environment (the reference launcher's)."""
    return {"DMLC_ROLE": "server", "DMLC_NUM_WORKER": str(n_workers),
            "MX_PS_PORT": str(port), "MX_FORCE_CPU": "1"}


def ps_worker_env(roots) -> dict:
    """What a worker reads to find the parameter servers."""
    host, port = roots[0].rsplit(":", 1)
    return {"MX_PS_ROOT": roots[0], "MX_PS_ROOTS": ",".join(roots),
            "DMLC_PS_ROOT_URI": host, "DMLC_PS_ROOT_PORT": port,
            "DMLC_NUM_SERVER": str(len(roots))}


def _stop(procs, grace: float = 10.0) -> None:
    """SIGTERM every live process, then SIGKILL what is left after
    ``grace`` seconds."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + grace
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _recv_exact(s: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            break
        buf += chunk
    return buf


def send_stop(addr: str, timeout: float = 5.0) -> None:
    """Send a server the kvstore wire STOP (one length-prefixed pickle
    frame, the server's framing) and read its acknowledgement.  Inlined,
    so the launcher loads nothing of the framework."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host or "127.0.0.1", int(port)),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        payload = pickle.dumps(("STOP", None), protocol=4)
        s.sendall(struct.pack("<Q", len(payload)) + payload)
        head = _recv_exact(s, 8)
        if len(head) == 8:
            _recv_exact(s, struct.unpack("<Q", head)[0])


def stop_servers(servers, timeout: float = STOP_TIMEOUT) -> int:
    """Stop each live server with the wire STOP and wait for it; SIGTERM
    is the fallback for one that cannot be reached or does not exit.
    Returns the first nonzero exit code of a server we did not kill, or
    0."""
    rc = 0
    for proc, addr in servers:
        killed = False
        if proc.poll() is None:
            try:
                send_stop(addr)
            except OSError as e:
                print("launch: server %s: STOP failed (%s); terminating it"
                      % (addr, e), file=sys.stderr, flush=True)
                proc.terminate()
                killed = True
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                killed = True
        code = proc.returncode
        if code and not killed:
            print("launch: server %s exited with %d" % (addr, code),
                  file=sys.stderr, flush=True)
            rc = rc or (code if code > 0 else 128 - code)
    return rc


def start_servers(n_servers: int, n_workers: int, fault=None,
                  snapshot_dir=None):
    """Spawn ``n_servers`` parameter servers on free local ports; returns
    ``[(process, "127.0.0.1:port")]``."""
    if snapshot_dir:
        os.makedirs(snapshot_dir, exist_ok=True)
    servers = []
    for s in range(n_servers):
        port = _free_port()
        env = dict(os.environ)
        env.update(server_env(port, n_workers))
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        if fault:
            env["MX_FAULT_INJECT"] = fault
        if snapshot_dir:
            # a server restarted with the same path resumes its store
            env["MX_PS_SNAPSHOT"] = os.path.join(
                os.path.abspath(snapshot_dir), "server_%d.pkl" % s)
        proc = subprocess.Popen([sys.executable, "-m",
                                 "mxnet_tpu_torch.kvstore.server"], env=env)
        servers.append((proc, "127.0.0.1:%d" % port))
    return servers


def launch_local(n: int, command, poll: float = 0.05, num_servers: int = 0,
                 fault=None, ps_snapshot_dir=None) -> int:
    """Run ``command`` as ranks 0..n-1 on this host, beside
    ``num_servers`` parameter servers; returns 0 when every process exits
    0, else the first failing process's code (the others are stopped)."""
    coordinator = "127.0.0.1:%d" % _free_port()
    servers, procs = [], []
    try:
        servers = start_servers(num_servers, n, fault, ps_snapshot_dir)
        roots = [addr for _, addr in servers]
        for rank in range(n):
            env = dict(os.environ)
            env.update(worker_env(rank, coordinator, n))
            if roots:
                env.update(ps_worker_env(roots))
            if fault:
                env["MX_FAULT_INJECT"] = fault
            procs.append(subprocess.Popen(list(command), env=env))
        named = [("rank %d" % r, p) for r, p in enumerate(procs)] + \
            [("server %d" % s, p) for s, (p, _) in enumerate(servers)]
        while True:
            failed = [(name, p.poll()) for name, p in named
                      if p.poll() not in (None, 0)]
            if failed:
                name, code = failed[0]
                print("launch: %s exited with %d; stopping the other "
                      "processes" % (name, code), file=sys.stderr,
                      flush=True)
                _stop(procs + [p for p, _ in servers])
                return code if code > 0 else 128 - code
            if all(p.poll() == 0 for p in procs):
                return stop_servers(servers)
            time.sleep(poll)
    finally:
        _stop(procs + [p for p, _ in servers])


def launch_manual(n: int, command) -> int:
    for rank in range(n):
        env = worker_env(rank, "<host0>:43117", n)
        print("rank %d:  env %s %s" % (
            rank, " ".join("%s=%s" % kv for kv in env.items()),
            " ".join(command)))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.launch",
        description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("-s", "--num-servers", type=int, default=0,
                   help="parameter servers for the dist_async store")
    p.add_argument("--launcher", default="local",
                   choices=["local", "ssh", "manual"])
    p.add_argument("--fault", default=None, metavar="SPEC",
                   help="arm fault injection (MX_FAULT_INJECT) in every "
                        "process, e.g. 'kvstore.send:close:after=3'")
    p.add_argument("--ps-snapshot-dir", default=None, metavar="DIR",
                   help="keep each parameter server's store under DIR, so "
                        "a restarted server loses nothing")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args, unknown = p.parse_known_args(argv)
    flags = [u.split("=", 1)[0] for u in unknown if u.startswith("-")]
    part_b = (["--launcher ssh"] if args.launcher == "ssh" else []) + \
        [f for f in flags if f in PART_B]
    if part_b:
        p.error("%s: not ported yet (the launcher's ssh mode and "
                "supervision come with part (b) of the parameter-server "
                "slice)" % ", ".join(part_b))
    item_6 = [f for f in flags if f in ITEM_6]
    if item_6:
        p.error("%s: not ported yet (the serving fleet, ROADMAP Queue 1 "
                "item 6)" % ", ".join(item_6))
    if unknown:
        p.error("unrecognized arguments: %s" % " ".join(unknown))
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        p.error("no command given")
    if args.num_workers < 1:
        p.error("-n must be at least 1")
    if args.num_servers < 0:
        p.error("-s must be at least 0")
    if args.launcher == "manual":
        return launch_manual(args.num_workers, command)
    return launch_local(args.num_workers, command,
                        num_servers=args.num_servers, fault=args.fault,
                        ps_snapshot_dir=args.ps_snapshot_dir)


if __name__ == "__main__":
    sys.exit(main())
