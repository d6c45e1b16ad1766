"""Start a data-parallel job: N worker processes on this host.

Counterpart of ``tools/launch.py`` (reference: tools/launch.py and
ps-lite's dmlc tracker)::

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local -- \\
        python train.py

Every worker gets the reference's environment contract, which
``mxnet_tpu_torch.parallel.init_process_group`` reads:

  MX_COORDINATOR    host:port of rank 0 (a free port of this host)
  MX_NUM_PROCESSES  the world size
  MX_PROCESS_ID     this worker's rank

and the reference-era ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID`` and
``DMLC_ROLE=worker``.  ``--launcher local`` spawns the N workers and
waits; when one exits nonzero the launcher stops the others and exits
with that code.  ``--launcher manual`` prints each rank's environment and
command.  Parameter servers (``-s``), ``--launcher ssh`` and the
reference's supervision flags (``--restart``, ``--hang-timeout``,
``--elastic``, ...) come with the parameter-server slice; until then they
are refused with a message that says so.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

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


def launch_local(n: int, command, poll: float = 0.05) -> int:
    """Run ``command`` as ranks 0..n-1 on this host; returns 0 when every
    rank exits 0, else the first failing rank's code (the others are
    stopped)."""
    coordinator = "127.0.0.1:%d" % _free_port()
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ)
            env.update(worker_env(rank, coordinator, n))
            procs.append(subprocess.Popen(list(command), env=env))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                rank, code = failed[0]
                print("launch: rank %d exited with %d; stopping the other "
                      "ranks" % (rank, code), file=sys.stderr, flush=True)
                _stop(procs)
                return code if code > 0 else 128 - code
            if all(c == 0 for c in codes):
                return 0
            time.sleep(poll)
    finally:
        _stop(procs)


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
    p.add_argument("-s", "--num-servers", type=int, default=0)
    p.add_argument("--launcher", default="local",
                   choices=["local", "ssh", "manual"])
    p.add_argument("command", nargs=argparse.REMAINDER)
    args, unknown = p.parse_known_args(argv)
    if unknown:
        # the reference launcher's supervision and host flags (--restart,
        # --hang-timeout, --elastic, -H, ...)
        p.error("unrecognized arguments: %s (the reference launcher's "
                "supervision and host flags are not ported yet: they come "
                "with the parameter-server slice)" % " ".join(unknown))
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        p.error("no command given")
    if args.num_workers < 1:
        p.error("-n must be at least 1")
    unported = (["--launcher ssh"] if args.launcher == "ssh" else []) + \
        (["-s"] if args.num_servers else [])
    if unported:
        p.error("%s: not ported yet (parameter servers and ssh come with "
                "the parameter-server slice)" % ", ".join(unported))
    if args.launcher == "manual":
        return launch_manual(args.num_workers, command)
    return launch_local(args.num_workers, command)


if __name__ == "__main__":
    sys.exit(main())
