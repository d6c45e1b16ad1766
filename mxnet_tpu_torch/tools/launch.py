"""Start and supervise a training job: N worker processes, and parameter
servers, on this host or over ssh.

Counterpart of ``tools/launch.py`` (reference: tools/launch.py and
ps-lite's dmlc tracker)::

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local -- \\
        python train.py
    python -m mxnet_tpu_torch.tools.launch -n 2 -s 2 --launcher local -- \\
        python train_dist_async.py
    python -m mxnet_tpu_torch.tools.launch -n 2 --restart on-failure \\
        --fault 'worker.step:crash:after=5' -- python train.py
    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher ssh \\
        -H hosts -- python train.py

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

Every process runs under a :class:`Supervisor`.  When every worker has
exited 0 it sends each server the wire STOP (the server drains its
requests in flight and writes its snapshot), waits for it, and folds a
server's nonzero exit into the job's code.  Under ``--restart never``
(the default) a process that exits nonzero stops the job: the others are
stopped and the launcher exits with its code.  With ``--restart
on-failure`` (or ``--restart N``) a crashed worker or server is
restarted with its original environment (same rank, coordinator and
snapshot path, so checkpoint resume and ``MX_PS_SNAPSHOT`` pick up from
the last save) after a ``fault.RetryPolicy`` backoff; a process past
``--max-restarts`` tears the job down.  ``--hang-timeout S`` gives each
worker ``MX_HEARTBEAT_FILE`` (``health.Heartbeat``, rewritten every
batch) and kills, then restarts, a worker whose file is stale for S
seconds; in the worker ``MX_STEP_TIMEOUT`` (``health.Watchdog``) turns a
hung step into exit 86, which the supervisor names.
``--status-interval S`` prints a table of every process from the
heartbeat files' telemetry payload every S seconds and on each failure.
``--elastic`` gives every worker ``MX_ELASTIC=1`` (the parameter-server
membership JOIN, and a SIGTERM drain at the next epoch boundary): a
worker past its restart budget is given up (the supervisor sends LEAVE
for it to every server) and the job goes on with the others, and
``--resize-file PATH`` is polled for a new worker count: every worker is
drained (SIGTERM; ``--drain-timeout`` bounds the wait), removed ranks
leave the membership, and ranks ``0..N-1`` are started under a new
generation (``MX_ELASTIC_EPOCH``, the bucket-name salt).

``--launcher ssh -H hostfile`` starts rank r on the hostfile's line r by
``ssh`` and only waits: supervision needs the processes' lifetimes,
which an ssh client does not give, so ``--restart``,
``--hang-timeout``, ``--elastic`` / ``--resize-file`` and ``-s`` are
refused there.  ``--launcher manual`` prints each rank's environment and
command.

Not ported yet, and refused with a message that says so: the serving
fleet's ``--serve-port-base``, ``--route``, ``--autoscale`` and
``--compile-cache`` (ROADMAP Queue 1 item 6), with the supervisor's fleet
collector and serving tier.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shlex
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import time

from .. import fault as _fault
from .. import telemetry as _telemetry
from ..health import WATCHDOG_EXIT_CODE

#: the reference launcher's flags that wait for the serving fleet (ROADMAP
#: Queue 1 item 6): refused by name
ITEM_6 = ("--serve-port-base", "--route", "--autoscale", "--compile-cache")

STOP_TIMEOUT = 10.0     # seconds a server may take to exit after STOP
SSH_COORDINATOR_PORT = 43117
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


# ---------------------------------------------------------------------------
# The kvstore wire verbs the supervisor sends (inlined framing: one
# length-prefixed pickle frame each way, the server's)
# ---------------------------------------------------------------------------

def _recv_exact(s: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            break
        buf += chunk
    return buf


def _rpc(addr: str, msg, timeout: float) -> None:
    """Send ``msg`` to the server at ``addr`` and read its reply."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host or "127.0.0.1", int(port)),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        payload = pickle.dumps(msg, protocol=4)
        s.sendall(struct.pack("<Q", len(payload)) + payload)
        head = _recv_exact(s, 8)
        if len(head) == 8:
            _recv_exact(s, struct.unpack("<Q", head)[0])


def send_stop(addr: str, timeout: float = 5.0) -> None:
    """The wire STOP: the server drains its requests in flight, writes its
    snapshot and exits."""
    _rpc(addr, ("STOP", None), timeout)


def send_leave(addr: str, rank: int, timeout: float = 5.0) -> None:
    """The wire LEAVE for worker ``rank`` (elastic membership): sent on
    behalf of a dead or removed worker, so that barriers count the
    survivors at once instead of waiting for liveness eviction.  LEAVE is
    idempotent on the server."""
    _rpc(addr, ("LEAVE", "r%d" % int(rank)), timeout)


# ---------------------------------------------------------------------------
# The supervisor
# ---------------------------------------------------------------------------

class SupervisedProc:
    """One supervised process: argv, frozen env, restart accounting."""

    def __init__(self, name, argv, env, role="worker", addr=None,
                 heartbeat=None):
        self.name = name
        self.argv = list(argv)
        self.env = dict(env)          # frozen: a restart reuses it
        self.role = role              # "worker" | "server"
        self.addr = addr              # host:port of a server, for STOP
        self.heartbeat = heartbeat    # liveness file or None
        self.proc = None
        self.restarts = 0
        self.restart_at = None        # the respawn's backoff deadline
        self.spawned_wall = None      # wall clock of the last spawn
        self.rc = None                # final status once done for good
        self.we_killed = False        # torn down by us: not a failure

    @property
    def done(self):
        return self.rc is not None

    def alive(self):
        return self.proc is not None and self.proc.poll() is None


class Supervisor:
    """Restart-and-resume process supervisor (the reference's, less its
    fleet collector and serving tier, which wait for ROADMAP Queue 1 item
    6; the status table reads the heartbeat files alone, as the
    reference's does without a collector).

    ``restart="on-failure"`` restarts a crashed process with its original
    env after a ``fault.RetryPolicy`` backoff, up to ``max_restarts``
    times a process; past the budget the job is torn down (an elastic
    job instead gives a worker up while others survive).  A heartbeat
    stale past ``hang_timeout`` is a crash: the process is killed, then
    the restart path runs.  Under ``restart="never"`` a failure stops the
    job at once, where the reference waits for the other processes: a
    rank that died leaves its peers blocked in their next collective, so
    waiting for them would wait for ever.

    Backoff is scheduled by deadline, not slept inline, so a process in
    its backoff window never holds up reaping, hang checks or the other
    restarts, and every deadline reads :mod:`..fault`'s clock: under
    ``fault.use_virtual_time()`` tests run a whole schedule with no real
    sleep.
    """

    # heartbeat payload lines that failed to parse, tolerated and counted:
    # a torn payload must not drop the beat, whose head line still proves
    # liveness
    malformed_beats = 0

    def __init__(self, restart="never", max_restarts=3, backoff=None,
                 hang_timeout=None, startup_grace=None, poll=0.05,
                 log=None, status_interval=None, elastic=False,
                 resize_file=None, drain_timeout=60.0):
        if restart not in ("never", "on-failure"):
            raise ValueError("restart must be 'never' or 'on-failure'")
        self.restart = restart
        self.max_restarts = int(max_restarts)
        self.elastic = bool(elastic)
        self.resize_file = resize_file
        self.drain_timeout = float(drain_timeout)
        self.ps_addrs = []            # server addresses, for LEAVE
        self.worker_factory = None    # (rank, n, generation) ->
                                      # (name, argv, env, heartbeat)
        self.generation = 0           # bumped by each resize; rides
                                      # MX_ELASTIC_EPOCH
        self._resize_applied = None   # the last target honoured: a stale
                                      # resize file must not undo a shrink
        self._backoff = backoff
        self.hang_timeout = hang_timeout
        # a table every status_interval seconds and on every failure; 0:
        # on failures only; None: never
        self.status_interval = status_interval
        self._last_status = time.time()
        self._crash_seq = 0
        # before its first beat a process gets a startup window (imports,
        # kernel loads, a restore) that is long but bounded: a respawn that
        # wedges before its first batch is still found
        self.startup_grace = startup_grace if startup_grace is not None \
            else (max(120.0, 20.0 * hang_timeout) if hang_timeout
                  else None)
        self.poll = poll
        self.log = log or (lambda msg: print("launch: %s" % msg,
                                             file=sys.stderr, flush=True))
        self.procs = []
        self.job_rc = 0

    def add(self, name, argv, env, role="worker", addr=None,
            heartbeat=None):
        sp = SupervisedProc(name, argv, env, role=role, addr=addr,
                            heartbeat=heartbeat)
        self.procs.append(sp)
        return sp

    # -- plumbing -----------------------------------------------------------
    def _now(self):
        return _fault.now()

    def _sleep_poll(self):
        _fault.sleep(self.poll)

    def _backoff_delay(self, attempt):
        if self._backoff is None:
            # the deadline is unused (only delay() is read); the jitter
            # spreads the restarts of ranks that failed together
            self._backoff = _fault.RetryPolicy(
                deadline=float("inf"), base=1.0, max_delay=30.0,
                jitter=0.1)
        return self._backoff.delay(attempt)

    def _spawn(self, sp):
        if sp.heartbeat:
            # the previous incarnation's beats go: liveness is enforced
            # from this process's first beat on
            try:
                os.remove(sp.heartbeat)
            except OSError:
                pass
        sp.spawned_wall = time.time()
        sp.proc = subprocess.Popen(sp.argv, env=sp.env)

    def _kill(self, sp):
        if not sp.alive():
            return
        sp.we_killed = True
        sp.proc.terminate()
        try:
            sp.proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:
            sp.proc.kill()
            try:
                # bounded: an unkillable child must not wedge the loop; a
                # later poll() reaps it
                sp.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.log("%s ignored SIGKILL (uninterruptible?); "
                         "leaving it to a later poll" % sp.name)

    def _fold(self, rc):
        if rc:
            self.job_rc = self.job_rc or (rc if rc > 0 else 1)

    # -- status -------------------------------------------------------------
    @staticmethod
    def _read_beat(sp):
        """(age in seconds or None, head line, payload dict) of a
        process's heartbeat file, parsed by
        :func:`..telemetry.parse_heartbeat`.  The age compares the wall
        clock with the file's mtime; under a virtual fault clock it is
        read on that clock from the payload's ``ts`` instead."""
        if not sp.heartbeat:
            return None, "", {}
        try:
            age = time.time() - os.stat(sp.heartbeat).st_mtime
            with open(sp.heartbeat) as f:
                lines = f.read().splitlines()
        except OSError:
            return None, "", {}
        head, payload, malformed = _telemetry.parse_heartbeat(lines)
        Supervisor.malformed_beats += malformed
        if _fault.is_virtual() and \
                isinstance(payload.get("ts"), (int, float)):
            age = max(0.0, _fault.now() - float(payload["ts"]))
        return age, head, payload

    @staticmethod
    def _state_of(sp):
        if sp.done:
            return "done(rc=%s)" % sp.rc
        if sp.restart_at is not None:
            return "restarting"
        return "running" if sp.alive() else "spawning"

    def status_table(self):
        """One row a supervised process, from its heartbeat payload."""
        cols = ("proc", "state", "restarts", "step", "epoch",
                "steps/s", "img/s", "wire KB", "beat age", "flags")
        rows = [cols]
        for sp in self.procs:
            age, _head, p = self._read_beat(sp)
            rows.append((
                sp.name, self._state_of(sp), str(sp.restarts),
                str(p.get("step", "-")), str(p.get("epoch", "-")),
                "%.3g" % p["steps_per_sec"] if "steps_per_sec" in p
                else "-",
                "%.4g" % p["throughput"] if "throughput" in p else "-",
                "%.1f" % (p["wire_bytes"] / 1024.0)
                if "wire_bytes" in p else "-",
                "%.1fs" % age if age is not None else "-", "-"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        sep = "-" * len(lines[0])
        return "\n".join(["fleet status:", sep] + lines + [sep])

    def _maybe_status(self):
        if not self.status_interval:
            return
        now = time.time()
        if now - self._last_status >= self.status_interval:
            self._last_status = now
            self.log("\n" + self.status_table())

    def _crash_dump(self, sp, rc, kind):
        """What the supervisor saw of a failed process (exit code, restart
        budget, last heartbeat) into ``MX_CRASH_DIR``, beside the worker's
        own flight-recorder dump."""
        d = os.environ.get("MX_CRASH_DIR")
        if not d:
            return None
        try:
            os.makedirs(d, exist_ok=True)
            self._crash_seq += 1
            age, head, payload = self._read_beat(sp)
            safe = "".join(c if c.isalnum() else "_" for c in sp.name)
            path = os.path.join(d, "supervisor-%s-%d.json"
                                % (safe, self._crash_seq))
            blob = {"reason": kind, "proc": sp.name, "role": sp.role,
                    "rc": rc, "restarts": sp.restarts,
                    "wall_time": time.time(),
                    "heartbeat_age": age, "heartbeat_head": head,
                    "heartbeat": payload}
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "w") as f:
                json.dump(blob, f, indent=1)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    # -- failures -----------------------------------------------------------
    @staticmethod
    def _describe(rc):
        if rc == WATCHDOG_EXIT_CODE:
            return "exit %d (MX_STEP_TIMEOUT watchdog: hung step)" % rc
        if rc < 0:
            return "signal %d" % -rc
        return "exit %d" % rc

    def _leave(self, sp):
        """LEAVE ``sp``'s rank at every server."""
        try:
            rank = int(sp.env.get("MX_PROCESS_ID", -1))
        except (TypeError, ValueError):
            rank = -1
        if rank < 0:
            return
        for addr in self.ps_addrs:
            try:
                send_leave(addr, rank)
            except OSError as e:
                self.log("LEAVE r%d -> %s failed (%s); liveness eviction "
                         "will catch up" % (rank, addr, e))

    def _on_failure(self, sp, rc):
        """``sp`` crashed (or was killed as hung).  Returns True to keep
        running, False to tear the job down."""
        self._crash_dump(sp, rc, self._describe(rc))
        if self.status_interval is not None:
            self.log("\n" + self.status_table())
        if self.restart != "on-failure":
            self.log("%s exited with %d; stopping the other processes"
                     % (sp.name, rc))
            sp.rc = rc
            self._fold(rc)
            return False
        if sp.restarts >= self.max_restarts:
            survivors = [w for w in self.procs
                         if w is not sp and w.role == "worker"
                         and not w.done]
            if self.elastic and sp.role == "worker" and survivors:
                # shrink and continue: the worker is given up; LEAVE on its
                # behalf takes it out of the servers' membership, so their
                # barriers count the survivors at once
                self.log("%s failed (%s) past its restart budget (%d) - "
                         "elastic shrink: continuing with %d worker(s)"
                         % (sp.name, self._describe(rc), self.max_restarts,
                            len(survivors)))
                sp.rc = rc      # done, not folded: the survivors' code
                self._leave(sp)
                return True
            self.log("%s failed (%s) and exhausted its restart budget "
                     "(%d) - tearing the job down"
                     % (sp.name, self._describe(rc), self.max_restarts))
            sp.rc = rc
            self._fold(rc)
            return False
        delay = self._backoff_delay(sp.restarts)
        sp.restarts += 1
        sp.restart_at = self._now() + delay    # a deadline, not a sleep
        extra = ""
        if sp.role == "worker" and sp.env.get("MX_PROCESS_ID") == "0":
            extra = " (rank 0: regenerating the coordinator on %s)" \
                % sp.env.get("MX_COORDINATOR", "?")
        self.log("%s failed (%s) - restart %d/%d in %.3gs with original "
                 "env%s" % (sp.name, self._describe(rc), sp.restarts,
                            self.max_restarts, delay, extra))
        return True

    def _check_hang(self, sp):
        """Heartbeat liveness: a slow process keeps its file fresh; a file
        stale past ``hang_timeout`` (or no file past the startup grace)
        means wedged: kill it, and its exit takes the failure path."""
        if not (sp.heartbeat and self.hang_timeout) or not sp.alive():
            return
        try:
            age = time.time() - os.stat(sp.heartbeat).st_mtime
            limit, phase = self.hang_timeout, "--hang-timeout"
            try:
                with open(sp.heartbeat) as f:
                    if f.read().strip().endswith("done"):
                        return  # the loop finished its beats
            except OSError:
                pass
        except OSError:
            if self.startup_grace is None or sp.spawned_wall is None:
                return
            age = time.time() - sp.spawned_wall
            limit, phase = self.startup_grace, "startup grace"
        if age > limit:
            self.log("%s heartbeat stale for %.3gs (> %s %.3g) - killing "
                     "the wedged process" % (sp.name, age, phase, limit))
            sp.proc.kill()
            try:
                sp.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.log("%s ignored SIGKILL (uninterruptible?); leaving "
                         "it to a later poll" % sp.name)

    # -- elastic resize -----------------------------------------------------
    def _check_resize(self):
        """Poll the resize file for a worker count; one that differs from
        the last honoured starts a resize."""
        if not (self.elastic and self.resize_file and self.worker_factory):
            return
        try:
            with open(self.resize_file) as f:
                txt = f.read().strip()
        except OSError:
            return
        if not txt:
            return
        try:
            n_new = int(txt)
        except ValueError:
            self.log("resize file %r holds %r (not an integer); ignored"
                     % (self.resize_file, txt))
            return
        if n_new <= 0 or n_new == self._resize_applied:
            return
        self._resize_applied = n_new
        self._do_resize(n_new)

    def _do_resize(self, n_new):
        """Drain every worker at its next epoch boundary (SIGTERM: the
        loop checkpoints and exits 0), LEAVE the removed ranks, then start
        ranks 0..n_new-1 under a new generation, which ``MX_ELASTIC_EPOCH``
        carries into every worker (the bucket-name salt, so the resized
        world's exchange layout is new and agreed)."""
        old = [sp for sp in self.procs
               if sp.role == "worker" and not sp.done]
        self.generation += 1
        self.log("elastic resize: %d -> %d worker(s) (generation %d); "
                 "draining at the epoch boundary"
                 % (len(old), n_new, self.generation))
        for sp in old:
            if sp.alive():
                sp.proc.terminate()
        deadline = time.time() + self.drain_timeout
        for sp in old:
            if sp.proc is not None:
                try:
                    sp.proc.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    self.log("%s did not drain within %.3gs - killing it "
                             "(resume picks up from its last checkpoint)"
                             % (sp.name, self.drain_timeout))
                    sp.we_killed = True
                    sp.proc.kill()
                    try:
                        sp.proc.wait(timeout=5.0)
                    except subprocess.TimeoutExpired:
                        pass
            sp.rc = 0                 # drained on request: no failure
        for sp in old:
            try:
                rank = int(sp.env.get("MX_PROCESS_ID", -1))
            except (TypeError, ValueError):
                rank = -1
            if rank >= n_new:
                self._leave(sp)
        self.procs = [sp for sp in self.procs if sp.role != "worker"]
        for rank in range(n_new):
            name, argv, env, heartbeat = self.worker_factory(
                rank, n_new, self.generation)
            self._spawn(self.add(name, argv, env, role="worker",
                                 heartbeat=heartbeat))

    # -- run ----------------------------------------------------------------
    def _teardown(self):
        for sp in self.procs:
            self._kill(sp)
            if sp.rc is None:
                sp.rc = 0 if sp.proc is None else (sp.proc.poll() or 0)

    def run(self):
        """Spawn everything, supervise until every worker is done, then
        stop the servers.  Returns the job's exit code."""
        for sp in self.procs:
            self._spawn(sp)
        try:
            while True:
                # a resize swaps the worker set: read it fresh each tick
                self._check_resize()
                for sp in list(self.procs):
                    if sp.done or sp.proc is None:
                        continue
                    if sp.restart_at is not None:
                        if self._now() >= sp.restart_at:
                            sp.restart_at = None
                            self._spawn(sp)
                        continue        # in its backoff window
                    self._check_hang(sp)
                    rc = sp.proc.poll()
                    if rc is None:
                        continue
                    if rc == 0:
                        # a server that exits 0 early was sent STOP by a
                        # worker: done too
                        sp.rc = 0
                        continue
                    if not self._on_failure(sp, rc):
                        self._teardown()
                        return self.job_rc
                if all(w.done for w in self.procs if w.role != "server"):
                    break
                self._maybe_status()
                self._sleep_poll()
        except BaseException:
            # ^C or a supervisor fault (a respawn's Popen failing): never
            # leave processes running unsupervised
            self._teardown()
            raise
        self.stop_servers()
        return self.job_rc

    def stop_servers(self, timeout=STOP_TIMEOUT):
        """The workers are done: stop each surviving server with the wire
        STOP (requests in flight finish, the snapshot lands), SIGTERM if it
        cannot be reached, and fold a server's exit code into the job's; a
        kill we sent is no server failure."""
        for sp in self.procs:
            if sp.role != "server" or sp.done:
                continue
            if sp.restart_at is not None and not sp.alive():
                # a crash the restart policy forgave, its backoff window
                # outlived the workers: folding it would make the job's
                # code a race
                sp.rc = 0
                continue
            stop_sent = False
            if sp.alive() and sp.addr:
                try:
                    send_stop(sp.addr)
                    stop_sent = True
                except OSError as e:
                    self.log("%s: STOP failed (%s); terminating it"
                             % (sp.name, e))
            if not stop_sent:
                self._kill(sp)
            try:
                sp.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self._kill(sp)
            rc = sp.proc.poll()
            sp.rc = rc if rc is not None else 0
            if sp.rc and not sp.we_killed:
                self.log("%s exited with %d" % (sp.name, sp.rc))
                self._fold(sp.rc)


def _make_supervisor(args):
    """A :class:`Supervisor` from the parsed flags (``--restart N`` is
    on-failure with a budget of N)."""
    restart = getattr(args, "restart", "never")
    max_restarts = getattr(args, "max_restarts", 3)
    if restart not in ("never", "on-failure"):
        try:
            max_restarts = int(restart)
        except ValueError:
            raise SystemExit("--restart must be never, on-failure, or an "
                             "integer budget (got %r)" % restart)
        if max_restarts < 0:
            raise SystemExit("--restart N needs N >= 0")
        restart = "on-failure"
    return Supervisor(restart=restart, max_restarts=max_restarts,
                      hang_timeout=getattr(args, "hang_timeout", None),
                      status_interval=getattr(args, "status_interval",
                                              None),
                      elastic=getattr(args, "elastic", False),
                      resize_file=getattr(args, "resize_file", None),
                      drain_timeout=getattr(args, "drain_timeout", None)
                      or 60.0)


# ---------------------------------------------------------------------------
# Launch modes
# ---------------------------------------------------------------------------

def launch_local(args, command) -> int:
    """Run ``command`` as ranks 0..n-1 on this host, beside
    ``args.num_servers`` parameter servers, under a :class:`Supervisor`;
    returns the job's exit code."""
    coordinator = "127.0.0.1:%d" % _free_port()
    sup = _make_supervisor(args)
    n = args.num_workers
    fault_spec = getattr(args, "fault", None)
    hb_dir = tempfile.mkdtemp(prefix="mx-heartbeat-") \
        if sup.hang_timeout or sup.status_interval else None
    ps_roots = []
    snap_dir = getattr(args, "ps_snapshot_dir", None)
    if snap_dir:
        os.makedirs(snap_dir, exist_ok=True)
    for s in range(getattr(args, "num_servers", 0)):
        port = _free_port()
        addr = "127.0.0.1:%d" % port
        ps_roots.append(addr)
        env = dict(os.environ)
        env.update(server_env(port, n))
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        if fault_spec:
            env["MX_FAULT_INJECT"] = fault_spec
        if snap_dir:
            # a server restarted with the same path resumes its store
            env["MX_PS_SNAPSHOT"] = os.path.join(
                os.path.abspath(snap_dir), "server_%d.pkl" % s)
        sup.add("server %d" % s,
                [sys.executable, "-m", "mxnet_tpu_torch.kvstore.server"],
                env, role="server", addr=addr)
    elastic = bool(getattr(args, "elastic", False))

    def make_worker(rank, world, generation):
        """(name, argv, env, heartbeat) of one worker: the first spawn's,
        and an elastic resize's at any size."""
        env = dict(os.environ)
        env.update(worker_env(rank, coordinator, world))
        if fault_spec:
            # a restarted rank re-arms the same spec
            env["MX_FAULT_INJECT"] = fault_spec
        heartbeat = None
        if hb_dir:
            heartbeat = os.path.join(hb_dir, "rank_%d" % rank)
            env["MX_HEARTBEAT_FILE"] = heartbeat
        if ps_roots:
            env.update(ps_worker_env(ps_roots))
        if elastic:
            env["MX_ELASTIC"] = "1"
            env["MX_ELASTIC_EPOCH"] = str(int(generation))
        return "rank %d" % rank, list(command), env, heartbeat

    for rank in range(n):
        name, argv, env, heartbeat = make_worker(rank, n, 0)
        sup.add(name, argv, env, role="worker", heartbeat=heartbeat)
    sup.ps_addrs = list(ps_roots)
    if elastic:
        sup.worker_factory = make_worker
        sup._resize_applied = n
    try:
        return sup.run()
    finally:
        if hb_dir:
            shutil.rmtree(hb_dir, ignore_errors=True)


def launch_ssh(args, command) -> int:
    """Start rank r on line r of the hostfile through ``ssh`` (the
    launcher's environment contract exported on the remote command line)
    and wait for every rank."""
    if getattr(args, "hang_timeout", None):
        raise SystemExit(
            "launch: --hang-timeout reads a LOCAL heartbeat file and cannot "
            "observe remote ranks; it is only supported with --launcher "
            "local (use MX_STEP_TIMEOUT for in-process hang detection on "
            "remote ranks)")
    if getattr(args, "restart", "never") != "never":
        # an ssh client exiting nonzero does not mean the remote rank died
        # (a transport blip orphans it alive): a restart could start a
        # second rank k against the same servers and checkpoints
        raise SystemExit(
            "launch: --restart is only supported with --launcher local (an "
            "ssh client's exit cannot be told from the remote rank's death; "
            "restarting on it risks duplicate ranks)")
    if getattr(args, "elastic", False) or getattr(args, "resize_file",
                                                  None):
        raise SystemExit(
            "launch: --elastic/--resize-file are only supported with "
            "--launcher local")
    if getattr(args, "num_servers", 0) > 0:
        raise SystemExit(
            "launch: -s/--num-servers is only implemented for the local "
            "launcher; start `python -m mxnet_tpu_torch.kvstore.server` on "
            "a host and export MX_PS_ROOT=host:port")
    if getattr(args, "route", None) is not None or \
            getattr(args, "serve_port_base", None) is not None or \
            getattr(args, "autoscale", None):
        raise SystemExit(
            "launch: --route/--serve-port-base/--autoscale are only "
            "supported with --launcher local")
    hosts = []
    with open(args.hostfile) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                hosts.append(line.split()[0])
    if len(hosts) < args.num_workers:
        raise SystemExit("hostfile has %d hosts < -n %d"
                         % (len(hosts), args.num_workers))
    coordinator = "%s:%d" % (hosts[0], SSH_COORDINATOR_PORT)
    sup = _make_supervisor(args)    # restart never (refused above)
    for rank in range(args.num_workers):
        env = dict(os.environ)
        env.update(worker_env(rank, coordinator, args.num_workers))
        exports = " ".join("%s=%s" % (k, shlex.quote(v))
                           for k, v in env.items()
                           if k.startswith(("MX_", "DMLC_")))
        remote = "cd %s && env %s %s" % (
            shlex.quote(os.getcwd()), exports,
            " ".join(shlex.quote(c) for c in command))
        sup.add("rank %d (%s)" % (rank, hosts[rank]),
                ["ssh", "-o", "StrictHostKeyChecking=no", hosts[rank],
                 remote], dict(os.environ), role="worker")
    return sup.run()


def launch_manual(args, command) -> int:
    for rank in range(args.num_workers):
        env = worker_env(rank, "<host0>:%d" % SSH_COORDINATOR_PORT,
                         args.num_workers)
        print("rank %d:  env %s %s" % (
            rank, " ".join("%s=%s" % kv for kv in env.items()),
            " ".join(command)))
    return 0


#: supervision flags: (flag, attribute, its value when not given)
SUPERVISION = (("--restart", "restart", None),
               ("--max-restarts", "max_restarts", None),
               ("--hang-timeout", "hang_timeout", None),
               ("--status-interval", "status_interval", None),
               ("--elastic", "elastic", False),
               ("--resize-file", "resize_file", None),
               ("--drain-timeout", "drain_timeout", None))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.launch",
        description=__doc__.split("\n\n")[0])
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("-s", "--num-servers", type=int, default=0,
                   help="parameter servers for the dist_async store")
    p.add_argument("--launcher", default="local",
                   choices=["local", "ssh", "manual"])
    p.add_argument("-H", "--hostfile", default=None,
                   help="one host a line, rank r on line r (--launcher "
                        "ssh)")
    p.add_argument("--restart", default=None, metavar="POLICY",
                   help="never (default) | on-failure | N (on-failure with "
                        "--max-restarts N): restart a crashed worker or "
                        "server with its original env after a backoff, so "
                        "that it resumes from its last checkpoint; past the "
                        "budget the job is torn down")
    p.add_argument("--max-restarts", type=int, default=None, metavar="N",
                   help="restarts a process may take under --restart "
                        "on-failure (default 3)")
    p.add_argument("--hang-timeout", type=float, default=None,
                   metavar="SECS",
                   help="give each worker MX_HEARTBEAT_FILE and kill, then "
                        "handle as a crash, a worker whose file is stale "
                        "this long (before its first beat: a startup grace "
                        "of max(120 s, 20 x SECS))")
    p.add_argument("--status-interval", type=float, default=None,
                   metavar="SECS",
                   help="print a table of every process (step, rate, "
                        "wire bytes from the heartbeat payload) every SECS "
                        "seconds and on each failure")
    p.add_argument("--elastic", action="store_true",
                   help="MX_ELASTIC=1 in every worker; a worker past its "
                        "restart budget is given up (LEAVE) and the job "
                        "goes on with the others")
    p.add_argument("--resize-file", default=None, metavar="PATH",
                   help="poll PATH for a worker count: drain every worker "
                        "at its epoch boundary and start the new world "
                        "under a new MX_ELASTIC_EPOCH (needs --elastic)")
    p.add_argument("--drain-timeout", type=float, default=None,
                   metavar="SECS",
                   help="how long a resize waits for the drain before it "
                        "kills (default 60)")
    p.add_argument("--fault", default=None, metavar="SPEC",
                   help="arm fault injection (MX_FAULT_INJECT) in every "
                        "process, e.g. 'worker.step:crash:after=5' or "
                        "'kvstore.send:close:after=3'")
    p.add_argument("--ps-snapshot-dir", default=None, metavar="DIR",
                   help="keep each parameter server's store under DIR, so "
                        "a restarted server loses nothing")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args, unknown = p.parse_known_args(argv)
    flags = [u.split("=", 1)[0] for u in unknown if u.startswith("-")]
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
    # a flag is honoured or refused by name, never dropped
    given = [flag for flag, attr, unset in SUPERVISION
             if getattr(args, attr) != unset]
    if args.launcher == "manual" and given:
        p.error("%s: the manual launcher starts nothing to supervise"
                % ", ".join(given))
    if args.launcher == "ssh" and not args.hostfile:
        p.error("--launcher ssh needs -H hostfile")
    if args.hostfile and args.launcher != "ssh":
        p.error("-H: the hostfile is read by --launcher ssh alone")
    if args.resize_file and not args.elastic:
        p.error("--resize-file requires --elastic")
    if args.drain_timeout is not None and not args.resize_file:
        p.error("--drain-timeout: only a --resize-file resize drains")
    if args.max_restarts is not None and args.restart in (None, "never"):
        p.error("--max-restarts: restarts need --restart on-failure")
    args.restart = args.restart or "never"
    if args.max_restarts is None:
        args.max_restarts = 3
    if args.launcher == "manual":
        return launch_manual(args, command)
    if args.launcher == "ssh":
        return launch_ssh(args, command)
    return launch_local(args, command)


if __name__ == "__main__":
    sys.exit(main())
