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

**The serving tier.**  ``--serve-port-base B`` says the command is a
serving replica bound at ``B + rank`` (its own ``--port-base``): each
replica is supervised as a ``serve`` process and scraped over METRICS by
the supervisor's embedded fleet collector (``fleet.FleetCollector``; it
also reads the workers' heartbeat files and the parameter servers'
METRICS, and the status table reads its merged snapshot;
``MX_FLEET_INTERVAL=0`` opts out, and a collector that cannot start
leaves the heartbeat table, with a logged line).  ``--route PORT`` fronts
the replicas with the session router (``python -m
mxnet_tpu_torch.serve.router``, a host process: it is given the CPU)
reading a replicas file that the supervisor rewrites, and the
collector's FLEET port for its load signals.  ``--autoscale MIN:MAX``
arms the SLO-burn autoscaler: when any fleet SLO burn (targets by
``MX_FLEET_SLO_*``) holds at or above ``MX_AUTOSCALE_UP_BURN`` for
``MX_AUTOSCALE_HOLD`` scrape rounds a replica is spawned; when every burn
holds at or below ``MX_AUTOSCALE_DOWN_BURN`` the newest replica is retired
drain-not-kill: dropped from the replicas file first (the router stops
admitting to it), then sent the wire DRAIN, and killed only when the
DRAIN cannot be delivered.  Each action arms a ``fault.RetryPolicy``
cooldown (``MX_AUTOSCALE_COOLDOWN``).  A replica past its restart budget
is retired involuntarily while others serve; replicas and the router
count as workers for the job's end (a STOP through the router ends it).
``--compile-cache DIR`` gives ``MX_COMPILE_CACHE`` to every worker,
server and replica (restarts included), so a respawned or autoscaled
process loads its kernel libraries instead of running ``nvcc``.

``--launcher ssh -H hostfile`` starts rank r on the hostfile's line r by
``ssh`` and only waits: supervision needs the processes' lifetimes,
which an ssh client does not give, so ``--restart``,
``--hang-timeout``, ``--elastic`` / ``--resize-file``, ``-s`` and the
serving tier's flags are refused there.  ``--launcher manual`` prints
each rank's environment and command.
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
from ..base import get_env
from ..health import WATCHDOG_EXIT_CODE

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


def send_drain(addr: str, drain_timeout=None, timeout: float = 5.0) -> None:
    """The serve wire DRAIN (drain-not-kill retirement): the replica stops
    admitting, finishes what is in flight against its deadline
    (``drain_timeout``, else its own ``MX_SERVE_DRAIN_TIMEOUT``) and exits
    0.  DRAIN is idempotent: a retry keeps the first deadline."""
    msg = ("DRAIN",) if drain_timeout is None \
        else ("DRAIN", float(drain_timeout))
    _rpc(addr, msg, timeout)


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
        self.role = role              # "worker"|"server"|"serve"|"router"
        self.addr = addr              # host:port (servers, replicas)
        self.draining = False         # a replica whose retirement is on
        self.heartbeat = heartbeat    # liveness file or None
        self.fleet_key = None         # this process's fleet member id
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
    """Restart-and-resume process supervisor, with the embedded fleet
    collector, the serving tier and its autoscaler (the reference's).

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
        self.fleet = None             # the embedded FleetCollector
        # the serving tier: --route / --autoscale wiring
        self.replicas_file = None     # the router's replica list
        self.fleet_port = None        # FLEET wire port (router signals)
        self.autoscale = None         # (min, max) replicas, or None
        self.serve_factory = None     # index -> (name, argv, env, addr,
                                      #           heartbeat)
        self._as_next_index = 0       # the next spawned replica's rank
        self._as_up_hold = 0          # consecutive rounds burn >= up
        self._as_down_hold = 0        # consecutive rounds burn <= down
        self._as_last_round = None    # the last scrape round read
        self._as_last_dir = None      # the last action's direction
        self._as_streak = 0           # consecutive same-direction acts
        self._as_cooldown_until = 0.0
        self._as_policy = None        # the cooldown's RetryPolicy

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

    # -- the embedded fleet collector ---------------------------------------
    def _start_collector(self):
        """Embed a fleet collector: workers through their heartbeat files,
        parameter servers, replicas and the router over METRICS.  The
        status table, crash dumps, the router (over FLEET) and the
        autoscaler read its merged snapshot.  ``MX_FLEET_INTERVAL=0`` opts
        out; any failure leaves the heartbeat-only table, never a dead
        supervisor.  Host code: it never touches a device."""
        if self.fleet is not None:
            return
        candidates = [sp for sp in self.procs
                      if sp.heartbeat or (sp.role in ("server", "serve",
                                                      "router")
                                          and sp.addr)]
        if not candidates:
            return
        try:
            from .. import fleet as _fleet
            interval = get_env("MX_FLEET_INTERVAL", 2.0, float)
            if not interval or interval <= 0:
                return      # MX_FLEET_INTERVAL=0 opts the embed out
            members = []
            nsrv = 0
            for sp in candidates:
                if sp.role in ("serve", "router") and sp.addr:
                    rank = sp.env.get("MX_PROCESS_ID",
                                      "0" if sp.role == "router"
                                      else len(members))
                    m = _fleet.FleetMember(sp.role, rank, addr=sp.addr)
                elif sp.heartbeat:
                    rank = sp.env.get("MX_PROCESS_ID", len(members))
                    m = _fleet.FleetMember("worker", rank,
                                           heartbeat=sp.heartbeat)
                else:
                    m = _fleet.FleetMember("server", nsrv, addr=sp.addr)
                    nsrv += 1
                sp.fleet_key = m.key
                members.append(m)
            self.fleet = _fleet.FleetCollector(members).start(
                port=self.fleet_port)
        except Exception as e:
            self.log("fleet collector unavailable (%s); falling back to "
                     "heartbeat-only status" % e)
            self.fleet = None

    def _stop_collector(self):
        if self.fleet is not None:
            try:
                self.fleet.stop()
            except Exception:
                pass

    def _retire_member(self, sp):
        if self.fleet is not None and sp.fleet_key:
            try:
                self.fleet.retire(sp.fleet_key)
            except Exception:
                pass

    def status_table(self):
        """One row a supervised process, from its heartbeat payload; the
        absent and straggler flags and the latched SLO breaches from the
        collector's merged snapshot when it runs."""
        snap = self.fleet.snapshot() if self.fleet is not None else None
        fleet_members = (snap or {}).get("members") or {}
        stragglers = {f.get("member"): f
                      for f in (snap or {}).get("stragglers") or []}
        cols = ("proc", "state", "restarts", "step", "epoch",
                "steps/s", "img/s", "wire KB", "beat age", "flags")
        rows = [cols]
        for sp in self.procs:
            age, _head, p = self._read_beat(sp)
            flags = []
            meta = fleet_members.get(sp.fleet_key)
            if meta is not None and not meta.get("present") and \
                    not sp.done:
                flags.append("ABSENT")
            f = stragglers.get(sp.fleet_key)
            if f:
                flags.append("STRAGGLER(%.3gx %s)"
                             % (f.get("ratio", 0),
                                f.get("dominant_phase") or "?"))
            rows.append((
                sp.name, self._state_of(sp), str(sp.restarts),
                str(p.get("step", "-")), str(p.get("epoch", "-")),
                "%.3g" % p["steps_per_sec"] if "steps_per_sec" in p
                else "-",
                "%.4g" % p["throughput"] if "throughput" in p else "-",
                "%.1f" % (p["wire_bytes"] / 1024.0)
                if "wire_bytes" in p else "-",
                "%.1fs" % age if age is not None else "-",
                " ".join(flags) or "-"))
        widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
                 for r in rows]
        sep = "-" * len(lines[0])
        out = ["fleet status:", sep] + lines + [sep]
        slo = (snap or {}).get("slo") or {}
        breached = sorted(slo.get("breached") or {})
        if breached:
            out.append("SLO BREACH (latched): %s" % ", ".join(breached))
        return "\n".join(out)

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
            if self.fleet is not None:
                # what the rest of the job was doing when this one died
                try:
                    blob["fleet"] = self.fleet.snapshot()
                except Exception:
                    blob["fleet"] = None
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
                self._retire_member(sp)
                return True
            serving = [w for w in self.procs
                       if w is not sp and w.role == "serve" and not w.done]
            if sp.role == "serve" and serving:
                # involuntary retire: the serve tier shrinks and goes on
                # (the router failed the replica's sessions over at its
                # first dead forward); it leaves the replicas file and
                # the collector
                self.log("%s failed (%s) past its restart budget (%d) - "
                         "involuntary retire: serving continues on %d "
                         "replica(s)" % (sp.name, self._describe(rc),
                                         self.max_restarts, len(serving)))
                sp.rc = rc      # done, not folded: the survivors' code
                self._write_replicas_file()
                self._retire_member(sp)
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
        if self.fleet is not None:
            # the collector's members are fixed at its start: rebuild it
            # over the new world
            self._stop_collector()
            self.fleet = None
            self._start_collector()

    # -- the serving autoscaler ----------------------------------------------
    def _serve_procs(self, live_only=True):
        return [sp for sp in self.procs
                if sp.role == "serve" and not sp.done
                and not (live_only and sp.draining)]

    def _write_replicas_file(self):
        """Rewrite the router's replica list atomically: live replicas
        that are not draining.  Dropping an address here is a
        retirement's first step: the router stops admitting to it before
        the replica is asked to DRAIN."""
        if not self.replicas_file:
            return
        addrs = [sp.addr for sp in self._serve_procs() if sp.addr]
        tmp = "%s.tmp.%d" % (self.replicas_file, os.getpid())
        with open(tmp, "w") as f:
            f.write("".join(a + "\n" for a in addrs))
        os.replace(tmp, self.replicas_file)

    @staticmethod
    def _as_env(name, default):
        try:
            v = get_env(name, default, float)
            return float(default if v is None else v)
        except (TypeError, ValueError):
            return float(default)

    def _check_autoscale(self):
        """One evaluation a fleet scrape round: the worst SLO burn must
        hold past the hysteresis band for ``MX_AUTOSCALE_HOLD`` rounds
        before an action, and each action arms a backed-off cooldown."""
        if not (self.autoscale and self.serve_factory
                and self.fleet is not None):
            return
        try:
            snap = self.fleet.snapshot()
        except Exception:
            return
        if not snap:
            return
        round_id = snap.get("scrape")
        if round_id is None or round_id == self._as_last_round:
            return                      # nothing new to read
        self._as_last_round = round_id
        burn = (snap.get("slo") or {}).get("burn") or {}
        vals = [float(v) for v in burn.values()
                if isinstance(v, (int, float))]
        worst = max(vals, default=0.0)
        up_t = self._as_env("MX_AUTOSCALE_UP_BURN", 1.0)
        down_t = self._as_env("MX_AUTOSCALE_DOWN_BURN", 0.5)
        hold = max(1, int(self._as_env("MX_AUTOSCALE_HOLD", 3)))
        if worst >= up_t:
            self._as_up_hold += 1
            self._as_down_hold = 0
        elif worst <= down_t:
            self._as_down_hold += 1
            self._as_up_hold = 0
        else:
            # inside the hysteresis band: hold steady both ways
            self._as_up_hold = self._as_down_hold = 0
        self.log("autoscale: round %s burn %.4g (up hold %d, down hold "
                 "%d)" % (round_id, worst, self._as_up_hold,
                          self._as_down_hold))
        if self._now() < self._as_cooldown_until:
            return
        mn, mx = self.autoscale
        n_live = len(self._serve_procs())
        if self._as_up_hold >= hold and n_live < mx:
            self._scale_up(worst, up_t, n_live)
        elif self._as_down_hold >= hold and n_live > mn:
            self._scale_down(worst, down_t, n_live)

    def _as_arm_cooldown(self, direction):
        if self._as_last_dir == direction:
            self._as_streak += 1
        else:
            self._as_streak = 0
            self._as_last_dir = direction
        base = max(0.1, self._as_env("MX_AUTOSCALE_COOLDOWN", 10.0))
        if self._as_policy is None or self._as_policy.base != base:
            self._as_policy = _fault.RetryPolicy(
                deadline=float("inf"), base=base, max_delay=8.0 * base,
                jitter=0.1)
        self._as_cooldown_until = self._now() + \
            self._as_policy.delay(min(self._as_streak, 3))
        self._as_up_hold = self._as_down_hold = 0

    def _scale_up(self, worst, up_t, n_live):
        idx = self._as_next_index
        self._as_next_index += 1
        name, argv, env, addr, heartbeat = self.serve_factory(idx)
        sp = self.add(name, argv, env, role="serve", addr=addr,
                      heartbeat=heartbeat)
        self._spawn(sp)
        self._write_replicas_file()
        self.log("autoscale: burn %.3g >= %.3g held - spawning %s at %s "
                 "(%d -> %d replicas)"
                 % (worst, up_t, name, addr, n_live, n_live + 1))
        if self.fleet is not None:
            try:
                from .. import fleet as _fleet
                m = _fleet.FleetMember("serve", idx, addr=addr)
                sp.fleet_key = m.key
                self.fleet.add_member(m)
            except Exception:
                pass
        self._as_arm_cooldown("up")

    def _scale_down(self, worst, down_t, n_live):
        victims = self._serve_procs()
        if not victims:
            return
        sp = victims[-1]                # the newest replica retires first
        sp.draining = True
        self._write_replicas_file()     # the router's admission closes first
        self.log("autoscale: burn %.3g <= %.3g held - retiring %s "
                 "drain-not-kill (%d -> %d replicas)"
                 % (worst, down_t, sp.name, n_live, n_live - 1))
        try:
            send_drain(sp.addr)
        except OSError as e:
            # dead or wedged: the DRAIN could not be delivered, so the
            # supervisor kills it (clients fail over and replay)
            self.log("%s: DRAIN failed (%s); killing it" % (sp.name, e))
            self._kill(sp)
        if self.fleet is not None:
            self._retire_member(sp)
            try:
                # the spike this answers is over: un-latch the breaches
                # so the next one is a fresh signal
                self.fleet.slo.reset()
            except Exception:
                pass
        self._as_arm_cooldown("down")

    # -- run ----------------------------------------------------------------
    def _teardown(self):
        for sp in self.procs:
            self._kill(sp)
            if sp.rc is None:
                sp.rc = 0 if sp.proc is None else (sp.proc.poll() or 0)

    def run(self):
        """Spawn everything, supervise until every worker (replicas and the
        router included) is done, then stop the servers.  Returns the
        job's exit code."""
        for sp in self.procs:
            self._spawn(sp)
        if self.status_interval is not None or self.hang_timeout \
                or self.replicas_file or self.autoscale:
            # the fleet plane rides the status table's and hang
            # detection's provisioning; the router and the autoscaler
            # need it for their signals
            self._start_collector()
        try:
            while True:
                # a resize swaps the worker set: read it fresh each tick
                self._check_resize()
                self._check_autoscale()
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
                # replicas and the router count as workers: the job ends
                # when every process but the servers is done (a STOP
                # through the router stops the whole tier)
                if all(w.done for w in self.procs if w.role != "server"):
                    break
                self._maybe_status()
                self._sleep_poll()
        except BaseException:
            # ^C or a supervisor fault (a respawn's Popen failing): never
            # leave processes running unsupervised
            self._teardown()
            raise
        finally:
            self._stop_collector()
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

def _parse_autoscale(spec):
    """(MIN, MAX) of ``--autoscale MIN:MAX``, refused with the reference's
    texts."""
    try:
        mn, mx = (int(x) for x in str(spec).split(":", 1))
    except ValueError:
        raise SystemExit("launch: --autoscale wants MIN:MAX (got %r)"
                         % (spec,))
    if not (1 <= mn <= mx):
        raise SystemExit("launch: --autoscale needs 1 <= MIN <= MAX")
    return mn, mx


def launch_local(args, command) -> int:
    """Run ``command`` as ranks 0..n-1 on this host (as serving replicas
    with ``--serve-port-base``, behind the router with ``--route``),
    beside ``args.num_servers`` parameter servers, under a
    :class:`Supervisor`; returns the job's exit code."""
    serve_base = getattr(args, "serve_port_base", None)
    route_port = getattr(args, "route", None)
    autoscale = getattr(args, "autoscale", None)
    if (route_port is not None or autoscale) and serve_base is None:
        raise SystemExit("launch: --route/--autoscale need "
                         "--serve-port-base B (the replicas' --port-base, "
                         "so the supervisor knows their addrs)")
    bounds = _parse_autoscale(autoscale) if autoscale else None
    coordinator = "127.0.0.1:%d" % _free_port()
    sup = _make_supervisor(args)
    n = args.num_workers
    fault_spec = getattr(args, "fault", None)
    hb_dir = tempfile.mkdtemp(prefix="mx-heartbeat-") \
        if sup.hang_timeout or sup.status_interval else None
    # one resolved cache directory in every process's env, restarts
    # included: a respawned process loads its kernel libraries from it
    cache = getattr(args, "compile_cache", None)
    if cache:
        cache = os.path.abspath(cache)
        os.makedirs(cache, exist_ok=True)
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
        if cache:
            env["MX_COMPILE_CACHE"] = cache
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
        if cache:
            env["MX_COMPILE_CACHE"] = cache
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

    def make_replica(index):
        """(name, argv, env, addr, heartbeat) of replica ``index``, bound
        at serve-port-base + index: the first spawn's and every scale-up's
        (an autoscaled replica's rank runs past -n)."""
        name, argv, env, heartbeat = make_worker(index, n, 0)
        return (name, argv, env, "127.0.0.1:%d" % (serve_base + index),
                heartbeat)

    for rank in range(n):
        if serve_base is not None:
            name, argv, env, addr, heartbeat = make_replica(rank)
            sup.add(name, argv, env, role="serve", addr=addr,
                    heartbeat=heartbeat)
        else:
            name, argv, env, heartbeat = make_worker(rank, n, 0)
            sup.add(name, argv, env, role="worker", heartbeat=heartbeat)
    rt_dir = None
    if route_port is not None:
        rt_dir = tempfile.mkdtemp(prefix="mx-router-")
        sup.replicas_file = os.path.join(rt_dir, "replicas.txt")
        sup.fleet_port = _free_port()
        sup._write_replicas_file()
        env = dict(os.environ)
        # the router is host code: it is given the CPU, and never opens a
        # CUDA context
        env.update({"MX_FORCE_CPU": "1", "CUDA_VISIBLE_DEVICES": "",
                    "PYTHONPATH": ROOT + os.pathsep +
                    env.get("PYTHONPATH", "")})
        if fault_spec:
            # the router's own chaos sites take the same spec
            env["MX_FAULT_INJECT"] = fault_spec
        heartbeat = None
        if hb_dir:
            heartbeat = os.path.join(hb_dir, "router")
            env["MX_HEARTBEAT_FILE"] = heartbeat
        sup.add("router",
                [sys.executable, "-m", "mxnet_tpu_torch.serve.router",
                 "--port", str(route_port),
                 "--replicas-file", sup.replicas_file,
                 "--fleet", "127.0.0.1:%d" % sup.fleet_port],
                env, role="router", addr="127.0.0.1:%d" % route_port,
                heartbeat=heartbeat)
    if bounds:
        sup.autoscale = bounds
        sup.serve_factory = make_replica
        sup._as_next_index = n
    sup.ps_addrs = list(ps_roots)
    if elastic:
        sup.worker_factory = make_worker
        sup._resize_applied = n
    try:
        return sup.run()
    finally:
        if hb_dir:
            shutil.rmtree(hb_dir, ignore_errors=True)
        if rt_dir:
            shutil.rmtree(rt_dir, ignore_errors=True)


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


#: supervision and serving-tier flags: (flag, attribute, its value when
#: not given)
SUPERVISION = (("--restart", "restart", None),
               ("--max-restarts", "max_restarts", None),
               ("--hang-timeout", "hang_timeout", None),
               ("--status-interval", "status_interval", None),
               ("--elastic", "elastic", False),
               ("--resize-file", "resize_file", None),
               ("--drain-timeout", "drain_timeout", None),
               ("--serve-port-base", "serve_port_base", None),
               ("--route", "route", None),
               ("--autoscale", "autoscale", None),
               ("--compile-cache", "compile_cache", None))


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
    p.add_argument("--serve-port-base", type=int, default=None,
                   metavar="PORT",
                   help="the command is a serving replica bound at PORT + "
                        "rank (its own --port-base): each replica is a "
                        "'serve' member of the embedded fleet collector, "
                        "scraped over METRICS")
    p.add_argument("--route", type=int, default=None, metavar="PORT",
                   help="front the replicas with the session router "
                        "(python -m mxnet_tpu_torch.serve.router) on PORT, "
                        "fed by a replicas file the supervisor rewrites and "
                        "by the collector's FLEET port; needs "
                        "--serve-port-base")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                   help="SLO-burn autoscaler: spawn a replica when any "
                        "fleet SLO burn (MX_FLEET_SLO_* targets) holds >= "
                        "MX_AUTOSCALE_UP_BURN, retire the newest by DRAIN "
                        "when every burn holds <= MX_AUTOSCALE_DOWN_BURN; "
                        "needs --serve-port-base")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="persistent compile cache (MX_COMPILE_CACHE in "
                        "every worker, server and replica, restarts "
                        "included): a respawned process loads its kernel "
                        "libraries from DIR instead of running nvcc")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args, unknown = p.parse_known_args(argv)
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
