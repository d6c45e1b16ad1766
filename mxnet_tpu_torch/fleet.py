"""Fleet telemetry plane: cross-process metrics aggregation, straggler
and SLO detection, and the merged-snapshot API.

Counterpart of ``mxnet_tpu/fleet.py``, host Python throughout, with the
reference's behaviour line for line:

* **FleetCollector** -- periodically scrapes every registered
  :class:`FleetMember`: serve replicas and parameter servers over their
  METRICS wire verb (``fmt='json'``: the registry snapshot), training
  workers from their heartbeat files' JSON payload (written by
  :class:`~mxnet_tpu_torch.health.Heartbeat`).  Per-process snapshots
  merge into fleet rollups with exact algebra: counters SUM (a member's
  restart resets are rebased, never double-counted and never backwards),
  gauges keep per-member values plus min/mean/max, histograms merge
  bucket-wise (mismatched boundaries are rejected loudly).  Snapshots
  retain in a bounded ring (``MX_FLEET_RING``).

* **Detectors** -- a straggler detector for training (windowed per-rank
  step duration against the fleet's lower median; a rank over
  ``MX_FLEET_STRAGGLER_FACTOR`` x is flagged with its dominant phase) and
  an SLO tracker for serving (rolling p50/p99 from the merged
  ``MX_FLEET_SLO_PHASES`` histograms, rejection-rate and queue-depth burn
  against the ``MX_FLEET_SLO_*`` targets, ``fleet.slo_burn{slo=...}``
  gauges with latched breach events).

* **Two faces** -- the FLEET wire verb (the merged snapshot as a typed
  JSN payload: what the serving router reads its load signals from) and
  a Prometheus federation endpoint (one scrape = the whole fleet, every
  member's series re-labelled ``role``/``rank``/``model``).  Crash dumps
  gain a ``fleet`` section (the last merged snapshot).

The scrape and merge loop never touches a device (this module imports no
torch and no numpy).  Logic runs on :func:`mxnet_tpu_torch.fault.now`;
wall stamps are only for humans reading dumps.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import fault as _fault
from . import telemetry as _telemetry
from .base import MXNetError, get_env
from .kvstore.wire_codec import decode_json, decode_text, encode_json, \
    encode_text, recv_msg, send_msg
from .kvstore.wire_verbs import declare_verbs

__all__ = [
    "SCHEMA", "FleetMergeError", "FleetMember", "FleetCollector",
    "StragglerDetector", "SLOTracker",
    "merge_bucket_maps", "quantile_from_buckets", "merge_snapshots",
    "serve_fleet", "fetch_fleet", "fetch_metrics", "replica_signals",
]

# FLEET payload schema, the reference's: 2: member rows carry their
# scrape ``addr``, so the router maps per-member gauges back to the
# replica address it forwards to; 3: a ``models`` section rolls
# model-labelled serve.* counters up per co-hosted model.
SCHEMA = 3

# The fleet wire surface, declared as the reference declares it.
# Read-only by construction: the collector never mutates a member.
WIRE_VERBS = declare_verbs("fleet", {
    # merged fleet snapshot as one typed JSN payload: what the serving
    # router reads
    "FLEET": {"semantics": "idempotent", "replay": "bypass",
              "codec": "json", "mutates": ()},
    # whole-fleet federation exposition (or the collector's own
    # registry as json) — same contract as the serve/kvstore scrape
    "METRICS": {"semantics": "idempotent", "replay": "bypass",
                "codec": "text", "mutates": ()},
}, role="collector", handler="serve_fleet.Handler.handle")


class FleetMergeError(MXNetError):
    """Merge-algebra violation (e.g. histogram boundary mismatch)."""


# ---------------------------------------------------------------------------
# merge algebra (pure)
# ---------------------------------------------------------------------------

def _entry_name(key: str, entry: Dict[str, Any]) -> str:
    return entry.get("name") or key.split("{", 1)[0]


def merge_bucket_maps(maps: Sequence[Dict[str, Any]],
                      name: str = "?") -> Dict[str, int]:
    """Bucket-wise merge of cumulative histogram bucket maps.

    Exact by construction: cumulative counts on IDENTICAL boundaries
    add; any boundary mismatch means the members were configured
    differently and a silent merge would fabricate quantiles — rejected
    with a :class:`FleetMergeError` naming the instrument."""
    maps = [m for m in maps if m]
    if not maps:
        return {}
    keys = set(maps[0])
    for m in maps[1:]:
        if set(m) != keys:
            raise FleetMergeError(
                "fleet: histogram %r bucket boundaries differ across "
                "members (%r vs %r) - refusing to merge mismatched "
                "buckets" % (name, sorted(keys), sorted(m)))
    return {k: int(sum(m[k] for m in maps)) for k in keys}


def _sorted_bounds(buckets: Dict[str, Any]) -> List[Tuple[float, str]]:
    out = []
    for k in buckets:
        if k == "+Inf":
            continue
        try:
            out.append((float(k), k))
        except ValueError:
            continue
    out.sort()
    return out


def quantile_from_buckets(buckets: Dict[str, Any], q: float) -> float:
    """q-quantile from a cumulative bucket map, upper-bound convention:
    the smallest bucket boundary whose cumulative count covers q of the
    total.  Both a merged histogram and its members use the same
    convention, so a correct merge reproduces per-member quantiles to
    within one bucket boundary exactly.

    Mass above the TOP bound reports the largest finite boundary (the
    Prometheus ``histogram_quantile`` convention) — an infinity here
    would ride the FLEET/``/fleet.json`` payloads as the non-RFC
    ``Infinity`` token and break every non-Python consumer."""
    total = buckets.get("+Inf", 0) or 0
    if total <= 0:
        return 0.0
    want = q * total
    bounds = _sorted_bounds(buckets)
    for bound, key in bounds:
        if buckets[key] >= want:
            return bound
    return bounds[-1][0] if bounds else 0.0


def merge_snapshots(member_snaps: Dict[str, Dict[str, Any]],
                    include_counters: bool = True) -> Dict[str, Any]:
    """Merge per-member registry snapshots (``Registry.snapshot()``
    dicts keyed by member id) into one fleet rollup:

    counters  -> ``{"total", "per_member"}`` (summed RAW values; the
                 collector passes ``include_counters=False`` and
                 substitutes its restart-REBASED running totals — use
                 this pure form only when no member ever restarts)
    gauges    -> ``{"per_member", "min", "mean", "max"}``
    histograms-> ``{"buckets", "count", "sum", "p50", "p99"}``
                 (bucket-wise exact merge)

    Pure function of its inputs — restart rebasing is the collector's
    job (it owns the per-member history); tests drive this directly."""
    counters: Dict[str, Dict[str, Any]] = {}
    gauges: Dict[str, Dict[str, Any]] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for mid in sorted(member_snaps):
        snap = member_snaps[mid] or {}
        for key, entry in snap.items():
            if not isinstance(entry, dict):
                continue
            kind = entry.get("type")
            if kind == "counter":
                if not include_counters:
                    continue
                slot = counters.setdefault(key, {"total": 0,
                                                 "per_member": {}})
                val = entry.get("value", 0) or 0
                slot["per_member"][mid] = val
                slot["total"] += val
            elif kind == "gauge":
                slot = gauges.setdefault(key, {"per_member": {}})
                slot["per_member"][mid] = entry.get("value", 0) or 0
            elif kind == "histogram":
                slot = hists.setdefault(key, {"_maps": [], "count": 0,
                                              "sum": 0.0})
                slot["_maps"].append(entry.get("buckets") or {})
                slot["count"] += entry.get("count", 0) or 0
                slot["sum"] += entry.get("sum", 0.0) or 0.0
    for slot in gauges.values():
        vals = list(slot["per_member"].values())
        slot["min"] = min(vals) if vals else 0
        slot["max"] = max(vals) if vals else 0
        slot["mean"] = (sum(vals) / len(vals)) if vals else 0.0
    for key, slot in hists.items():
        merged = merge_bucket_maps(slot.pop("_maps"), name=key)
        slot["buckets"] = merged
        slot["p50"] = quantile_from_buckets(merged, 0.50)
        slot["p99"] = quantile_from_buckets(merged, 0.99)
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def _lower_median(values: Sequence[float]) -> float:
    """Median with the LOWER element on even counts: with only two
    workers, [1x, 3x]'s lower median is 1x, so a 3x-slow rank still
    reads as 3x over 'the fleet' instead of 1.5x over the midpoint —
    exactly the two-rank chaos case the acceptance pins."""
    vs = sorted(values)
    if not vs:
        return 0.0
    return vs[(len(vs) - 1) // 2]


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Training straggler/skew detection over a sliding window.

    Per scrape round, each worker contributes its step duration
    (``1/steps_per_sec`` from the beat; falling back to the summed
    per-phase seconds) and its per-phase breakdown.  A worker whose
    windowed mean step duration exceeds ``factor`` x the fleet
    lower-median is a straggler; the finding names the member and its
    dominant phase (``data_wait`` share is the classic input-bound
    signature), so the operator knows WHAT is slow, not just WHO."""

    def __init__(self, factor: Optional[float] = None,
                 window: Optional[int] = None, min_members: int = 2):
        if factor is None:
            factor = get_env("MX_FLEET_STRAGGLER_FACTOR", 2.0, float) \
                or 2.0
        if window is None:
            window = get_env("MX_FLEET_WINDOW", 5, int) or 5
        self.factor = float(factor)
        self.window = max(1, int(window))
        self.min_members = max(2, int(min_members))
        self._hist: Dict[str, deque] = {}
        self._missed: Dict[str, int] = {}
        # guards _hist/_missed: the collector thread updates them every
        # scrape round while an elastic retire() (main/supervisor
        # thread) may drop a departed member mid-round
        self._guard = threading.Lock()

    def update(self, worker_stats: Dict[str, Dict[str, Any]]
               ) -> List[Dict[str, Any]]:
        """One scrape round of ``{member_id: {"step_seconds", "phases"}}``
        -> the current straggler findings (possibly empty)."""
        reported = set()
        with self._guard:
            for mid, st in worker_stats.items():
                dur = st.get("step_seconds")
                if dur is None or dur <= 0:
                    continue
                dq = self._hist.setdefault(mid,
                                           deque(maxlen=self.window))
                dq.append((float(dur), dict(st.get("phases") or {})))
                self._missed[mid] = 0
                reported.add(mid)
            # a member that stopped reporting a USABLE step duration —
            # absent, or present with an empty/unreadable payload — falls
            # out of the comparison, but only after a full window of
            # misses: one transient scrape failure must not reset a slow
            # rank's accumulated history (it would oscillate out of
            # detection exactly when it matters), while a permanently
            # silent one must not stay flagged on a frozen mean forever
            for mid in list(self._hist):
                if mid not in reported:
                    self._missed[mid] = self._missed.get(mid, 0) + 1
                    if self._missed[mid] > self.window:
                        self._hist.pop(mid)
                        self._missed.pop(mid, None)
            means = {mid: sum(d for d, _p in dq) / len(dq)
                     for mid, dq in self._hist.items() if dq}
            if len(means) < self.min_members:
                return []
            med = _lower_median(list(means.values()))
            if med <= 0:
                return []
            out = []
            for mid, mean_dur in sorted(means.items()):
                if mean_dur <= self.factor * med:
                    continue
                phases: Dict[str, float] = {}
                for _d, p in self._hist[mid]:
                    for k, v in p.items():
                        phases[k] = phases.get(k, 0.0) + float(v)
                total = sum(phases.values())
                dom, share = None, 0.0
                if phases:
                    dom = max(phases, key=lambda k: phases[k])
                    share = phases[dom] / total if total > 0 else 0.0
                out.append({"member": mid,
                            "step_seconds": round(mean_dur, 6),
                            "fleet_median_seconds": round(med, 6),
                            "ratio": round(mean_dur / med, 3),
                            "dominant_phase": dom,
                            "dominant_share": round(share, 4)})
            return out

    def retire(self, mid: str) -> None:
        """Drop a member from straggler tracking IMMEDIATELY (elastic
        membership): a worker that sent LEAVE — or was evicted
        from the kvstore membership table — is gone by protocol, not
        merely silent, so it must not sit in the window as a frozen mean
        (a false straggler flag on every voluntary shrink) or burn the
        full miss-window aging out."""
        with self._guard:
            self._hist.pop(mid, None)
            self._missed.pop(mid, None)


class SLOTracker:
    """Serving SLO burn over a sliding window of scrape deltas.

    Latency comes from the fleet-merged ``MX_FLEET_SLO_PHASES``
    histograms — per-round bucket DELTAS accumulate into a rolling
    window distribution whose p50/p99 are compared against the declared
    millisecond targets; rejection rate from merged ``serve.rejected``
    / ``serve.requests`` counter deltas; queue depth from the mean
    merged ``serve.queue_rows`` gauge.  Burn = observed/target; a burn
    over 1.0 LATCHES a breach event (it stays raised until
    :meth:`reset` — an alert that un-fires the moment load dips is an
    alert nobody sees)."""

    def __init__(self, window: Optional[int] = None,
                 targets: Optional[Dict[str, float]] = None):
        if window is None:
            window = get_env("MX_FLEET_WINDOW", 5, int) or 5
        self.window = max(1, int(window))
        if targets is None:
            targets = {}
            for slo, env in (("p50_latency", "MX_FLEET_SLO_P50_MS"),
                             ("p99_latency", "MX_FLEET_SLO_P99_MS"),
                             ("rejection_rate",
                              "MX_FLEET_SLO_REJECT_RATE"),
                             ("queue_depth", "MX_FLEET_SLO_QUEUE")):
                raw = get_env(env, "")
                if raw not in (None, ""):
                    try:
                        targets[slo] = float(raw)
                    except (TypeError, ValueError):
                        pass
        self.targets = {k: float(v) for k, v in targets.items()
                        if v and v > 0}
        # leaf lock: update() runs on the collector thread while
        # reset()/breach reads come from operators (main thread)
        self._lock = threading.Lock()
        self._lat = deque(maxlen=self.window)    # bucket-delta maps
        self._rej = deque(maxlen=self.window)    # (rejected, offered)
        self._breached: Dict[str, Dict[str, Any]] = {}

    @property
    def breached(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: dict(v) for k, v in self._breached.items()}

    def reset(self) -> None:
        """Un-latch every breach (operator acknowledged)."""
        with self._lock:
            self._breached = {}

    def update(self, latency_delta: Dict[str, int],
               rejected_delta: float, offered_delta: float,
               queue_depth: float) -> Dict[str, Any]:
        with self._lock:
            # empty rounds append too: the window must AGE OUT during
            # idle, or a spike's p99 burn would read hot forever on a
            # fleet serving no traffic (merge_bucket_maps drops empties)
            self._lat.append(latency_delta or {})
            self._rej.append((max(0.0, rejected_delta),
                              max(0.0, offered_delta)))
            window_map = merge_bucket_maps(list(self._lat),
                                           name="slo_latency_window") \
                if self._lat else {}
            rej = sum(r for r, _o in self._rej)
            off = sum(o for _r, o in self._rej)
        p50_ms = quantile_from_buckets(window_map, 0.50) * 1e3
        p99_ms = quantile_from_buckets(window_map, 0.99) * 1e3
        reject_rate = rej / off if off > 0 else 0.0
        observed = {"p50_latency": p50_ms, "p99_latency": p99_ms,
                    "rejection_rate": reject_rate,
                    "queue_depth": float(queue_depth)}
        burn: Dict[str, float] = {}
        with self._lock:
            for slo, target in self.targets.items():
                b = observed[slo] / target
                burn[slo] = round(b, 4)
                if b > 1.0 and slo not in self._breached:
                    self._breached[slo] = {
                        "slo": slo, "burn": round(b, 4),
                        "observed": round(observed[slo], 4),
                        "target": target, "ts": _fault.now()}
            breached = {k: dict(v) for k, v in self._breached.items()}
        return {"p50_ms": round(p50_ms, 4), "p99_ms": round(p99_ms, 4),
                "rejection_rate": round(reject_rate, 6),
                "queue_depth": round(float(queue_depth), 3),
                "targets": dict(self.targets), "burn": burn,
                "breached": breached}


# ---------------------------------------------------------------------------
# members + wire scraping
# ---------------------------------------------------------------------------

class FleetMember:
    """One scrape target: ``addr`` (host:port) members answer the
    METRICS wire verb; ``heartbeat`` members are read from their
    liveness file's JSON payload (degraded fallback — no wire server
    in a training worker)."""

    __slots__ = ("role", "rank", "addr", "heartbeat", "model")

    def __init__(self, role: str, rank, addr: Optional[str] = None,
                 heartbeat: Optional[str] = None,
                 model: Optional[str] = None):
        if not addr and not heartbeat:
            raise MXNetError("FleetMember %s:%s needs an addr (wire "
                             "METRICS) or a heartbeat file path"
                             % (role, rank))
        self.role = str(role)
        self.rank = str(rank)
        self.addr = addr
        self.heartbeat = heartbeat
        self.model = model

    @property
    def key(self) -> str:
        return "%s:%s" % (self.role, self.rank)

    def __repr__(self):
        return "FleetMember(%s, %s)" % (
            self.key, self.addr or self.heartbeat)


def fetch_metrics(addr: str, fmt: str = "json", timeout: float = 5.0):
    """Scrape one member's METRICS verb (serve replica, PS server, or a
    fleet collector's wire server).  ``fmt='json'`` returns the decoded
    registry-snapshot dict; ``'prometheus'`` the exposition text."""
    with _telemetry.rpc_span("fleet.scrape.METRICS") as span:
        span.event("scrape", addr=addr, fmt=fmt)
        host, _, port = addr.rpartition(":")
        sock = socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=timeout)
        try:
            sock.settimeout(timeout)
            send_msg(sock, ("METRICS", fmt))
            ok, payload = recv_msg(sock, timeout=timeout)
        finally:
            try:
                sock.close()
            except OSError:
                pass
    if not ok:
        raise MXNetError("fleet: %s answered METRICS: %s"
                         % (addr, payload))
    text = decode_text(payload)
    return json.loads(text) if fmt == "json" else text


def fetch_fleet(addr: str, timeout: float = 5.0) -> Dict[str, Any]:
    """Fetch the merged fleet snapshot over the FLEET wire verb — the
    call the serving router makes."""
    with _telemetry.rpc_span("fleet.client.FLEET") as span:
        span.event("fetch", addr=addr)
        host, _, port = addr.rpartition(":")
        sock = socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=timeout)
        try:
            sock.settimeout(timeout)
            send_msg(sock, ("FLEET",))
            ok, payload = recv_msg(sock, timeout=timeout)
        finally:
            try:
                sock.close()
            except OSError:
                pass
    if not ok:
        raise MXNetError("fleet: %s answered FLEET: %s" % (addr, payload))
    return decode_json(payload)


def replica_signals(snapshot: Optional[Dict[str, Any]],
                    role: str = "serve") -> Dict[str, Dict[str, Any]]:
    """The router-consumable signal surface: one merged
    FLEET snapshot -> ``{replica addr: load signals}`` for every
    ``role`` member that carries a scrape address.

    Pure function of the schema-2 payload, so the router, the
    autoscaler, and tests all read the SAME projection: per-replica
    queue depth (``serve.queue_rows`` + decode admission queue), decode
    slot occupancy, KV-pool admission headroom, and cumulative
    rejections (the caller differences these for burn).  Members whose
    row predates schema 2 (no ``addr``) are skipped — a router must
    never route to an address it cannot name."""
    out: Dict[str, Dict[str, Any]] = {}
    if not isinstance(snapshot, dict):
        return out
    gauges = snapshot.get("gauges") or {}
    counters = snapshot.get("counters") or {}

    def _per_member(table, name):
        slot = table.get(name) or {}
        return slot.get("per_member") or {}

    queue = _per_member(gauges, "serve.queue_rows")
    dqueue = _per_member(gauges, "serve.decode.queue")
    active = _per_member(gauges, "serve.decode.active_slots")
    occupancy = _per_member(gauges, "serve.decode.slot_occupancy")
    headroom = _per_member(gauges, "serve.decode.kv_headroom_bytes")
    # paged replicas additionally publish page-level
    # headroom + sharing savings; flat replicas simply lack the gauges
    # (keys default to 0/absent — same schema 2, router math unchanged:
    # kv_headroom_bytes already means "admission headroom in bytes" on
    # both engines)
    free_pages = _per_member(gauges, "serve.decode.kv_free_pages")
    shared_saved = _per_member(gauges,
                               "serve.decode.kv_shared_saved_bytes")
    rejected = _per_member(counters, "serve.rejected")
    d_rejected = _per_member(counters, "serve.decode.rejected")
    for key, meta in (snapshot.get("members") or {}).items():
        if not isinstance(meta, dict) or meta.get("role") != role:
            continue
        addr = meta.get("addr")
        if not addr:
            continue
        out[str(addr)] = {
            "member": key,
            "present": bool(meta.get("present")),
            "queue_rows": queue.get(key, 0) or 0,
            "decode_queue": dqueue.get(key, 0) or 0,
            "active_slots": active.get(key, 0) or 0,
            "slot_occupancy": occupancy.get(key, 0.0) or 0.0,
            "kv_headroom_bytes": headroom.get(key, 0) or 0,
            "kv_free_pages": free_pages.get(key),
            "kv_shared_saved_bytes": shared_saved.get(key, 0) or 0,
            "rejected": (rejected.get(key, 0) or 0)
            + (d_rejected.get(key, 0) or 0),
        }
    return out


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

class _MemberState:
    """Per-member scrape history the merge algebra needs: raw last
    snapshot, counter rebase offsets (restart discontinuities), and the
    previous histogram cumulative maps (window deltas)."""

    __slots__ = ("present", "absent_scrapes", "source", "age", "model",
                 "last_snap", "counter_raw", "counter_base",
                 "prev_hists", "malformed")

    def __init__(self):
        self.present = False
        self.absent_scrapes = 0
        self.source = None
        self.age: Optional[float] = None
        self.model: Optional[str] = None
        self.last_snap: Dict[str, Any] = {}
        self.counter_raw: Dict[str, float] = {}
        self.counter_base: Dict[str, float] = {}
        self.prev_hists: Dict[str, Dict[str, int]] = {}
        self.malformed = 0


# the process's most recently active collector: crash dumps embed its
# last merged snapshot as the `fleet` section, so a post-mortem shows
# what the REST of the job was doing when this process died
_active: List[Optional["FleetCollector"]] = [None]


def _fleet_crash_section():
    c = _active[0]
    return c.snapshot() if c is not None else None


_telemetry.register_crash_section("fleet", _fleet_crash_section)


class FleetCollector:
    """Scrape -> merge -> detect loop over a registered member set.

    Lock discipline: ``_lock`` is a leaf guarding the member/state/ring
    tables only — scraping (socket IO) happens OUTSIDE it, merge is
    pure, and registry instrument updates take their own leaf locks
    after ``_lock`` is released."""

    def __init__(self, members: Sequence[FleetMember] = (),
                 interval: Optional[float] = None,
                 ring: Optional[int] = None,
                 window: Optional[int] = None,
                 stale_after: Optional[float] = None,
                 straggler_factor: Optional[float] = None,
                 slo_targets: Optional[Dict[str, float]] = None,
                 scrape_timeout: float = 5.0, logger=None):
        if interval is None:
            interval = get_env("MX_FLEET_INTERVAL", 2.0, float) or 2.0
        self.interval = float(interval)
        if ring is None:
            ring = get_env("MX_FLEET_RING", 120, int) or 120
        if stale_after is None:
            # auto floor is 30s, not a couple of intervals: heartbeats
            # are rewritten per BATCH, and a slow rank stepping at 6-10s
            # must flag as a STRAGGLER, not flap absent/present (which
            # would also keep resetting its straggler window).  Jobs
            # with faster liveness needs set MX_FLEET_STALE explicitly.
            raw = get_env("MX_FLEET_STALE", "")
            try:
                stale_after = float(raw) if raw not in (None, "") else \
                    max(2.0 * self.interval, 30.0)
            except (TypeError, ValueError):
                stale_after = max(2.0 * self.interval, 30.0)
        self.stale_after = float(stale_after)
        self.scrape_timeout = float(scrape_timeout)
        self.logger = logger or logging
        self._lock = threading.Lock()
        self._members: Dict[str, FleetMember] = {}
        self._state: Dict[str, _MemberState] = {}
        self._ring: deque = deque(maxlen=max(1, int(ring)))
        self._scrapes = 0
        self._flagged: set = set()      # stragglers already warned about
        self.stragglers = StragglerDetector(factor=straggler_factor,
                                            window=window)
        self.slo = SLOTracker(window=window, targets=slo_targets)
        self._slo_phases = [p.strip() for p in str(
            get_env("MX_FLEET_SLO_PHASES", "queue_wait,serve_dispatch")
            or "").split(",") if p.strip()]
        self._prev_rates: Optional[Tuple[float, float]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # loop-ownership generation: stop() bumps it so a scrape loop
        # whose join timed out (stuck in socket IO) retires itself on
        # its next iteration instead of racing a restarted loop
        self._run_gen = 0
        self._wire_server = None
        self._http_server = None
        reg = _telemetry.registry
        self._g_members = reg.gauge(
            "fleet.members", doc="members present at the last scrape")
        self._g_absent = reg.gauge(
            "fleet.members_absent",
            doc="members that failed their last scrape (dead, "
                "unreachable, or heartbeat gone stale)")
        self._g_stragglers = reg.gauge(
            "fleet.stragglers",
            doc="workers currently over the straggler threshold "
                "(MX_FLEET_STRAGGLER_FACTOR x fleet median step time)")
        self._c_scrapes = reg.counter(
            "fleet.scrapes", doc="completed fleet scrape rounds")
        self._c_malformed = reg.counter(
            "fleet.malformed_beats",
            doc="heartbeat JSON payload lines that failed to parse "
                "(tolerated and counted; the beat itself still counts "
                "for liveness)")
        for m in members:
            self.add_member(m)

    # -- membership ---------------------------------------------------------
    def add_member(self, member: FleetMember) -> FleetMember:
        with self._lock:
            self._members[member.key] = member
            self._state.setdefault(member.key, _MemberState())
        return member

    def remove_member(self, key: str) -> None:
        with self._lock:
            self._members.pop(key, None)
            self._state.pop(key, None)

    def retire(self, key: str) -> None:
        """Elastic departure: a member that sent LEAVE (or
        was evicted by the kvstore membership table, or shrunk away by
        the supervisor) is retired from presence AND detector state in
        one step — unlike :meth:`remove_member` alone, this also clears
        its straggler window and any outstanding flag, so a voluntary
        shrink never false-alarms as a straggler/ABSENT member aging
        out over the miss-window.  All under _lock — the scrape thread
        mutates the same detector state mid-round."""
        with self._lock:
            self._members.pop(key, None)
            self._state.pop(key, None)
            self.stragglers.retire(key)
            self._flagged.discard(key)

    def members(self) -> List[FleetMember]:
        with self._lock:
            return list(self._members.values())

    # -- scraping -----------------------------------------------------------
    def _scrape_member(self, member: FleetMember):
        """(snapshot, source, age, malformed) or raises on failure."""
        if member.addr:
            snap = fetch_metrics(member.addr, fmt="json",
                                 timeout=self.scrape_timeout)
            return snap, "wire", None, 0
        return self._scrape_heartbeat(member)

    def _scrape_heartbeat(self, member: FleetMember):
        """Degraded fallback: the worker's liveness file.  Line 1 is
        the classic beat, line 2 the flight recorder's latest step
        record (telemetry.heartbeat_payload JSON).  A malformed JSON
        line is tolerated-and-counted — the beat still proves liveness.
        Synthesized into a minimal registry-shaped snapshot so one
        merge path serves both sources."""
        st = os.stat(member.heartbeat)
        # reading the liveness file IS this scrape path's job (the
        # degraded fallback for members with no wire face); it runs on
        # the collector's own thread at MX_FLEET_INTERVAL, never on a
        # dispatch path
        with open(member.heartbeat) as f:
            lines = f.read().splitlines()
        _head, payload, malformed = _telemetry.parse_heartbeat(lines)
        age = time.time() - st.st_mtime
        ts = payload.get("ts")
        if _fault.is_virtual() and isinstance(ts, (int, float)):
            # same-clock age: beats stamp fault.now(); comparing wall
            # mtime against a virtual supervisor clock would misfire
            age = max(0.0, _fault.now() - float(ts))
        if age > self.stale_after:
            raise MXNetError(
                "heartbeat %s stale for %.3gs (> %.3gs)"
                % (member.heartbeat, age, self.stale_after))
        snap: Dict[str, Any] = {}

        def gauge(name, value):
            snap[name] = {"type": "gauge", "name": name,
                          "value": float(value)}

        if isinstance(payload.get("step"), (int, float)):
            snap["worker.steps"] = {"type": "counter",
                                    "name": "worker.steps",
                                    "value": int(payload["step"])}
        for field in ("steps_per_sec", "throughput", "wire_bytes",
                      "dispatches", "retries", "nan_events", "epoch",
                      "batch"):
            if isinstance(payload.get(field), (int, float)):
                gauge("worker.%s" % field, payload[field])
        for pname, dur in (payload.get("phases") or {}).items():
            if isinstance(dur, (int, float)):
                key = "worker.phase_seconds{phase=%s}" % pname
                snap[key] = {"type": "gauge",
                             "name": "worker.phase_seconds",
                             "labels": {"phase": str(pname)},
                             "value": float(dur)}
        return snap, "heartbeat", age, malformed

    def scrape_once(self) -> Dict[str, Any]:
        """One scrape round: poll every member CONCURRENTLY (one dead
        host blocking a connect for scrape_timeout must not stall the
        whole round past the interval — the absent-within-one-scrape
        promise holds per member, not per fleet), then merge, run
        detectors, publish fleet gauges, append the merged snapshot to
        the ring.  Returns the merged snapshot (the FLEET verb's
        payload)."""
        _active[0] = self
        members = self.members()
        results: Dict[str, tuple] = {}
        res_lock = threading.Lock()

        def scrape_one(m):
            try:
                r = self._scrape_member(m)
            except (OSError, ValueError, MXNetError) as e:
                r = (None, None, None, str(e))
            with res_lock:
                results[m.key] = r

        threads = [threading.Thread(target=scrape_one, args=(m,),
                                    daemon=True,
                                    name="mx-fleet-scrape-%s" % m.key)
                   for m in members]
        for t in threads:
            t.start()
        deadline = _fault.Deadline(self.scrape_timeout + 1.0)
        for t in threads:
            t.join(timeout=max(0.05, deadline.remaining()))
        with res_lock:
            for m in members:
                # a scraper thread still stuck past the budget counts
                # as an absent member this round; its late result is
                # simply dropped (next round scrapes fresh)
                results.setdefault(m.key,
                                   (None, None, None, "scrape timed out"))
            snap_results = dict(results)
        merged = self._fold(members, snap_results)
        self._publish(merged)
        return merged

    def _fold(self, members, results) -> Dict[str, Any]:
        """Fold scrape results into member state + the merged snapshot
        (under the lock; no IO, no instrument updates)."""
        now_ts = _fault.now()
        malformed_total = 0
        with self._lock:
            self._scrapes += 1
            member_meta: Dict[str, Dict[str, Any]] = {}
            mergeable: Dict[str, Dict[str, Any]] = {}
            counter_totals: Dict[str, Dict[str, Any]] = {}
            lat_delta: Dict[str, int] = {}
            worker_stats: Dict[str, Dict[str, Any]] = {}
            for m in members:
                st = self._state.setdefault(m.key, _MemberState())
                snap, source, age, info = results.get(
                    m.key, (None, None, None, "not scraped"))
                if snap is None:
                    st.present = False
                    st.absent_scrapes += 1
                    st.age = None
                else:
                    was_restart = self._rebase_counters(st, snap)
                    lat_delta = merge_bucket_maps(
                        [lat_delta,
                         self._hist_delta(st, snap, was_restart)],
                        name="slo_latency_window")
                    st.present = True
                    st.absent_scrapes = 0
                    st.source = source
                    st.age = age
                    st.last_snap = snap
                    if isinstance(info, int) and info:
                        # malformed heartbeat JSON line: tolerated (the
                        # beat still proves liveness), but counted
                        st.malformed += info
                        malformed_total += info
                    st.model = m.model or self._model_of(snap) or st.model
                    if m.role == "worker":
                        worker_stats[m.key] = self._worker_stat(snap)
                # counters keep advancing monotonically from the last
                # known (rebased) values even while a member is absent
                for key, raw in st.counter_raw.items():
                    base = st.counter_base.get(key, 0)
                    slot = counter_totals.setdefault(
                        key, {"total": 0, "per_member": {}})
                    slot["per_member"][m.key] = base + raw
                    slot["total"] += base + raw
                if st.present:
                    mergeable[m.key] = st.last_snap
                member_meta[m.key] = {
                    "role": m.role, "rank": m.rank,
                    "present": st.present,
                    "absent_scrapes": st.absent_scrapes,
                    # schema 2: the scrape address rides the row so a
                    # router can map per-member signals -> replica addr
                    "addr": m.addr,
                    "source": st.source, "model": st.model,
                    "age": round(st.age, 3) if st.age is not None
                    else None,
                    "error": None if st.present else
                    (info if isinstance(info, str) else "scrape failed"),
                }
            # counters come from the rebased running totals, not the
            # raw present-member values (restart discontinuities and
            # absent members are already folded in) — so the pure merge
            # skips its counter pass entirely
            base_merge = merge_snapshots(mergeable,
                                         include_counters=False)
            base_merge["counters"] = counter_totals
            # per-model rollup (schema 3): every model-labeled
            # serve.* counter folds into a {model: {name: total}} map —
            # the multi-model replica's per-model traffic, fleet-wide
            model_rollup: Dict[str, Dict[str, Any]] = {}
            for key, slot in counter_totals.items():
                if "{" not in key or not key.startswith("serve."):
                    continue
                name, rest = key.split("{", 1)
                mdl = None
                for part in rest.rstrip("}").split(","):
                    if part.startswith("model="):
                        mdl = part[len("model="):]
                if mdl is not None:
                    model_rollup.setdefault(mdl, {})[name] = \
                        slot["total"]
            straggler_findings = self.stragglers.update(worker_stats)
            rejected_d, offered_d = self._rate_deltas(counter_totals)
            queue_depth = self._queue_depth(base_merge["gauges"])
            slo = self.slo.update(lat_delta, rejected_d, offered_d,
                                  queue_depth)
            merged = {
                "schema": SCHEMA,
                "ts": now_ts,
                "wall_time": time.time(),
                "scrape": self._scrapes,
                "interval": self.interval,
                "members": member_meta,
                "counters": base_merge["counters"],
                "gauges": base_merge["gauges"],
                "histograms": base_merge["histograms"],
                "models": model_rollup,
                "stragglers": straggler_findings,
                "slo": slo,
                "malformed_beats": malformed_total,
            }
            self._ring.append(merged)
        return merged

    @staticmethod
    def _model_of(snap) -> Optional[str]:
        """The replica's live model from its serve.active_version
        gauges.  After a hot-swap to a differently-named servable the
        OLD model's gauge persists in the registry — versions are
        monotonic across swaps (ModelHost enforces it), so the gauge
        with the HIGHEST version is the live one."""
        best_v, best_model = None, None
        for entry in snap.values():
            if isinstance(entry, dict) and \
                    entry.get("name") == "serve.active_version":
                v = entry.get("value", 0) or 0
                if best_v is None or v > best_v:
                    best_v = v
                    best_model = (entry.get("labels") or {}).get("model")
        return best_model

    @staticmethod
    def _worker_stat(snap) -> Dict[str, Any]:
        phases = {}
        for entry in snap.values():
            if isinstance(entry, dict) and \
                    entry.get("name") == "worker.phase_seconds":
                pname = (entry.get("labels") or {}).get("phase")
                if pname:
                    phases[pname] = entry.get("value", 0.0)
        sps = (snap.get("worker.steps_per_sec") or {}).get("value")
        if sps and sps > 0:
            dur = 1.0 / float(sps)
        elif phases:
            dur = sum(phases.values())
        else:
            dur = None
        return {"step_seconds": dur, "phases": phases}

    def _rebase_counters(self, st: _MemberState, snap) -> bool:
        """Track counter values per member; a raw value BELOW the last
        seen one means the member restarted (process counters reset):
        the previous total folds into the base so the fleet total never
        moves backwards and never double-counts.  Returns whether a
        restart discontinuity was detected."""
        restarted = False
        for key, entry in snap.items():
            if not isinstance(entry, dict) or \
                    entry.get("type") != "counter":
                continue
            raw = entry.get("value", 0) or 0
            last = st.counter_raw.get(key)
            if last is not None and raw < last:
                st.counter_base[key] = \
                    st.counter_base.get(key, 0) + last
                restarted = True
            st.counter_raw[key] = raw
        return restarted

    def _hist_delta(self, st: _MemberState, snap,
                    was_restart: bool) -> Dict[str, int]:
        """This member's latency-histogram bucket delta since its last
        scrape, summed over the configured SLO phases.  On a restart
        the member's cumulative counts reset — the fresh counts ARE the
        delta (clamping at zero would silently drop them)."""
        delta: Dict[str, int] = {}
        for pname in self._slo_phases:
            key = "step_phase_seconds{phase=%s}" % pname
            entry = snap.get(key)
            if not isinstance(entry, dict) or \
                    entry.get("type") != "histogram":
                continue
            cur = entry.get("buckets") or {}
            prev = st.prev_hists.get(key)
            if prev is None:
                # FIRST sight of this member: its lifetime history is
                # not "this round's work" — folding it in would let a
                # collector attached to a long-running fleet compute
                # burn over all history and falsely latch a breach
                d = {}
            elif was_restart or set(prev) != set(cur):
                # restart: the counts reset — the fresh counts ARE the
                # work since the restart
                d = dict(cur)
            else:
                d = {k: max(0, cur[k] - prev.get(k, 0)) for k in cur}
            st.prev_hists[key] = dict(cur)
            delta = merge_bucket_maps([delta, d],
                                      name="slo_latency_window")
        return delta

    def _rate_deltas(self, counter_totals) -> Tuple[float, float]:
        """This round's (rejected, offered) DELTAS from the rebased
        running totals — what the SLO tracker windows over.  Totals are
        monotone by construction (restart rebasing), so the deltas are
        never negative."""
        rej = (counter_totals.get("serve.rejected") or {}).get("total", 0)
        req = (counter_totals.get("serve.requests") or {}).get("total", 0)
        offered = rej + req
        prev = self._prev_rates
        self._prev_rates = (rej, offered)
        if prev is None:
            # first round: lifetime totals are not one round's work —
            # a collector attaching to a running fleet must not compute
            # a rejection "rate" over all history (false breach latch)
            return 0.0, 0.0
        return max(0.0, rej - prev[0]), max(0.0, offered - prev[1])

    def _queue_depth(self, gauges) -> float:
        entry = gauges.get("serve.queue_rows")
        return float(entry["mean"]) if entry else 0.0

    def _publish(self, merged) -> None:
        """Registry + log side effects, outside the collector lock."""
        meta = merged["members"]
        present = sum(1 for m in meta.values() if m["present"])
        self._g_members.set(present)
        self._g_absent.set(len(meta) - present)
        self._c_scrapes.inc()
        if merged.get("malformed_beats"):
            self._c_malformed.inc(merged["malformed_beats"])
        findings = merged["stragglers"]
        self._g_stragglers.set(len(findings))
        reg = _telemetry.registry
        for slo, b in (merged["slo"].get("burn") or {}).items():
            reg.gauge("fleet.slo_burn", doc="windowed SLO burn "
                      "(observed/target; >1 = out of budget)",
                      labels={"slo": slo}).set(b)
        breached = merged["slo"].get("breached") or {}
        for slo in self.slo.targets:
            # written BOTH ways so an operator's SLOTracker.reset()
            # actually clears the exported gauge on the next scrape —
            # a latch nothing can un-latch is a stuck alert
            reg.gauge("fleet.slo_breached", doc="latched SLO breach "
                      "(stays raised until SLOTracker.reset)",
                      labels={"slo": slo}).set(1 if slo in breached
                                               else 0)
        current = {f["member"] for f in findings}
        with self._lock:      # vs retire() clearing a flag mid-round
            flagged = set(self._flagged)
        for f in findings:
            if f["member"] in flagged:
                continue
            dom = ""
            if f.get("dominant_phase"):
                dom = "; dominant phase %s (%.0f%%)" % (
                    f["dominant_phase"], 100 * f["dominant_share"])
            self.logger.warning(
                "fleet: %s is a straggler: step %.3gs = %.3gx the "
                "fleet median %.3gs%s",
                f["member"], f["step_seconds"], f["ratio"],
                f["fleet_median_seconds"], dom)
            if _telemetry.enabled():
                _telemetry.flight_recorder.record(
                    steps=0, extra={"event": "fleet.straggler",
                                    **{k: f[k] for k in
                                       ("member", "ratio",
                                        "dominant_phase")}})
        with self._lock:
            self._flagged = current

    # -- faces --------------------------------------------------------------
    def snapshot(self) -> Optional[Dict[str, Any]]:
        """The last merged fleet snapshot (None before the first
        scrape) — what the FLEET verb returns."""
        with self._lock:
            return self._ring[-1] if self._ring else None

    def ring(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def to_prometheus(self) -> str:
        """Federation exposition: every member's instruments re-labeled
        ``role``/``rank`` (and ``model`` when known) + this process's
        own registry (the ``fleet.*`` rollups).  One scrape = the whole
        fleet."""
        with self._lock:
            members = dict(self._members)
            states = {k: (st.last_snap, st.model)
                      for k, st in self._state.items() if st.last_snap}
        lines: List[str] = []
        typed: set = set()
        for mid in sorted(states):
            snap, model = states[mid]
            m = members.get(mid)
            extra = {"role": m.role if m else "?",
                     "rank": m.rank if m else "?"}
            if model:
                extra["model"] = model
            for key in sorted(snap):
                entry = snap[key]
                if not isinstance(entry, dict) or "type" not in entry:
                    continue
                name = _entry_name(key, entry)
                pname = "mx_" + _telemetry._prom_name(name)
                labels = dict(entry.get("labels") or {})
                labels.update(extra)
                if pname not in typed:
                    typed.add(pname)
                    lines.append("# TYPE %s %s" % (pname, entry["type"]))
                if entry["type"] in ("counter", "gauge"):
                    lines.append("%s%s %s" % (
                        pname, _telemetry._prom_labels(labels),
                        entry.get("value", 0)))
                    continue
                for le, cum in (entry.get("buckets") or {}).items():
                    lines.append("%s_bucket%s %d" % (
                        pname,
                        _telemetry._prom_labels(labels,
                                                'le="%s"' % le), cum))
                lines.append("%s_sum%s %g" % (
                    pname, _telemetry._prom_labels(labels),
                    entry.get("sum", 0.0)))
                lines.append("%s_count%s %d" % (
                    pname, _telemetry._prom_labels(labels),
                    entry.get("count", 0)))
        return "\n".join(lines) + "\n" + _telemetry.registry.to_prometheus()

    # -- lifecycle ----------------------------------------------------------
    def start(self, port: Optional[int] = None,
              http_port: Optional[int] = None) -> "FleetCollector":
        """Start the background scrape thread (and, when configured,
        the FLEET wire server / federation HTTP endpoint)."""
        _active[0] = self
        if port is None:
            raw = get_env("MX_FLEET_PORT", "")
            port = int(raw) if raw not in (None, "") else None
        if http_port is None:
            raw = get_env("MX_FLEET_HTTP_PORT", "")
            http_port = int(raw) if raw not in (None, "") else None
        if self._thread is None:
            # a stop()ed collector is restartable: clear the event or
            # the fresh thread exits on its first wait (silently dead —
            # snapshot() frozen, FLEET serving stale data).  The new
            # loop takes a fresh generation; an old loop whose join
            # timed out sees the mismatch and retires instead of
            # double-scraping alongside this one.
            self._stop.clear()
            with self._lock:
                self._run_gen += 1
                gen = self._run_gen
            self._thread = threading.Thread(
                target=self._run, args=(gen,), daemon=True,
                name="mx-fleet-collector")
            self._thread.start()
        if port is not None and self._wire_server is None:
            self._wire_server = serve_fleet(self, port)
        if http_port is not None and self._http_server is None:
            self._http_server = _serve_federation(self, http_port)
        return self

    def _run(self, gen: int) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                superseded = gen != self._run_gen
            if superseded:
                return      # a newer loop owns scraping now
            try:
                self.scrape_once()
            except Exception:
                # the collector observes the fleet; it must never take
                # the fleet (or the supervisor hosting it) down
                self.logger.warning("fleet: scrape round failed",
                                    exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        # orphan any loop that misses the event window (e.g. blocked in
        # a scrape while the join below times out): on its next
        # iteration the generation mismatch retires it
        with self._lock:
            self._run_gen += 1
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, self.interval + 1.0))
            self._thread = None
        for srv in (self._wire_server, self._http_server):
            if srv is not None:
                try:
                    srv.shutdown()
                    srv.server_close()
                except OSError:
                    pass
        self._wire_server = self._http_server = None
        if get_env("MX_TELEMETRY_TRACE", ""):
            # the scrape spans become their own row in the merged
            # chrome trace
            _telemetry.dump_trace(role="fleet")

    @property
    def bound_ports(self) -> Dict[str, Optional[int]]:
        return {
            "wire": self._wire_server.server_address[1]
            if self._wire_server else None,
            "http": self._http_server.server_address[1]
            if self._http_server else None,
        }


# ---------------------------------------------------------------------------
# the FLEET wire server + federation HTTP endpoint
# ---------------------------------------------------------------------------

def serve_fleet(collector: FleetCollector, port: int,
                ready_file: Optional[str] = None):
    """Serve the collector over the kvstore-style wire: FLEET returns
    the merged snapshot (JSN payload), METRICS the whole-fleet
    federation exposition (fmt='json': the collector process's own
    registry snapshot).  Returns the started ThreadingTCPServer; caller
    owns shutdown (FleetCollector.stop does it for embedded use)."""

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                try:
                    msg = recv_msg(self.request, idle_block=True)
                except (ConnectionError, OSError, TimeoutError):
                    return
                if isinstance(msg, tuple) and msg and msg[0] == "SEQ":
                    msg = msg[3]    # idempotent verbs: envelope is noise
                cmd = msg[0] if isinstance(msg, tuple) and msg else msg
                if cmd == "FLEET":
                    reply = (True, encode_json(collector.snapshot()
                                               or {"schema": SCHEMA,
                                                   "members": {}}))
                elif cmd == "METRICS":
                    fmt = msg[1] if isinstance(msg, tuple) and \
                        len(msg) > 1 else "prometheus"
                    text = _telemetry.registry.to_json(indent=1) \
                        if fmt == "json" else collector.to_prometheus()
                    reply = (True, encode_text(text))
                else:
                    reply = (False, "unknown fleet command %r" % (cmd,))
                try:
                    send_msg(self.request, reply)
                except (ConnectionError, OSError):
                    return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    srv = Server(("0.0.0.0", int(port)), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mx-fleet-wire")
    t.start()
    if ready_file:
        with open(ready_file, "w") as f:
            f.write("%d" % srv.server_address[1])
    return srv


def _serve_federation(collector: FleetCollector, port: int):
    """Prometheus federation HTTP endpoint: GET /metrics = the whole
    fleet in one scrape; GET /fleet.json = the merged snapshot."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/fleet.json"):
                body = json.dumps(collector.snapshot() or {},
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif self.path.startswith("/metrics") or self.path == "/":
                body = collector.to_prometheus().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):     # stay off stderr
            pass

    srv = ThreadingHTTPServer(("0.0.0.0", int(port)), Handler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mx-fleet-federation")
    t.start()
    return srv
