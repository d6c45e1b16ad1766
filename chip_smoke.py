#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits nonzero):

1. device  -- require CUDA; print the card's name and power limit.
2. build   -- build every hand-written kernel from ``mxnet_tpu_torch/csrc``.
3. kernels -- hold each kernel against its plain PyTorch version on the card
   at the main path's shapes (and ragged/causal edge cases), and time the
   kernel, the plain version and the PyTorch library call.
4. slice   -- the serving path: BERT-base (12 x 768 x 12, fp32, T = 512,
   seeded random weights) behind Servable -> ModelHost.deploy -> Batcher ->
   ServeServer/serve_forever, answering 32 PREDICT requests from 8
   ServeClient threads; every answer is checked against an in-process
   forward through the plain attention composition, and the flash kernel's
   launch count against 12 x dispatched micro-batches (warm-up included).
5. bf16    -- the same model cast to bfloat16, one 8 x 512 forward through
   the kernel; its deviation from the fp32 answer is printed for the record.

The last lines of standard output are the ``nvidia-smi`` name and power
limit, one JSON object ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or mxnet_tpu.
"""
from __future__ import annotations

import json
import socket
import subprocess
import threading
import time

import numpy as np
import torch

SEED = 20261017
BUCKETS = (1, 2, 4, 8)
SEQ_LEN = 512
N_REQUESTS = 32
N_CLIENTS = 8
SLICE_TOL = 2e-3

# Data-sheet peaks (dense) of the card this script was measured on, by the
# name torch reports: HBM bytes/s, fp32 FLOP/s on CUDA cores, bf16 FLOP/s on
# tensor cores.  Add a row before running on another card.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "fp32": 67e12, "bf16": 989e12},
}


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    if name not in PEAKS:
        raise RuntimeError("chip_smoke: no data-sheet peaks for %r; add its "
                           "row to PEAKS" % name)
    peaks = PEAKS[name]
    # float32 products in full fp32: the comparisons below need it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: %s | torch %s cuda %s | %s" % (
        name, torch.__version__, torch.version.cuda, smi))
    log("device: peaks %s" % json.dumps(peaks))
    return smi, name, peaks


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    from mxnet_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    secs = _kernels.build_all()
    log("build: %s in %.2f s wall" % (json.dumps(secs),
                                      time.perf_counter() - t0))
    for lib in _kernels.LIBRARIES:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("build: %s: %s" % (lib.name, line.strip()))


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(got, want, tol):
    """(max |got - want| over finite entries, ok) with the rule
    |got - want| <= tol + tol * |want| + u * |want|; equal infinities
    agree.  ``u`` is 0 for a float32 ``got`` and bf16's unit roundoff 2^-8
    for a bfloat16 one: a bf16 output is the fp32 result rounded once to
    bf16, which moves it by at most half a bf16 ulp of |want|, and that is
    at most 2^-8 * |want|.  The fp32 reference is not rounded, and near
    |O| = 2 (a causal row that sees one key returns that key's value row)
    the rounding alone is up to 0.0078, above tol."""
    u = torch.finfo(got.dtype).eps / 2 if got.dtype == torch.bfloat16 \
        else 0.0
    got, want = got.float(), want.float()
    same_inf = torch.isinf(got) & torch.isinf(want) & \
        (torch.sign(got) == torch.sign(want))
    err = (got - want).abs().masked_fill(same_inf, 0.0)
    ok = bool(((err <= tol + (tol + u) * want.abs()) | same_inf).all())
    finite = err[torch.isfinite(err)]
    return (float(finite.max()) if finite.numel() else 0.0), ok


def flash_work(B, H, Tq, Tk, D, causal, itemsize):
    """(operations, bytes) one flash-forward call needs on these shapes:
    2 FLOP per multiply-add in QK^T and PV over the visible (q, k) pairs;
    Q, K, V read once, O and the fp32 LSE written once."""
    if causal:
        pairs = sum(min(i + 1, Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    ops = 4 * B * H * pairs * D
    nbytes = B * H * ((2 * Tq + 2 * Tk) * D * itemsize + Tq * 4)
    return ops, nbytes


def bound_ms(ops, nbytes, flops_peak, hbm_peak):
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / hbm_peak * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


KERNEL_CASES = [
    # name, B, H, Tq, Tk, D, dtype, causal, timed
    ("bert-base", 8, 12, 512, 512, 64, torch.float32, False, True),
    ("bert-base", 8, 12, 512, 512, 64, torch.bfloat16, False, True),
    ("ragged-causal", 2, 3, 200, 200, 128, torch.float32, True, False),
    ("ragged-causal", 2, 3, 200, 200, 128, torch.bfloat16, True, False),
    ("top-left-causal", 2, 3, 64, 128, 64, torch.float32, True, False),
    ("ragged-cross", 2, 3, 77, 333, 64, torch.float32, False, False),
    ("causal", 8, 12, 512, 512, 64, torch.float32, True, False),
    ("d128", 2, 8, 512, 512, 128, torch.float32, False, False),
]


def phase_kernels(peaks):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import attention as att
    results = {}
    for (name, B, H, Tq, Tk, D, dtype, causal, timed) in KERNEL_CASES:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda")
                   .to(dtype) for T in (Tq, Tk, Tk))
        scale = 1.0 / D ** 0.5
        o, lse = att.flash_attention_with_lse(q, k, v, scale, causal)
        torch.cuda.synchronize()
        # bf16 is held against the plain version run in fp32 on the same
        # bf16 inputs; fp32 against the plain version itself
        o_ref, lse_ref = att.flash_attention_plain(
            q.float(), k.float(), v.float(), scale, causal)
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        err_o, ok_o = compare(o, o_ref, tol)
        err_l, ok_l = compare(lse, lse_ref, tol)
        tag = "%s B=%d H=%d Tq=%d Tk=%d D=%d %s causal=%s" % (
            name, B, H, Tq, Tk, D, str(dtype).replace("torch.", ""), causal)
        log("kernels: %s | max|dO| %.3g max|dLSE| %.3g (tol %g) %s"
            % (tag, err_o, err_l, tol, "ok" if ok_o and ok_l else "FAIL"))
        if not (ok_o and ok_l and torch.isfinite(o.float()).all()):
            raise RuntimeError("flash_fwd disagrees with its plain version: "
                               + tag)
        if not timed:
            continue
        itemsize = torch.finfo(dtype).bits // 8
        ops, nbytes = flash_work(B, H, Tq, Tk, D, causal, itemsize)
        flops_peak = peaks["fp32" if dtype == torch.float32 else "bf16"]
        b_ms, b_by = bound_ms(ops, nbytes, flops_peak, peaks["hbm"])
        rec = {
            "kernel_ms": time_ms(lambda: att.flash_attention_with_lse(
                q, k, v, scale, causal)),
            "plain_ms": time_ms(lambda: att.flash_attention_plain(
                q, k, v, scale, causal)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale)),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": ops / 1e9,
            "mbytes": nbytes / 1e6, "max_abs_err": max(err_o, err_l)}
        rec["tflops"] = ops / rec["kernel_ms"] / 1e9
        log("kernels: timing %s %s" % (tag, json.dumps(rec)))
        results[dtype] = rec
    return results


# ---------------------------------------------------------------------------
# 4. the slice: BERT-base served over the wire
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_requests():
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, 30522, size=(N_REQUESTS, 1, SEQ_LEN)) \
        .astype(np.int32)
    types = np.zeros((N_REQUESTS, 1, SEQ_LEN), np.int32)
    for i, cut in enumerate(rng.randint(1, SEQ_LEN, size=N_REQUESTS)):
        types[i, 0, cut:] = 1       # segment A, then segment B
    return tokens, types


def run_burst(port, tokens, types):
    """N_REQUESTS PREDICTs from N_CLIENTS closed-loop ServeClient threads
    (one outstanding request each), each on a connection opened (by a
    HEALTH call) before the burst starts, as a client pool keeps them;
    returns (answers, latencies in s, wall seconds of the burst)."""
    from mxnet_tpu_torch.serve import ServeClient
    answers = [None] * N_REQUESTS
    latency = [None] * N_REQUESTS
    errors = []
    barrier = threading.Barrier(N_CLIENTS + 1)

    def client(c):
        try:
            with ServeClient(["127.0.0.1:%d" % port], timeout=120) as cli:
                cli.health()
                barrier.wait(60)
                for i in range(c, N_REQUESTS, N_CLIENTS):
                    t0 = time.perf_counter()
                    answers[i] = cli.predict([tokens[i], types[i]])
                    latency[i] = time.perf_counter() - t0
        except Exception as e:    # reported and failed below
            errors.append("client %d: %r" % (c, e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(a is None for a in answers):
        raise RuntimeError("PREDICT failed: %s" % errors)
    return answers, latency, wall


def device_busy_ms(prof):
    """Milliseconds in which at least one device activity (kernel or copy)
    ran, from a torch.profiler trace: the union of their intervals."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def phase_slice():
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.bert import bert_12_768_12
    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.attention import attention_impl_scope
    from mxnet_tpu_torch.serve import (BucketTable, ModelHost, Servable,
                                       ServeClient, ServeServer,
                                       serve_forever)
    net = bert_12_768_12(use_decoder=False, dropout=0.0)
    net.initialize(initializer.Normal(0.02), seed=SEED)
    n_layers = len(net.encoder.transformer_cells)
    tokens, types = make_requests()
    sv = Servable(net, name="bert_12_768_12", version=1,
                  buckets=BucketTable(BUCKETS))
    host = ModelHost()
    state = ServeServer(host, max_batch=max(BUCKETS), max_delay_us=2000,
                        queue_cap=256)
    port = _free_port()
    stop = threading.Event()
    ready = threading.Event()

    # --- the main path, counted ---
    for lib in _kernels.LIBRARIES:
        lib.reset_launches()
    t_deploy = time.perf_counter()
    host.deploy(sv, example=[tokens[0], types[0]])
    t_deploy = time.perf_counter() - t_deploy
    server = threading.Thread(
        target=serve_forever, name="chip-smoke-serve",
        kwargs=dict(port=port, state=state, stop_event=stop,
                    bind="127.0.0.1", ready_event=ready))
    server.start()
    try:
        if not ready.wait(30):
            raise RuntimeError("serve_forever did not come up")
        answers, latency, t_burst = run_burst(port, tokens, types)
        launches = {lib.name: lib.launches for lib in _kernels.LIBRARIES}
        served = sv.batches
        burst_stats = state.batcher.stats()
        micro_batches = len(BUCKETS) + served
        # --- end of the counted main path ---
        _, latency2, t_burst2 = run_burst(port, tokens, types)
        log("slice: repeat burst latency ms by request: %s"
            % json.dumps((np.array(latency2) * 1e3).tolist()))
        idle = traced_burst(port, tokens, types, sv)
        with ServeClient(["127.0.0.1:%d" % port], timeout=60) as cli:
            health = cli.health()
            cli.stop()
    finally:
        stop.set()
        server.join(30)
    if server.is_alive():
        raise RuntimeError("serve_forever did not exit after STOP")

    log("slice: deploy+warm %.3f s; batcher after the measured burst %s; "
        "health at the end %s" % (t_deploy, json.dumps(burst_stats),
                                         json.dumps(health)))
    want = n_layers * micro_batches
    log("slice: flash_fwd launches %d, %d layers x %d micro-batches "
        "(%d warm + %d served) = %d" % (launches["flash_fwd"], n_layers,
                                        micro_batches, len(BUCKETS),
                                        served, want))
    if launches["flash_fwd"] != want:
        raise RuntimeError("flash_fwd launched %d times, expected %d"
                           % (launches["flash_fwd"], want))
    if health.get("status") != "serving":
        raise RuntimeError("HEALTH says %r" % (health,))

    # every answer against the plain composition, in process
    worst = 0.0
    with torch.inference_mode(), attention_impl_scope("xla"):
        for lo in range(0, N_REQUESTS, max(BUCKETS)):
            hi = lo + max(BUCKETS)
            ref = net(torch.from_numpy(tokens[lo:hi, 0]).cuda(),
                      torch.from_numpy(types[lo:hi, 0]).cuda())
            ref = [r.float().cpu().numpy() for r in ref]
            for i in range(lo, hi):
                version, outs = answers[i]
                if version != 1 or len(outs) != 3:
                    raise RuntimeError("request %d: version %r, %d outputs"
                                       % (i, version, len(outs)))
                for o, r in zip(outs, ref):
                    r = r[i - lo:i - lo + 1]
                    if o.shape != r.shape or not np.isfinite(o).all():
                        raise RuntimeError("request %d: output %s vs %s"
                                           % (i, o.shape, r.shape))
                    err = float(np.abs(o - r).max())
                    worst = max(worst, err)
                    if not np.allclose(o, r, atol=SLICE_TOL, rtol=SLICE_TOL):
                        raise RuntimeError(
                            "request %d disagrees with the composition by "
                            "%.3g" % (i, err))
    lat = np.array(latency) * 1e3
    log("slice: latency ms by request (client c sends c, c+8, c+16, c+24 "
        "in turn): %s" % json.dumps(lat.tolist()))
    rec = {"requests": N_REQUESTS, "clients": N_CLIENTS,
           "requests_per_s": N_REQUESTS / t_burst,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "served_batches": served,
           "max_abs_err_vs_composition": worst,
           "warm_s": sv.warm_seconds}
    lat2 = np.array(latency2) * 1e3
    rec.update({"repeat_requests_per_s": N_REQUESTS / t_burst2,
                "repeat_p50_ms": float(np.percentile(lat2, 50)),
                "repeat_p99_ms": float(np.percentile(lat2, 99))})
    rec.update(idle)
    log("slice: %s" % json.dumps(rec))
    return net, sv, answers, launches


def traced_burst(port, tokens, types, sv):
    """The same burst again under torch.profiler, after the measured one:
    the device's busy and idle share of the burst's wall time (the trace
    costs host time, so its wall time is reported, not compared).  The
    flash kernels the trace saw are counted against 12 x the burst's
    micro-batches, to show the trace caught the serving thread's work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batches0 = sv.batches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_burst(port, tokens, types)
        torch.cuda.synchronize()
    busy = device_busy_ms(prof)
    flash = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                and "flash_fwd_kernel" in e.name)
    rec = {"traced_wall_ms": wall * 1e3, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / (wall * 1e3),
           "traced_batches": sv.batches - batches0,
           "traced_flash_kernels": flash}
    log("slice: traced burst %s" % json.dumps(rec))
    return rec


def phase_breakdown(sv, tokens, types):
    """One bucket-8 micro-batch: its device time by CUDA events, and its
    device time by kernel from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bucket = max(BUCKETS)
    xs = [tokens[:bucket, 0], types[:bucket, 0]]
    ms = time_ms(lambda: sv.dispatch(bucket, xs, warming=True), iters=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sv.dispatch(bucket, xs, warming=True)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    total = sum(us for us, _ in by_name.values())
    log("breakdown: bucket-%d forward %.3f ms (CUDA events); traced device "
        "time %.3f ms, busy %.3f ms, over %d kernels"
        % (bucket, ms, total / 1e3, device_busy_ms(prof), len(by_name)))
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        log("breakdown: %8.3f ms %5.1f%% x%-4d %s"
            % (us / 1e3, 100.0 * us / total, n, name[:90]))
    return ms


# ---------------------------------------------------------------------------
# 5. bf16 in process
# ---------------------------------------------------------------------------

def phase_bf16(net, answers, tokens, types):
    from mxnet_tpu_torch.ops import _kernels
    n = max(BUCKETS)
    net.cast("bfloat16")
    before = _kernels.FLASH_FWD.launches
    with torch.inference_mode():
        outs = net(torch.from_numpy(tokens[:n, 0]).cuda(),
                   torch.from_numpy(types[:n, 0]).cuda())
    if _kernels.FLASH_FWD.launches - before != len(
            net.encoder.transformer_cells):
        raise RuntimeError("the bf16 forward did not run the flash kernel "
                           "once per layer")
    devs = []
    for j, o in enumerate(outs):
        o = o.float().cpu().numpy()
        if not np.isfinite(o).all():
            raise RuntimeError("bf16 output %d is not finite" % j)
        ref = np.concatenate([answers[i][1][j] for i in range(n)])
        devs.append(float(np.abs(o - ref).max()))
    log("bf16: max |bf16 - fp32| (seq_out, pooled, nsp) = %s" % devs)
    return devs


def main():
    smi, name, peaks = phase_device()
    phase_build()
    timings = phase_kernels(peaks)
    net, sv, answers, launches = phase_slice()
    tokens, types = make_requests()
    phase_breakdown(sv, tokens, types)
    phase_bf16(net, answers, tokens, types)
    fp32 = timings[torch.float32]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/ops/attention.py:148",
        "launches": launches["flash_fwd"],
        "max_abs_err": fp32["max_abs_err"], "ms": fp32["kernel_ms"],
        "plain_ms": fp32["plain_ms"], "bound_ms": fp32["bound_ms"],
        "bound_by": fp32["bound_by"], "library_ms": fp32["library_ms"]}]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
