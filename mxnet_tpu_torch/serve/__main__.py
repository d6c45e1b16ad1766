"""``python -m mxnet_tpu_torch.serve``: run one serving replica.

Counterpart of ``python -m mxnet_tpu.serve``.  The process face of the
serving engine: build the servables (the deterministic demo MLP, the
resnet18 conv demo, and the demo LM behind GENERATE), warm every bucket,
then serve PREDICT / GENERATE / HEALTH / METRICS / SWAP / DRAIN on a TCP
port until a STOP arrives or a DRAIN retires the replica.

The replica runs on the GPU.  ``--ctx cpu`` asks for the CPU instead (the
tests do): it is the caller's choice, never a fallback.  With
``--port-base P`` the replica binds ``P + MX_PROCESS_ID``; with
``MX_HEARTBEAT_FILE`` set, the batcher loop beats it once a second, so a
launcher's hang timeout can tell a wedged replica from an idle one.
Several specs co-host on one replica under ``MX_SERVE_HBM_BUDGET``: the
first is the default model, the rest are admitted through
``ServeServer.add_model`` and addressed by the wire envelope's model
field.  ``--decode`` hosts the flat engine, or the paged one with
``MX_SERVE_KV_PAGES`` > 0, or the speculative pair with
``MX_SERVE_DRAFT`` > 0 as well.  With ``MX_COMPILE_CACHE`` set the kernel
libraries come from the persistent compile cache (``compile_cache.py``)
and the banner reports its hits and misses.

Examples::

  python -m mxnet_tpu_torch.serve --demo --decode --port 9700
  python -m mxnet_tpu_torch.serve --demo --decode --ctx cpu --port 0 \\
      --ready-file /tmp/replica.port
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def _build_servables(args, device):
    """Every --demo / --demo-conv / --model spec as (servable, example),
    the first being the default model."""
    from .servable import BucketTable, Servable
    buckets = BucketTable([int(b) for b in args.buckets.split(",")]) \
        if args.buckets else None
    specs = []
    if args.demo:
        from .demo import demo_block, demo_example
        specs.append((Servable(demo_block(device), name="demo-mlp",
                               version=1, buckets=buckets, device=device),
                      demo_example()))
    if args.demo_conv:
        from .demo import demo_conv_block, demo_conv_example
        specs.append((Servable(demo_conv_block(device), name="demo-conv",
                               version=1, buckets=buckets, device=device),
                      demo_conv_example()))
    for prefix in (args.model or ()):
        # raises, naming what it waits for (gluon.SymbolBlock)
        Servable.from_checkpoint(prefix, epoch=args.epoch,
                                 input_names=args.inputs.split(","),
                                 version=1, buckets=buckets)
    return specs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", action="append", default=None,
                    metavar="PREFIX",
                    help="exported checkpoint prefix (PREFIX-symbol.json + "
                         "PREFIX-%%04d.params); loading it needs "
                         "gluon.SymbolBlock, which is not ported yet")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--inputs", default="data",
                    help="comma-separated model input names")
    ap.add_argument("--demo", action="store_true",
                    help="serve the deterministic demo MLP")
    ap.add_argument("--demo-conv", action="store_true",
                    help="serve the deterministic conv demo (resnet18 at "
                         "64x64)")
    ap.add_argument("--decode", action="store_true",
                    help="also host the deterministic demo LM behind "
                         "GENERATE (continuous-batching decode engine)")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--port-base", type=int, default=None,
                    help="bind port-base + MX_PROCESS_ID")
    ap.add_argument("--buckets", default=None,
                    help="override MX_SERVE_BUCKETS for this replica")
    ap.add_argument("--ready-file", default=None,
                    help="write the bound port here once accepting")
    ap.add_argument("--ctx", default="gpu", choices=("gpu", "cpu"),
                    help="device to serve on (default: the GPU)")
    args = ap.parse_args(argv)

    from ..base import get_env
    from ..device import resolve
    from ..health import Heartbeat
    from .server import ServeServer, serve_forever

    device = resolve("cuda" if args.ctx == "gpu" else "cpu")
    port = args.port
    if port is None and args.port_base is not None:
        rank = int(get_env("MX_PROCESS_ID") or
                   os.environ.get("DMLC_WORKER_ID") or 0)
        port = args.port_base + rank
    if port is None:
        port = int(get_env("MX_SERVE_PORT"))

    # heartbeat-file liveness: beat from the batcher loop, throttled (an
    # idle replica is healthy, so the beat must not depend on traffic)
    tick = None
    hb_path = get_env("MX_HEARTBEAT_FILE", "")
    if hb_path:
        hb = Heartbeat(hb_path)
        last = [0.0]

        def tick():
            now = time.monotonic()
            if now - last[0] >= 1.0:
                last[0] = now
                hb.beat(0, 0)

        hb.beat(0, 0)

    decode_engine = None
    t_warm0 = time.perf_counter()
    if args.decode:
        paged = int(get_env("MX_SERVE_KV_PAGES", 0, int) or 0) > 0
        draft_layers = int(get_env("MX_SERVE_DRAFT", 0, int) or 0)
        if draft_layers > 0:
            if not paged:
                raise SystemExit("serve: MX_SERVE_DRAFT needs the paged "
                                 "engine (set MX_SERVE_KV_PAGES)")
            from .decode import (DecodeConfig, DraftDecodeServable,
                                 PagedDecodeServable,
                                 SpeculativeDecodeBatcher, demo_spec_pair)
            cfg = DecodeConfig()
            tparams, dcfg, dparams = demo_spec_pair(
                cfg, draft_layers=draft_layers)
            decode_engine = SpeculativeDecodeBatcher(
                PagedDecodeServable(params=tparams, config=cfg,
                                    device=device),
                DraftDecodeServable(params=dparams, config=dcfg,
                                    name="demo-lm-draft", device=device),
                on_tick=tick)
        elif paged:
            from .decode import PagedDecodeBatcher, PagedDecodeServable
            decode_engine = PagedDecodeBatcher(
                PagedDecodeServable(device=device), on_tick=tick)
        else:
            from .decode import DecodeBatcher, DecodeServable
            decode_engine = DecodeBatcher(DecodeServable(device=device),
                                          on_tick=tick)
    state = ServeServer(on_tick=tick, decode=decode_engine)
    sv = None
    specs = _build_servables(args, device)
    if specs:
        sv, example = specs[0]
        state.host.deploy(sv, example=example)
        for extra_sv, extra_ex in specs[1:]:
            state.add_model(extra_sv, example=extra_ex, on_tick=tick)
    elif not args.decode:
        raise SystemExit("serve: need --demo, --demo-conv or --decode")
    warm_s = time.perf_counter() - t_warm0
    # with MX_COMPILE_CACHE set, the warm loads the kernel libraries from
    # the persistent cache instead of running nvcc: the banner (and the
    # compile_cache.* counters on METRICS) carry the receipts
    from ..compile_cache import stats as _cc_stats
    cs = _cc_stats()
    if sv is not None:
        print("serve: %s v%d warm on %d bucket(s) %r in %.2fs "
              "(compile-cache%s hits=%d misses=%d) on %s, port %d"
              % (sv.name, sv.version, len(sv.buckets.sizes),
                 list(sv.buckets.sizes), warm_s,
                 "" if cs["enabled"] else " off", cs["hits"],
                 cs["misses"], device, port),
              file=sys.stderr, flush=True)
        if len(specs) > 1:
            rep = state.host.packing_report()
            print("serve: co-hosting %d models %r (used=%d budget=%s)"
                  % (len(rep["models"]), sorted(rep["models"]),
                     rep["used_bytes"], rep["hbm_budget_bytes"] or "off"),
                  file=sys.stderr, flush=True)
    if decode_engine is not None:
        dsv = decode_engine.servable
        ps = decode_engine.page_stats()
        if ps is not None:
            spec = ""
            if ps.get("engine") == "speculative":
                spec = ", speculative: k=%d draft=%s" \
                    % (ps["spec_k"], ps["draft_model"])
            print("serve: decode %s v%d warm (paged: %d pages x %d tok, "
                  "chunk=%d, share=%s%s) in %.2fs (slots=%d, "
                  "max_tokens=%d) on %s, port %d"
                  % (dsv.name, dsv.version, ps["kv_pages"],
                     ps["kv_page_len"], ps["prefill_chunk"],
                     "on" if ps["prefix_share"] else "off", spec, warm_s,
                     dsv.config.slots, dsv.config.max_tokens, device, port),
                  file=sys.stderr, flush=True)
        else:
            print("serve: decode %s v%d warm on %d prompt + %d slot "
                  "bucket(s) in %.2fs (slots=%d, max_tokens=%d, page=%d) "
                  "on %s, port %d"
                  % (dsv.name, dsv.version, len(dsv.config.prompt_buckets),
                     len(dsv.config.slot_buckets), warm_s,
                     dsv.config.slots, dsv.config.max_tokens,
                     dsv.config.page, device, port),
                  file=sys.stderr, flush=True)

    serve_forever(port=port, state=state, ready_file=args.ready_file)
    print("serve: stopped", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
