"""Program-contract verifier: donation, HBM-budget and trace-closure
proofs of the port's contracted programs.

Counterpart of ``tools/mxlint/contracts.py``::

    python -m mxnet_tpu_torch.tools.contracts [--device cuda|cpu]
        [--format text|json] [--select NAME ...] [--write-manifest [PATH]]

Every contracted site (``mxnet_tpu_torch.programs.declare_contract``: the
servable's bucket table, the fused optimizer applies, the quantization
wire, the kvstore exchange bodies, the compiled step, the decode tables)
is imported, its cases built on ``--device`` (default the GPU; ``cpu``
asks for the CPU, as the tests do), and each case is dispatched once
through the site's own registered program.  torch lowers nothing, so each
of the reference's theorems has a counterpart that a dispatch can show:

* **donation -> written in place** (``contract-donation-dropped``).  torch
  has no donation; the port's bodies update their state in place.  After
  the dispatch every tensor of each declared donated argument must still
  be the same storage (``untyped_storage().data_ptr()``, read again from
  the argument's container) and must have been written: its version
  counter advanced, or, for a tensor made under ``inference_mode`` (which
  has none), its values differ from a copy taken before the call (the
  case's ``witness`` says which).  A dropped donation is a body that
  rebinds a fresh tensor where the reference's aliases: the storage
  changed, or a tensor of the leaf's shape and dtype came back while the
  leaf stayed unwritten.  A declared leaf the body neither writes nor
  replaces is *pruned*: noted in the table, not flagged.
* **hbm-budget -> the allocator's temp bytes** (``contract-hbm-budget``).
  On CUDA the case's first dispatch is measured by the registry
  (``temp_bytes``: the allocator's peak less what was there and the new
  outputs) and held to ``temp_budget_bytes``.  cuBLAS, cuBLASLt and cuDNN
  are warmed by throwaway GEMMs and a convolution first, so that their
  workspaces are not charged to a case.  On the CPU memory is not measured: the budget
  is reported *unmeasured*, never as held.
* **trace-closure** (``contract-trace-closure``): every point's
  ``resolve(point)`` signature must be one of the cases' signatures; a
  miss is rendered through ``diff_signatures``, naming the argument at
  fault.  None marks a point the runtime refuses before any dispatch.

A build or a case that raises is a ``contract-error`` finding, not a
crash.  The cases run inside ``programs.isolated()``: the program
records, the census, the telemetry instruments and the leak detector are
as they were afterwards.  That scope takes back whatever the process
recorded meanwhile, so the verifier runs in a process of its own (it
refuses to start where ``serve_forever`` answers); the allocator's peak
is process-global too.

Exit codes: 0 clean, 1 findings, 2 an internal error.  ``--format json``
prints the findings, the measured table and the budgets' status;
``--write-manifest`` writes the declared manifest
(``programs.contract_manifest()``) to ``contracts.json`` beside this
file, the port's own (the reference's ``tools/mxlint/contracts.json`` is
another file).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

RULE_DONATION = "contract-donation-dropped"
RULE_BUDGET = "contract-hbm-budget"
RULE_CLOSURE = "contract-trace-closure"
RULE_ERROR = "contract-error"

DEFAULT_MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "contracts.json")

#: modules whose import declares the port's contracts (the cases are
#: built lazily: importing costs dict inserts)
DECLARING_MODULES = (
    "mxnet_tpu_torch.step",
    "mxnet_tpu_torch.serve.servable",
    "mxnet_tpu_torch.serve.decode",
    "mxnet_tpu_torch.ops.optimizer",
    "mxnet_tpu_torch.ops.quantization",
    "mxnet_tpu_torch.kvstore.kvstore",
)


class Diagnostic:
    """One finding: rule, the declaring site's location, a message."""

    __slots__ = ("rule", "path", "line", "col", "message", "snippet")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str, snippet: str = ""):
        self.rule = rule
        self.path = path.replace(os.sep, "/")
        self.line = line
        self.col = col
        self.message = message
        self.snippet = snippet.strip()

    def fingerprint_id(self) -> str:
        blob = "\x00".join((self.path, self.rule, self.snippet))
        return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]

    def to_json(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet,
                "fingerprint": self.fingerprint_id(), "threads": []}

    def __repr__(self):
        return "%s:%d:%d: %s: %s" % (self.path, self.line, self.col,
                                     self.rule, self.message)


def load_contracts(extra_modules: Tuple[str, ...] = ()):
    """Import the declaring modules and return the registered contracts."""
    import importlib
    for mod in tuple(DECLARING_MODULES) + tuple(extra_modules):
        importlib.import_module(mod)
    from mxnet_tpu_torch import programs
    return programs.contracts()


def _rel(path: Optional[str], root: str) -> str:
    if not path:
        return "<contracts>"
    try:
        rel = os.path.relpath(os.path.abspath(path), root)
    except ValueError:
        return path.replace(os.sep, "/")
    return rel.replace(os.sep, "/")


def _origin(contract, root: str) -> Tuple[str, int]:
    if contract.origin:
        return _rel(contract.origin[0], root), int(contract.origin[1])
    return "<contracts>", 1


class CaseResult:
    """One dispatched case's facts (one row of the budget table)."""

    __slots__ = ("contract", "program", "label", "device",
                 "donated_expected", "aliased", "pruned", "dropped",
                 "witness", "temp_bytes", "memory", "budget",
                 "budget_status", "compile_seconds")

    def __init__(self, contract: str, program: str, label: str,
                 device: str):
        self.contract = contract
        self.program = program
        self.label = label
        self.device = device
        self.donated_expected = 0
        self.aliased = 0
        self.pruned = 0
        self.dropped = 0
        self.witness = "version"
        self.temp_bytes: Optional[int] = None
        self.memory: Optional[Dict[str, Any]] = None
        self.budget: Optional[int] = None
        self.budget_status = "unmeasured"
        self.compile_seconds = 0.0

    def to_json(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


def _warm_libraries(device) -> None:
    """Throwaway GEMMs (plain, and with a bias: cuBLASLt's own workspace)
    and a convolution, so that cuBLAS's and cuDNN's workspaces are
    allocated before any case is measured."""
    import torch
    if torch.device(device).type != "cuda":
        return
    a = torch.randn(64, 64, device=device)
    (a @ a).sum().item()
    torch.nn.functional.linear(a, a, a[0]).sum().item()
    with torch.inference_mode():
        torch.nn.functional.linear(a, a, a[0]).sum().item()
    x = torch.randn(1, 3, 16, 16, device=device)
    w = torch.randn(4, 3, 3, 3, device=device)
    torch.nn.functional.conv2d(x, w).sum().item()
    torch.cuda.synchronize(device)


def _version(t) -> Optional[int]:
    try:
        return int(t._version)
    except RuntimeError:            # an inference tensor has none
        return None


def _written(t, ver0, copy0) -> bool:
    if ver0 is not None:
        return _version(t) != ver0
    import torch
    return not torch.equal(t, copy0)


def _verify_case(contract, case, root: str, device, seed: int):
    """Dispatch one case and check it; returns (CaseResult, findings)."""
    import torch
    from mxnet_tpu_torch import programs
    path, line = _origin(contract, root)
    res = CaseResult(contract.name, case.program, case.label, str(device))
    res.budget = contract.temp_budget_bytes
    diags: List[Diagnostic] = []
    args, kwargs = case.make_args(device, seed)
    donated = [i for i in contract.donate_argnums if i < len(args)]
    before = {}
    for i in donated:
        snaps = []
        for t in programs._tensor_leaves(args[i]):
            ver = _version(t)
            if ver is None:
                res.witness = "value"
            snaps.append((t, programs._storage_key(t), ver,
                          t.detach().clone() if ver is None else None))
        before[i] = snaps
    if case.state is not None:
        snaps = []
        for t in case.state():
            ver = _version(t)
            if ver is None:
                res.witness = "value"
            snaps.append((t, programs._storage_key(t), ver,
                          t.detach().clone() if ver is None else None))
        before["state"] = snaps
    res.donated_expected = sum(len(v) for v in before.values())

    prog = case.program_object(device)
    # the site's own program, made to measure this dispatch as its first
    # (the isolated registry records it), then put back as it was
    with prog._build_lock:
        saved = (prog._seen, prog._record)
        prog._seen, prog._record = set(), None
    t0 = time.perf_counter()
    try:
        out = prog(*args, **kwargs)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        res.compile_seconds = time.perf_counter() - t0
        rec = prog._record
        with prog._build_lock:
            prog._seen, prog._record = saved
    mem = rec.memory if rec is not None else None

    in_keys = {programs._storage_key(t)
               for t in programs._tensor_leaves((args, kwargs))}
    fresh: Dict[Tuple, int] = {}
    for t in programs._tensor_leaves(out):
        if programs._storage_key(t) not in in_keys:
            k = (tuple(t.shape), t.dtype)
            fresh[k] = fresh.get(k, 0) + 1
    rebound = []
    for i in list(before):
        now = list(case.state()) if i == "state" else \
            programs._tensor_leaves(args[i])
        if len(now) != len(before[i]):
            res.dropped += len(before[i])
            rebound.append("argument %s's tree changed (%d -> %d tensors)"
                           % (i, len(before[i]), len(now)))
            continue
        for j, ((t, key0, ver0, copy0), t_now) in enumerate(
                zip(before[i], now)):
            if programs._storage_key(t_now) != key0:
                res.dropped += 1
                rebound.append("argument %s leaf %d rebound to new storage"
                               % (i, j))
            elif _written(t, ver0, copy0):
                res.aliased += 1
            else:
                k = (tuple(t.shape), t.dtype)
                if fresh.get(k):
                    fresh[k] -= 1
                    res.dropped += 1
                    rebound.append(
                        "argument %s leaf %d %s %s unwritten while a fresh "
                        "tensor of its shape and dtype came back"
                        % (i, j, tuple(t.shape),
                           str(t.dtype).replace("torch.", "")))
                else:
                    res.pruned += 1
    if rebound:
        diags.append(Diagnostic(
            RULE_DONATION, path, line, 0,
            "program %r (case %s): %d of %d declared donated tensors not "
            "written in place (%s); the rebound tensor keeps two "
            "generations alive on the card.  Write the state in place, or "
            "shrink the declared donate_argnums"
            % (case.program, case.label, res.dropped, res.donated_expected,
               "; ".join(rebound)[:300]),
            snippet="contract %s" % contract.name))

    if mem is not None:
        res.memory = dict(mem)
        res.temp_bytes = int(mem["temp_bytes"])
    budget = contract.temp_budget_bytes
    if budget is None:
        res.budget_status = "none"
    elif res.temp_bytes is None:
        res.budget_status = "unmeasured"
    elif res.temp_bytes > budget:
        res.budget_status = "over"
        diags.append(Diagnostic(
            RULE_BUDGET, path, line, 0,
            "program %r (case %s): first-dispatch temp bytes %d exceed the "
            "contract's %d-byte budget; shrink the program or raise the "
            "budget from a new measurement on the card"
            % (case.program, case.label, res.temp_bytes, budget),
            snippet="contract %s" % contract.name))
    else:
        res.budget_status = "held"
    return res, diags


def _verify_closure(contract, cases, root: str) -> List[Diagnostic]:
    """Every declared workload point's signature must be a case's;
    misses are rendered through the retrace explainer."""
    from mxnet_tpu_torch import programs
    closure = contract.closure
    if callable(closure) and not isinstance(closure,
                                            programs.ContractClosure):
        closure = closure()
    if closure is None or not cases:
        return []
    path, line = _origin(contract, root)
    scalar_values = cases[0].scalar_values
    case_sigs = {}
    for case in cases:
        case_sigs.setdefault(case.signature(), case)
    diags: List[Diagnostic] = []
    for point in closure.points:
        args = closure.resolve(point)
        if args is None:
            continue            # refused before any dispatch
        sig = programs.signature_of(tuple(args), {}, scalar_values)
        if sig in case_sigs:
            continue
        near = None
        for csig, case in case_sigs.items():
            if csig[0] == sig[0]:
                near = (csig, case)
                break
        if near is None:
            near = next(iter(case_sigs.items()))
        detail = ""
        diff = programs.diff_signatures(near[0], sig)
        if diff is not None:
            detail = " vs case %s: %s" % (near[1].label,
                                          programs._format_diff(diff))
        diags.append(Diagnostic(
            RULE_CLOSURE, path, line, 0,
            "contract %r: workload point %r dispatches a signature OUTSIDE "
            "the declared case set (a run-time retrace the zero-retrace "
            "proof does not cover)%s" % (contract.name, point, detail),
            snippet="contract %s" % contract.name))
    return diags


def verify(contract_names: Optional[List[str]] = None,
           root: Optional[str] = None, device="cuda", seed: int = 0,
           contracts=None):
    """Run the whole lane on ``device``.  Returns (findings, results,
    verified program names).  ``contracts`` replaces the declared set (a
    planted contract)."""
    import torch
    from mxnet_tpu_torch import programs
    root = root or os.getcwd()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available (ask for "
                           "the CPU with --device cpu)")
    if contracts is None:
        contracts = load_contracts()
    if contract_names:
        wanted = set(contract_names)
        contracts = [c for c in contracts if c.name in wanted]
    diags: List[Diagnostic] = []
    results: List[CaseResult] = []
    verified: List[str] = []
    with programs.contract_scope(device), programs.isolated():
        _warm_libraries(device)
        for contract in contracts:
            path, line = _origin(contract, root)
            try:
                cases = list(contract.build())
            except Exception as e:
                diags.append(Diagnostic(
                    RULE_ERROR, path, line, 0,
                    "contract %r failed to build its cases: %s: %s"
                    % (contract.name, type(e).__name__, e),
                    snippet="contract %s" % contract.name))
                continue
            built = []
            for k, case in enumerate(cases):
                try:
                    res, case_diags = _verify_case(contract, case, root,
                                                   device, seed + k)
                except Exception as e:
                    diags.append(Diagnostic(
                        RULE_ERROR, path, line, 0,
                        "contract %r case %s failed to dispatch: %s: %s"
                        % (contract.name, case.label, type(e).__name__, e),
                        snippet="contract %s" % contract.name))
                    continue
                built.append(case)
                results.append(res)
                diags.extend(case_diags)
                if case.program not in verified:
                    verified.append(case.program)
            try:
                diags.extend(_verify_closure(contract, built, root))
            except Exception as e:
                diags.append(Diagnostic(
                    RULE_ERROR, path, line, 0,
                    "contract %r closure check failed: %s: %s"
                    % (contract.name, type(e).__name__, e),
                    snippet="contract %s" % contract.name))
    return diags, results, verified


def _fmt_bytes(n: Optional[int]) -> str:
    return "-" if n is None else "{:,}".format(n)


def budget_table(results: List[CaseResult]) -> str:
    """One row a case: donated / written / pruned tensors, the witness,
    the temp bytes against the budget and whether it was measured."""
    header = ("program", "case", "donated", "written", "pruned", "witness",
              "temp_bytes", "budget", "budget_status", "first_dispatch_s")
    rows = [header]
    for r in results:
        rows.append((r.program, r.label, str(r.donated_expected),
                     str(r.aliased), str(r.pruned), r.witness,
                     _fmt_bytes(r.temp_bytes), _fmt_bytes(r.budget),
                     r.budget_status, "%.3f" % r.compile_seconds))
    widths = [max(len(row[i]) for row in rows) for i in range(len(header))]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths))
                     .rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def budget_summary(results: List[CaseResult]) -> Dict[str, int]:
    out = {"held": 0, "over": 0, "unmeasured": 0, "none": 0}
    for r in results:
        out[r.budget_status] = out.get(r.budget_status, 0) + 1
    return out


def manifest(results: List[CaseResult]) -> Dict[str, Any]:
    """The declared manifest plus this run's measured rows, every case of
    each program kept."""
    from mxnet_tpu_torch import programs
    doc = programs.contract_manifest()
    rows: Dict[str, Any] = {}
    for r in results:
        slot = rows.setdefault(r.program, {"program": r.program,
                                           "contract": r.contract,
                                           "cases": []})
        slot["cases"].append(r.to_json())
    doc["programs"] = rows
    return doc


def write_manifest_file(path: str = DEFAULT_MANIFEST) -> Dict[str, Any]:
    """Write the declared manifest (what is checked in) to ``path``."""
    from mxnet_tpu_torch import programs
    load_contracts()
    doc = programs.contract_manifest()
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def run_cli(fmt: str = "text", write_manifest: Optional[str] = None,
            contract_names: Optional[List[str]] = None,
            device: str = "cuda") -> int:
    root = os.getcwd()
    if write_manifest and contract_names:
        print("contracts: --write-manifest cannot be combined with --select "
              "(it would drop the unselected contracts)", file=sys.stderr)
        return 2
    try:
        if contract_names:
            known = {c.name for c in load_contracts()}
            unknown = set(contract_names) - known
            if unknown:
                print("contracts: unknown contract(s): %s (have %s)"
                      % (", ".join(sorted(unknown)),
                         ", ".join(sorted(known))), file=sys.stderr)
                return 2
        diags, results, verified = verify(contract_names, root=root,
                                          device=device)
    except Exception as e:      # an import error etc: never "clean"
        print("contracts: internal error: %s: %s" % (type(e).__name__, e),
              file=sys.stderr)
        return 2
    doc = manifest(results)
    if write_manifest:
        write_manifest_file(write_manifest)
        print("contracts: wrote the declared manifest (%d contracts) to %s"
              % (len(doc["contracts"]), write_manifest), file=sys.stderr)
    budgets = budget_summary(results)
    if fmt == "json":
        print(json.dumps({
            "contract_schema": doc["schema"],
            "device": str(device),
            "violations": [d.to_json() for d in diags],
            "verified_programs": verified,
            "contracts": sorted({r.contract for r in results}),
            "budgets": budgets,
            "programs": doc["programs"],
            "budget_table": budget_table(results),
        }, indent=1, sort_keys=True))
    else:
        for d in diags:
            print(repr(d))
        print(budget_table(results))
        print("contracts: %d program%s verified on %s, %d finding%s; "
              "budgets held %d, over %d, unmeasured %d%s"
              % (len(verified), "" if len(verified) == 1 else "s", device,
                 len(diags), "" if len(diags) == 1 else "s",
                 budgets["held"], budgets["over"], budgets["unmeasured"],
                 " (memory is not measured on the CPU)"
                 if budgets["unmeasured"] else ""), file=sys.stderr)
    return 1 if diags else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.contracts",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the cases run (default: the GPU)")
    ap.add_argument("--format", default="text", choices=("text", "json"))
    ap.add_argument("--select", action="append", default=None,
                    metavar="NAME", help="verify only this contract "
                    "(repeatable)")
    ap.add_argument("--write-manifest", nargs="?", const=DEFAULT_MANIFEST,
                    default=None, metavar="PATH",
                    help="write the declared manifest (default: "
                         "contracts.json beside this file)")
    args = ap.parse_args(argv)
    return run_cli(fmt=args.format, write_manifest=args.write_manifest,
                   contract_names=args.select, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
