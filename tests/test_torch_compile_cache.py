"""The port's persistent compile cache: kernel libraries a warm process
loads instead of running ``nvcc``.

No ``nvcc`` here: a stand-in compiler (a script that runs ``g++`` on the
library's source, and logs each run) builds the shared objects, through
the real ``KernelLibrary`` path of ``ops/_kernels.py``.  The key, the
reference's function fingerprint, the entry's round trip, every miss
(absent, corrupt, truncated, envelope skew) followed by a rebuild of the
same library, concurrent writers in processes, ``stats()``'s keys and the
registry's cache-hit accounting.
"""
import ctypes
import hashlib
import os
import pickle
import shutil
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

from mxnet_tpu_torch import compile_cache as tcc  # noqa: E402
from mxnet_tpu_torch import programs as tprog  # noqa: E402
from mxnet_tpu_torch.ops import _kernels  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the stand-in compiler needs g++")

_FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    # stand-in for nvcc: g++ on the source, -o kept, nvcc's flags dropped
    if [ "$1" = "--version" ]; then echo "stand-in nvcc 0.0"; exit 0; fi
    out=""; src=""
    while [ $# -gt 0 ]; do
      case "$1" in
        -o) out="$2"; shift 2 ;;
        -gencode|-Xcompiler|-Xptxas) shift 2 ;;
        -*) shift ;;
        *) src="$1"; shift ;;
      esac
    done
    echo "$src" >> "$FAKE_NVCC_LOG"
    exec g++ -shared -fPIC -x c++ "$src" -o "$out"
""")

_SRC = 'extern "C" int add_k(int x) { return x + %d; }\n'
_SIG = {"add_k": ([ctypes.c_int], ctypes.c_int)}


@pytest.fixture
def cuda_home(tmp_path, monkeypatch):
    """A CUDA_HOME whose bin/nvcc is the stand-in; a private _build/; the
    envelope recomputed under it; the counters at 0."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tcc, "_env_fixed", None)
    monkeypatch.delenv("MX_COMPILE_CACHE_SALT", raising=False)
    tcc.reset_stats()
    return log


def _lib(k=1, name="add"):
    return _kernels.SourceLibrary(name, _SRC % k, _SIG, kernels=["add_k"])


def _reasons(st):
    """The miss reasons counted since the last reset (a reset keeps the
    instruments at 0)."""
    return {k: v for k, v in st["miss_reasons"].items() if v}


def _runs(log):
    return len([ln for ln in log.read_text().splitlines() if ln])


def test_the_key_changes_with_each_part(monkeypatch):
    env = {"schema": "1", "torch": "t", "cuda": "c", "nvcc": "n",
           "device_name": "d", "capability": "9.0", "device_count": "1",
           "python": "3.12", "library": "l", "salt": ""}
    base = tcc.cache_key("flash_fwd", "src", jit_kw={"nvcc": "-O3"},
                         env=env)
    assert base == tcc.cache_key("flash_fwd", "src",
                                 jit_kw={"nvcc": "-O3"}, env=dict(env))
    assert tcc.cache_key("flash_bwd", "src", jit_kw={"nvcc": "-O3"},
                         env=env) != base
    assert tcc.cache_key("flash_fwd", "src2", jit_kw={"nvcc": "-O3"},
                         env=env) != base
    assert tcc.cache_key("flash_fwd", "src", jit_kw={"nvcc": "-O2"},
                         env=env) != base
    for field in env:
        assert tcc.cache_key("flash_fwd", "src", jit_kw={"nvcc": "-O3"},
                             env=dict(env, **{field: "other"})) != base, \
            field
    sig_a = tprog.signature_of((torch.zeros(2, 3),))
    sig_b = tprog.signature_of((torch.zeros(2, 4),))
    assert tcc.cache_key("p", sig_a, env=env) != \
        tcc.cache_key("p", sig_b, env=env)
    # the salt reaches the envelope (and so every key) from the environment
    monkeypatch.setattr(tcc, "_env_fixed", dict(env))
    k0 = tcc.cache_key("p", "s")
    monkeypatch.setenv("MX_COMPILE_CACHE_SALT", "branch-b")
    assert tcc.envelope()["salt"] == "branch-b"
    assert tcc.cache_key("p", "s") != k0
    # a library's key reads its source, its headers and the flags
    a, b = _lib(1), _lib(2)
    assert a.cache_key() != b.cache_key()
    ka = a.cache_key()
    assert ka == _lib(1).cache_key()
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ["-G"])
    assert _lib(1).cache_key() != ka


def _plain_f(x, y=3):
    return x * y + 1


def _make_closure(k):
    def g(x):
        return x + k
    return g


def test_function_fingerprint_is_the_reference_s():
    import functools
    from mxnet_tpu import compile_cache as jcc
    fns = [_plain_f, _make_closure(2), _make_closure(3),
           functools.partial(_plain_f, y=5), lambda z: {1, 2, 3} | {z}]
    for f in fns:
        assert tcc.function_fingerprint(f) == jcc.function_fingerprint(f)
    assert tcc.function_fingerprint(_make_closure(2)) != \
        tcc.function_fingerprint(_make_closure(3))


def test_off_writes_nothing(cuda_home, tmp_path, monkeypatch):
    monkeypatch.delenv("MX_COMPILE_CACHE", raising=False)
    so = tmp_path / "x.so"
    so.write_bytes(b"\x7fELF")
    assert not tcc.enabled() and not tcc.activate()
    assert tcc.store("x", "ab" * 32, str(so)) is False
    assert tcc.load("x", "ab" * 32) is None
    lib = _lib(5)
    assert lib.load().add_k(1) == 6
    # built into _build/ as before; nothing counted
    assert lib._path == lib.library_path() and lib._path.exists()
    st = tcc.stats()
    assert (st["enabled"], st["hits"], st["misses"], st["writes"]) == \
        (False, 0, 0, 0)
    assert _runs(cuda_home) == 1


def test_a_library_round_trips_through_the_cache(cuda_home, tmp_path,
                                                 monkeypatch):
    cache = tmp_path / "cc"
    monkeypatch.setenv("MX_COMPILE_CACHE", str(cache))
    cold = _lib(7)
    assert cold.load().add_k(1) == 8
    assert not cold.from_cache and _runs(cuda_home) == 1
    # the build went to this process's private directory, not _build/
    assert not cold.library_path().exists()
    st = tcc.stats()
    assert (st["hits"], st["misses"], _reasons(st), st["writes"]) == \
        (0, 1, {"absent": 1}, 1)
    entry = Path(tcc.entry_path(cold.cache_key()))
    assert entry.exists()
    doc = pickle.loads(entry.read_bytes())
    assert doc["schema"] == tcc.SCHEMA and doc["envelope"] == tcc.envelope()
    assert doc["sha256"] == hashlib.sha256(doc["payload"]).hexdigest()
    warm = _lib(7)
    assert warm.load().add_k(41) == 48
    assert warm.from_cache and _runs(cuda_home) == 1      # no nvcc run
    assert warm.build_seconds == 0.0
    assert tcc.stats()["hits"] == 1
    # a library in _build/ cannot hide a miss: the cache is looked up
    other = _lib(9)
    other.library_path().parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(cold._path, other.library_path())
    other.load()
    assert tcc.stats()["misses"] == 2 and _runs(cuda_home) == 2


def _damage_payload(entry):
    doc = pickle.loads(entry.read_bytes())
    doc["payload"] = doc["payload"][:-1] + bytes([doc["payload"][-1] ^ 1])
    entry.write_bytes(pickle.dumps(doc))


def _skew_envelope(entry):
    doc = pickle.loads(entry.read_bytes())
    doc["envelope"] = dict(doc["envelope"], torch="0.0.0")
    entry.write_bytes(pickle.dumps(doc))


@pytest.mark.parametrize("damage, reason, error", [
    (lambda e: e.write_bytes(b"not a pickle"), "corrupt", True),
    (lambda e: e.write_bytes(e.read_bytes()[:len(e.read_bytes()) // 2]),
     "corrupt", True),
    (_damage_payload, "corrupt", True),
    (_skew_envelope, "envelope", False),
], ids=["garbage", "truncated", "digest", "envelope-skew"])
def test_a_bad_entry_is_a_counted_miss_then_the_same_kernel_rebuilt(
        cuda_home, tmp_path, monkeypatch, damage, reason, error):
    monkeypatch.setenv("MX_COMPILE_CACHE", str(tmp_path / "cc"))
    first = _lib(3)
    first.load()
    entry = Path(tcc.entry_path(first.cache_key()))
    damage(entry)
    tcc.reset_stats()
    again = _lib(3)
    assert again.load().add_k(1) == 4            # the same kernel
    assert not again.from_cache and _runs(cuda_home) == 2
    st = tcc.stats()
    assert _reasons(st) == {reason: 1} and st["hits"] == 0
    assert st["errors"] == (1 if error else 0)
    assert st["writes"] == 1                     # stored afresh
    third = _lib(3)
    assert third.load().add_k(2) == 5 and third.from_cache


_WRITER = textwrap.dedent("""\
    import sys
    import torch
    torch.set_num_threads(1)
    from mxnet_tpu_torch import compile_cache as cc
    key, path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
    for _ in range(n):
        assert cc.store("add", key, path)
    print(cc.stats()["writes"])
""")


def test_concurrent_writers_last_write_wins_no_torn_read(
        cuda_home, tmp_path, monkeypatch):
    """Two writer processes store two different libraries under one key,
    over and over, while this process loads it: every load verifies and
    opens one whole library (no torn read, no error), and after the
    writers the last write is what loads."""
    cache = tmp_path / "cc"
    monkeypatch.setenv("MX_COMPILE_CACHE", str(cache))
    libs = [_lib(1, "a"), _lib(2, "b")]
    for lib in libs:
        lib.load()
    key = "f" * 64
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, key,
                               str(lib._path), "150"], env=env,
                              stdout=subprocess.PIPE, text=True)
             for lib in libs]
    tcc.reset_stats()
    seen = set()
    while any(p.poll() is None for p in procs) or not seen:
        got = tcc.load("add", key)
        if got is not None:
            seen.add(ctypes.CDLL(got).add_k(0))
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    st = tcc.stats()
    assert st["errors"] == 0 and "corrupt" not in _reasons(st)
    assert seen <= {1, 2} and seen
    assert tcc.store("add", key, str(libs[1]._path))
    assert ctypes.CDLL(tcc.load("add", key)).add_k(0) == 2


def test_stats_has_the_reference_s_keys(monkeypatch):
    from mxnet_tpu import compile_cache as jcc
    monkeypatch.delenv("MX_COMPILE_CACHE", raising=False)
    st = tcc.stats()
    assert sorted(st) == sorted(jcc.stats())
    assert st["xla_cache_hits"] is None and st["xla_cache_misses"] is None
    assert tcc.SCHEMA == jcc.SCHEMA
    for name in ("enabled", "cache_dir", "envelope", "cache_key",
                 "signature_token", "function_fingerprint", "entry_path",
                 "load", "store", "stats", "reset_stats", "activate"):
        assert callable(getattr(tcc, name)), name


def test_a_first_dispatch_from_the_cache_is_a_hit_and_ensure_compiled(
        cuda_home, tmp_path, monkeypatch):
    """A program whose first dispatch loads its library from the cache
    (and builds none) counts a cache hit, not a compile; one that builds
    counts a compile.  ensure_compiled answers "ready" only for a
    signature already dispatched."""
    monkeypatch.setenv("MX_COMPILE_CACHE", str(tmp_path / "cc"))
    x = torch.zeros(3)

    def body_of(lib):
        def run(t):
            return t + lib.load().add_k(1)
        return run
    with tprog.isolated():
        cold = tprog.register_program("cc.cold", body_of(_lib(11)))
        assert cold.ensure_compiled(x) is False
        cold(x)
        assert cold.ensure_compiled(x) == "ready"
        assert cold.ensure_compiled(torch.zeros(4)) is False
        rec = tprog.find_record("cc.cold")
        assert (rec.compiles, rec.cache_hits) == (1, 0)
        warm = tprog.register_program("cc.warm", body_of(_lib(11)))
        assert torch.equal(warm(x), x + 12)
        rec = tprog.find_record("cc.warm")
        assert (rec.compiles, rec.cache_hits) == (0, 1)
        assert rec.deserialize_seconds_total > 0
        snap = rec.snapshot()
        assert snap["cache_hits"] == 1 and snap["compiles"] == 0
        assert tprog.program_summary()["cache_hits"] == 1
        # a later first dispatch that loads nothing is a compile again
        warm(torch.zeros(5))
        assert (rec.compiles, rec.cache_hits) == (1, 1)
    assert tprog.find_record("cc.warm") is None
