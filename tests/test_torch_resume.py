"""Supervised training end to end on the CPU: the port's launcher over
``chip_smoke.py --resume-worker --device cpu`` at a tiny BERT (2 layers,
64 units, 2 heads, batch 4, T = 16).

The five jobs of ``chip_smoke.resume_part_b`` start at once (a module
fixture): an uninterrupted ``-n 1`` run; ``-n 2 --restart on-failure``
with ``worker.step:crash:after=5``; a hang (``worker.step:delay``) turned
into exit 86 by ``MX_STEP_TIMEOUT``; the same hang found by
``--hang-timeout``; and ``--elastic`` grown from 2 to 3 workers through
``--resize-file``.  Each must exit 0 with every rank's final parameters
within rtol 1e-5 / atol 1e-6 of the uninterrupted run (the reference's
acceptance, ``tests/test_supervisor.py``); ``resume_part_b`` raises
otherwise, and the cases below read what each job did.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = ["--device", "cpu", "--size", "tiny"]
#: the worker runs 2 epochs of 4 batches; a fault fires at the 6th batch
STEPS, FAULT_AT = 8, 6


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("resume"))
    return chip_smoke.resume_part_b(tmp, TINY, per_step=0, grow=(2, 3)), tmp


def test_the_uninterrupted_run(jobs):
    ref = jobs[0]["ref"]
    assert ref["steps"] == STEPS and ref["start_epochs"] == [0]
    assert ref["restarts"] == [] and ref["crash_dumps"] == []
    # no kernel on the CPU: the wrappers took their plain versions
    assert set(ref["launches"].values()) == {0}


def test_two_crashed_ranks_restart_and_resume_from_epoch_0(jobs):
    rec, tmp = jobs[0]["crash"], jobs[1]
    # each rank ran 5 steps, died entering the 6th, and replayed epoch 1
    assert rec["steps"] == 2 * ((FAULT_AT - 1) + STEPS // 2)
    assert rec["start_epochs"] == [1, 1]
    assert sorted(r["rank"] for r in rec["restarts"]) == [0, 1]
    assert rec["max_abs_diff"] <= 1e-6
    dumps = rec["crash_dumps"]
    assert sum(d.startswith("crash-rank") for d in dumps) == 2
    assert sum(d.startswith("supervisor-") for d in dumps) == 2
    (worker_dump,) = [d for d in dumps if d.startswith("crash-rank0")]
    blob = json.load(open(os.path.join(tmp, "crash.crash", worker_dump)))
    assert "injected crash" in blob["reason"]
    with open(os.path.join(tmp, "crash.stderr")) as f:
        err = f.read()
    assert "rank 0 failed (exit 1) - restart 1/2" in err
    assert "rank 1 failed (exit 1) - restart 1/2" in err


def test_the_watchdog_turns_a_hang_into_exit_86(jobs):
    rec, tmp = jobs[0]["watchdog"], jobs[1]
    assert rec["start_epochs"] == [1]
    assert rec["steps"] == (FAULT_AT - 1) + STEPS // 2
    assert rec["max_abs_diff"] <= 1e-6
    (restart,) = rec["restarts"]
    # detection waits out MX_STEP_TIMEOUT, less than the 60 s hang
    assert float(chip_smoke.RESUME_STEP_TIMEOUT) <= \
        restart["death_to_start_s"] < 60
    with open(os.path.join(tmp, "watchdog.stderr")) as f:
        err = f.read()
    assert "rank 0 failed (exit 86 (MX_STEP_TIMEOUT watchdog: hung step))" \
        in err
    assert "--- thread" in err                  # the stacks were dumped
    assert any("watchdog" in json.load(open(
        os.path.join(tmp, "watchdog.crash", d)))["reason"]
        for d in rec["crash_dumps"] if d.startswith("crash-rank"))


def test_a_stale_heartbeat_is_killed_and_restarted(jobs):
    rec, tmp = jobs[0]["heartbeat"], jobs[1]
    assert rec["start_epochs"] == [1]
    assert rec["max_abs_diff"] <= 1e-6
    (restart,) = rec["restarts"]
    assert float(chip_smoke.RESUME_HANG_TIMEOUT) <= \
        restart["death_to_start_s"] < 60
    with open(os.path.join(tmp, "heartbeat.stderr")) as f:
        err = f.read()
    assert "heartbeat stale" in err and "(signal 9)" in err
    assert "watchdog" not in err


def test_an_elastic_job_grows_from_two_to_three(jobs):
    rec, tmp = jobs[0]["elastic"], jobs[1]
    assert rec["max_abs_diff"] <= 1e-6
    with open(os.path.join(tmp, "elastic.stderr")) as f:
        err = f.read()
    assert "elastic resize: 2 -> 3 worker(s) (generation 1)" in err
    # by rank: the new rank 2 starts at epoch 0; rank 0 resumes after its
    # drain's checkpoint (drained after the fit, with nothing left to run)
    starts = rec["start_epochs"]
    assert len(starts) == 3 and starts[2] == 0
    if rec["interleaving"].startswith("drain at epoch"):
        assert starts[0] == int(rec["interleaving"].split()[-1]) + 1
        assert rec["resize_to_drained_s"] > 0
    elif rec["interleaving"] == "after the fit ended":
        assert starts[0] == chip_smoke.RESUME_EPOCHS


def test_the_worker_refuses_a_nan_policy(tmp_path):
    """TrainStep applies its update inside the step, so the gradient guard
    has nothing to read: the worker says so instead of dropping it."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--resume-worker", "--ckpt-dir", str(tmp_path)] + TINY,
        env=dict(os.environ, PYTHONPATH=REPO, MX_NAN_POLICY="warn"),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "MX_NAN_POLICY" in r.stderr
