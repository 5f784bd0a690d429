"""The bench harness's un-killable contract.

An all-or-nothing bench loses its whole record when it is cut.  These
tests pin the guarantees via ``bench.py --selfcheck`` (no device, no jax
import on the hot path): the headline value is recorded before later
sections, the budget gate records skipped sections, and SIGTERM mid-run
still emits a complete JSON line with stage timestamps and
``interrupted_at_s``.
"""

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_env(**extra):
    env = dict(os.environ)
    env.update(extra)
    return env


def test_selfcheck_completes_with_value_and_stages():
    out = subprocess.run(
        [sys.executable, BENCH, "--selfcheck"],
        capture_output=True, text=True, timeout=60,
        env=_run_env(BENCH_BUDGET_S="30"), cwd=REPO,
    )
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] == 1.0
    assert rec["value_stage"] == "selfcheck_stub"
    assert "stub_value_set" in rec["stages"] and "end" in rec["stages"]
    # the budget gate must record what it skipped, not drop it silently
    assert rec["skipped_budget"] == ["too_expensive"]
    assert "section_cheap_done" in rec["stages"]


def test_sigterm_mid_run_still_emits_headline_json():
    progress = os.path.join(REPO, "BENCH_PROGRESS.json")
    try:
        os.remove(progress)  # a stale file would satisfy the poll below
    except OSError:
        pass
    proc = subprocess.Popen(
        [sys.executable, BENCH, "--selfcheck"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=_run_env(BENCH_BUDGET_S="300", BENCH_SELFCHECK_SLEEP="120"),
        cwd=REPO,
    )
    # wait until the stub value has been recorded (mirrored to disk by
    # _stamp), then kill mid-sleep — exactly the driver-timeout scenario
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            with open(progress) as fh:
                if "stub_value_set" in json.load(fh).get("stages", {}):
                    break
        except (OSError, json.JSONDecodeError):
            pass
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=30)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["value"] == 1.0, "headline lost on SIGTERM"
    assert "interrupted_at_s" in rec
    assert "stub_value_set" in rec["stages"]


def test_peak_table_knows_h100_and_refuses_unknown_devices():
    """Roofline shares are taken against a published peak for the exact
    device; an unlisted device is an error, never a default."""
    import pytest

    sys.path.insert(0, REPO)
    import bench

    assert bench.device_peaks("NVIDIA H100 80GB HBM3")["hbm_gbps"] == 3350.0
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("Unknown Accelerator 9000")
