"""Smoke-run every example so they cannot rot as APIs move.

Each example runs as a SUBPROCESS at tiny shapes on the CPU backend (they
configure jax themselves; in-process imports would fight the suite's
backend state).  Assertions check the example's own success markers, not
just the exit code — the examples print live statistics that prove the
path they demonstrate actually ran.
"""

import os
import subprocess
import sys
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _run(script: str, *args: str, env_extra: dict | None = None) -> str:
    env = dict(os.environ)
    # examples pick their own device counts; don't leak the suite's 8
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    r = subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args],
        capture_output=True,
        timeout=560,
        env=env,
        cwd=str(EXAMPLES.parent),
    )
    out = r.stdout.decode(errors="replace") + r.stderr.decode(errors="replace")
    assert r.returncode == 0, f"{script} failed:\n{out[-4000:]}"
    return out


def test_interactive_roi_drag():
    out = _run(
        "interactive_roi_drag.py", "--cpu", "--size", "64x48", "--steps", "3"
    )
    # the whole drag must have compiled exactly ONE dynamic-rect program
    assert "dynamic-rect programs compiled for the drag: 1" in out, out[-2000:]
    assert "full capture: mean level" in out


def test_multistream_serving():
    out = _run(
        "multistream_serving.py",
        "--streams", "4", "--size", "64x48", "--frames", "2", "--cpu-mesh",
    )
    assert "mesh: 4 devices" in out, out[-2000:]
    assert "stream 3" in out  # per-stream summaries printed for all streams


def test_p010_wire_ingest(tmp_path):
    out = _run(
        "p010_wire_ingest.py", "--size", "64x48", "--frames", "2",
        env_extra={"OCM_PLATFORM": "cpu"},
    )
    assert "OK" in out, out[-2000:]
    # P010: MSB-aligned in 16-bit words -> monitoring domain is >>8
    assert "device shift=8" in out


def test_driver_pipeline():
    out = _run(
        "driver_pipeline.py", "--cpu", "--size", "64x48", "--frames", "6",
    )
    assert "DRIVER_PIPELINE_OK" in out, out[-2000:]
    assert "'errors': 0" in out


def test_driver_pipeline_nv12():
    out = _run(
        "driver_pipeline.py", "--cpu", "--nv12", "--size", "64x48",
        "--frames", "6",
    )
    assert "DRIVER_PIPELINE_OK" in out, out[-2000:]


def test_multihost_distributed_simulate():
    out = _run(
        "multihost_distributed.py", "--simulate", "--size", "64x48",
        "--streams_per_host", "1",
    )
    assert "host 0/1: 8 local devices" in out, out[-2000:]
    assert "vectorscope occupied bins per local stream" in out
