"""Multi-host (multi-process) distributed backend, executed for real.

The reference is single-process (SURVEY §5: multi-machine = independent
OBS processes); the multi-device mapping is a `jax.distributed` cluster where
each host ingests its own frames and the mesh makes the fleet one logical
device array.  This test actually RUNS that path: two OS processes, a
localhost coordinator, 2 CPU devices per process, Gloo cross-process
collectives — the psum bin merge and the focus-peaking ppermute halo both
cross the process boundary, and every statistic must still bit-match the
single-machine golden model (tests/_multihost_worker.py carries the
assertions)."""

import os
import socket
import subprocess
import sys
from pathlib import Path



def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_bitexact():
    worker = Path(__file__).with_name("_multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    # the workers pick their own device counts (2 CPU devices each); the
    # suite's 8-device forcing must not leak in
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=str(worker.parents[1]),
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK p{i}" in out, f"process {i} output:\n{out[-4000:]}"
