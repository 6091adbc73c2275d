"""Multi-host deployment example: scope analysis across several hosts.

Completes the scaling story: within one host, frames shard over the host's
devices via the batch mesh; across hosts, `jax.distributed` builds the
global mesh and each host feeds its own locally-ingested streams (frames
never cross the network between hosts — per-frame results are <=256 KB, so
only the tiny stats would ever travel, and with per-host output fetching
nothing does).

This mirrors the reference's deployment unit (one OBS process per machine,
SURVEY.md §5 'distributed communication backend': the reference has none —
multi-machine means independent processes; here the mesh makes the fleet
one logical device array while keeping frame traffic host-local).

Launch on every host (or simulate with --simulate):

    python examples/multihost_distributed.py \
        --coordinator 10.0.0.2:8476 --num_hosts 4 --host_id $ID

Simulated locally (one process, 8 virtual CPU devices):

    python examples/multihost_distributed.py --simulate
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num_hosts", type=int, default=1)
    ap.add_argument("--host_id", type=int, default=0)
    ap.add_argument("--streams_per_host", type=int, default=2)
    ap.add_argument("--size", default="640x360")
    ap.add_argument(
        "--simulate",
        action="store_true",
        help="single process, 8 virtual CPU devices (CI / laptop)",
    )
    args = ap.parse_args()

    import jax

    if args.simulate:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    elif args.coordinator:
        # One process per host; JAX connects the hosts and exposes the
        # global device list.  Frames stay host-local (addressable shards).
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_hosts,
            process_id=args.host_id,
        )

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from obs_color_monitor_tpu.api import make_batched_step
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.parallel import make_mesh

    w, h = (int(v) for v in args.size.split("x"))
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    batch = max(args.streams_per_host, 1) * n_dev // max(n_local, 1)
    batch = max(batch - batch % n_dev, n_dev)  # divisible by the mesh

    mesh = make_mesh()
    step = make_batched_step(h, w, mesh=mesh, cs=Colorspace.BT709, scale=2)
    sh = NamedSharding(mesh, P("batch"))

    # Each host ingests ONLY its shard of the global batch (its own camera /
    # decoder feeds) and assembles the global array from local shards — the
    # multi-host ingest pattern; no frame bytes cross between hosts.
    rng = np.random.default_rng(jax.process_index())
    global_shape = (batch, h, w, 4)
    per_dev = batch // n_dev

    def local_frames(dev_index: int) -> np.ndarray:
        f = rng.integers(0, 256, (per_dev, h, w, 4), dtype=np.uint8)
        f[..., 3] = 255
        return f

    arrays = [
        jax.device_put(local_frames(i), d)
        for i, d in enumerate(jax.local_devices())
    ]
    frames = jax.make_array_from_single_device_arrays(
        global_shape, sh, arrays
    )
    tms = jax.make_array_from_single_device_arrays(
        (batch,),
        sh,
        [
            jax.device_put(np.zeros(per_dev, np.float32), d)
            for d in jax.local_devices()
        ],
    )

    out = step(frames, tms)
    jax.block_until_ready(out)

    # Fetch only the host-local results (addressable shards) — tiny.
    local_vs = [np.asarray(s.data) for s in out.vs_counts.addressable_shards]
    occupied = [int((v > 0).sum()) for v in local_vs for v in v.reshape(-1, 256, 256)]
    print(
        f"host {jax.process_index()}/{jax.process_count()}: "
        f"{n_local} local devices, batch {batch} global, "
        f"vectorscope occupied bins per local stream: {occupied}"
    )


if __name__ == "__main__":
    main()
