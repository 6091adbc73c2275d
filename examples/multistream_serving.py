"""Multi-stream serving example: batch-DP scope analysis over a device mesh.

The reference analyzes one OBS program feed; a multi-card deployment
serves MANY streams by sharding the frame batch across devices
(obs_color_monitor_tpu/parallel/mesh.py).  This example runs N synthetic
streams through the batched fused analysis and prints per-stream summaries.

Run on real devices (one card still works — a 1-device mesh):
    python examples/multistream_serving.py --streams 8 --size 640x360
Demo the multi-device sharding anywhere with a virtual CPU mesh:
    python examples/multistream_serving.py --streams 8 --cpu-mesh
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--size", default="640x360")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument(
        "--cpu-mesh",
        action="store_true",
        help="use a virtual CPU mesh of --streams devices (must be chosen "
        "BEFORE jax initializes a backend — device enumeration itself "
        "initializes, so there is no reliable post-hoc fallback)",
    )
    args = ap.parse_args()

    import jax

    if args.cpu_mesh:
        jax.config.update("jax_num_cpu_devices", args.streams)
        jax.config.update("jax_platforms", "cpu")

    from obs_color_monitor_tpu.parallel import batch_analyze, make_mesh
    from obs_color_monitor_tpu.runtime import native

    w, h = (int(x) for x in args.size.split("x"))
    # largest device count that divides the stream batch evenly
    n_dev = min(len(jax.devices()), args.streams)
    while args.streams % n_dev:
        n_dev -= 1
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} devices; {args.streams} streams {w}x{h}")

    kinds = ["bars", "ramp", "zoneplate"]
    for it in range(args.frames):
        frames = np.stack(
            [
                native.pattern(kinds[s % 3], w, h, it)
                for s in range(args.streams)
            ]
        )
        t0 = time.perf_counter()
        vs, hi, wv = batch_analyze(frames, mesh, cs=2)
        jax.block_until_ready((vs, hi, wv))
        dt = time.perf_counter() - t0
        if it == args.frames - 1:
            for s in range(args.streams):
                h_r = np.asarray(hi[s][0])
                peak = int(h_r.argmax())
                occ = int((np.asarray(vs[s]) > 0).sum())
                print(
                    f"stream {s} ({kinds[s % 3]:9s}): R-peak={peak:3d} "
                    f"vectorscope-occupancy={occ}"
                )
        print(f"frame {it}: {args.streams} streams analyzed in {dt*1e3:.1f} ms")


if __name__ == "__main__":
    main()
