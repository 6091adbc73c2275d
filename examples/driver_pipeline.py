"""Composed production pipeline: PipelineDriver feeding a Dock.

The reference runs ONE pipeline per source — graphics thread stages,
a pthread consumes through a bounded drop-on-full queue, scopes publish
double-buffered (src/common.c:335-454).  This example is the device-side
twin of that whole stack, composed from the public pieces:

  * ``PipelineDriver(dock=...)`` — producer pushes frames (packed RGBA
    or raw NV12/P010 wire planes), a worker thread consumes each one
    through the Dock's ONE-program stream step (analysis + hub
    publication + every scope render + composite in a single cached
    device program per frame).
  * ``driver.push_nv12`` stages the host→device plane upload on the
    producer thread — the transfer overlaps the worker's running
    program, which is the reference's stage-while-accumulating pattern.
  * ``on_panel`` is the sink: it receives the device-resident panel per
    frame; fetching/encoding there never blocks the producer.

Run (CPU works; on a GPU the driver-fed dock's rate is not measured yet,
see PERF.md):
    python examples/driver_pipeline.py --frames 24 --size 320x180
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="320x180")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--nv12", action="store_true",
                    help="push raw NV12 wire planes instead of packed RGBA")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from obs_color_monitor_tpu.config import DockConfig, ROIConfig
    from obs_color_monitor_tpu.models import Dock
    from obs_color_monitor_tpu.pipeline import PipelineDriver
    from obs_color_monitor_tpu.runtime import native

    w, h = (int(v) for v in args.size.split("x"))
    dock = Dock(DockConfig(), roi=ROIConfig(interleave=0, target_scale=1))

    fetched = []

    def sink(panel) -> None:
        # the sink runs on the worker thread; a real deployment would
        # encode/publish here (see pipeline.live / pipeline.sinks)
        fetched.append(np.asarray(panel).shape)

    drv = PipelineDriver(dock=dock, on_panel=sink)
    drv.start()
    t0 = time.perf_counter()
    try:
        for i in range(args.frames):
            if args.nv12:
                # one contiguous NV12 buffer per frame (the wire shape);
                # y/uv adjacent views -> ONE staged upload on THIS thread
                rng = np.random.default_rng(i)
                buf = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
                ok = drv.push_nv12(buf[:h], buf[h:])
            else:
                ok = drv.push_frame(native.pattern("ramp", w, h, i))
            if not ok:
                time.sleep(0.002)  # queue full: the frame was dropped
        drv.flush()
    finally:
        drv.stop()
    dt = time.perf_counter() - t0

    st = drv.stats
    print(f"driver stats: {st}")
    print(f"panels sunk: {len(fetched)} x {fetched[-1] if fetched else None}")
    print(f"histogram occupied levels: "
          f"{int((dock.histogram.counts() > 0).sum())}")
    print(f"wall: {dt * 1e3 / max(st['processed'], 1):.2f} ms/frame "
          f"({st['processed']} frames)")
    assert st["errors"] == 0 and st["processed"] > 0 and fetched
    print("DRIVER_PIPELINE_OK")


if __name__ == "__main__":
    main()
