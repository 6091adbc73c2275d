"""Interactive ROI example: drag a selection rect WITHOUT recompiling.

The reference's dock lets you drag a region-of-interest on the preview
band and every scope re-analyzes just that crop, live, every tick
(reference src/roi.c:343-521 + src/common.c:273-282).  On an accelerator
that is only interactive if the drag does NOT retrace/recompile the
program — a cold compile of the dock takes seconds.  Here the rect is a runtime
(4,) input to ONE compiled dock program (`make_dock_step(dynamic_roi=
True)` under the hood), so a drag is just new scalars each frame.

This example streams a per-tick rect change across the capture (what the
reference's move-drag pushes every frame), prints the live mean level of
the cropped region as it moves — it tracks the ramp, proving the stats
follow the rect — and shows the whole drag compiled exactly ONE program.

Run:
    python examples/interactive_roi_drag.py            # real backend
    python examples/interactive_roi_drag.py --cpu      # force CPU
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--size", default="320x180")
    ap.add_argument("--steps", type=int, default=12, help="drag positions")
    ap.add_argument("--out", default="", help="optional final panel PNG")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from obs_color_monitor_tpu.config import DockConfig, ROIConfig
    from obs_color_monitor_tpu.models import Dock
    from obs_color_monitor_tpu.runtime import native

    w, h = (int(x) for x in args.size.split("x"))
    dock = Dock(
        DockConfig(width=128, height=784),
        roi=ROIConfig(target_scale=2, interleave=0),
    )

    # a ramp frame: brightness grows to the right, so the LIVE mean level
    # of the analyzed crop proves WHICH region the moving rect covers
    frame = np.asarray(native.pattern("ramp", w, h, 0)).copy()

    # warm the steady-state stream route (full capture)
    for _ in range(3):
        dock.push_frame(frame)
        dock.render_async(128, 784)

    def live_mean() -> float:
        counts = dock.scopes["histogram"].counts()
        if counts is None:
            return -1.0
        c = np.asarray(counts[0], np.float64)
        return float((c * np.arange(256)).sum() / max(c.sum(), 1))

    print(f"full capture: mean level = {live_mean():.1f}")

    # the drag: the rect changes EVERY tick, exactly what the reference's
    # move-drag pushes per frame (roi_send_range, src/roi.c:478-520).  A UI
    # wires dock.mouse_down/move/up to its events (full reference state
    # machine: handles, hover indicators, drag grab — see
    # tests/test_stream_step.py); hub.set_roi is the per-tick commit they
    # drive underneath.  Every rect is served by ONE compiled dynamic-rect
    # program — no retrace, no recompile, statistics stay bit-exact.
    sw, sh = w // 2, h // 2  # scaled capture space (target_scale=2)
    wsel, hsel = sw // 4, sh - 8
    travel = sw - wsel - 8
    t0 = time.perf_counter()
    panel = None
    for i in range(args.steps):
        x0 = 4 + travel * i // max(args.steps - 1, 1)
        dock.hub.set_roi(x0, 4, x0 + wsel, 4 + hsel)
        dock.push_frame(frame)
        panel = dock.render_async(128, 784)  # device-resident panel
        print(f"drag step {i:2d}: rect x0={x0:3d}  "
              f"live crop mean={live_mean():6.1f}")
    dt = time.perf_counter() - t0
    np.asarray(panel)  # fetch once at the end

    step = getattr(dock, "_device_step", None)
    dyn = bool(getattr(dock, "_device_step_dynamic", False))
    n_progs = step._cache_size() if (step is not None and dyn) else "?"
    print(
        f"{args.steps}-position drag in {dt:.2f}s "
        f"({args.steps / dt:.1f} fps incl. host on this machine), "
        f"dynamic-rect programs compiled for the drag: {n_progs}"
    )
    if args.out:
        from obs_color_monitor_tpu.utils.image_io import write_png

        write_png(args.out, np.asarray(dock.render(128, 784)))
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
