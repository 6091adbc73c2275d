"""P010 wire-format ingest example: zero host per-pixel work.

A production HDR capture stack hands you P010 buffers (10-bit 4:2:0,
16-bit LE words, samples MSB-aligned).  The reference relies on OBS to
convert sources to its canvas before the scopes read pixels
(reference src/common.c:223-333); here the WHOLE conversion — the
round-shift to the 8-bit monitoring domain AND the fixed-point YUV->RGB
decode — is fused into the per-frame device program
(``ops.nv12_to_packed``), so the host's only per-frame work is handing
the untouched wire buffer to the accelerator:

    raw P010 bytes -> ONE host->device upload (y/uv are adjacent views
    of the same buffer) -> one device program: shift + decode + analyze
    + every scope render + composite.

Run (writes a demo P010 clip to the temp directory first):
    python examples/p010_wire_ingest.py [--size 1920x1080] [--frames 24]
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

if os.environ.get("OCM_PLATFORM"):
    # pick the backend before any is initialized (e.g. "cpu")
    jax.config.update("jax_platforms", os.environ["OCM_PLATFORM"])

from obs_color_monitor_tpu.config import DockConfig, ROIConfig
from obs_color_monitor_tpu.models import Dock
from obs_color_monitor_tpu.pipeline.ingest import NV12Source


def write_demo_p010(path: str, w: int, h: int, n: int) -> None:
    """A moving 10-bit luma ramp with neutral chroma, MSB-aligned."""
    with open(path, "wb") as f:
        for i in range(n):
            col = (np.arange(w) * 876 // max(w - 1, 1) + 64 + 8 * i) % 940
            y10 = np.broadcast_to(col.astype(np.uint16), (h, w))
            f.write((y10 << 6).astype("<u2").tobytes())
            f.write(np.full((h // 2, w), 512 << 6, "<u2").tobytes())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()
    w, h = (int(v) for v in args.size.split("x"))

    clip = os.path.join(tempfile.gettempdir(), "demo.p010")
    write_demo_p010(clip, w, h, args.frames)
    src = NV12Source(clip, w, h, cs=2, bits=10, msb_aligned=True)
    print(f"source: {clip} {w}x{h}, {src.n_frames} frames, "
          f"device shift={src.nv12_shift}")

    dock = Dock(DockConfig(show_roi=False, show_focuspeaking=True),
                roi=ROIConfig(interleave=0, target_scale=1))
    t0 = time.perf_counter()
    panel = None
    for y16, uv16 in src.frames_nv12():
        # raw u16 wire planes in, shift+decode fused into the stream step
        dock.push_nv12(y16, uv16, cs=src.cs, shift=src.nv12_shift)
        panel = dock.render_async()
    jax.block_until_ready(panel)
    dt = time.perf_counter() - t0
    n = src.n_frames
    print(f"{n} frames in {dt:.3f}s = {n / dt:.1f} fps "
          f"(includes disk read + upload + warmup compiles)")
    hist = np.asarray(dock.histogram.counts())
    print(f"luma histogram occupancy: {int((hist[0] > 0).sum())} levels, "
          f"sum {int(hist[0].sum())} (= {w}x{h} = {w * h})")
    assert int(hist[0].sum()) == w * h
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
