"""On-card smoke run: the system's main paths on one NVIDIA GPU, in one
process, each compared bit-for-bit with the NumPy golden model.

Every statistic and overlay is integer or fixed point, so every comparison
has tolerance 0; a mismatch names the first differing index and both values.

Phases (one card):
  a. ``make_full_step`` at 3840x2160, scale 2, for the rgba, packed, NV12
     and P010 input forms, on random content (about 5% alpha-0 pixels) and
     SMPTE bars; scale 1 and 3 with rgba input.  All nine ScopeOutputs
     fields vs ``golden/reference.py`` + ``golden/render.py``; the wire
     forms vs the native decoder (``runtime.native.nv12_to_rgba``).
  b. ``make_dock_step`` at 1920x1080: the static build, and the
     dynamic-ROI build driven through three rects by ONE compiled program;
     counts vs golden of the crop.
  c. The served path: a ``Dock`` fed 1920x1080 frames through
     ``PipelineDriver``; the published statistics vs golden, and the last
     panel vs the same dock program run on the CPU device.
  d. Numbers (printed on the way): the card's name and power limit, compile
     seconds and ``memory_analysis()`` of every program of phases a-b, and
     the steady-state ms/frame of the 4K packed step.

``--four-cards`` runs only phase e, on four GPUs: ``make_batched_step`` with
B=4 at 4K sharded over the batch axis, and ``spatial_pipeline`` on one
7680x4320 frame with its rows over the four cards (psum-merged bins, a
one-row ppermute halo), each vs golden.

The last line of standard output is the JSON result
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU, or outside a checkout of the repository, it exits non-zero
and prints no result.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from obs_color_monitor_tpu import golden  # noqa: E402
from obs_color_monitor_tpu.colorspace import Colorspace, calc_colorspace  # noqa: E402
from obs_color_monitor_tpu.config import (  # noqa: E402
    Components,
    DockConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    ROIConfig,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
)
from obs_color_monitor_tpu.golden import render as grender  # noqa: E402
from obs_color_monitor_tpu.runtime import native  # noqa: E402
from obs_color_monitor_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

UHD = (2160, 3840)
FHD = (1080, 1920)
CS = Colorspace.BT709


def check(name: str, got, want) -> None:
    """Bit-exact comparison; raises with the first differing index."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != golden {want.shape}")
    if got.dtype != want.dtype:
        got = got.astype(np.int64)
        want = want.astype(np.int64)
    diff = got != want
    if diff.any():
        idx = tuple(int(i) for i in np.argwhere(diff)[0])
        raise AssertionError(
            f"{name}: {int(diff.sum())} elements differ; first at {idx}: "
            f"got {got[idx]}, golden {want[idx]}"
        )


def compile_program(name: str, fn, *args):
    """Lower + compile ``fn`` for ``args``; prints compile seconds and the
    compiled program's memory analysis, returns the executable."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    dt = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    mib = lambda b: b / 2**20  # noqa: E731
    print(
        f"compile {name}: {dt:.2f} s; memory MiB: arguments "
        f"{mib(ma.argument_size_in_bytes):.1f}, outputs "
        f"{mib(ma.output_size_in_bytes):.1f}, temporaries "
        f"{mib(ma.temp_size_in_bytes):.1f}, code "
        f"{mib(ma.generated_code_size_in_bytes):.2f}",
        flush=True,
    )
    return compiled


def random_frame(rng, h: int, w: int) -> np.ndarray:
    """Uniform random RGBA with about 5% alpha-0 pixels."""
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.05, 0, 255)
    return f


def golden_outputs(frame: np.ndarray, scale: int, tm: float) -> dict:
    """The nine ScopeOutputs fields of make_full_step with default scope
    configs, from the golden model."""
    vs_cfg, wv_cfg, hi_cfg = VectorscopeConfig(), WaveformConfig(), HistogramConfig()
    comp = wv_cfg.components
    scaled = golden.downscale(frame, scale)
    sh, sw = scaled.shape[:2]
    yuv = golden.rgb_to_yuv_u8(scaled, CS)
    vs = golden.vectorscope_counts(yuv)
    wv = golden.waveform_counts(scaled, None, comp)
    hi = golden.histogram_counts(scaled, None, hi_cfg.components)
    hi_max = golden.histogram_hi_max(
        hi, hi_cfg.components, sw, sh, hi_cfg.level_fixed,
        hi_cfg.level_ratio_permille,
    )
    levels, hi_eff = golden.histogram_levels(
        hi, hi_max, hi_cfg.components, hi_cfg.logscale
    )
    zb_cfg, fc_cfg, fp_cfg = ZebraConfig(), FalseColorConfig(), FocusPeakingConfig()
    planar = lambda img: np.ascontiguousarray(np.moveaxis(img, -1, 0))  # noqa: E731
    return {
        "vectorscope": grender.render_vectorscope(
            vs, vs_cfg.intensity, CS, vs_cfg.color_type == 0
        ),
        "waveform": grender.render_waveform(
            wv, wv_cfg.intensity, int(wv_cfg.display), comp.n_components, False
        ),
        "histogram": grender.render_histogram(
            levels, hi_eff, hi_cfg.level_height, int(hi_cfg.display),
            hi_cfg.components.n_components, False,
        ),
        "zebra": planar(golden.zebra(
            frame, zb_cfg.th_low, zb_cfg.th_high, tm,
            calc_colorspace(zb_cfg.colorspace),
        )),
        "falsecolor": planar(
            golden.falsecolor(frame, calc_colorspace(fc_cfg.colorspace))
        ),
        "focuspeaking": planar(golden.focus_peaking(
            frame, fp_cfg.peaking_threshold, fp_cfg.peaking_rgba
        )),
        "vs_counts": vs,
        "wv_counts": wv,
        "hi_counts": hi,
    }


def check_outputs(name: str, out, want: dict) -> None:
    for field in out._fields:
        check(f"{name}.{field}", getattr(out, field), want[field])


def to8(plane16: np.ndarray, shift: int) -> np.ndarray:
    """The ingest host round-shift policy (pipeline/ingest.py ``_to8``)."""
    v = (plane16.astype(np.uint32) + (1 << (shift - 1))) >> shift
    return np.minimum(v, 255).astype(np.uint8)


def phase_full_step(rng, h: int, w: int, timing_frames: int = 50) -> None:
    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.ops import nv12_shift

    tm = np.float32(2.5)
    rand = random_frame(rng, h, w)
    bars = native.pattern("bars", w, h, 0)
    want = {"random": golden_outputs(rand, 2, 2.5),
            "bars": golden_outputs(bars, 2, 2.5)}

    step = make_full_step(h, w, cs=CS, scale=2)
    run = compile_program(f"full_step {w}x{h} s2 rgba", step, rand, tm)
    for content, f in (("random", rand), ("bars", bars)):
        check_outputs(f"rgba/{content}", run(f, tm), want[content])

    packed_step = make_full_step(h, w, cs=CS, scale=2, input_format="packed")
    pk = {c: f.view(np.uint32)[..., 0] for c, f in (("random", rand), ("bars", bars))}
    run = compile_program(f"full_step {w}x{h} s2 packed", packed_step,
                          pk["random"], tm)
    for content in pk:
        check_outputs(f"packed/{content}", run(pk[content], tm), want[content])
    # steady state on device-resident frames, fenced at the end
    dev = [jax.device_put(pk["random"]), jax.device_put(pk["bars"])]
    jax.block_until_ready(run(dev[0], tm))
    t0 = time.perf_counter()
    out = None
    for i in range(timing_frames):
        out = run(dev[i % 2], np.float32(i * 0.0667))
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1e3 / timing_frames
    print(f"steady state full_step {w}x{h} s2 packed: {ms:.3f} ms/frame "
          f"({1e3 / ms:.1f} fps, {timing_frames} frames)", flush=True)

    y = rng.integers(0, 256, (h, w), np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), np.uint8)
    nv_step = make_full_step(h, w, cs=CS, scale=2, input_format="nv12")
    run = compile_program(f"full_step {w}x{h} s2 nv12", nv_step, (y, uv), tm)
    ref = native.nv12_to_rgba(y, uv, cs=int(CS))
    check_outputs("nv12/random", run((y, uv), tm), golden_outputs(ref, 2, 2.5))

    shift = nv12_shift(10, msb_aligned=True)
    y16 = (rng.integers(0, 1024, (h, w)) << 6).astype(np.uint16)
    uv16 = (rng.integers(0, 1024, (h // 2, w)) << 6).astype(np.uint16)
    p010_step = make_full_step(h, w, cs=CS, scale=2, input_format="nv12",
                               nv12_shift=shift)
    run = compile_program(f"full_step {w}x{h} s2 p010", p010_step, (y16, uv16), tm)
    ref = native.nv12_to_rgba(to8(y16, shift), to8(uv16, shift), cs=int(CS))
    check_outputs("p010/random", run((y16, uv16), tm), golden_outputs(ref, 2, 2.5))

    for scale in (1, 3):
        s_step = make_full_step(h, w, cs=CS, scale=scale)
        run = compile_program(f"full_step {w}x{h} s{scale} rgba", s_step, rand, tm)
        check_outputs(f"rgba/s{scale}", run(rand, tm),
                      golden_outputs(rand, scale, 2.5))
    print("phase a: full step bit-exact", flush=True)


def _check_crop_counts(name, out, scaled, rect) -> None:
    x0, y0, x1, y1 = rect
    crop = scaled[y0:y1, x0:x1]
    yuv = golden.rgb_to_yuv_u8(crop, CS)
    check(f"{name}.vs_counts", out.vs_counts, golden.vectorscope_counts(yuv))
    check(f"{name}.hi_counts", out.hi_counts,
          golden.histogram_counts(crop, None, Components.RGB))
    wv = np.asarray(out.wv_counts)
    check(f"{name}.wv_counts", wv[:, :, x0:x1],
          golden.waveform_counts(crop, None, Components.RGB))
    if wv.shape[-1] != x1 - x0:
        outside = np.concatenate([wv[:, :, :x0], wv[:, :, x1:]], axis=-1)
        check(f"{name}.wv_counts outside the rect", outside,
              np.zeros_like(outside))


def phase_dock_step(rng, h: int, w: int) -> None:
    from obs_color_monitor_tpu.dock_step import make_dock_step

    tm = np.float32(1.0)
    f = random_frame(rng, h, w)
    scaled = golden.downscale(f, 2)
    sh, sw = scaled.shape[:2]
    step = make_dock_step(h, w, cs=CS, scale=2)
    run = compile_program(f"dock_step {w}x{h} static", step, f, tm)
    out = run(f, tm)
    assert out.panel.shape == (1536, 512, 4), out.panel.shape
    _check_crop_counts("dock static", out, scaled, (0, 0, sw, sh))

    dyn = make_dock_step(h, w, cs=CS, scale=2, dynamic_roi=True)
    rects = [(0, 0, sw, sh), (sw // 8, sh // 7, sw * 3 // 4, sh * 5 // 8),
             (sw // 2, sh // 2, sw // 2 + 1, sh // 2 + 1)]
    r0 = jnp.asarray(rects[0], jnp.int32)
    run = compile_program(f"dock_step {w}x{h} dynamic_roi", dyn, f, tm, r0)
    for rect in rects:
        out = run(f, tm, jnp.asarray(rect, jnp.int32))
        assert out.panel.shape == (1536, 512, 4), out.panel.shape
        _check_crop_counts(f"dock dynamic {rect}", out, scaled, rect)
    print("phase b: dock step bit-exact (3 rects, one program)", flush=True)


def phase_served(rng, h: int, w: int, n_frames: int = 30) -> None:
    from obs_color_monitor_tpu.models import Dock
    from obs_color_monitor_tpu.pipeline import PipelineDriver

    frames = [
        native.pattern("bars", w, h, i) if i % 3 == 1 else random_frame(rng, h, w)
        for i in range(n_frames)
    ]

    def make_dock():
        return Dock(DockConfig(), roi=ROIConfig(interleave=0, target_scale=2))

    dock = make_dock()
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=panels.append,
                         queue_depth=n_frames + 2)
    drv.start()
    t0 = time.perf_counter()
    try:
        for f in frames:
            assert drv.push_frame(f), "queue full"
        drv.flush(timeout=600.0)
        last = np.asarray(panels[-1])
    finally:
        drv.stop()
    dt = time.perf_counter() - t0
    st = drv.stats
    assert st["processed"] == n_frames and st["errors"] == 0, st
    assert st["dropped"] == 0, st
    print(f"served dock {w}x{h}: {n_frames} frames through PipelineDriver in "
          f"{dt:.2f} s (first frame compiles)", flush=True)

    scaled = golden.downscale(frames[-1], 2)
    yuv = golden.rgb_to_yuv_u8(scaled, Colorspace(int(dock.hub.colorspace)))
    res = dock.hub.last_surface.result
    want_wv = golden.waveform_counts(scaled, None, Components.RGB)
    want_hi = golden.histogram_counts(scaled, None, Components.RGB)
    check("served vs_counts", res.vs_counts, golden.vectorscope_counts(yuv))
    check("served wv_counts", res.wv_rgb, want_wv)
    check("served hi_counts", res.hi_rgb, want_hi)
    check("served waveform.counts()", dock.waveform.counts(), want_wv)
    check("served histogram.counts()", dock.histogram.counts(), want_hi)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        twin = make_dock()
        for f in frames:
            twin.push_frame(f)
            panel = twin.render_async()
        assert next(iter(panel.devices())).platform == "cpu"
        check("served panel vs the CPU device", last, np.asarray(panel))
    print("phase c: served dock bit-exact; panel identical to the CPU device",
          flush=True)


def phase_four_cards(rng, uhd=UHD, big=(4320, 7680)) -> None:
    from jax.sharding import NamedSharding, PartitionSpec as P

    from obs_color_monitor_tpu.api import make_batched_step
    from obs_color_monitor_tpu.golden.reference import peaking_threshold_fixed
    from obs_color_monitor_tpu.parallel import make_mesh, spatial_pipeline

    n = len(jax.devices())
    if n < 4:
        sys.exit(f"--four-cards needs 4 GPUs, found {n}")
    h, w = uhd
    mesh = make_mesh(4)
    frames = np.stack([random_frame(rng, h, w) for _ in range(4)])
    tms = np.arange(4, dtype=np.float32) * np.float32(0.5)
    sh = NamedSharding(mesh, P("batch"))
    step = make_batched_step(h, w, mesh=mesh, cs=CS, scale=2)
    fr, tm_d = jax.device_put(frames, sh), jax.device_put(tms, sh)
    run = compile_program(f"batched_step B=4 {w}x{h} s2", step, fr, tm_d)
    out = run(fr, tm_d)
    for b in range(4):
        want = golden_outputs(frames[b], 2, float(tms[b]))
        for field in out._fields:
            check(f"batch[{b}].{field}", getattr(out, field)[b], want[field])
    print(f"phase e: batch-DP B=4 at {w}x{h} over 4 cards bit-exact",
          flush=True)

    h8, w8 = big
    frame = random_frame(rng, h8, w8)
    t0 = time.perf_counter()
    vs, hi, wv, zb, fc, fp = spatial_pipeline(
        frame, make_mesh(4, axis="rows"), cs=int(CS), tm=1.5,
        peak_th=peaking_threshold_fixed(0.05),
    )
    jax.block_until_ready((vs, hi, wv, zb, fc, fp))
    print(f"spatial_pipeline {w8}x{h8} over 4 cards: first call "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    yuv = golden.rgb_to_yuv_u8(frame, CS)
    check("8K vs", vs, golden.vectorscope_counts(yuv))
    check("8K hist", hi, golden.histogram_counts(frame, None, Components.RGB))
    check("8K waveform", wv, golden.waveform_counts(frame, None, Components.RGB))
    planar = lambda img: np.moveaxis(img, -1, 0)  # noqa: E731
    check("8K zebra", zb, planar(golden.zebra(frame, 0.75, 1.0, 1.5, CS)))
    check("8K falsecolor", fc, planar(golden.falsecolor(frame, CS)))
    check("8K focuspeaking", fp,
          planar(golden.focus_peaking(frame, 0.05, (1.0, 0.0, 0.0, 1.0))))
    print(f"phase e: row-sharded {w8}x{h8} over 4 cards bit-exact", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX's default device is {platform!r}")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    print(f"jax {jax.__version__}; devices: "
          f"{[d.device_kind for d in jax.devices()]}", flush=True)

    rng = np.random.default_rng(20261016)
    if args.four_cards:
        phase_four_cards(rng)
    else:
        phase_full_step(rng, *UHD)
        phase_dock_step(rng, *FHD)
        phase_served(rng, *FHD)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
