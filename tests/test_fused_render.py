"""Fused one-program Dock.render (steady-state streaming).

When every shown scope exposes its published buffers
(render_leaves/render_traced), the dock fuses all scope renders + the
composite into ONE cached jitted program — a single device dispatch per
panel.  These tests pin (a) pixel parity with the legacy
per-scope route, (b) program reuse across frames, (c) rebuild on config
change, (d) recompile-free ROI drag through the fused route.
"""

import numpy as np
import pytest

from obs_color_monitor_tpu.config import DockConfig, ROIConfig
from obs_color_monitor_tpu.models import Dock


class _NoCache(dict):
    """Cache stub that never hits nor stores: forces the legacy route."""

    def get(self, k, default=None):
        return None

    def __setitem__(self, k, v):
        pass


def _mk_dock(show_roi=False, legacy=False):
    cfg = DockConfig(show_roi=show_roi)
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    # pin the fused-render route: the one-program stream step would bypass
    # it in steady state (its own coverage lives in test_stream_step.py)
    dock._stream_fns = None
    if legacy:
        dock._fused_render_fns = _NoCache()
    return dock


def _frames(n, rng):
    return [rng.integers(0, 256, (48, 96, 4), dtype=np.uint8) for _ in range(n)]


def test_fused_render_matches_legacy_streaming(rng):
    """Frame-by-frame pixel parity: fused (2nd render on) vs legacy-only."""
    fused = _mk_dock(show_roi=True)
    legacy = _mk_dock(show_roi=True, legacy=True)
    for i, f in enumerate(_frames(4, rng)):
        f[..., 3] = 255
        fused.push_frame(f)
        legacy.push_frame(f)
        a = fused.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    # after the first (legacy, layout-discovering) render the fused program
    # exists and the stream reuses exactly one entry
    assert len(fused._fused_render_fns) == 1


def test_fused_program_is_reused(rng):
    dock = _mk_dock()
    for f in _frames(2, rng):
        f[..., 3] = 255
        dock.push_frame(f)
        dock.render(width=128, height=600)
    (key,) = dock._fused_render_fns
    fn, rects, included = dock._fused_render_fns[key]
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    dock._fused_render_fns[key] = (counting, rects, included)
    for f in _frames(3, rng):
        f[..., 3] = 255
        dock.push_frame(f)
        dock.render(width=128, height=600)
    assert len(calls) == 3
    assert len(dock._fused_render_fns) == 1


def test_fused_rebuilds_on_config_change(rng):
    """A config change must invalidate the fused program (new trace key)."""
    dock = _mk_dock()
    legacy = _mk_dock(legacy=True)
    fs = _frames(3, rng)
    for f in fs:
        f[..., 3] = 255
    for d in (dock, legacy):
        for f in fs[:2]:  # two frames: tick-gated buffers all published
            d.push_frame(f)
            d.render(width=128, height=600)
        d.waveform.config.intensity = 255
        d.vectorscope.config.zoom = 2.0
        d.push_frame(fs[2])
    np.testing.assert_array_equal(
        dock.render(width=128, height=600), legacy.render(width=128, height=600)
    )
    assert len(dock._fused_render_fns) == 2  # old + new key


def test_fused_roi_drag_translation_reuses_program(rng):
    """Moving the ROI rect (same size) changes only LEAVES — the crop shape
    and trace key are unchanged, so the panel follows the rect with no new
    fused entry.  (A rect RESIZE changes the consumers' crop shapes and
    legitimately rebuilds — the reference re-allocs its textures there too,
    src/roi.c:77-104; the recompile-free-resize path is the dock_step
    dynamic_roi build, tests/test_dynamic_roi.py.)"""
    dock = _mk_dock(show_roi=True)
    legacy = _mk_dock(show_roi=True, legacy=True)
    f = _frames(1, rng)[0]
    f[..., 3] = 255
    outs = []
    n0 = None
    for i, rect in enumerate([(5, 5, 55, 35), (5, 5, 55, 35),
                              (20, 10, 70, 40), (1, 2, 51, 32)]):
        for d in (dock, legacy):
            d.hub.config.x0, d.hub.config.y0 = rect[0], rect[1]
            d.hub.config.x1, d.hub.config.y1 = rect[2], rect[3]
            d.push_frame(f)
        a = dock.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        np.testing.assert_array_equal(a, b, err_msg=f"rect {rect}")
        outs.append(a)
        if i == 1:  # two frames in: tick-gated buffers published, fused built
            n0 = len(dock._fused_render_fns)
            assert n0 == 1
    assert len(dock._fused_render_fns) == n0  # translations never rebuilt
    assert (outs[2] != outs[3]).any()  # and the content actually moved
