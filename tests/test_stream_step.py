"""One-program stream step (Dock.push_frame + render_async steady state).

When configs are static and only the default consumers are registered,
push_frame defers the analysis and render_async runs analyze + hub
publication + every scope render + the composite as ONE cached device
program per frame (each separate program execution pays its own
dispatch).  These tests pin (a) frame-by-frame
pixel AND published-statistics parity with the legacy hub route,
(b) single-program reuse, (c) interleave-skip semantics, (d) fallbacks:
custom consumers, push-without-render, bypass.
"""

import numpy as np
import pytest

from obs_color_monitor_tpu.config import DockConfig, ROIConfig
from obs_color_monitor_tpu.models import Dock


def _mk(stream=True, interleave=0, show_roi=False, rect=None):
    roi = ROIConfig(interleave=interleave, target_scale=1)
    if rect is not None:
        roi.x0, roi.y0, roi.x1, roi.y1 = rect
    dock = Dock(DockConfig(show_roi=show_roi), roi=roi)
    if not stream:
        dock._stream_fns = None  # legacy/fused only
    return dock


def _frames(n, rng, shape=(48, 96)):
    out = []
    for _ in range(n):
        f = rng.integers(0, 256, shape + (4,), dtype=np.uint8)
        f[..., 3] = 255
        out.append(f)
    return out


def _assert_scope_state_equal(a: Dock, b: Dock, msg=""):
    np.testing.assert_array_equal(
        a.histogram.counts(), b.histogram.counts(), err_msg=f"hist {msg}"
    )
    np.testing.assert_array_equal(
        a.waveform.counts(), b.waveform.counts(), err_msg=f"wv {msg}"
    )
    np.testing.assert_array_equal(
        np.asarray(a.vectorscope._read()),
        np.asarray(b.vectorscope._read()),
        err_msg=f"vs {msg}",
    )
    np.testing.assert_array_equal(
        np.asarray(a.zebra.render_image()),
        np.asarray(b.zebra.render_image()),
        err_msg=f"zebra {msg}",
    )


def test_stream_matches_legacy_frame_by_frame(rng):
    stream, legacy = _mk(), _mk(stream=False)
    for i, f in enumerate(_frames(6, rng)):
        stream.push_frame(f)
        legacy.push_frame(f)
        a = stream.render(width=128, height=600)
        b = legacy.render(width=128, height=600)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
        _assert_scope_state_equal(stream, legacy, f"frame {i}")
    assert len(stream._stream_fns) == 1
    assert stream.hub.frames_processed == legacy.hub.frames_processed


def test_stream_with_roi_preview_and_rect(rng):
    """Static ROI rect: the rect is baked into the stream program (the hub
    route recompiles analyze per rect too); panel + stats stay identical."""
    kw = dict(show_roi=True, rect=(8, 4, 72, 40))
    stream, legacy = _mk(**kw), _mk(stream=False, **kw)
    for i, f in enumerate(_frames(4, rng)):
        stream.push_frame(f)
        legacy.push_frame(f)
        a = stream.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    _assert_scope_state_equal(stream, legacy)
    assert len(stream._stream_fns) == 1
    assert stream._rects == legacy._rects


def test_stream_program_reused_not_retraced(rng):
    dock = _mk()
    fs = _frames(6, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=600)
    assert len(dock._stream_fns) == 1
    (skey,) = dock._stream_fns
    fn, rects, wy, hy = dock._stream_fns[skey]
    calls = []

    def counting(*a):
        calls.append(1)
        return fn(*a)

    dock._stream_fns[skey] = (counting, rects, wy, hy)
    dock._stream_fast = None  # drop the steady-state shortcut: the next
    # frame must re-resolve from _stream_fns (picking up the counter),
    # NOT rebuild the program
    keyed = []
    orig_fused_key = dock._fused_key

    def counting_key(*a):
        keyed.append(1)
        return orig_fused_key(*a)

    dock._fused_key = counting_key
    for f in fs[3:]:
        dock.push_frame(f)
        dock.render(width=128, height=600)
    assert len(calls) == 3
    assert len(dock._stream_fns) == 1
    # the steady-state fast path re-derives the fused key only on the one
    # post-reset frame; later frames skip key/leaf rederivation entirely
    assert len(keyed) == 1


def test_stream_interleave_parity(rng):
    """interleave=1 (the reference default): every other frame is skipped;
    skipped frames re-render the published buffers (reference
    src/roi.c:266-277).  Stream route must match the hub bit-for-bit."""
    stream, legacy = _mk(interleave=1), _mk(stream=False, interleave=1)
    for i, f in enumerate(_frames(7, rng)):
        stream.push_frame(f)
        legacy.push_frame(f)
        a = stream.render(width=128, height=600)
        b = legacy.render(width=128, height=600)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    assert stream.hub.frames_processed == legacy.hub.frames_processed
    assert stream.hub.frames_skipped == legacy.hub.frames_skipped
    _assert_scope_state_equal(stream, legacy)


def test_push_without_render_flushes_through_hub(rng):
    """push-push-render: the unrendered frame must still be analyzed and
    published (headless consumers poll scope state between renders)."""
    stream, legacy = _mk(), _mk(stream=False)
    fs = _frames(5, rng)
    # warm up the stream route
    for f in fs[:2]:
        stream.push_frame(f)
        legacy.push_frame(f)
        stream.render(width=128, height=600)
        legacy.render(width=128, height=600)
    # two pushes, no render in between
    for f in fs[2:4]:
        stream.push_frame(f)
        legacy.push_frame(f)
    # the first of the two was flushed through the hub: published stats
    # advance identically (the second is pending analysis on the stream
    # dock and processed on the legacy dock — rendering flushes it)
    a = stream.render(width=128, height=600)
    b = legacy.render(width=128, height=600)
    np.testing.assert_array_equal(a, b)
    _assert_scope_state_equal(stream, legacy)
    assert stream.hub.frames_processed == legacy.hub.frames_processed


def test_custom_consumer_disables_stream(rng):
    """A registered non-default consumer must see every processed frame's
    surface_cb — the stream route steps aside entirely."""
    dock = _mk()
    seen = []

    class Probe:
        def needs(self):
            from obs_color_monitor_tpu.models.base import Needs

            return Needs(rgba=True)

        def surface_cb(self, surface):
            seen.append(surface.result.planes.shape)

        def tick(self, seconds=1.0 / 60.0):
            pass

    dock.hub.register(Probe())
    for f in _frames(4, rng):
        dock.push_frame(f)
        dock.render(width=128, height=600)
    assert len(seen) == 4
    assert len(dock._stream_fns) == 0


def test_bypass_disables_stream(rng):
    dock = _mk()
    fs = _frames(4, rng)
    for f in fs[:2]:
        dock.push_frame(f)
        dock.render(width=128, height=600)
    dock.waveform.config.bypass = True
    for f in fs[2:]:
        dock.push_frame(f)
        dock.render(width=128, height=600)
    # bypass needs the captured frame through the hub every frame
    assert dock.waveform._bypass_planes is not None


def test_config_change_rebuilds_stream_program(rng):
    stream, legacy = _mk(), _mk(stream=False)
    fs = _frames(5, rng)
    for f in fs[:3]:
        stream.push_frame(f)
        legacy.push_frame(f)
        stream.render(width=128, height=600)
        legacy.render(width=128, height=600)
    for d in (stream, legacy):
        d.waveform.config.intensity = 255
        d.histogram.config.logscale = True
    for i, f in enumerate(fs[3:]):
        stream.push_frame(f)
        legacy.push_frame(f)
        a = stream.render(width=128, height=600)
        b = legacy.render(width=128, height=600)
        np.testing.assert_array_equal(a, b, err_msg=f"post-change {i}")
    assert len(stream._stream_fns) == 2  # old + new key


def test_live_drag_serves_dynamic_step(rng):
    """A move-drag changes the hub rect every frame (reference pushes the
    rect per tick, roi_send_range src/roi.c:478-520); streaming serves every
    rect from ONE compiled dynamic-rect program — zero recompiles — with
    exact published vectorscope/histogram statistics, then resumes the
    exact per-rect stream path when the rect settles."""
    from obs_color_monitor_tpu.config import Components
    from obs_color_monitor_tpu.golden import reference as golden
    from obs_color_monitor_tpu.models.roi_interact import DRAG_MOVE

    dock = _mk(show_roi=True)
    fs = _frames(12, rng)
    for f in fs[:3]:  # warm the full-rect stream route
        dock.push_frame(f)
        dock.render(width=128, height=700)
    assert len(dock._stream_fns) == 1
    # a programmatic rect change routes the next frame onto the dynamic step
    dock.hub.set_roi(10, 8, 60, 40)
    dock.push_frame(fs[3])
    dock.render(width=128, height=700)
    assert dock._device_step_dynamic
    step = dock._device_step
    assert step._cache_size() == 1

    x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]

    def to_panel(sx, sy):
        # ceil: _hit's inverse is floor((x - x0) * ws / wb), so the
        # smallest panel pixel mapping back to (sx, sy) exactly
        return x0b + -(-sx * wb // ws), y0b + -(-sy * hb // hs)

    dock.mouse_move(*to_panel(30, 20))  # hover inside the rect
    dock.mouse_down(*to_panel(30, 20))
    assert dock.roi_interact.flags & DRAG_MOVE
    cs = dock.hub.colorspace
    rects_seen = set()
    for i, f in enumerate(fs[4:9]):
        dock.mouse_move(*to_panel(30 + 2 * (i + 1), 20 + (i + 1)))
        r = dock.hub.config.resolve_rect(96, 48)
        rects_seen.add(r)
        dock.push_frame(f)
        p = np.asarray(dock.render(width=128, height=700))
        # the panel is the dynamic step's own output for this rect, plus
        # the green committed-rect indicator the reference draws during a
        # move drag (roi_render, src/roi.c:306-308)
        out = step(
            f.view(np.uint32).reshape(48, 96),
            np.float32(dock.zebra.tm),
            np.asarray(r, np.int32),
        )
        diff = p != np.asarray(out.panel)
        green = np.array([0, 255, 0, 255], np.uint8)
        # any extra pixels are the indicator (often a subset of the
        # step's own in-program border -> zero diff is fine too)
        assert (p[diff.any(axis=-1)] == green).all()
        # published statistics are exact for the live rect
        crop = golden.roi_crop(f, *r)
        yuv = golden.rgb_to_yuv_u8(crop, cs)
        np.testing.assert_array_equal(
            np.asarray(dock.vectorscope._read()),
            golden.vectorscope_counts(yuv),
        )
        hi, n_px = dock.histogram._read()
        np.testing.assert_array_equal(
            np.asarray(hi), golden.histogram_counts(crop, None, Components.RGB)
        )
        assert n_px == (r[2] - r[0]) * (r[3] - r[1])
    assert len(rects_seen) == 5  # the rect moved every frame
    assert step._cache_size() == 1  # ...through ONE compiled program
    assert dock._device_step is step
    dock.mouse_up(*to_panel(40, 25))
    # park the pointer off the roi band: hovering the region keeps the
    # green outline drawn (reference roi_render w/ DRAW_ROI_RECT), which
    # would differ from the mouse-less legacy twin below
    dock.mouse_move(0, 699)
    assert dock.roi_interact.flags == 0

    # settled: the exact per-rect stream path resumes (hub-route parity)
    final = dock.hub.config.resolve_rect(96, 48)
    legacy = _mk(stream=False, show_roi=True)
    legacy.hub.set_roi(*final)
    dock.push_frame(fs[9])
    legacy.push_frame(fs[9])
    dock.render(width=128, height=700)
    legacy.render(width=128, height=700)
    for f in fs[10:]:
        dock.push_frame(f)
        legacy.push_frame(f)
        a = dock.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _assert_scope_state_equal(dock, legacy)


def test_sizing_drag_outlines_selection(rng):
    """A corner-handle resize drag keeps the committed rect (and its stream
    program) but outlines the in-progress selection on the panel
    (reference draw_roi_rect, src/roi.c:236-265)."""
    dock = _mk(show_roi=True)
    fs = _frames(6, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]

    def to_panel(sx, sy):
        # ceil: _hit's inverse is floor((x - x0) * ws / wb), so the
        # smallest panel pixel mapping back to (sx, sy) exactly
        return x0b + -(-sx * wb // ws), y0b + -(-sy * hb // hs)

    dock.push_frame(fs[3])
    dock.render(width=128, height=700)
    # second render of the SAME frame state (no push between): same tm,
    # same published stats — the before/after pair differs only by the
    # drag outline
    base = np.asarray(dock.render(width=128, height=700))
    # first-selection drag over empty state
    dock.mouse_move(*to_panel(20, 10))
    dock.mouse_down(*to_panel(20, 10))
    dock.mouse_move(*to_panel(70, 40))
    assert dock.roi_interact.sizing_rect() == (20, 10, 70, 40)
    p = np.asarray(dock.render(width=128, height=700))
    green = np.array([0, 255, 0, 255], np.uint8)
    assert (p == green).all(axis=-1).any()
    # the committed rect never changed: still the full-rect stream program
    assert dock.hub.config.resolve_rect(96, 48) == (0, 0, 96, 48)
    diff = p != base
    ys, xs = np.where(diff.any(axis=-1))
    # changes are exactly the outline, confined to the preview band
    assert ys.size and (ys < y0b + hb).all() and (ys >= y0b).all()
    assert (p[ys, xs] == green).all()
    dock.mouse_up(*to_panel(70, 40))
    assert dock.hub.config.resolve_rect(96, 48) == (20, 10, 70, 40)


def test_settled_rect_change_uses_fresh_layout(rng):
    """The first settled frame after a rect change must NOT pair the old
    rect's layout spec with the new rect's analysis: the published leaves
    are republished at the new rect (one hub fan-out frame) before any
    stream program is built, so slot geometry always matches the live
    crop and converges to the legacy route bit-exactly."""
    dock = _mk(show_roi=True)
    legacy = _mk(stream=False, show_roi=True)
    fs = _frames(10, rng)
    for d in (dock, legacy):
        d.hub.set_roi(10, 8, 60, 40)  # 50x32 crop (wide)
    for f in fs[:3]:
        for d in (dock, legacy):
            d.push_frame(f)
            d.render(width=128, height=700)
    assert dock._rects["roi"][4:] == (50, 32)
    for d in (dock, legacy):
        d.hub.set_roi(30, 4, 50, 44)  # 20x40 crop (tall) - new aspect
    for i, f in enumerate(fs[3:]):
        dock.push_frame(f)
        legacy.push_frame(f)
        a = np.asarray(dock.render(width=128, height=700))
        b = np.asarray(legacy.render(width=128, height=700))
        if i >= 1:
            # i==0 is the dynamic-step frame (static bands over the full
            # capture); from the settle frame on, the slot geometry must
            # track the NEW crop, never the old wide aspect
            assert dock._rects["roi"][4:] == (20, 40), f"frame {i}"
        if i >= 2:
            # published state has converged: panels match legacy exactly
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
    _assert_scope_state_equal(dock, legacy)


def test_flush_publishes_pending_statistics(rng):
    """Dock.flush: a push-then-poll consumer sees the pushed frame's
    statistics without rendering (the stream route otherwise defers the
    analysis into the next render)."""
    from obs_color_monitor_tpu.config import Components
    from obs_color_monitor_tpu.golden import reference as golden

    dock = _mk()
    fs = _frames(4, rng)
    for f in fs[:3]:  # warm the stream route (deferral active)
        dock.push_frame(f)
        dock.render(width=128, height=600)
    dock.push_frame(fs[3])
    assert dock._pending is not None  # deferred
    dock.flush()
    assert dock._pending is None
    hi, _ = dock.histogram._read()
    np.testing.assert_array_equal(
        np.asarray(hi),
        golden.histogram_counts(fs[3], None, Components.RGB),
    )
    # rendering afterwards is still consistent (no double processing)
    n = dock.hub.frames_processed
    dock.render(width=128, height=600)
    assert dock.hub.frames_processed == n


def test_live_drag_custom_configs_and_midrag_config_change(rng):
    """Drag streaming with non-default configs (falsecolor LUT + RIGHT key
    legend): the cached-program key (tuple config_key + LUT fingerprint)
    serves every rect from ONE dynamic program with exact stats; mutating a
    config mid-drag rebuilds the program (a stale key must not survive)."""
    from obs_color_monitor_tpu.config import Components, ShowKey
    from obs_color_monitor_tpu.golden import reference as golden

    dock = _mk(show_roi=True)
    lut = np.stack([
        np.arange(256, dtype=np.uint8),
        np.arange(255, -1, -1, dtype=np.uint8),
        np.full(256, 40, np.uint8),
        np.full(256, 255, np.uint8),
    ], axis=1)
    dock.falsecolor.update(use_lut=True, lut=lut, show_key=ShowKey.RIGHT)
    fs = _frames(12, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    cs = dock.hub.colorspace
    # programmatic per-frame rect changes ride the dynamic route
    for i, f in enumerate(fs[3:8]):
        dock.hub.set_roi(5 + 2 * i, 4 + i, 70 + 2 * i, 40 + i)
        r = dock.hub.config.resolve_rect(96, 48)
        dock.push_frame(f)
        dock.render(width=128, height=700)
        assert dock._device_step_dynamic, f"frame {i}"
        crop = golden.roi_crop(f, *r)
        yuv = golden.rgb_to_yuv_u8(crop, cs)
        np.testing.assert_array_equal(
            np.asarray(dock.vectorscope._read()),
            golden.vectorscope_counts(yuv), err_msg=f"frame {i}",
        )
    step = dock._device_step
    assert step._cache_size() == 1  # five rects, one compiled program
    # mid-drag config mutation -> the device-step key must miss and rebuild
    dock.falsecolor.update(show_key=ShowKey.LEFT)
    dock.hub.set_roi(30, 10, 80, 44)
    dock.push_frame(fs[8])
    dock.render(width=128, height=700)
    assert dock._device_step is not step
    assert dock._device_step_dynamic


def test_move_drag_from_settled_crop_view(rng):
    """A settled non-full rect displays the CROP in the preview band; mouse
    coords there are crop-local while the interact state machine works in
    scaled-capture space (the reference's ROI view is always the full
    target) — the bridge offsets by the committed rect origin, so moving
    the rect from the crop view lands exactly."""
    from obs_color_monitor_tpu.golden import reference as golden
    from obs_color_monitor_tpu.models.roi_interact import DRAG_MOVE

    dock = _mk(show_roi=True)
    fs = _frames(10, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    dock.hub.set_roi(20, 10, 70, 40)
    for f in fs[3:6]:  # dynamic frame, resync frame, stream frame
        dock.push_frame(f)
        dock.render(width=128, height=700)
    assert dock._roi_shows_crop
    assert dock._rects["roi"][4:] == (50, 30)  # band displays the crop

    def cap_to_panel(cx_, cy_):
        x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]
        ox, oy = dock._roi_crop_origin  # the DISPLAYED crop's origin
        return (
            x0b + -(-(cx_ - ox) * wb // ws),
            y0b + -(-(cy_ - oy) * hb // hs),
        )

    dock.mouse_move(*cap_to_panel(40, 25))
    dock.mouse_down(*cap_to_panel(40, 25))
    assert dock.roi_interact.flags & DRAG_MOVE
    dock.mouse_move(*cap_to_panel(50, 30))  # drag +10,+5 in capture space
    assert dock.hub.config.resolve_rect(96, 48) == (30, 15, 80, 45)
    cs = dock.hub.colorspace
    dock.push_frame(fs[6])
    dock.render(width=128, height=700)
    assert not dock._roi_shows_crop  # mid-drag: dynamic full-capture view
    crop = golden.roi_crop(fs[6], 30, 15, 80, 45)
    np.testing.assert_array_equal(
        np.asarray(dock.vectorscope._read()),
        golden.vectorscope_counts(golden.rgb_to_yuv_u8(crop, cs)),
    )
    # the drag continues in full-view coordinates (no crop offset now)
    dock.mouse_move(*cap_to_panel(52, 31))
    assert dock.hub.config.resolve_rect(96, 48) == (32, 16, 82, 46)
    dock.mouse_up(*cap_to_panel(52, 31))
    assert dock.hub.config.resolve_rect(96, 48) == (32, 16, 82, 46)


def test_multi_move_drag_between_renders_no_drift(rng):
    """Many mouse-move events between two renders (the normal UI cadence —
    mouse rates exceed display rates) must track the cursor 1:1 from a
    settled crop view: the crop offset is snapshotted at render time, so
    mid-drag rect commits cannot compound into runaway drift (each event
    once gained an offset equal to ALL prior motion)."""
    from obs_color_monitor_tpu.models.roi_interact import DRAG_MOVE

    dock = _mk(show_roi=True)
    fs = _frames(8, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    dock.hub.set_roi(20, 10, 70, 40)
    for f in fs[3:6]:  # dynamic, resync, stream: crop view settles
        dock.push_frame(f)
        dock.render(width=128, height=700)
    assert dock._roi_shows_crop

    x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]
    ox, oy = dock._roi_crop_origin
    assert (ox, oy) == (20, 10)

    def cap_to_panel(cx_, cy_):
        return (
            x0b + -(-(cx_ - ox) * wb // ws),
            y0b + -(-(cy_ - oy) * hb // hs),
        )

    dock.mouse_move(*cap_to_panel(40, 25))
    dock.mouse_down(*cap_to_panel(40, 25))
    assert dock.roi_interact.flags & DRAG_MOVE
    # three 1-px moves with NO render in between: total shift must be +3,
    # not +1,+2,+3 compounding
    for dx in (1, 2, 3):
        dock.mouse_move(*cap_to_panel(40 + dx, 25))
    assert dock.hub.config.resolve_rect(96, 48) == (23, 10, 73, 40)
    dock.mouse_up(*cap_to_panel(43, 25))
    assert dock.hub.config.resolve_rect(96, 48) == (23, 10, 73, 40)


def test_hover_indicators_and_leave(rng):
    """Hovering the committed region draws its green outline; hovering near
    an edge adds the resize-handle indicator line; moving off the band
    sends a leave and clears the indicators (reference roi_render +
    draw_roi_rect src/roi.c:183-242,304-308, leave scope-widget.cpp:379)."""
    from obs_color_monitor_tpu.models.roi_interact import (
        DRAW_ROI_RECT, HANDLE_LI,
    )

    dock = _mk(show_roi=True)
    fs = _frames(4, rng)
    for f in fs:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]

    def tp(sx, sy):
        return x0b + -(-sx * wb // ws), y0b + -(-sy * hb // hs)

    # commit a rect by dragging
    dock.mouse_move(*tp(20, 10))
    dock.mouse_down(*tp(20, 10))
    dock.mouse_move(*tp(70, 40))
    dock.mouse_up(*tp(70, 40))
    assert dock.hub.config.resolve_rect(96, 48) == (20, 10, 70, 40)
    dock.mouse_move(0, 699)  # park off-band
    assert dock.roi_interact.flags == 0
    base = np.asarray(dock.render(width=128, height=700))
    green = np.array([0, 255, 0, 255], np.uint8)

    # hover the region center: outline only
    dock.mouse_move(*tp(45, 25))
    assert dock.roi_interact.flags == DRAW_ROI_RECT
    p_center = np.asarray(dock.render(width=128, height=700))
    d_center = (p_center != base).any(axis=-1)
    assert d_center.sum() > 0 and (p_center[d_center] == green).all()

    # hover the left edge: outline + handle indicator line
    dock.mouse_move(*tp(21, 25))
    assert dock.roi_interact.flags == (DRAW_ROI_RECT | HANDLE_LI)
    p_edge = np.asarray(dock.render(width=128, height=700))
    d_edge = (p_edge != base).any(axis=-1)
    assert (p_edge[d_edge] == green).all()
    assert d_edge.sum() > d_center.sum()  # the handle line adds pixels

    # leave clears everything
    dock.mouse_move(0, 699)
    assert dock.roi_interact.flags == 0
    np.testing.assert_array_equal(
        np.asarray(dock.render(width=128, height=700)), base
    )


def test_indicator_pixel_convention_matches_inprogram_border():
    """Indicator segments use the same half-open-rect pixel convention as
    _shaded_preview and the dynamic step's in-program border: lines sit on
    the LAST included pixel (x1-1/y1-1), so an overlaid outline and an
    in-program border land on the same source pixels (no doubled, offset
    border after band resampling)."""
    from obs_color_monitor_tpu.models.roi_interact import InteractiveROI

    ri = InteractiveROI(width=96, height=48)
    ri.x0in, ri.y0in, ri.x1in, ri.y1in = 20, 10, 70, 40
    ri.mouse_move(45, 25)  # hover the region center: outline only, 4 segs
    segs = ri.indicator_segments()
    assert len(segs) == 4
    xs = [c for s in segs for c in (s[0], s[2])]
    ys = [c for s in segs for c in (s[1], s[3])]
    assert min(xs) == 20 and max(xs) == 69  # x1 - 1, not x1
    assert min(ys) == 10 and max(ys) == 39  # y1 - 1, not y1


def test_offview_drag_segments_clipped_not_collapsed(rng):
    """From a settled crop view, resize-dragging an edge outside the
    displayed crop must CLIP the sizing outline: the off-view left edge is
    dropped, not collapsed onto the band's left column as a spurious
    full-height line."""
    from obs_color_monitor_tpu.models.roi_interact import (
        DRAG_RESIZE, HANDLE_LO,
    )

    dock = _mk(show_roi=True)
    fs = _frames(8, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    dock.hub.set_roi(20, 10, 34, 24)  # small rect: outside handles
    for f in fs[3:6]:  # dynamic, resync, stream: the crop view settles
        dock.push_frame(f)
        dock.render(width=128, height=700)
    assert dock._roi_shows_crop
    x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]
    ox, oy = dock._roi_crop_origin
    assert (ox, oy) == (20, 10)

    def cap_to_panel(cx_, cy_):
        return (
            x0b + -(-(cx_ - ox) * wb // ws),
            y0b + -(-(cy_ - oy) * hb // hs),
        )

    # grab the left (outside) handle at the crop's left column...
    dock.mouse_move(*cap_to_panel(20, 17))
    assert dock.roi_interact.flags & HANDLE_LO
    dock.mouse_down(*cap_to_panel(20, 17))
    assert dock.roi_interact.flags & DRAG_RESIZE
    # ...and drag it 10 px left, outside the displayed crop (the grab
    # keeps routing even though the pointer leaves the band)
    dock.mouse_move(*cap_to_panel(10, 17))
    assert dock.roi_interact.sizing_rect() == (10, 10, 34, 24)
    p = np.asarray(dock.render(width=128, height=700))  # no push: crop view
    green = np.array([0, 255, 0, 255], np.uint8)
    # the sizing outline's left edge lies off-view; the band's left column
    # must NOT be a full-height green line (only the clipped horizontal
    # top/bottom edges may cross it)
    col = p[y0b : y0b + hb, x0b]
    n_green = int((col == green).all(axis=-1).sum())
    assert n_green <= 4, n_green
    # the in-view right edge still draws (at x1-1 in capture space);
    # drawn segments use the FLOOR capture->band mapping (mx in
    # render_async), unlike cap_to_panel's ceil (which inverts the
    # band->capture mouse mapping)
    right = p[y0b : y0b + hb, x0b + (33 - ox) * wb // ws]
    assert (right == green).all(axis=-1).sum() > hb // 2
    dock.mouse_up(*cap_to_panel(10, 17))


def test_interact_dims_track_capture_resolution(rng):
    """Handle geometry tracks the LIVE capture size (the reference
    recomputes roi_get_width/height per event, src/roi.c:146-156):
    a capture-resolution change refreshes the interact's dims, and the
    steady stream route keeps hub.capture_size current without a
    hub.process call."""
    dock = _mk(show_roi=True)
    for f in _frames(3, rng):
        dock.push_frame(f)
        dock.render(width=128, height=700)
    x0b, y0b = dock._rects["roi"][:2]
    dock.mouse_move(x0b + 1, y0b + 1)
    assert dock.roi_interact.width == 96
    assert dock.roi_interact.height == 48
    # switch the source to a 192x96 capture; stream until steady
    for f in _frames(4, rng, shape=(96, 192)):
        dock.push_frame(f)
        dock.render(width=128, height=700)
    # steady state: the stream step (not hub.process) served the last
    # frames, and it kept capture_size current
    assert dock.hub.capture_size == (192, 96)
    n = dock.hub.frames_processed
    dock.hub.capture_size = (7, 7)  # poison: only the stream route resets
    dock.push_frame(_frames(1, rng, shape=(96, 192))[0])
    dock.render(width=128, height=700)
    assert dock.hub.frames_processed == n + 1
    assert dock.hub.capture_size == (192, 96)
    # a mouse event now sees the new dims
    dock.mouse_move(x0b + 1, y0b + 1)
    assert dock.roi_interact.width == 192
    assert dock.roi_interact.height == 96


def test_direct_hub_process_crop_origin(rng):
    """Driving hub.process directly (push_frame's documented alternative)
    and then committing a new rect: mouse/indicator rendering must
    translate through the PUBLISHED crop's origin, not the live config —
    the displayed planes still show the old crop until the next process."""
    dock = _mk(show_roi=True)
    fs = _frames(4, rng)
    dock.hub.set_roi(20, 10, 70, 40)
    for f in fs[:2]:
        dock.hub.process(f)
        dock.hub.tick()
    dock.render(width=128, height=700)
    assert dock._roi_shows_crop and dock._leaves_rect is None
    assert dock._roi_crop_origin == (20, 10)
    # a rect commit ahead of the display (e.g. mid-drag) must not move
    # the origin until the new crop is actually published
    dock.hub.set_roi(40, 20, 90, 48)
    dock.render(width=128, height=700)
    assert dock._roi_crop_origin == (20, 10)
    dock.hub.process(fs[2])
    dock.render(width=128, height=700)
    assert dock._roi_crop_origin == (40, 20)


def _nv12_frames(n, rng, shape=(48, 96)):
    h, w = shape
    return [
        (
            rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h // 2, w), dtype=np.uint8),
        )
        for _ in range(n)
    ]


def test_nv12_stream_one_program(rng, monkeypatch):
    """push_nv12 steady state: the device decode folds INTO the stream
    program — ONE device program per frame with ZERO eager nv12_to_packed
    dispatches (the reference's pipeline is one path regardless of source
    format, src/common.c:223-333) — panel + published stats identical to
    the legacy route (hub.process_nv12, which decodes separately)."""
    from obs_color_monitor_tpu.ops import convert as conv

    stream, legacy = _mk(show_roi=True), _mk(stream=False, show_roi=True)
    fs = _nv12_frames(8, rng)
    for i, (y, uv) in enumerate(fs[:4]):
        stream.push_nv12(y, uv)
        legacy.push_nv12(y, uv)
        a = stream.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
        _assert_scope_state_equal(stream, legacy, f"frame {i}")
    assert len(stream._stream_fns) == 1
    # dispatch-count assert: steady state issues NO separate decode — the
    # only nv12_to_packed call sites left are trace-time (program builds)
    calls = []
    orig = conv.nv12_to_packed

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(conv, "nv12_to_packed", counting)
    for y, uv in fs[4:]:
        stream.push_nv12(y, uv)
        stream.render(width=128, height=700)
    assert calls == []
    assert len(stream._stream_fns) == 1
    assert stream.hub.frames_processed == 8


def test_nv12_live_drag_dynamic_step(rng):
    """A rect drag during NV12 streaming rides the dynamic-rect step with
    the decode in-program: exact published stats per rect, one compiled
    program across the drag."""
    from obs_color_monitor_tpu.config import Components
    from obs_color_monitor_tpu.golden import reference as golden
    from obs_color_monitor_tpu.runtime import native

    dock = _mk(show_roi=True)
    fs = _nv12_frames(10, rng)
    for y, uv in fs[:3]:
        dock.push_nv12(y, uv)
        dock.render(width=128, height=700)
    cs = dock.hub.colorspace
    for i, (y, uv) in enumerate(fs[3:8]):
        dock.hub.set_roi(5 + 2 * i, 4 + i, 70 + 2 * i, 40 + i)
        r = dock.hub.config.resolve_rect(96, 48)
        dock.push_nv12(y, uv)
        dock.render(width=128, height=700)
        assert dock._device_step_dynamic, f"frame {i}"
        rgba = native.nv12_to_rgba(y, uv, cs=int(cs))
        crop = golden.roi_crop(rgba, *r)
        np.testing.assert_array_equal(
            np.asarray(dock.vectorscope._read()),
            golden.vectorscope_counts(golden.rgb_to_yuv_u8(crop, cs)),
            err_msg=f"frame {i}",
        )
        np.testing.assert_array_equal(
            dock.waveform.counts(),
            golden.waveform_counts(crop, None, Components.RGB),
            err_msg=f"frame {i}",
        )
    assert dock._device_step._cache_size() == 1
    # settle: the exact per-rect stream path resumes, still nv12-input
    final = dock.hub.config.resolve_rect(96, 48)
    legacy = _mk(stream=False, show_roi=True)
    legacy.hub.set_roi(*final)
    for i, (y, uv) in enumerate(fs[8:]):
        dock.push_nv12(y, uv)
        legacy.push_nv12(y, uv)
        a = dock.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        if i >= 1:
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=f"settled {i}"
            )
    _assert_scope_state_equal(dock, legacy)


def test_dynamic_route_publishes_raw_and_marks_surface(rng):
    """The dynamic-rect route publishes RAW histogram counts — channel
    selection stays a read/render-time concern like every other route —
    and hub.last_surface is FRESH (this frame's analysis), marked with
    ``dynamic_rect`` and carrying the full scaled capture as planes; the
    first settled frame resyncs to an unmarked crop surface."""
    from obs_color_monitor_tpu.config import Components
    from obs_color_monitor_tpu.golden import reference as golden

    dock = _mk(show_roi=True)
    dock.histogram.update(components=Components(0x05))  # R|B only
    fs = _frames(6, rng)
    for f in fs[:3]:
        dock.push_frame(f)
        dock.render(width=128, height=700)
    assert dock.hub.last_surface is not None
    assert dock.hub.last_surface.dynamic_rect is None
    dock.hub.set_roi(10, 8, 60, 40)
    dock.push_frame(fs[3])
    dock.render(width=128, height=700)
    assert dock._device_step_dynamic
    # fresh mid-drag surface: explicit dynamic marker + full-capture planes
    surf = dock.hub.last_surface
    assert surf is not None
    assert surf.dynamic_rect == (10, 8, 60, 40)
    assert not surf.cropped
    assert surf.result.planes.shape == (4, 48, 96)
    np.testing.assert_array_equal(
        np.asarray(surf.result.planes),
        np.moveaxis(fs[3], -1, 0),  # target_scale=1: the capture itself
    )
    # RAW publication: enabling G AFTER the frame was analyzed reveals its
    # real bins at the next read, exactly like the legacy hub route
    dock.histogram.update(components=Components.RGB)
    crop = golden.roi_crop(fs[3], 10, 8, 60, 40)
    np.testing.assert_array_equal(
        dock.histogram.counts(),
        golden.histogram_counts(crop, None, Components.RGB),
    )
    # settled rect: the first settled frame resyncs through the hub
    dock.push_frame(fs[4])
    dock.render(width=128, height=700)
    assert dock.hub.last_surface is not None
    assert dock.hub.last_surface.dynamic_rect is None
    assert dock.hub.last_surface.cropped


def test_mid_drag_publishes_every_consumer(rng):
    """Mid-drag frames on the streaming route publish EVERY consumer fresh
    (the reference pushes the changed crop to all consumers every tick,
    roi_send_range src/roi.c:478-520): a 10-rect drag's host reads of
    vectorscope/waveform/histogram track each rect bit-exactly vs golden,
    and the preview/overlay scopes hold THIS frame's full capture."""
    from obs_color_monitor_tpu.config import Components
    from obs_color_monitor_tpu.golden import reference as golden
    from obs_color_monitor_tpu.models.roi_interact import DRAG_MOVE

    dock = _mk(show_roi=True)
    fs = _frames(14, rng)
    for f in fs[:3]:  # warm the full-rect stream route
        dock.push_frame(f)
        dock.render(width=128, height=700)
    dock.hub.set_roi(10, 8, 60, 40)
    dock.push_frame(fs[3])
    dock.render(width=128, height=700)
    assert dock._device_step_dynamic
    x0b, y0b, wb, hb, ws, hs = dock._rects["roi"]

    def to_panel(sx, sy):
        return x0b + -(-sx * wb // ws), y0b + -(-sy * hb // hs)

    dock.mouse_move(*to_panel(30, 20))
    dock.mouse_down(*to_panel(30, 20))
    assert dock.roi_interact.flags & DRAG_MOVE
    cs = dock.hub.colorspace
    rects_seen = set()
    for i, f in enumerate(fs[4:14]):
        dock.mouse_move(*to_panel(30 + 2 * (i + 1), 20 + (i % 3)))
        r = dock.hub.config.resolve_rect(96, 48)
        rects_seen.add(r)
        dock.push_frame(f)
        dock.render(width=128, height=700)
        crop = golden.roi_crop(f, *r)
        yuv = golden.rgb_to_yuv_u8(crop, cs)
        # vectorscope: exact rect counts
        np.testing.assert_array_equal(
            np.asarray(dock.vectorscope._read()),
            golden.vectorscope_counts(yuv), err_msg=f"vs rect {r}",
        )
        # histogram: exact rect counts + rect pixel count
        np.testing.assert_array_equal(
            dock.histogram.counts(),
            golden.histogram_counts(crop, None, Components.RGB),
            err_msg=f"hi rect {r}",
        )
        assert dock.histogram._read()[1] == (r[2] - r[0]) * (r[3] - r[1])
        # waveform: counts() returns the exact rect slice of the
        # full-width publication, width reports the rect width
        np.testing.assert_array_equal(
            dock.waveform.counts(),
            golden.waveform_counts(crop, None, Components.RGB),
            err_msg=f"wv rect {r}",
        )
        # overlay/preview scopes hold THIS frame's full capture
        zp, _zcs = dock.zebra._read()
        np.testing.assert_array_equal(
            np.asarray(zp), np.moveaxis(f, -1, 0), err_msg=f"zb rect {r}"
        )
        assert dock.zebra._size == (96, 48)
        np.testing.assert_array_equal(
            np.asarray(dock.roi_preview._read()), np.moveaxis(f, -1, 0)
        )
        assert dock.hub.last_surface.dynamic_rect == r
    assert len(rects_seen) == 10
    # the waveform read buffer is tick-gated (one-frame latency): after
    # one more tick its host width reports the LAST drag rect's width
    dock.mouse_up(*to_panel(52, 22))
    dock.push_frame(fs[0])
    assert dock.waveform.width == 50


def test_nv12_joint_upload(rng, monkeypatch):
    """Adjacent y/uv views of one contiguous NV12 buffer (the wire shape:
    file reads, decoder outputs) upload with ONE host->device transfer;
    non-adjacent planes fall back to two.  Decode is bit-identical either
    way."""
    from obs_color_monitor_tpu.ops import convert

    h, w = 48, 96
    buf = rng.integers(0, 256, (h * 3 // 2, w), np.uint8)
    y_adj, uv_adj = buf[:h], buf[h:]
    y_sep = y_adj.copy()
    uv_sep = uv_adj.copy()

    uploads = []
    orig = convert.jnp.asarray

    def counting(x, *a, **k):
        if isinstance(x, np.ndarray):
            uploads.append(x.shape)
        return orig(x, *a, **k)

    monkeypatch.setattr(convert.jnp, "asarray", counting)

    ya, uva = convert.nv12_device_planes(y_adj, uv_adj)
    assert uploads == [(h * 3 // 2, w)]  # ONE joint transfer
    uploads.clear()
    ys, uvs = convert.nv12_device_planes(y_sep, uv_sep)
    assert uploads == [(h, w), (h // 2, w)]  # fallback: two

    np.testing.assert_array_equal(np.asarray(ya), y_sep)
    np.testing.assert_array_equal(np.asarray(uva), uv_sep)
    got_a = np.asarray(convert.nv12_to_packed(ya, uva, cs=2))
    got_s = np.asarray(convert.nv12_to_packed(ys, uvs, cs=2))
    np.testing.assert_array_equal(got_a, got_s)

    # device-resident inputs pass through untouched (no re-upload)
    uploads.clear()
    yd, uvd = convert.nv12_device_planes(ya, uva)
    assert uploads == [] and yd is ya and uvd is uva


def test_nv12_16bit_stream_matches_host_shift(rng, monkeypatch):
    """push_nv12(shift=) steady state: raw u16 P010-family planes stream
    through ONE device program per frame (the monitoring-domain round-
    shift fuses into the in-program decode) — panel + published stats
    identical to host-shifting the planes first and pushing 8-bit."""
    from obs_color_monitor_tpu.ops import convert as conv
    from obs_color_monitor_tpu.ops.convert import nv12_shift

    shift = nv12_shift(10, msb_aligned=True)  # real P010
    h, w = 48, 96
    fs16 = [
        (
            (rng.integers(0, 1 << 10, (h, w)) << 6).astype(np.uint16),
            (rng.integers(0, 1 << 10, (h // 2, w)) << 6).astype(np.uint16),
        )
        for _ in range(8)
    ]

    def to8(a):  # the ingest host policy (pipeline/ingest.py _to8)
        v = (a.astype(np.uint32) + (1 << (shift - 1))) >> shift
        return np.minimum(v, 255).astype(np.uint8)

    stream, legacy = _mk(show_roi=True), _mk(stream=False, show_roi=True)
    for i, (y16, uv16) in enumerate(fs16[:4]):
        stream.push_nv12(y16, uv16, shift=shift)
        legacy.push_nv12(to8(y16), to8(uv16))
        a = stream.render(width=128, height=700)
        b = legacy.render(width=128, height=700)
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")
        _assert_scope_state_equal(stream, legacy, f"frame {i}")
    assert len(stream._stream_fns) == 1
    calls = []
    orig = conv.nv12_to_packed

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(conv, "nv12_to_packed", counting)
    for y16, uv16 in fs16[4:]:
        stream.push_nv12(y16, uv16, shift=shift)
        stream.render(width=128, height=700)
    assert calls == []  # no eager decode: the shift+decode is in-program
    assert len(stream._stream_fns) == 1
    assert stream.hub.frames_processed == 8
