"""Dock composite layout rules (reference src/scope-widget.cpp:99-175)."""

import numpy as np
import pytest

from obs_color_monitor_tpu.config import DockConfig, ROIConfig
from obs_color_monitor_tpu.models import Dock


@pytest.fixture(scope="module")
def dock_frame(rng):
    f = rng.integers(0, 256, (72, 128, 4), dtype=np.uint8)
    f[..., 3] = 255
    return f


def test_vectorscope_slot_is_square(dock_frame):
    """Vectorscope gets w = h = min(w, h) (scope-widget.cpp:137-139)."""
    cfg = DockConfig(
        show_roi=False,
        show_vectorscope=True,
        show_waveform=False,
        show_histogram=False,
        show_zebra=False,
        show_falsecolor=False,
        show_focuspeaking=False,
    )
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    img = dock.render(width=300, height=900)
    # square content centered horizontally in a 300x900 canvas:
    drawn = (img[..., :3].sum(axis=-1) > 0)
    ys, xs = np.nonzero(drawn)
    # content confined to a 300x300 block at the top slot
    assert ys.max() < 300
    assert xs.max() - xs.min() < 300


def test_overlay_scopes_keep_aspect(dock_frame):
    """Zebra/falsecolor keep the source aspect (scope-widget.cpp:129-136)."""
    cfg = DockConfig(
        show_roi=False,
        show_vectorscope=False,
        show_waveform=False,
        show_histogram=False,
        show_zebra=False,
        show_falsecolor=True,
        show_focuspeaking=False,
    )
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    img = dock.render(width=256, height=512)
    drawn = (img[..., :3].sum(axis=-1) > 0)
    ys, xs = np.nonzero(drawn)
    h_drawn = ys.max() - ys.min() + 1
    w_drawn = xs.max() - xs.min() + 1
    # source is 128x72 (16:9): drawn region must be ~16:9, not stretched to slot
    assert abs(w_drawn / h_drawn - 128 / 72) < 0.15


def test_vertical_stack_partition(dock_frame):
    """Slots divide the remaining height like (cy-y0)/(n-k)
    (scope-widget.cpp:121-124)."""
    dock = Dock(roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    img = dock.render(width=128, height=600)
    assert img.shape == (600, 128, 4)
    # default = ROI preview + five scopes -> six slots of 100; waveform
    # (slot 2, after roi + vectorscope) stretches full width
    row_slot2 = img[250]
    assert (row_slot2[..., 3] == 255).all()


def test_hidden_scope_skipped(dock_frame):
    dock = Dock(roi=ROIConfig(interleave=0, target_scale=1))
    dock.config.show_waveform = False
    dock.push_frame(dock_frame)
    img = dock.render(width=128, height=500)
    assert img.shape == (500, 128, 4)


def test_mouse_routing_zoom_and_roi(dock_frame):
    """Wheel over the vectorscope zooms; drag over the ROI preview sets
    the hub rect (reference scope-widget.cpp:241-428 routing)."""
    cfg = DockConfig(show_roi=True)
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    dock.render(width=256, height=1400)
    assert "vectorscope" in dock._rects and "roi" in dock._rects

    z0 = dock.vectorscope.config.zoom
    vx0, vy0, vw, vh, _, _ = dock._rects["vectorscope"]
    dock.mouse_wheel(vx0 + vw // 2, vy0 + vh // 2, 2000)
    assert dock.vectorscope.config.zoom > z0
    # wheel elsewhere does nothing
    z1 = dock.vectorscope.config.zoom
    dock.mouse_wheel(0, 1399, 2000)
    assert dock.vectorscope.config.zoom == z1

    rx0, ry0, rw, rh, rsw, rsh = dock._rects["roi"]
    dock.mouse_move(rx0 + 2, ry0 + 2)
    dock.mouse_down(rx0 + 2, ry0 + 2)
    dock.mouse_up(rx0 + rw - 2, ry0 + rh - 2)
    x0, y0, x1, y1 = dock.hub.config.resolve_rect(rsw, rsh)
    assert (x1 - x0) > 0 and (y1 - y0) > 0
    assert x1 <= rsw and y1 <= rsh


def test_one_program_dock_step(dock_frame):
    """The whole dock as one XLA program (dock_step.make_dock_step)."""
    import numpy as np

    from obs_color_monitor_tpu import golden
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.dock_step import make_dock_step

    h, w = dock_frame.shape[:2]
    step = make_dock_step(h, w, scale=1, out_width=256, out_height=1200)
    out = step(dock_frame, np.float32(0.0))
    assert out.panel.shape == (1200, 256, 4)
    # stats bit-exact through the full program
    yuv = golden.rgb_to_yuv_u8(dock_frame, Colorspace.BT709)
    np.testing.assert_array_equal(
        np.asarray(out.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(out.hi_counts),
        golden.histogram_counts(dock_frame, None, 7),
    )
    panel = np.asarray(out.panel)
    assert panel[..., :3].sum() > 0 and (panel[..., 3] == 255).all()


def test_dock_step_roi_rect(rng):
    """ROI sub-rect in the one-program dock step: stats match a golden crop."""
    import numpy as np

    from obs_color_monitor_tpu import golden
    from obs_color_monitor_tpu.dock_step import make_dock_step

    f = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
    f[..., 3] = 255
    step = make_dock_step(
        64, 128, scale=1, out_width=128, out_height=900, roi_rect=(8, 4, 72, 60)
    )
    out = step(f, np.float32(0.0))
    crop = golden.roi_crop(f, 8, 4, 72, 60)
    np.testing.assert_array_equal(
        np.asarray(out.hi_counts), golden.histogram_counts(crop, None, 7)
    )


def test_roi_preview_selection_shading(dock_frame):
    """ROI preview darkens outside the rect and draws a green border
    (reference draw_roi_range/draw_roi_rect, roi.c:207-265)."""
    import numpy as np

    cfg = DockConfig(show_roi=True)
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    dock.hub.set_roi(20, 10, 100, 50)
    img = dock.roi_preview.render()
    assert img is not None
    # border green
    assert tuple(img[10, 50][:3]) == (0, 255, 0)
    # outside darker than source, inside untouched
    np.testing.assert_array_equal(img[30, 50], dock_frame[30, 50])
    assert (img[60, 50][:3].astype(int) <= dock_frame[60, 50][:3].astype(int)).all()


def test_roi_preview_drag_no_recompile(dock_frame):
    """The shading program takes the rect as a DYNAMIC (4,) input: dragging
    the selection reuses one compiled program for every rect."""
    import numpy as np
    from obs_color_monitor_tpu.models.dock import _shaded_preview

    cfg = DockConfig(show_roi=True)
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    n0 = _shaded_preview._cache_size()
    for rect in [(20, 10, 100, 50), (21, 10, 100, 50), (0, 0, 40, 40)]:
        dock.hub.set_roi(*rect)
        img = dock.roi_preview.render()
        x0, y0, x1, y1 = rect
        assert tuple(img[y0, (x0 + x1) // 2][:3]) == (0, 255, 0)
        assert tuple(img[y1 - 1, (x0 + x1) // 2][:3]) == (0, 255, 0)
        assert tuple(img[(y0 + y1) // 2, x0][:3]) == (0, 255, 0)
        np.testing.assert_array_equal(
            img[(y0 + y1) // 2, (x0 + x1) // 2],
            dock_frame[(y0 + y1) // 2, (x0 + x1) // 2],
        )
    assert _shaded_preview._cache_size() - n0 <= 1


def test_focuspeaking_actual_size(dock_frame):
    """1:1 centered mapping when actual_size is on (focuspeaking.c:203-220)."""
    import numpy as np

    cfg = DockConfig(
        show_vectorscope=False,
        show_waveform=False,
        show_histogram=False,
        show_zebra=False,
        show_falsecolor=False,
        show_focuspeaking=True,
    )
    dock = Dock(cfg, roi=ROIConfig(interleave=0, target_scale=1))
    dock.focuspeaking.update(actual_size=True)
    dock.push_frame(dock_frame)  # source 128x72
    img = dock.render(width=300, height=300)
    x0, y0, w, h, _, _ = dock._rects["focuspeaking"]
    assert (w, h) == (128, 72)  # 1:1, not stretched to 300x300
    # pixels match the scope output exactly (no resampling)
    scope_img = dock.focuspeaking.render()
    np.testing.assert_array_equal(img[y0 : y0 + h, x0 : x0 + w], scope_img)


def _panel_parity(dock_frame, out_w, out_h, scale=1, **scope_cfgs):
    """Build the model-layer Dock and the one-program step from the same
    configs; assert the composited panels match pixel-for-pixel."""
    import numpy as np

    from obs_color_monitor_tpu.dock_step import make_dock_step

    h, w = dock_frame.shape[:2]
    dock = Dock(roi=ROIConfig(interleave=0, target_scale=scale), **scope_cfgs)
    # twice: the waveform publishes its read buffer on the NEXT tick
    # (reference wvs_tick double-buffer latency, src/waveform.c:394-400)
    dock.push_frame(dock_frame)
    dock.push_frame(dock_frame)
    want = dock.render(width=out_w, height=out_h)
    step = make_dock_step(
        h,
        w,
        cs=dock.hub.colorspace,
        scale=scale,
        out_width=out_w,
        out_height=out_h,
        **{k: v for k, v in scope_cfgs.items()},
    )
    got = np.asarray(step(dock_frame, np.float32(dock.zebra.tm)).panel)
    np.testing.assert_array_equal(got, want)


def test_dock_step_panel_parity_default(dock_frame):
    _panel_parity(dock_frame, 192, 1100)


def test_dock_step_panel_parity_falsecolor_key_and_lut(dock_frame):
    """LUT + key legend in the one-program dock must match the model layer
    (reference key drawing src/zebra.c:385-597, LUT falsecolor.effect:36-37)."""
    import numpy as np

    from obs_color_monitor_tpu.config import FalseColorConfig, ShowKey

    lut = np.zeros((64, 4), np.uint8)
    lut[:, 0] = np.arange(64) * 4
    lut[:, 2] = 255 - np.arange(64) * 4
    lut[:, 3] = 255
    for key in (ShowKey.LEFT, ShowKey.BELOW, ShowKey.OUTSIDE):
        _panel_parity(
            dock_frame,
            160,
            900,
            falsecolor=FalseColorConfig(use_lut=True, lut=lut, show_key=key),
        )


def test_dock_step_panel_parity_key_no_lut(dock_frame):
    from obs_color_monitor_tpu.config import FalseColorConfig, ShowKey

    _panel_parity(
        dock_frame, 160, 900, falsecolor=FalseColorConfig(show_key=ShowKey.TOP)
    )


def test_dock_step_panel_parity_fp_actual_size(dock_frame):
    from obs_color_monitor_tpu.config import FocusPeakingConfig

    _panel_parity(
        dock_frame, 96, 700, focuspeaking=FocusPeakingConfig(actual_size=True)
    )


def test_dock_step_panel_parity_scale2_and_displays(dock_frame):
    """Non-default displays at the dock's default scale 2: waveform parade,
    histogram stack, vectorscope white+zoom — panel still pixel-identical."""
    from obs_color_monitor_tpu.config import (
        Components,
        DisplayMode,
        HistogramConfig,
        VectorscopeConfig,
        VectorscopeColorType,
        WaveformConfig,
    )

    _panel_parity(
        dock_frame,
        200,
        1200,
        scale=2,
        vectorscope=VectorscopeConfig(
            color_type=VectorscopeColorType.WHITE, zoom=1.7
        ),
        waveform=WaveformConfig(display=DisplayMode.PARADE),
        histogram=HistogramConfig(
            display=DisplayMode.STACK, components=Components.YUV
        ),
    )


def test_dock_step_panel_parity_per_scope_colorspace(dock_frame):
    """Overlay scopes use their OWN colorspace in the dock (reference
    zbs_render, src/zebra.c:620) while stats use the hub's conversion."""
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.config import FalseColorConfig, ZebraConfig

    _panel_parity(
        dock_frame,
        160,
        1000,
        zebra=ZebraConfig(colorspace=Colorspace.BT601),
        falsecolor=FalseColorConfig(colorspace=Colorspace.BT601),
    )


def test_dock_render_single_fetch(dock_frame, monkeypatch):
    """Dock.render composites on device and fetches the panel ONCE — scope
    images never individually cross the host boundary (one transfer per
    panel, not one per scope)."""
    import jax
    import numpy as np

    dock = Dock(roi=ROIConfig(interleave=0, target_scale=1))
    dock.push_frame(dock_frame)
    dock.push_frame(dock_frame)
    dock.render(width=128, height=900)  # warm compile + overlay constants

    fetches = 0
    orig = np.asarray

    def counting(x, *a, **k):
        nonlocal fetches
        if isinstance(x, jax.Array):
            fetches += 1
        return orig(x, *a, **k)

    monkeypatch.setattr(np, "asarray", counting)
    dock.push_frame(dock_frame)
    panel = dock.render(width=128, height=900)
    assert fetches == 1, f"expected 1 device fetch per panel, saw {fetches}"
    assert panel.shape == (900, 128, 4)


def test_render_device_matches_shape_and_caches(dock_frame):
    import numpy as np

    dock = Dock(roi=ROIConfig(interleave=0, target_scale=1))
    p1 = dock.render_device(dock_frame, tm=0.0, width=256, height=1200)
    assert p1.shape == (1200, 256, 4)
    step1 = dock._device_step
    p2 = dock.render_device(dock_frame, tm=1.0, width=256, height=1200)
    assert dock._device_step is step1  # cached, no rebuild
    dock.vectorscope.update(intensity=200)
    dock.render_device(dock_frame, tm=0.0, width=256, height=1200)
    assert dock._device_step is not step1  # config change -> rebuild


def test_dock_step_hidden_scopes_skip_stats(rng):
    """Hidden scopes compile out of the one-program step (zero stats)."""
    import numpy as np

    from obs_color_monitor_tpu.dock_step import make_dock_step

    f = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
    f[..., 3] = 255
    cfg = DockConfig(show_vectorscope=False, show_histogram=False)
    step = make_dock_step(
        64, 128, scale=1, out_width=128, out_height=800, dock=cfg
    )
    out = step(f, np.float32(0.0))
    assert np.asarray(out.vs_counts).sum() == 0
    assert np.asarray(out.hi_counts).sum() == 0
    assert np.asarray(out.wv_counts).sum() > 0  # waveform still shown
    assert out.panel.shape == (800, 128, 4)


def test_analyze_packed_equals_planar():
    """analyze(is_packed=True) on the XLA path (planarize_packed) must match
    the planar path exactly — the dock hands analyze the u32 frame view."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from obs_color_monitor_tpu.ops.fused import analyze

    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (70, 150, 4), np.uint8)
    planes = jnp.asarray(np.moveaxis(frame, -1, 0).copy())
    x32 = jax.lax.bitcast_convert_type(jnp.asarray(frame), jnp.uint32)
    kw = dict(cs=2, scale=2, need_vs=True, need_wv_rgb=True,
              need_hi_rgb=True, keep_rgba=True)
    a = analyze(planes, is_planar=True, **kw)
    b = analyze(x32, is_packed=True, **kw)
    for name in ("vs_counts", "wv_rgb", "hi_rgb", "planes"):
        va, vb = getattr(a, name), getattr(b, name)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), name


def test_compose_vstack_overlap_fallback():
    """A panel too short for its scope count makes slots overlap; the
    composite must fall back to last-drawn-wins update-slices."""
    import numpy as np
    import jax.numpy as jnp
    from obs_color_monitor_tpu.dock_step import compose_vstack

    p1 = jnp.full((4, 6, 4), 10, jnp.uint8)
    p2 = jnp.full((3, 6, 4), 20, jnp.uint8)
    out = np.asarray(compose_vstack([(0, 0, p1), (1, 2, p2)], 8, 8))
    assert out.shape == (8, 8, 4)
    assert (out[0, 0] == 10).all()
    assert (out[2, 1] == 20).all()       # overlap: last drawn wins
    assert tuple(out[7, 7]) == (0, 0, 0, 255)  # background opaque black
    # stacked (disjoint) path: patches, gaps, and trailing background
    out2 = np.asarray(compose_vstack([(0, 0, p1), (1, 6, p2)], 8, 16))
    assert (out2[:4, 0:6] == 10).all() and (out2[6:9, 1:7] == 20).all()
    assert tuple(out2[5, 0]) == (0, 0, 0, 255)   # gap row
    assert tuple(out2[15, 0]) == (0, 0, 0, 255)  # trailing rows
