"""Shape/config fuzz: odd sizes through every kernel, random dock configs.

The reference only ever sees OBS-canvas sizes; a standalone framework must
hold for arbitrary frames (tiling/padding edge cases are where bit-exactness
bugs hide).
"""

import numpy as np
import pytest

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.config import (
    Components,
    DisplayMode,
    DockConfig,
    LevelMode,
    ROIConfig,
)
from obs_color_monitor_tpu.models import Dock
from obs_color_monitor_tpu.ops.fused import analyze

SHAPES = [(1, 1), (7, 3), (8, 128), (31, 257), (130, 96), (257, 129)]


@pytest.mark.parametrize("shape", SHAPES)
def test_stats_odd_shapes_bitexact(rng, shape):
    h, w = shape
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.2, 0, 255)
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT601)
    res = analyze(
        f,
        cs=1,
        need_vs=True,
        need_wv_rgb=True,
        need_hi_rgb=True,
    )
    np.testing.assert_array_equal(
        np.asarray(res.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(res.wv_rgb), golden.waveform_counts(f, None, Components.RGB)
    )
    np.testing.assert_array_equal(
        np.asarray(res.hi_rgb), golden.histogram_counts(f, None, Components.RGB)
    )


@pytest.mark.parametrize("shape", [(1, 1), (31, 257), (130, 96)])
def test_analyze_odd_shapes_bt709_rgb_family(rng, shape):
    """Odd shapes with BT.709 and sparse alpha-0 pixels: vectorscope,
    waveform and histogram of one analysis pass vs golden."""
    h, w = shape
    f = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.2, 0, 255)
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT709)
    res = analyze(f, cs=2, need_vs=True, need_wv_rgb=True, need_hi_rgb=True)
    np.testing.assert_array_equal(
        np.asarray(res.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(res.wv_rgb), golden.waveform_counts(f, None, Components.RGB)
    )
    np.testing.assert_array_equal(
        np.asarray(res.hi_rgb), golden.histogram_counts(f, None, Components.RGB)
    )


def test_frame_smaller_than_scale_skipped(rng):
    """Reference returns without staging when scaled size is 0
    (src/common.c:251-254)."""
    from obs_color_monitor_tpu.models import CaptureHub, Histogram
    from obs_color_monitor_tpu.config import HistogramConfig

    hub = CaptureHub(ROIConfig(target_scale=16, interleave=0))
    his = Histogram(HistogramConfig())
    hub.register(his)
    hub.tick()
    tiny = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    assert hub.process(tiny) is None
    assert hub.frames_skipped == 1
    assert his.counts() is None


def test_random_dock_configs(rng):
    """Random settings through the dock: shapes sane, no crashes."""
    for trial in range(3):
        dock = Dock(
            DockConfig(
                show_roi=bool(rng.integers(2)),
                show_vectorscope=bool(rng.integers(2)),
                show_waveform=True,
                show_histogram=bool(rng.integers(2)),
            ),
            roi=ROIConfig(target_scale=int(rng.integers(1, 4)), interleave=0),
        )
        dock.waveform.update(
            display=DisplayMode(int(rng.integers(3))),
            components=[Components.RGB, Components.Y, Components.UV, Components.YUV][
                int(rng.integers(4))
            ],
        )
        dock.histogram.update(
            level_mode=LevelMode(int(rng.integers(3))),
            logscale=bool(rng.integers(2)),
        )
        f = rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)
        f[..., 3] = 255
        dock.push_frame(f)
        dock.push_frame(f)
        img = dock.render(width=200, height=800)
        assert img.shape == (800, 200, 4)


def test_fused_combo_yuv_mode_bitexact(rng):
    """VS + YUV-mode waveform take the fused kernel path too."""
    f = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    f[..., 3] = 255
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT601)
    res = analyze(
        f, cs=1, need_vs=True, need_wv_yuv=True, need_hi_yuv=True
    )
    np.testing.assert_array_equal(
        np.asarray(res.wv_yuv), golden.waveform_counts(f, yuv, Components.YUV)
    )
    np.testing.assert_array_equal(
        np.asarray(res.hi_yuv), golden.histogram_counts(f, yuv, Components.YUV)
    )
    np.testing.assert_array_equal(
        np.asarray(res.vs_counts), golden.vectorscope_counts(yuv)
    )


def test_dock_step_overlays_on_capture(rng):
    """Dock-parity: overlays run on the scaled capture
    (reference dock points every scope at the ROI source)."""
    from obs_color_monitor_tpu.dock_step import make_dock_step

    f = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
    f[..., 3] = 255
    step = make_dock_step(64, 128, scale=2, out_width=128, out_height=900)
    out = step(f, np.float32(0.0))
    assert out.panel.shape == (900, 128, 4)
    step_full = make_dock_step(
        64, 128, scale=2, out_width=128, out_height=900, overlays_on_capture=False
    )
    out2 = step_full(f, np.float32(0.0))
    assert out2.panel.shape == (900, 128, 4)


def test_full_step_nv12_input(rng):
    """NV12 ingest variant of the full step matches the RGBA path."""
    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.runtime import native

    h, w = 64, 96
    y = rng.integers(16, 236, (h, w), dtype=np.uint8)
    uv = rng.integers(16, 240, (h // 2, w), dtype=np.uint8)
    rgba = native.nv12_to_rgba(y, uv, cs=2)

    s_nv = make_full_step(h, w, cs=Colorspace.BT709, scale=1, input_format="nv12")
    s_rgba = make_full_step(h, w, cs=Colorspace.BT709, scale=1)
    out_nv = s_nv((y, uv), np.float32(0.0))
    out_rgba = s_rgba(rgba, np.float32(0.0))
    np.testing.assert_array_equal(
        np.asarray(out_nv.vs_counts), np.asarray(out_rgba.vs_counts)
    )
    np.testing.assert_array_equal(
        np.asarray(out_nv.hi_counts), np.asarray(out_rgba.hi_counts)
    )
    np.testing.assert_array_equal(
        np.asarray(out_nv.zebra), np.asarray(out_rgba.zebra)
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_full_step_vs_golden_direct(seed):
    """make_full_step vs the golden model DIRECTLY — random shape, scale,
    colorspaces, zebra thresholds, stripe clock, peaking threshold and
    colour, sparse alpha-0: statistics AND all three overlays."""
    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.config import (
        FalseColorConfig,
        FocusPeakingConfig,
        ZebraConfig,
    )

    r = np.random.default_rng(1000 + seed)
    h4 = int(r.integers(10, 200))
    w4 = int(r.integers(10, 300))
    scale = int(r.choice([1, 2]))
    cs = int(r.choice([1, 2]))
    zb_cfg = ZebraConfig(
        colorspace=int(r.choice([1, 2])),
        zebra_th_low=int(r.integers(50, 90)),
        zebra_th_high=int(r.integers(90, 101)),
    )
    fc_cfg = FalseColorConfig(colorspace=int(r.choice([1, 2])))
    fp_cfg = FocusPeakingConfig(
        peaking_threshold=float(r.uniform(0.01, 0.1)),
        peaking_color=0xFF000000 | (int(r.integers(0, 256)) << 8) | 0xFF,
    )
    tm = float(r.uniform(0, 12))
    f = r.integers(0, 256, (h4, w4, 4), np.uint8)
    f[..., 3] = np.where(r.random((h4, w4)) < 0.3, 0, 255)  # sparse alpha-0

    step = make_full_step(h4, w4, cs=cs, scale=scale, zebra=zb_cfg,
                          falsecolor=fc_cfg, focuspeaking=fp_cfg)
    out = step(f, np.float32(tm))
    scaled = golden.downscale(f, scale)
    yuv = golden.rgb_to_yuv_u8(scaled, Colorspace(cs))
    np.testing.assert_array_equal(
        np.asarray(out.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(out.wv_counts),
        golden.waveform_counts(scaled, None, Components.RGB),
    )
    np.testing.assert_array_equal(
        np.asarray(out.hi_counts),
        golden.histogram_counts(scaled, None, Components.RGB),
    )
    to_rgba = lambda p: np.moveaxis(np.asarray(p), 0, -1)  # noqa: E731
    np.testing.assert_array_equal(
        to_rgba(out.zebra),
        golden.zebra(f, zb_cfg.th_low, zb_cfg.th_high, tm,
                     Colorspace(zb_cfg.colorspace)),
    )
    np.testing.assert_array_equal(
        to_rgba(out.falsecolor),
        golden.falsecolor(f, Colorspace(fc_cfg.colorspace)),
    )
    np.testing.assert_array_equal(
        to_rgba(out.focuspeaking),
        golden.focus_peaking(f, fp_cfg.peaking_threshold, fp_cfg.peaking_rgba),
    )


@pytest.mark.parametrize("comp", [0x04, 0x03, 0x20, 0x60, 0x50])
def test_partial_components_full_step(rng, comp):
    """Partial component masks (R-only, G+B, Y-only, Y|V, U|V) through the
    full step's device-side channel select, with alpha-0 pixels.

    Pins the apply-select-AFTER-saturation device order against the golden
    model's zero-BEFORE-counting order: equivalent because disabled
    channels are zeroed rather than summed."""
    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.config import HistogramConfig, WaveformConfig

    comp = Components(comp)
    h, w = 40, 72
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, 255)
    step = make_full_step(
        h, w, cs=Colorspace.BT709, scale=1,
        waveform=WaveformConfig(components=comp),
        histogram=HistogramConfig(components=comp),
    )
    out = step(f, np.float32(0.0))
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT709)
    fam = yuv if comp.is_yuv else None
    np.testing.assert_array_equal(
        np.asarray(out.wv_counts), golden.waveform_counts(f, fam, comp)
    )
    np.testing.assert_array_equal(
        np.asarray(out.hi_counts), golden.histogram_counts(f, fam, comp)
    )


def test_composite_cache_bounded_under_live_resize(rng):
    """An actual_size focus-peaking dock being live-resized churns
    _composite_fns (the key includes crop offsets); the cache must stay
    bounded and keep rendering."""
    from obs_color_monitor_tpu.config import FocusPeakingConfig

    dock = Dock(
        DockConfig(
            show_vectorscope=False, show_waveform=False, show_histogram=False,
            show_zebra=False, show_falsecolor=False, show_focuspeaking=True,
        ),
        roi=ROIConfig(interleave=0, target_scale=1),
        focuspeaking=FocusPeakingConfig(actual_size=True),
    )
    f = rng.integers(0, 256, (64, 96, 4), dtype=np.uint8)
    f[..., 3] = 255
    dock.push_frame(f)
    for i in range(40):
        img = dock.render(width=40 + i, height=30 + i)
        assert img.shape == (30 + i, 40 + i, 4)
        assert len(dock._composite_fns) <= 33
        assert len(dock._fused_render_fns) <= 9


def test_packed_u32_input_parity(rng):
    """The zero-copy (H, W) u32 packed frame form must match the (H, W, 4)
    u8 form bit-for-bit on every entry point: make_full_step
    (input_format="packed"), make_dock_step (auto-detected), the dynamic-ROI
    step, and the model layer (CaptureHub.process).  The packed view is
    identical memory to the (H, W, 4) frame."""
    import jax.numpy as jnp

    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.config import DockConfig
    from obs_color_monitor_tpu.dock_step import make_dock_step

    h, w = 48, 64
    rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
    rgba[rng.random((h, w)) < 0.1, 3] = 0
    packed = rgba.view(np.uint32).reshape(h, w)

    s1 = make_full_step(h, w, cs=Colorspace.BT709, scale=2)
    s2 = make_full_step(h, w, cs=Colorspace.BT709, scale=2,
                        input_format="packed")
    a, b = s1(rgba, np.float32(1.0)), s2(packed, np.float32(1.0))
    for name in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            err_msg=name,
        )

    d1 = make_dock_step(h, w, scale=2, out_width=128, out_height=700)
    o1, o2 = d1(rgba, np.float32(0.5)), d1(packed, np.float32(0.5))
    np.testing.assert_array_equal(np.asarray(o1.panel), np.asarray(o2.panel))

    dd = make_dock_step(h, w, scale=1, out_width=128, out_height=700,
                        dynamic_roi=True, dock=DockConfig(show_roi=True))
    r = np.asarray([4, 4, 40, 30], np.int32)
    o3, o4 = dd(rgba, np.float32(0.5), r), dd(packed, np.float32(0.5), r)
    np.testing.assert_array_equal(np.asarray(o3.panel), np.asarray(o4.panel))

    dk1 = Dock(roi=ROIConfig(interleave=0, target_scale=1))
    dk2 = Dock(roi=ROIConfig(interleave=0, target_scale=1))
    p1 = p2 = None
    for _ in range(3):
        dk1.push_frame(rgba)
        dk2.push_frame(jnp.asarray(packed))
        p1 = dk1.render(width=128, height=600)
        p2 = dk2.render(width=128, height=600)
    np.testing.assert_array_equal(p1, p2)


@pytest.mark.parametrize("bits,msb", [(10, True), (10, False), (12, False),
                                      (14, False), (16, False)])
def test_full_step_nv12_16bit_input_fuzz(bits, msb):
    """Every 16-bit NV12 depth/alignment through the full step matches
    host round-shift + the 8-bit NV12 path (random plane content, odd-ish
    geometry per depth) — the device shift+decode property end-to-end.
    Parametrized explicitly: an earlier random-draw version's fixed seeds
    deterministically never picked bits=10/12 or the MSB arm."""
    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.ops.convert import nv12_shift

    r = np.random.default_rng(0xF00D + bits + msb)
    h = int(r.choice([32, 48, 62]))
    w = int(r.choice([64, 96, 132]))
    shift = nv12_shift(bits, msb)
    hi = 1 << bits
    y16 = r.integers(0, hi, (h, w)).astype(np.uint16)
    uv16 = r.integers(0, hi, (h // 2, w)).astype(np.uint16)
    if msb:
        y16 = (y16 << (16 - bits)).astype(np.uint16)
        uv16 = (uv16 << (16 - bits)).astype(np.uint16)

    def to8(a):  # the ingest host policy
        v = (a.astype(np.uint32) + (1 << (shift - 1))) >> shift
        return np.minimum(v, 255).astype(np.uint8)

    s16 = make_full_step(h, w, cs=Colorspace.BT601, scale=1,
                         input_format="nv12", nv12_shift=shift)
    s8 = make_full_step(h, w, cs=Colorspace.BT601, scale=1,
                        input_format="nv12")
    out16 = s16((y16, uv16), np.float32(0.0))
    out8 = s8((to8(y16), to8(uv16)), np.float32(0.0))
    for name in ("vs_counts", "wv_counts", "hi_counts"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out16, name)),
            np.asarray(getattr(out8, name)),
            err_msg=f"{name} bits={bits} msb={msb} {h}x{w}",
        )
