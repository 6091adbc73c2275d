"""Dynamic (recompile-free) ROI: runtime rect vs the static-crop builds.

The reference's ROI is an interactive drag (src/roi.c:343-521) applied as a
per-tick crop (src/common.c:273-282); the dynamic paths take the rect as a
runtime (4,) i32 input so dragging never recompiles, and every statistic
must stay bit-identical to the statically-cropped build at the same rect
(doc/design-dynamic-roi.md).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from obs_color_monitor_tpu.config import DockConfig, FocusPeakingConfig
from obs_color_monitor_tpu.dock_step import make_dock_step
from obs_color_monitor_tpu.ops.convert import planarize
from obs_color_monitor_tpu.ops.fused import analyze


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(7)
    f = rng.integers(0, 256, (120, 160, 4), np.uint8)
    f[rng.random((120, 160)) < 0.08, 3] = 0  # alpha-skipped pixels
    return f


RECTS = [(10, 8, 50, 40), (0, 0, 80, 60), (5, 5, 75, 55), (79, 59, 80, 60)]


def test_analyze_rect_dyn_matches_static_crop(frame):
    """Mask-based dynamic rect == static crop, both families."""
    planes = planarize(frame)
    for yuv in (False, True):
        kw = dict(
            cs=2, scale=2, need_vs=True,
            need_wv_rgb=not yuv, need_wv_yuv=yuv,
            need_hi_rgb=not yuv, need_hi_yuv=yuv,
            keep_rgba=True, is_planar=True,
        )
        for r in RECTS:
            a_s = analyze(planes, rect=r, **kw)
            a_d = analyze(planes, rect_dyn=jnp.asarray(r, jnp.int32), **kw)
            np.testing.assert_array_equal(
                np.asarray(a_d.vs_counts), np.asarray(a_s.vs_counts)
            )
            wv_s = a_s.wv_yuv if yuv else a_s.wv_rgb
            wv_d = a_d.wv_yuv if yuv else a_d.wv_rgb
            np.testing.assert_array_equal(
                np.asarray(wv_d)[:, :, r[0] : r[2]], np.asarray(wv_s)
            )
            assert (np.asarray(wv_d)[:, :, : r[0]] == 0).all()
            assert (np.asarray(wv_d)[:, :, r[2] :] == 0).all()
            hi_s = a_s.hi_yuv if yuv else a_s.hi_rgb
            hi_d = a_d.hi_yuv if yuv else a_d.hi_rgb
            np.testing.assert_array_equal(np.asarray(hi_d), np.asarray(hi_s))
            # planes stay FULL-capture on the dynamic path
            assert a_d.planes.shape == (4, 60, 80)


def test_analyze_rect_dyn_scales_and_families(frame):
    """The dynamic rect at scale 2 (RGB family) and scale 1 (YUV family):
    counts equal the statically cropped analysis, and the kept planes are
    the full capture."""
    planes = planarize(frame)
    for scale, yuv in ((2, False), (1, True)):
        kw = dict(
            cs=2, scale=scale, need_vs=True,
            need_wv_rgb=not yuv, need_wv_yuv=yuv,
            need_hi_rgb=not yuv, need_hi_yuv=yuv,
            keep_rgba=True, is_planar=True,
        )
        sw = 160 // scale
        for r in [(10, 8, 50, 40), (0, 0, sw, 120 // scale)]:
            a_s = analyze(planes, rect=r, **kw)
            a_d = analyze(planes, rect_dyn=jnp.asarray(r, jnp.int32), **kw)
            np.testing.assert_array_equal(
                np.asarray(a_d.vs_counts), np.asarray(a_s.vs_counts)
            )
            wv_s = a_s.wv_yuv if yuv else a_s.wv_rgb
            wv_d = a_d.wv_yuv if yuv else a_d.wv_rgb
            np.testing.assert_array_equal(
                np.asarray(wv_d)[:, :, r[0] : r[2]], np.asarray(wv_s)
            )
            hi_s = a_s.hi_yuv if yuv else a_s.hi_rgb
            hi_d = a_d.hi_yuv if yuv else a_d.hi_rgb
            np.testing.assert_array_equal(np.asarray(hi_d), np.asarray(hi_s))
            assert a_d.planes.shape == (4, 120 // scale, sw)  # full capture


def test_overlay_rect_parity_vs_golden(frame):
    """In-rect overlay pixels == the golden overlays of the cropped frame:
    the zebra stripe phase anchors at the rect origin (tm shift), focus
    peaking clamps at the rect borders, false color is position-free."""
    from obs_color_monitor_tpu import golden
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.golden.reference import (
        peaking_threshold_fixed,
        quantize_unorm8,
    )
    from obs_color_monitor_tpu.ops import overlays as ov

    planes = planarize(frame)
    pk_col = (1.0, 0.0, 0.0, 1.0)
    pc = jnp.asarray(quantize_unorm8(np.asarray(pk_col, np.float32)))
    pk_th = peaking_threshold_fixed(0.05)
    tm = 3.7
    for r in [(15, 7, 150, 100), (0, 0, 160, 120), (100, 80, 160, 120)]:
        x0, y0, x1, y1 = r
        crop = frame[y0:y1, x0:x1]
        zb = ov.zebra_planes(planes, th_low=0.6, th_high=0.95,
                             tm=tm - (x0 + y0), cs=2)
        fc = ov.falsecolor_planes(planes, cs=1)
        fp = ov.focus_peaking_planes(planes, pk_th, pc,
                                     rect=jnp.asarray(r, jnp.int32))
        for got, want in (
            (zb, golden.zebra(crop, 0.6, 0.95, tm, Colorspace.BT709)),
            (fc, golden.falsecolor(crop, Colorspace.BT601)),
            (fp, golden.focus_peaking(crop, 0.05, pk_col)),
        ):
            np.testing.assert_array_equal(
                np.moveaxis(np.asarray(got), 0, -1)[y0:y1, x0:x1], want
            )


def test_xla_overlay_rect_twins(frame):
    """CPU-path twins: zebra via the tm phase shift, focus peaking via its
    rect argument."""
    from obs_color_monitor_tpu.golden.reference import quantize_unorm8
    from obs_color_monitor_tpu.ops import overlays as ov

    planes = planarize(frame)
    r = (15, 7, 150, 100)
    x0, y0, x1, y1 = r
    crop = planes[:, y0:y1, x0:x1]
    tm = 5.2
    zs = ov.zebra_planes(crop, th_low=0.6, th_high=0.95, tm=tm, cs=2)
    zd = ov.zebra_planes(
        planes, th_low=0.6, th_high=0.95, tm=tm - (x0 + y0), cs=2
    )
    np.testing.assert_array_equal(np.asarray(zd)[:, y0:y1, x0:x1], np.asarray(zs))
    pc = jnp.asarray(quantize_unorm8(np.asarray((1, 0, 0, 1), np.float32)))
    fs = ov.focus_peaking_planes(crop, 2000, pc)
    fd = ov.focus_peaking_planes(planes, 2000, pc, rect=jnp.asarray(r, jnp.int32))
    np.testing.assert_array_equal(np.asarray(fd)[:, y0:y1, x0:x1], np.asarray(fs))
    # the restructured static formula is unchanged: full rect == no rect
    f_full = ov.focus_peaking_planes(planes, 2000, pc)
    f_rect = ov.focus_peaking_planes(
        planes, 2000, pc, rect=jnp.asarray((0, 0, 160, 120), jnp.int32)
    )
    np.testing.assert_array_equal(np.asarray(f_full), np.asarray(f_rect))


def test_dynamic_dock_step_matches_static(frame):
    """The one-program dock with dynamic_roi: stats bit-exact AND the panel
    pixel-identical to the static roi_rect build at every rect, through ONE
    compiled program (trace-count assert over a 14-position drag)."""
    dk = DockConfig(show_roi=False, show_focuspeaking=True)
    dyn = make_dock_step(
        120, 160, scale=2, out_width=128, out_height=672, dock=dk,
        dynamic_roi=True,
    )
    tm = 2.5
    for r in RECTS:
        st = make_dock_step(
            120, 160, scale=2, out_width=128, out_height=672, dock=dk,
            roi_rect=r,
        )
        out_s = st(frame, np.float32(tm))
        out_d = dyn(frame, np.float32(tm), jnp.asarray(r, jnp.int32))
        np.testing.assert_array_equal(
            np.asarray(out_d.vs_counts), np.asarray(out_s.vs_counts)
        )
        np.testing.assert_array_equal(
            np.asarray(out_d.hi_counts), np.asarray(out_s.hi_counts)
        )
        np.testing.assert_array_equal(
            np.asarray(out_d.wv_counts)[:, :, r[0] : r[2]],
            np.asarray(out_s.wv_counts),
        )
        np.testing.assert_array_equal(
            np.asarray(out_d.panel), np.asarray(out_s.panel)
        )
    for i in range(10):
        dyn(frame, np.float32(tm), jnp.asarray((i, i, 50 + i, 40 + i), jnp.int32))
    assert dyn._cache_size() == 1


def test_dynamic_dock_step_actual_size_and_roi_row(frame):
    """actual_size focus peaking (1:1 crop) and the ROI preview row (full
    capture + drag shading) in the dynamic step."""
    dk = DockConfig(show_roi=True, show_focuspeaking=True)
    r = (10, 8, 50, 40)
    dyn = make_dock_step(
        120, 160, scale=2, out_width=128, out_height=784, dock=dk,
        focuspeaking=FocusPeakingConfig(actual_size=True), dynamic_roi=True,
    )
    st = make_dock_step(
        120, 160, scale=2, out_width=128, out_height=784, dock=dk,
        focuspeaking=FocusPeakingConfig(actual_size=True), roi_rect=r,
    )
    out_d = dyn(frame, np.float32(1.0), jnp.asarray(r, jnp.int32))
    out_s = st(frame, np.float32(1.0))
    pd, ps = np.asarray(out_d.panel), np.asarray(out_s.panel)
    # bands: 7 scopes x 112 rows; the ROI preview (band 0) differs BY DESIGN
    # (full capture + shading vs the crop); all other bands are identical
    np.testing.assert_array_equal(pd[112:], ps[112:])
    # the preview row shows the green selection border at the scaled rect
    band = pd[:112]
    assert (band == np.array([0, 255, 0, 255], np.uint8)).all(axis=-1).any()


def test_dynamic_dock_rejects_unsupported():
    with pytest.raises(ValueError):
        make_dock_step(120, 160, roi_rect=(0, 0, 10, 10), dynamic_roi=True)
    with pytest.raises(NotImplementedError):
        make_dock_step(120, 160, dynamic_roi=True, overlays_on_capture=False)


@pytest.mark.parametrize("placement", ["LEFT", "OUTSIDE", "BELOW"])
def test_dynamic_dock_key_legend(frame, placement):
    """False-color key legend in the dynamic-ROI step: content pixels equal
    the no-key dynamic build wherever the sampled legend is transparent,
    legend pixels equal the exact integer blend of the display-res legend
    texture, and dragging still compiles exactly one program."""
    from obs_color_monitor_tpu.colorspace import calc_colorspace
    from obs_color_monitor_tpu.config import FalseColorConfig, ShowKey
    from obs_color_monitor_tpu.dock_step import _layout
    from obs_color_monitor_tpu.ops.graticule import falsecolor_key_overlay

    sk = ShowKey[placement]
    dk = DockConfig(show_roi=False, show_focuspeaking=True)
    kw = dict(scale=2, out_width=128, out_height=672, dock=dk)
    dyn_key = make_dock_step(
        120, 160, dynamic_roi=True,
        falsecolor=FalseColorConfig(show_key=sk), **kw,
    )
    dyn_plain = make_dock_step(120, 160, dynamic_roi=True, **kw)

    # band geometry (mirrors make_dock_step's layout for show_roi=False)
    shown = [(n, 0, 0) for n in
             ("vectorscope", "waveform", "histogram", "zebra", "falsecolor",
              "focuspeaking")]
    shown[0] = ("vectorscope", 256, 256)
    shown[1] = ("waveform", 80, 256)
    shown[2] = ("histogram", 256, 200)
    rects = _layout(shown, 128, 672, False)
    x0s, y0s, ws, hs = rects["falsecolor"]
    base_w = ws * 10 // 11 if sk == ShowKey.OUTSIDE else ws
    base_h = hs * 10 // 12 if sk == ShowKey.BELOW else hs
    fc_cs_resolved = calc_colorspace(FalseColorConfig().colorspace)
    key_tex = falsecolor_key_overlay(sk, base_w, base_h, fc_cs_resolved)

    for r in RECTS[:3]:
        out_k = np.asarray(
            dyn_key(frame, np.float32(1.5), jnp.asarray(r, jnp.int32)).panel
        )
        out_p = np.asarray(
            dyn_plain(frame, np.float32(1.5), jnp.asarray(r, jnp.int32)).panel
        )
        rw, rh = r[2] - r[0], r[3] - r[1]
        cw_c = rw * 11 // 10 if sk == ShowKey.OUTSIDE else rw
        ch_c = rh * 12 // 10 if sk == ShowKey.BELOW else rh
        # numpy twin of the slot sampler's geometry
        fw = min(ws, hs * cw_c // max(ch_c, 1)) if ws * ch_c > hs * cw_c else ws
        fh = min(hs, ws * ch_c // max(cw_c, 1)) if hs * cw_c > ws * ch_c else hs
        fw, fh = max(fw, 1), max(fh, 1)
        dxo = (ws - fw) // 2
        ii = np.arange(hs)[:, None]
        jj = np.arange(ws)[None, :]
        in_box = (ii < fh) & (jj >= dxo) & (jj < dxo + fw)
        lh_t, lw_t = key_tex.shape[0], key_tex.shape[1]
        lg = key_tex[
            np.clip(ii * lh_t // fh, 0, lh_t - 1),
            np.clip((jj - dxo) * lw_t // fw, 0, lw_t - 1),
        ]
        a = np.where(in_box, lg[..., 3].astype(np.int64), 0)[..., None]
        band_k = out_k[y0s : y0s + hs, x0s : x0s + ws]
        # where the legend is transparent, the dynamic fit geometry for
        # non-extending placements matches the plain build exactly
        if sk == ShowKey.LEFT:
            band_p = out_p[y0s : y0s + hs, x0s : x0s + ws]
            exp_rgb = (
                lg[..., :3].astype(np.int64) * a
                + band_p[..., :3].astype(np.int64) * (255 - a) + 127
            ) // 255
            np.testing.assert_array_equal(band_k[..., :3], exp_rgb)
        else:
            # extended canvas (OUTSIDE/BELOW): full numpy twin of the
            # extended-canvas fit — base = falsecolor of the rect sampled
            # through the canvas mapping (only in-rect pixels are read),
            # opaque black outside the fit box, legend integer-blended
            # over the box.  Byte-exact, like the LEFT case.
            from obs_color_monitor_tpu.golden import reference as golden

            cap = golden.downscale(frame, 2)
            crop = cap[r[1] : r[3], r[0] : r[2]]
            fc_img = golden.falsecolor(crop, fc_cs_resolved)
            sy = np.clip(ii * ch_c // fh, 0, rh - 1)
            sx = np.clip((jj - dxo) * cw_c // fw, 0, rw - 1)
            samp = fc_img[
                np.broadcast_to(sy, (hs, ws)), np.broadcast_to(sx, (hs, ws))
            ]
            valid = ((ii < fh) & (ii * ch_c // fh < rh)) & (
                (jj >= dxo) & (jj < dxo + fw)
                & ((jj - dxo) * cw_c // fw < rw)
            )
            black = np.array([0, 0, 0, 255], np.uint8)
            base = np.where(valid[..., None], samp, black)
            exp_rgb = (
                lg[..., :3].astype(np.int64) * a
                + base[..., :3].astype(np.int64) * (255 - a) + 127
            ) // 255
            expected = np.concatenate(
                [exp_rgb.astype(np.uint8), base[..., 3:]], axis=-1
            )
            np.testing.assert_array_equal(band_k, expected)
        out_k2 = out_k.copy()
        out_k2[y0s : y0s + hs] = out_p[y0s : y0s + hs]
        np.testing.assert_array_equal(out_k2, out_p)

    for i in range(6):
        dyn_key(frame, np.float32(1.5),
                jnp.asarray((i, i, 50 + i, 40 + i), jnp.int32))
    assert dyn_key._cache_size() == 1


def test_render_device_drag_no_recompile(frame):
    """Dock.render_device routes a non-full hub rect onto the dynamic step:
    dragging through 10 rects builds and compiles exactly one program."""
    from obs_color_monitor_tpu.models.dock import Dock
    from obs_color_monitor_tpu.config import ROIConfig

    dock = Dock(
        DockConfig(show_roi=True, show_focuspeaking=True, width=128, height=784),
        roi=ROIConfig(target_scale=2),
    )
    dock.hub.set_roi(10, 8, 50, 40)
    dock.render_device(frame, tm=0.0)
    step = dock._device_step
    assert dock._device_step_dynamic
    for i in range(10):
        dock.hub.set_roi(10 + i, 8, 50 + i, 40 + i)
        dock.render_device(frame, tm=float(i))
    assert dock._device_step is step  # no rebuild
    assert step._cache_size() == 1  # no recompile
    # panel equals the static build at the final rect
    st = make_dock_step(
        120, 160, scale=2, out_width=128, out_height=784,
        dock=dock.config, roi_rect=(19, 8, 59, 49),
    )
    ps = np.asarray(st(frame, np.float32(9.0)).panel)
    pd = dock.render_device(frame, tm=9.0)
    np.testing.assert_array_equal(pd[112:], ps[112:])


def test_interactive_roi_to_render_device(frame):
    """InteractiveROI drag -> apply_to(hub) -> render_device end-to-end."""
    from obs_color_monitor_tpu.models.dock import Dock
    from obs_color_monitor_tpu.config import ROIConfig

    dock = Dock(
        DockConfig(show_roi=True, show_focuspeaking=True, width=128, height=784),
        roi=ROIConfig(target_scale=2),
    )
    dock.push_frame(frame)  # sizes the preview for the interact state
    dock.render(128, 784)  # lays out rects for mouse routing
    roi = dock._ensure_roi_interact()
    roi.mouse_down(10, 8)
    roi.mouse_move(50, 40)
    roi.mouse_up(50, 40)
    roi.apply_to(dock.hub)
    assert dock.hub.config.resolve_rect(80, 60) == (10, 8, 50, 40)
    pd = dock.render_device(frame, tm=0.0)
    assert dock._device_step_dynamic
    assert pd.shape == (784, 128, 4)
