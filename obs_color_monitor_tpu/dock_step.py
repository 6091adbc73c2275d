"""The whole dock as ONE jitted XLA program.

``make_dock_step`` builds (frame, tm) -> composited RGBA panel + stats: the
fused analysis, all six scope renders, graticule/legend blending, zoom, the
vertical-stack layout with the reference's aspect rules
(src/scope-widget.cpp:99-175), and the final composite — a single device
program per frame.  The reference needs an obs_display draw callback
iterating 7 sources with GPU state changes for the same panel.

Layout is computed statically (all sizes are known at build time), so the
composite is static slices + small nearest-resize gathers (outputs are
panel-sized, so the gathers are tiny).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .colorspace import Colorspace
from .config import (
    DockConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    VectorscopeConfig,
    VectorscopeColorType,
    WaveformConfig,
    ZebraConfig,
)
from .golden.reference import peaking_threshold_fixed, quantize_unorm8
from .models.dock import SCOPE_ORDER
from .ops import overlays as overlay_ops
from .ops import render as render_ops
from .ops.convert import nv12_to_packed, planarize, planarize_packed
from .ops.fused import analyze
from .ops.graticule import (
    histogram_graticule,
    vectorscope_graticule,
    waveform_graticule,
)
from .ops.stats import apply_channel_select, histogram_hi_max, histogram_levels


class DockStepOutput(NamedTuple):
    panel: jax.Array  # (out_h, out_w, 4) u8 composited dock
    # statistics as every route publishes them: RAW counts, channel
    # selection deferred to read/render (reference src/histogram.c:396-418)
    vs_counts: jax.Array  # (256, 256) u8 saturating
    wv_counts: jax.Array  # (3, 256, sw) u8 saturating, pre-select
    hi_counts: jax.Array  # (3, 256) u32, pre-select
    # dynamic_roi builds also return the analyzed full-capture planes
    # (4, sh, sw) u8 so the streaming route can publish FRESH preview/
    # overlay buffers mid-drag (the reference pushes the crop to every
    # consumer every tick, src/roi.c:478-520); None on static builds
    # (those publish through the hub fan-out already)
    planes: Optional[jax.Array] = None


def _resize_nearest_rgba(img: jax.Array, oh: int, ow: int) -> jax.Array:
    """(H, W, 4) u8 OR packed (H, W) u32 -> (oh, ow, 4) nearest resize.

    Rows are a take; columns are a one-hot selection matmul via
    _dyn_sample_rgba with STATIC indices (the selection matrix
    constant-folds).
    """
    h, w = img.shape[0], img.shape[1]
    sy = np.minimum((np.arange(oh) * h) // oh, h - 1).astype(np.int32)
    sx = np.minimum((np.arange(ow) * w) // ow, w - 1).astype(np.int32)
    return _dyn_sample_rgba(img, jnp.asarray(sy), jnp.asarray(sx), None)


# (4, H, W) u8 -> (H, W, 4) via u32 compose — the shared implementation
# lives in ops.convert
from .ops.convert import planes_to_rgba as _planes_to_rgba  # noqa: E402


_BLACK32 = 0xFF000000  # opaque black background pixel (little-endian RGBA)


def _fit_dyn(slot_w: int, slot_h: int, src_w: jax.Array, src_h: jax.Array):
    """Dynamic twin of _layout's keep-aspect fit: the largest (fw, fh)
    inside the static (slot_w, slot_h) band with the DYNAMIC source aspect
    (same integer formula as _layout / reference scope-widget.cpp:129-136,
    so coinciding rects produce pixel-identical panels)."""
    w = jnp.int32(slot_w)
    h = jnp.int32(slot_h)
    fw = jnp.where(w * src_h > h * src_w, (h * src_w) // jnp.maximum(src_h, 1), w)
    fh = jnp.where(h * src_w > w * src_h, (w * src_h) // jnp.maximum(src_w, 1), h)
    return jnp.maximum(fw, 1), jnp.maximum(fh, 1)


def _dyn_sample_rgba(
    img: jax.Array,
    sy: jax.Array,
    src_j: jax.Array,
    valid: jax.Array | None,
) -> jax.Array:
    """(H, W, 4) u8 or packed (H, W) u32 -> (len(sy), len(src_j), 4),
    sampled at row/column indices (dynamic or static — with static indices
    the selection matrix constant-folds and this is also the fastest
    STATIC nearest resize, see _resize_nearest_rgba).

    Rows are a gather (jnp.take); columns are a one-hot selection matmul
    (doc/design-dynamic-roi.md).  Channel values <= 255 and the 0/1 matrix are both bf16-exact, and each
    output column selects exactly one source column, so the f32-accumulated
    result is exact.  ``valid`` masks pixels outside the dynamic fitted box
    to opaque black (the slot background); None = all valid.
    """
    h, w = img.shape[0], img.shape[1]
    if img.ndim == 2:  # already packed u32
        x32 = img
    else:
        x32 = jax.lax.bitcast_convert_type(img, jnp.uint32)  # (H, W)
    rows = jnp.take(x32, jnp.clip(sy, 0, h - 1), axis=0)  # (oh, W)
    ow = src_j.shape[0]
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, (w, ow), 0)
        == jnp.clip(src_j, 0, w - 1)[None, :]
    ).astype(jnp.bfloat16)
    chans = []
    for c in range(4):
        ch = ((rows >> (8 * c)) & 255).astype(jnp.bfloat16)
        v = jax.lax.dot_general(
            ch, sel,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        chans.append(v.astype(jnp.uint32))
    out32 = chans[0] | (chans[1] << 8) | (chans[2] << 16) | (chans[3] << 24)
    if valid is not None:
        out32 = jnp.where(valid, out32, jnp.uint32(_BLACK32))
    return jax.lax.bitcast_convert_type(out32, jnp.uint8)


def compose_vstack(patches: list, out_w: int, out_h: int) -> jax.Array:
    """Composite [(x0, y0, patch (h, w, 4) u8)] onto an opaque-black
    (out_h, out_w, 4) canvas.

    The dock layout stacks slots vertically (reference draw,
    src/scope-widget.cpp:117-170), so each patch is padded to a full-width
    row band on its u32 pixel view and the bands are concatenated — ONE
    output materialization instead of a whole-canvas dynamic-update-slice
    copy per scope.  Degenerate layouts (a panel too
    short for its scope count makes slots overlap) fall back to the
    update-slice loop, preserving the reference's last-drawn-wins order.
    """
    # band path requires every patch fully inside the canvas and in
    # y-sorted non-overlapping order; anything else (degenerate layouts —
    # a panel too short for its scope count, _layout's max(h,1) bump) takes
    # the update-slice loop, which clips like the reference draw
    stackable = (
        all(
            b[1] >= a[1] + a[2].shape[0] for a, b in zip(patches, patches[1:])
        )
        and all(
            0 <= y0
            and y0 + p.shape[0] <= out_h
            and 0 <= x0
            and x0 + p.shape[1] <= out_w
            for x0, y0, p in patches
        )
    )
    if not stackable:
        canvas = jnp.zeros((out_h, out_w, 4), jnp.uint8).at[..., 3].set(255)
        for x0, y0, patch in patches:
            h, w = patch.shape[0], patch.shape[1]
            y0c, x0c = max(y0, 0), max(x0, 0)
            y1c, x1c = min(y0 + h, out_h), min(x0 + w, out_w)
            if y1c <= y0c or x1c <= x0c:
                continue
            canvas = canvas.at[y0c:y1c, x0c:x1c, :].set(
                patch[y0c - y0 : y1c - y0, x0c - x0 : x1c - x0]
            )
        return canvas
    bands = []
    y = 0
    for x0, y0, patch in patches:
        h, w = patch.shape[0], patch.shape[1]
        if y0 > y:
            bands.append(jnp.full((y0 - y, out_w), _BLACK32, jnp.uint32))
        p32 = jax.lax.bitcast_convert_type(patch, jnp.uint32)
        bands.append(
            jnp.pad(p32, ((0, 0), (x0, out_w - x0 - w)),
                    constant_values=np.uint32(_BLACK32))
        )
        y = y0 + h
    if y < out_h:
        bands.append(jnp.full((out_h - y, out_w), _BLACK32, jnp.uint32))
    return jax.lax.bitcast_convert_type(jnp.concatenate(bands, axis=0),
                                        jnp.uint8)


def _layout(shown_dims: list[tuple[str, int, int]], cx: int, cy: int, fp_actual: bool):
    """Static layout (reference draw, src/scope-widget.cpp:117-170)."""
    rects = {}
    n_src = len(shown_dims)
    y0 = 0
    for k, (name, w_src, h_src) in enumerate(shown_dims):
        w, h = cx, (cy - y0) // (n_src - k)
        h_slot = h
        keep_aspect = name in ("roi", "zebra", "falsecolor") or (
            name == "focuspeaking" and not fp_actual
        )
        if name == "vectorscope":
            w = h = min(w, h)
        elif keep_aspect and w_src > 0 and h_src > 0:
            if w * h_src > h * w_src:
                w = h * w_src // h_src
            elif h * w_src > w * h_src:
                h = w * h_src // w_src
        rects[name] = ((cx - w) // 2, y0, max(w, 1), max(h, 1))
        y0 += h_slot
    return rects


def make_dock_step(
    height: int,
    width: int,
    cs: Colorspace = Colorspace.BT709,
    scale: int = 2,
    out_width: int = 512,
    out_height: int = 1536,
    dock: Optional[DockConfig] = None,
    vectorscope: Optional[VectorscopeConfig] = None,
    waveform: Optional[WaveformConfig] = None,
    histogram: Optional[HistogramConfig] = None,
    zebra: Optional[ZebraConfig] = None,
    falsecolor: Optional[FalseColorConfig] = None,
    focuspeaking: Optional[FocusPeakingConfig] = None,
    overlays_on_capture: bool = True,
    roi_rect: Optional[tuple[int, int, int, int]] = None,
    dynamic_roi: bool = False,
    input_format: str = "rgba",
    nv12_cs: Optional[int] = None,
    nv12_shift: int = 0,
):
    """Build the jitted dock step for a fixed frame shape.

    input_format="rgba" (the default) accepts (H, W, 4) u8 frames or their
    zero-copy (H, W) u32 packed view; "nv12" accepts a (y (H, W) u8,
    uv (H/2, W) u8) plane pair decoded IN-PROGRAM to the packed view
    (``ops.nv12_to_packed``, bit-exact twin of the native csrc decoder) —
    the wire-format capture route stays ONE device program per frame, like
    ``api.make_full_step(input_format="nv12")``.  ``nv12_cs`` is the decode
    colorimetry (defaults to ``cs``) — the analog of OBS converting the
    source to its canvas before the reference reads pixels.  With
    ``nv12_shift`` > 0 the planes are 16-bit-LE P010-family u16 samples
    and the round-shift to the monitoring domain fuses into the in-program
    decode (``ops.nv12_shift`` maps bits/msb_aligned to the shift).

    overlays_on_capture=True matches the reference dock, whose overlay
    scopes consume the shared ROI capture at its target_scale (the dock
    points every scope at the ROI source, src/scope-widget.cpp:542-561) —
    and is cheaper.  False runs overlays at full input resolution (the
    standalone-source default, where zebra/falsecolor/focuspeaking have
    target_scale=1).

    dynamic_roi=True returns ``step(frame, tm, rect)`` instead, where
    ``rect`` is a DYNAMIC (4,) i32 ROI (x0, y0, x1, y1) in scaled
    coordinates: statistics and overlay content are bit-identical to the
    static ``roi_rect`` build at the same rect, but dragging the rect
    NEVER recompiles (the reference's interactive drag, src/roi.c:343-521
    — a recompile per rect would stall every drag).  The rect masks the
    statistics as a runtime input; slot layout keeps static bands and
    fits the rect aspect dynamically inside them; the ROI preview row shows
    the FULL capture with the reference's drag shading.  A false-color key
    legend rides along as a display-resolution texture blended over the
    slot's dynamic fit (placement fractions are canvas-relative, and the
    canvas maps affinely onto the fit box).  See doc/design-dynamic-roi.md.
    Not combinable with roi_rect or overlays_on_capture=False.
    """
    dk = dock or DockConfig()
    vs_cfg = vectorscope or VectorscopeConfig()
    wv_cfg = waveform or WaveformConfig()
    hi_cfg = histogram or HistogramConfig()
    zb_cfg = zebra or ZebraConfig()
    fc_cfg = falsecolor or FalseColorConfig()
    fp_cfg = focuspeaking or FocusPeakingConfig()
    from .colorspace import calc_colorspace

    csi = int(calc_colorspace(cs))
    if input_format not in ("rgba", "nv12"):
        raise ValueError(f"unknown input_format {input_format!r}")
    dec_cs = csi if nv12_cs is None else int(calc_colorspace(nv12_cs))
    # Overlay scopes select their draw technique by their OWN colorspace
    # property even when hub-fed (reference zbs_render uses
    # src->cm.colorspace, src/zebra.c:620); stats scopes inherit the hub's
    # conversion colorspace (src/vectorscope.c:262).
    zb_cs = int(calc_colorspace(zb_cfg.colorspace))
    fc_cs = int(calc_colorspace(fc_cfg.colorspace))
    sw, sh = width // scale, height // scale
    if roi_rect is not None:
        # ROI sub-rect in scaled coordinates (reference src/common.c:273-282)
        x0, y0, x1, y1 = roi_rect
        x0, y0 = max(0, x0), max(0, y0)
        x1 = sw if (x1 < 0 or x1 > sw) else x1
        y1 = sh if (y1 < 0 or y1 > sh) else y1
        roi_rect = (x0, y0, x1, y1)
        sw, sh = x1 - x0, y1 - y0
    wv_yuv = wv_cfg.components.is_yuv
    hi_yuv = hi_cfg.components.is_yuv
    wv_n = wv_cfg.components.n_components
    hi_n = hi_cfg.components.n_components
    sel = hi_cfg.components.channel_select()
    wv_sel = wv_cfg.components.channel_select()

    # static per-scope output dims (w, h)
    from .config import DisplayMode

    wv_w = sw * (wv_n if wv_cfg.display == DisplayMode.PARADE else 1)
    wv_h = 256 * (wv_n if wv_cfg.display == DisplayMode.STACK else 1)
    hi_w = 256 * (hi_n if hi_cfg.display == DisplayMode.PARADE else 1)
    hi_h = hi_cfg.level_height * (hi_n if hi_cfg.display == DisplayMode.STACK else 1)
    ov_w, ov_h = (sw, sh) if overlays_on_capture else (width, height)
    # key legend extends the falsecolor canvas for OUTSIDE/BELOW
    # (reference src/zebra.c:316-334)
    from .config import ShowKey
    from .ops.graticule import falsecolor_key_overlay, key_canvas_size

    fc_w, fc_h = key_canvas_size(fc_cfg.show_key, ov_w, ov_h)
    dims = {
        "roi": (sw, sh),
        "vectorscope": (256, 256),
        "waveform": (wv_w, wv_h),
        "histogram": (hi_w, hi_h),
        "zebra": (ov_w, ov_h),
        "falsecolor": (fc_w, fc_h),
        "focuspeaking": (ov_w, ov_h),
    }
    if dynamic_roi:
        if roi_rect is not None:
            raise ValueError("dynamic_roi and roi_rect are mutually exclusive")
        if not overlays_on_capture:
            raise NotImplementedError(
                "dynamic_roi requires overlays_on_capture=True (the "
                "reference dock's configuration)"
            )
        # overlay slots become full static bands; the rect aspect is fitted
        # dynamically inside them per frame (doc/design-dynamic-roi.md)
        dims = {**dims, "zebra": (0, 0), "falsecolor": (0, 0),
                "focuspeaking": (0, 0)}
    shown = [
        (n, *dims[n]) for n in SCOPE_ORDER if getattr(dk, f"show_{n}")
    ]
    rects = _layout(shown, out_width, out_height, fp_cfg.actual_size)

    # precomputed device constants
    vs_grat = vectorscope_graticule(
        int(vs_cfg.graticule), vs_cfg.graticule_skintone_color, csi
    )
    wv_grat = waveform_graticule(
        wv_cfg.graticule_lines, sw, int(wv_cfg.display), wv_n
    )
    hi_grat = histogram_graticule(
        hi_cfg.graticule_vertical_lines,
        hi_cfg.graticule_horizontal_step,
        hi_cfg.level_height,
        int(hi_cfg.display),
        hi_n,
        hi_cfg.level_fixed,
        hi_cfg.level_ratio_permille,
        hi_cfg.logscale,
    )
    peak_color_u8 = quantize_unorm8(np.asarray(fp_cfg.peaking_rgba, np.float32))
    peak_color = jnp.asarray(peak_color_u8)
    peak_th = peaking_threshold_fixed(fp_cfg.peaking_threshold)
    fc_lut = (
        jnp.asarray(fc_cfg.lut) if (fc_cfg.use_lut and fc_cfg.lut is not None) else None
    )
    # key legend: a device constant per (placement, size, cs, lut), planar,
    # blended on device (reference draws it per frame, src/zebra.c:385-597)
    fc_key = None
    if fc_cfg.show_key != ShowKey.NONE and not dynamic_roi:
        key_rgba = falsecolor_key_overlay(
            fc_cfg.show_key, ov_w, ov_h, fc_cs,
            lut=fc_cfg.lut if fc_cfg.use_lut else None,
        )
        fc_key = jnp.asarray(np.ascontiguousarray(np.moveaxis(key_rgba, -1, 0)))
    # dynamic-ROI legend: the placement fractions are rect-relative
    # (reference src/zebra.c:385-597 draws into the scope canvas), but the
    # canvas maps AFFINELY onto the slot's fitted box — so a legend texture
    # prebuilt at the BAND's resolution, sampled by display fraction of the
    # dynamic fit, lands exactly where the static build's canvas-space
    # legend would (and renders glyphs at display resolution instead of
    # capture resolution; content pixels are untouched where its alpha=0,
    # since nearest sampling commutes with the per-pixel blend)
    fc_key_dyn = None
    if dynamic_roi and dk.show_falsecolor and fc_cfg.show_key != ShowKey.NONE:
        ws_fc, hs_fc = rects["falsecolor"][2], rects["falsecolor"][3]
        base_w = ws_fc * 10 // 11 if fc_cfg.show_key == ShowKey.OUTSIDE else ws_fc
        base_h = hs_fc * 10 // 12 if fc_cfg.show_key == ShowKey.BELOW else hs_fc
        fc_key_dyn = jnp.asarray(
            falsecolor_key_overlay(
                fc_cfg.show_key, base_w, base_h, fc_cs,
                lut=fc_cfg.lut if fc_cfg.use_lut else None,
            )
        )

    need_vs = dk.show_vectorscope
    need_wv = dk.show_waveform
    need_hi = dk.show_histogram

    def _stat_renders(res, n_pixels, images):
        """Vectorscope/waveform/histogram renders + the step's count
        outputs — shared verbatim by the static and dynamic step bodies
        (only the histogram's pixel count differs), so the dynamic
        build's bit-parity with the static one cannot drift.

        Returns RAW (pre-channel-select) waveform/histogram counts:
        exactly the representation every other route publishes (the hub
        fan-out and stream step publish raw and defer selection to
        read/render time, models/histogram.py surface_cb / reference
        src/histogram.c:396-418).  The drawn images apply the selection
        here.
        """
        if need_vs:
            vs_img = render_ops.render_vectorscope(
                res.vs_counts,
                intensity=vs_cfg.intensity,
                cs=csi,
                white=vs_cfg.color_type == VectorscopeColorType.WHITE,
            )
            if vs_grat is not None:
                vs_img = render_ops.blend_overlay(vs_img, jnp.asarray(vs_grat))
            images["vectorscope"] = render_ops.zoom_center(
                vs_img, zoom=round(vs_cfg.zoom, 3)
            )
            vs_counts = res.vs_counts
        else:
            vs_counts = jnp.zeros((256, 256), jnp.uint8)
        if need_wv:
            wv_raw = res.wv_yuv if wv_yuv else res.wv_rgb
            wv_img = render_ops.render_waveform(
                apply_channel_select(wv_raw, wv_sel),
                intensity=wv_cfg.intensity,
                display=int(wv_cfg.display),
                n_components=wv_n,
                yuv_mode=wv_yuv,
            )
            if wv_grat is not None:
                wv_img = render_ops.blend_overlay(wv_img, jnp.asarray(wv_grat))
            images["waveform"] = wv_img
        else:
            wv_raw = jnp.zeros((3, 256, sw), jnp.uint8)
        if need_hi:
            hi_raw = (res.hi_yuv if hi_yuv else res.hi_rgb).astype(jnp.int32)
            hi_counts = apply_channel_select(hi_raw, sel)
            hi = histogram_hi_max(
                hi_counts, sel, n_pixels, hi_cfg.level_fixed,
                hi_cfg.level_ratio_permille,
            )
            levels, hi_eff = histogram_levels(hi_counts, hi, sel, hi_cfg.logscale)
            hi_img = render_ops.render_histogram(
                levels,
                hi_eff,
                level_height=hi_cfg.level_height,
                display=int(hi_cfg.display),
                n_components=hi_n,
                yuv_mode=hi_yuv,
            )
            if hi_grat is not None:
                hi_img = render_ops.blend_overlay(hi_img, jnp.asarray(hi_grat))
            images["histogram"] = hi_img
        else:
            hi_raw = jnp.zeros((3, 256), jnp.int32)
        return vs_counts, wv_raw, hi_raw

    def _ingest_planes(frame):
        """Frame -> (4, H, W) u8 planes: an (H, W, 4) u8 frame, its (H, W)
        u32 packed view (the same bytes), or an NV12/P010 (y, uv) pair
        decoded in-program."""
        if input_format == "nv12":
            frame = nv12_to_packed(
                frame[0], frame[1], cs=dec_cs, shift=nv12_shift
            )
        return planarize_packed(frame) if frame.ndim == 2 else planarize(frame)

    if dynamic_roi:
        from .config import DisplayMode as _DM
        from .models.dock import _shaded_preview

        @jax.jit
        def step_dyn(
            frame: jax.Array, tm: jax.Array, rect: jax.Array
        ) -> DockStepOutput:
            r = jnp.asarray(rect, jnp.int32)
            rx0 = jnp.clip(r[0], 0, sw)
            ry0 = jnp.clip(r[1], 0, sh)
            rx1 = jnp.clip(r[2], rx0, sw)
            ry1 = jnp.clip(r[3], ry0, sh)
            rect_c = jnp.stack([rx0, ry0, rx1, ry1])
            rw, rh = rx1 - rx0, ry1 - ry0
            rw1, rh1 = jnp.maximum(rw, 1), jnp.maximum(rh, 1)
            res = analyze(
                _ingest_planes(frame),
                cs=csi,
                scale=scale,
                need_vs=need_vs,
                need_wv_rgb=need_wv and not wv_yuv,
                need_wv_yuv=need_wv and wv_yuv,
                need_hi_rgb=need_hi and not hi_yuv,
                need_hi_yuv=need_hi and hi_yuv,
                keep_rgba=True,
                is_planar=True,
                rect_dyn=rect_c,
            )
            images = {}
            if "roi" in rects:
                # full capture with the reference's selection shading
                # (src/roi.c:207-265) — the rect moves without recompiling
                images["roi"] = _shaded_preview(res.planes, rect_c)
            # waveform counts stay full-width (out-of-rect columns are
            # zero; the slot sampler below reads only [rx0, rx1)); the
            # histogram's level thresholds use the RECT's pixel count
            vs_counts, wv_counts, hi_counts = _stat_renders(
                res, rw * rh, images
            )

            # overlays on the FULL capture with rect-parity semantics (in-
            # rect pixels == the cropped capture's overlays; the slot
            # samplers read only the rect region)
            ov_src = res.planes
            tm_rect = tm - (rx0 + ry0).astype(jnp.float32)
            if dk.show_zebra:
                images["zebra"] = _planes_to_rgba(
                    overlay_ops.zebra_planes(
                        ov_src, th_low=zb_cfg.th_low, th_high=zb_cfg.th_high,
                        tm=tm_rect, cs=zb_cs,
                    )
                )
            if dk.show_falsecolor:
                if fc_lut is not None:
                    fc = overlay_ops.falsecolor_lut_planes(
                        ov_src, fc_lut, cs=fc_cs, lut_n=fc_lut.shape[0]
                    )
                else:
                    fc = overlay_ops.falsecolor_planes(ov_src, cs=fc_cs)
                images["falsecolor"] = _planes_to_rgba(fc)
            if dk.show_focuspeaking:
                images["focuspeaking"] = _planes_to_rgba(
                    overlay_ops.focus_peaking_planes(
                        ov_src, peak_th, peak_color, rect=rect_c
                    )
                )

            patches = []
            for name, _w_src, _h_src in shown:
                x0s, y0s, ws, hs = rects[name]
                img = images[name]
                if name in ("roi", "vectorscope", "histogram"):
                    # static-shaped content: plain nearest resize
                    patches.append((x0s, y0s, _resize_nearest_rgba(img, hs, ws)))
                    continue
                jj = jnp.arange(ws, dtype=jnp.int32)
                ii = jnp.arange(hs, dtype=jnp.int32)
                if name == "waveform":
                    # stretch the rect's columns across the slot; in parade
                    # mode map through the per-component segments first
                    r_img = img.shape[0]
                    sy = jnp.asarray(
                        np.minimum(np.arange(hs) * r_img // hs, r_img - 1),
                        jnp.int32,
                    )
                    if wv_cfg.display == _DM.PARADE and wv_n > 1:
                        m = (jj * (rw1 * wv_n)) // ws
                        cseg = m // rw1
                        src_j = cseg * sw + rx0 + (m - cseg * rw1)
                    else:
                        src_j = rx0 + (jj * rw1) // ws
                    patches.append(
                        (x0s, y0s, _dyn_sample_rgba(img, sy, src_j, None))
                    )
                    continue
                # content is x-centered but TOP-aligned in its band, exactly
                # like _layout places the static patch (y0 is the slot top)
                if name == "falsecolor" and fc_key_dyn is not None:
                    # canvas = rect extended by the key strip (OUTSIDE/
                    # BELOW, reference src/zebra.c:316-334); fit THAT
                    # aspect, sample frame pixels inside the rect region
                    # and blend the display-res legend texture over the box
                    cw_c = (
                        (rw1 * 11) // 10
                        if fc_cfg.show_key == ShowKey.OUTSIDE
                        else rw1
                    )
                    ch_c = (
                        (rh1 * 12) // 10
                        if fc_cfg.show_key == ShowKey.BELOW
                        else rh1
                    )
                    fw, fh = _fit_dyn(ws, hs, cw_c, ch_c)
                    dxo = (ws - fw) // 2
                    cx = ((jj - dxo) * cw_c) // fw
                    cy = (ii * ch_c) // fh
                    col_in_box = (jj >= dxo) & (jj < dxo + fw)
                    row_in_box = ii < fh
                    valid = (row_in_box & (cy < rh1))[:, None] & (
                        col_in_box & (cx < rw1)
                    )[None, :]
                    base = _dyn_sample_rgba(
                        img,
                        ry0 + jnp.clip(cy, 0, rh1 - 1),
                        rx0 + jnp.clip(cx, 0, rw1 - 1),
                        valid,
                    )
                    lh_t, lw_t = fc_key_dyn.shape[0], fc_key_dyn.shape[1]
                    lg = _dyn_sample_rgba(
                        fc_key_dyn,
                        jnp.clip((ii * lh_t) // fh, 0, lh_t - 1),
                        jnp.clip(((jj - dxo) * lw_t) // fw, 0, lw_t - 1),
                        None,
                    )
                    in_box = row_in_box[:, None] & col_in_box[None, :]
                    a = jnp.where(
                        in_box, lg[..., 3].astype(jnp.int32), 0
                    )[..., None]
                    rgb = (
                        lg[..., :3].astype(jnp.int32) * a
                        + base[..., :3].astype(jnp.int32) * (255 - a)
                        + 127
                    ) // 255
                    patches.append((
                        x0s, y0s,
                        jnp.concatenate(
                            [rgb.astype(jnp.uint8), base[..., 3:]], axis=-1
                        ),
                    ))
                    continue
                if name == "focuspeaking" and fp_cfg.actual_size:
                    # 1:1 pixel mapping, centered on the rect, cropped to
                    # the slot (reference focuspeaking.c:203-220)
                    fw = jnp.minimum(jnp.int32(ws), rw1)
                    fh = jnp.minimum(jnp.int32(hs), rh1)
                    dxo = (ws - fw) // 2
                    src_j = rx0 + (rw1 - fw) // 2 + (jj - dxo)
                    sy = ry0 + (rh1 - fh) // 2 + ii
                else:
                    fw, fh = _fit_dyn(ws, hs, rw1, rh1)
                    dxo = (ws - fw) // 2
                    src_j = rx0 + ((jj - dxo) * rw1) // fw
                    sy = ry0 + (ii * rh1) // fh
                valid = (ii < fh)[:, None] & (
                    (jj >= dxo) & (jj < dxo + fw)
                )[None, :]
                patches.append(
                    (x0s, y0s, _dyn_sample_rgba(img, sy, src_j, valid))
                )
            canvas = compose_vstack(patches, out_width, out_height)
            return DockStepOutput(
                panel=canvas,
                vs_counts=vs_counts,
                wv_counts=wv_counts,
                hi_counts=hi_counts.astype(jnp.uint32),
                planes=res.planes,
            )

        # slot geometry for the model layer's mouse routing (name ->
        # (x0, y0, w, h) band + source dims; overlays are (0, 0) = the
        # band itself in dynamic mode)
        step_dyn.rects = dict(rects)
        step_dyn.dims = dict(dims)
        return step_dyn

    @jax.jit
    def step(frame: jax.Array, tm: jax.Array) -> DockStepOutput:
        planes = _ingest_planes(frame)
        res = analyze(
            planes,
            cs=csi,
            scale=scale,
            rect=roi_rect,
            need_vs=need_vs,
            need_wv_rgb=need_wv and not wv_yuv,
            need_wv_yuv=need_wv and wv_yuv,
            need_hi_rgb=need_hi and not hi_yuv,
            need_hi_yuv=need_hi and hi_yuv,
            keep_rgba=True,
            is_planar=True,
        )
        images = {}
        if "roi" in rects:
            images["roi"] = _planes_to_rgba(res.planes)
        vs_counts, wv_counts, hi_counts = _stat_renders(res, sw * sh, images)
        # overlays (planar; to RGBA via u32 compose)
        ov_src = res.planes if overlays_on_capture else planes
        if dk.show_zebra:
            images["zebra"] = _planes_to_rgba(
                overlay_ops.zebra_planes(
                    ov_src, th_low=zb_cfg.th_low, th_high=zb_cfg.th_high, tm=tm,
                    cs=zb_cs,
                )
            )
        if dk.show_falsecolor:
            if fc_lut is not None:
                fc = overlay_ops.falsecolor_lut_planes(
                    ov_src, fc_lut, cs=fc_cs, lut_n=fc_lut.shape[0]
                )
            else:
                fc = overlay_ops.falsecolor_planes(ov_src, cs=fc_cs)
            if fc_key is not None:
                if (fc_h, fc_w) != (ov_h, ov_w):
                    canvas_fc = jnp.zeros((4, fc_h, fc_w), jnp.uint8)
                    canvas_fc = canvas_fc.at[3].set(255)
                    fc = canvas_fc.at[:, :ov_h, :ov_w].set(fc)
                fc = render_ops.blend_overlay_planes(fc, fc_key)
            images["falsecolor"] = _planes_to_rgba(fc)
        if dk.show_focuspeaking:
            images["focuspeaking"] = _planes_to_rgba(
                overlay_ops.focus_peaking_planes(ov_src, peak_th, peak_color)
            )

        patches = []
        for name, w_src, h_src in shown:
            x0, y0, w, h = rects[name]
            if name == "focuspeaking" and fp_cfg.actual_size:
                # 1:1 pixel mapping, centered, cropped to the slot
                # (reference set_actual_size_matrix, focuspeaking.c:203-220;
                # twin of models/dock.py Dock.render)
                w, h = min(w, w_src), min(h, h_src)
                cx0 = (w_src - w) // 2
                cy0 = (h_src - h) // 2
                patch = images[name][cy0 : cy0 + h, cx0 : cx0 + w]
                x0 = (out_width - w) // 2
            else:
                patch = _resize_nearest_rgba(images[name], h, w)
            patches.append((x0, y0, patch))
        canvas = compose_vstack(patches, out_width, out_height)
        return DockStepOutput(
            panel=canvas,
            vs_counts=vs_counts,
            wv_counts=wv_counts,
            hi_counts=hi_counts.astype(jnp.uint32),
        )

    step.rects = dict(rects)
    step.dims = dict(dims)
    return step
