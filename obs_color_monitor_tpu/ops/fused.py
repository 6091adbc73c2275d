"""Fused single-pass frame analysis (planar hot path).

The reference's ROI hub renders/reads back a frame once and fans the mapped
surface out to N scope callbacks, each running its own CPU loop over the
same pixels (reference src/roi.c:315-341, src/common.c:335-373).  Here it is
ONE jitted function that planarizes the frame once, reads it once from
device memory, and produces every requested statistic — XLA fuses the YUV
conversion into all consumers and nothing is traversed twice.

``analyze`` is the single entry: static flags select which statistics are
computed (compiled once per flag/shape combination, like the reference's
per-scope effect techniques).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .convert import (
    downscale_planes,
    planarize,
    planarize_packed,
    rgb_to_yuv_planes,
    roi_crop_planes,
)
from .stats import (
    histogram_from_waveform,
    select_planes,
    vectorscope_counts_i32,
    waveform_counts_i32,
)


class AnalysisResult(NamedTuple):
    """Per-frame statistics; entries are None unless requested.

    ``planes``/``yuv_planes`` are PLANAR (C, H, W) u8.
    """

    yuv_planes: jax.Array | None  # (3, H, W) u8
    vs_counts: jax.Array | None  # (256, 256) u8
    wv_rgb: jax.Array | None  # (3, 256, W) u8
    wv_yuv: jax.Array | None
    hi_rgb: jax.Array | None  # (3, 256) u32
    hi_yuv: jax.Array | None
    planes: jax.Array | None  # the scaled/cropped frame (4, H, W)


@functools.partial(
    jax.jit,
    static_argnames=(
        "cs",
        "scale",
        "rect",
        "need_vs",
        "need_wv_rgb",
        "need_wv_yuv",
        "need_hi_rgb",
        "need_hi_yuv",
        "keep_rgba",
        "is_planar",
        "is_packed",
    ),
)
def analyze(
    frame: jax.Array,
    cs: int,
    scale: int = 1,
    rect: tuple[int, int, int, int] | None = None,
    need_vs: bool = False,
    need_wv_rgb: bool = False,
    need_wv_yuv: bool = False,
    need_hi_rgb: bool = False,
    need_hi_yuv: bool = False,
    keep_rgba: bool = True,
    is_planar: bool = False,
    is_packed: bool = False,
    rect_dyn: jax.Array | None = None,
) -> AnalysisResult:
    """One pass: planarize -> downscale -> crop -> convert -> statistics.

    frame: uint8 (H, W, 4) RGBA, or (4, H, W) planar with is_planar=True,
    or the (H, W) u32 bitcast view of the interleaved frame with
    is_packed=True.  ``rect`` is the ROI (x0, y0, x1, y1) in *scaled*
    coordinates (reference src/common.c:273-282).

    ``rect_dyn`` is a DYNAMIC (4,) i32 ROI (x0, y0, x1, y1) in scaled
    coordinates (mutually exclusive with the static ``rect``): statistics
    count only in-rect pixels, bit-identical to the static crop — the
    waveform keeps full width with out-of-rect columns zero — but changing
    the rect never recompiles (reference interactive drag, src/roi.c:343-521).
    ``planes``/``yuv_planes`` then stay FULL-capture (uncropped).
    """
    if is_packed:
        planes = planarize_packed(frame)
    else:
        planes = frame if is_planar else planarize(frame)
    planes = downscale_planes(planes, scale=scale)
    if rect is not None:
        planes = roi_crop_planes(planes, *rect)

    # dynamic ROI: never crop — restrict counting with an iota rect mask
    in_rect = None
    if rect_dyn is not None:
        assert rect is None, "rect and rect_dyn are mutually exclusive"
        r = jnp.asarray(rect_dyn, jnp.int32)
        hh, ww = planes.shape[-2], planes.shape[-1]
        rx0 = jnp.clip(r[0], 0, ww)
        ry0 = jnp.clip(r[1], 0, hh)
        rx1 = jnp.clip(r[2], rx0, ww)
        ry1 = jnp.clip(r[3], ry0, hh)
        ri = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 0)
        ci = jax.lax.broadcasted_iota(jnp.int32, (hh, ww), 1)
        in_rect = (ri >= ry0) & (ri < ry1) & (ci >= rx0) & (ci < rx1)

    need_yuv = need_vs or need_wv_yuv or need_hi_yuv
    yuv = rgb_to_yuv_planes(planes, cs=cs) if need_yuv else None

    vs = None
    if need_vs:
        vs_i = vectorscope_counts_i32(yuv, in_rect)
        vs = jnp.minimum(vs_i, 255).astype(jnp.uint8)

    def _wv_hi(is_yuv, need_wv, need_hi):
        if not (need_wv or need_hi):
            return None, None
        data, mask = select_planes(planes, yuv, is_yuv=is_yuv)
        if in_rect is not None:
            mask = mask & in_rect
        # the histogram is the waveform's column sum (identical counting)
        wv_i32 = waveform_counts_i32(data, mask)
        wv = jnp.minimum(wv_i32, 255).astype(jnp.uint8) if need_wv else None
        return wv, histogram_from_waveform(wv_i32) if need_hi else None

    wv_rgb, hi_rgb = _wv_hi(False, need_wv_rgb, need_hi_rgb)
    wv_yuv, hi_yuv = _wv_hi(True, need_wv_yuv, need_hi_yuv)
    return AnalysisResult(
        yuv_planes=yuv,
        vs_counts=vs,
        wv_rgb=wv_rgb,
        wv_yuv=wv_yuv,
        hi_rgb=hi_rgb,
        hi_yuv=hi_yuv,
        planes=planes if keep_rgba else None,
    )
