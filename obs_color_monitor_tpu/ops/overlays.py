"""Overlay scopes: zebra, false color, focus peaking (JAX, planar).

These are pure per-pixel GPU shaders in the reference with no readback
(SURVEY.md §3.3); here they are fused elementwise/stencil jit functions over
device-resident PLANAR frames (see ops.convert docstring for why planar).
Luma thresholds use the same 2^12 fixed point as the golden model — carried
in integer-valued float32 (exact below 2^24).

Planar functions take (4, H, W) u8 and return (4, H, W) u8; the interleaved
(H, W, 4) wrappers exist for the spec/test boundary.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .convert import interleave, luma_planes, planarize
from ..golden.reference import (
    FALSECOLOR_BANDS,
    falsecolor_band_colors_u8,
    luma_threshold_fixed,
)


@functools.partial(jax.jit, static_argnames=("cs", "th_low", "th_high"))
def zebra_planes(
    planes: jax.Array, th_low: float, th_high: float, tm: jax.Array | float, cs: int
) -> jax.Array:
    """Diagonal-stripe overlay (reference data/zebra.effect:26-48).

    Stripes where ``floor(x + y + 1 + tm) mod 6 < 3`` and
    th_low <= luma <= th_high; striped pixels become opaque black.
    ``tm`` is traced (the stripe clock animates every frame,
    reference src/zebra.c:660-666) — no recompile per tick.
    """
    luma = luma_planes(planes, cs=cs)  # (H, W) integer-valued f32
    lo = np.float32(luma_threshold_fixed(th_low))
    hi = np.float32(luma_threshold_fixed(th_high))
    h, w = planes.shape[-2], planes.shape[-1]
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    phase = jnp.floor(xx + yy + 1.0 + jnp.float32(tm)).astype(jnp.int32) % 6
    stripe = (luma >= lo) & (luma <= hi) & (phase < 3)
    rgb = jnp.where(stripe[None], jnp.uint8(0), planes[..., :3, :, :])
    alpha = jnp.where(stripe[None], jnp.uint8(255), planes[..., 3:, :, :])
    return jnp.concatenate([rgb, alpha], axis=-3)


@functools.partial(jax.jit, static_argnames=("cs", "th_low", "th_high"))
def zebra(rgba, th_low, th_high, tm, cs):
    return interleave(zebra_planes(planarize(rgba), th_low, th_high, tm, cs))


# Precomputed device constants for the 12-band cascade.
_BAND_COLORS = falsecolor_band_colors_u8()  # (12, 4) u8
_BAND_THRESH = np.asarray(
    [luma_threshold_fixed(t) for t, _ in FALSECOLOR_BANDS[:-1]], dtype=np.float32
)  # (11,) upper bounds, exclusive


@functools.partial(jax.jit, static_argnames=("cs",))
def falsecolor_planes(planes: jax.Array, cs: int) -> jax.Array:
    """12-band false color (reference data/falsecolor.effect:38-61).

    The cascade is a monotone threshold ladder, so each channel is a chain
    of 11 selects on the f32 luma — no per-pixel gather.
    """
    luma = luma_planes(planes, cs=cs)  # (H, W) f32
    chans = []
    for c in range(4):
        # walking the ladder top-down, a select is only needed where the
        # channel value CHANGES between adjacent bands (e.g. the alpha
        # channel is constant: zero selects) — ~2x fewer selects
        out = jnp.full(luma.shape, _BAND_COLORS[-1][c], jnp.uint8)
        prev_val = int(_BAND_COLORS[-1][c])
        for i in range(len(_BAND_THRESH) - 1, -1, -1):
            v = int(_BAND_COLORS[i][c])
            if v == prev_val:
                continue
            out = jnp.where(luma < _BAND_THRESH[i], jnp.uint8(v), out)
            prev_val = v
        chans.append(out)
    return jnp.stack(chans, axis=-3)


@functools.partial(jax.jit, static_argnames=("cs",))
def falsecolor(rgba: jax.Array, cs: int) -> jax.Array:
    return interleave(falsecolor_planes(planarize(rgba), cs=cs))


@functools.partial(jax.jit, static_argnames=("cs", "lut_n"))
def falsecolor_lut_planes(
    planes: jax.Array, lut: jax.Array, cs: int, lut_n: int
) -> jax.Array:
    """User 1-D LUT false color (reference data/falsecolor.effect:36-37).

    Point-sampled with clamp at u = luma: ``i = clip(floor(luma*N), 0, N-1)``
    with the fixed-point luma (scale 255 * 2^12).

    ``luma * N`` needs ~2^35 — past int32 (JAX runs without x64) — so the
    floor-divide is split exactly: with luma = a*256 + b and
    D = 255*2^12 = 4080*256,

        (luma*N) // D = (a*N)//4080 + (((a*N) mod 4080)*256 + b*N) // D

    every intermediate < 2^27 for N <= 32768.  lut is (N, 4) u8.
    """
    if lut_n > 32768:
        raise ValueError("falsecolor LUT larger than 32768 entries")
    luma = luma_planes(planes, cs=cs).astype(jnp.int32)
    a = luma >> 8
    b = luma & 255
    an = a * jnp.int32(lut_n)
    q = an // 4080
    r = an - q * 4080
    i = q + (r * 256 + b * jnp.int32(lut_n)) // (4080 * 256)
    i = jnp.clip(i, 0, lut_n - 1)
    return jnp.stack([jnp.take(lut[:, c], i) for c in range(4)], axis=-3)


@functools.partial(jax.jit, static_argnames=("cs", "lut_n"))
def falsecolor_lut(rgba, lut, cs, lut_n):
    return interleave(falsecolor_lut_planes(planarize(rgba), lut, cs, lut_n))


@jax.jit
def focus_peaking_planes(
    planes: jax.Array,
    th_fixed: jax.Array | int,
    peaking_color_u8: jax.Array,
    rect: jax.Array | None = None,
) -> jax.Array:
    """4-neighbor edge highlight (reference data/focuspeaking.effect:26-48).

    d = sum over RGB and the +-dx/+-dy cross of |neighbor - center|
    (edge-clamped), compared in integer space against ``th_fixed`` from
    :func:`golden.peaking_threshold_fixed`.  |a-b| via u8 max-min; sums in
    i16 (max 4*765 = 3060).  Edge clamp makes border diffs zero, so each
    axis is one forward-difference array contributed twice, zero-padded at
    the respective edge.

    ``rect``: optional DYNAMIC (4,) i32 (x0, y0, x1, y1) — the edge-clamp
    zeros move to the rect borders, so in-rect pixels match the CROPPED
    frame's focus peaking bit-for-bit (outside pixels are unspecified;
    the dynamic-ROI dock samples only the rect).

    NOTE (parity): like the reference, this is a cross-shaped gradient
    magnitude, not a true Sobel (SURVEY.md §2 #16).
    """
    rgb = planes[..., :3, :, :]
    h, w = rgb.shape[-2], rgb.shape[-1]

    def absdiff_sum(a, b):
        d = jnp.maximum(a, b) - jnp.minimum(a, b)
        return d.astype(jnp.int16).sum(axis=-3)  # sum channels -> (H, W')

    dx = absdiff_sum(rgb[..., :, 1:], rgb[..., :, :-1])  # (H, W-1)
    dy = absdiff_sum(rgb[..., 1:, :], rgb[..., :-1, :])  # (H-1, W)
    zx = jnp.zeros(dx.shape[:-1] + (1,), jnp.int16)
    zrow = jnp.zeros(dy.shape[:-2] + (1, w), jnp.int16)
    dxf = jnp.concatenate([dx, zx], axis=-1)  # (H, W): forward diff, last 0
    dyf = jnp.concatenate([dy, zrow], axis=-2)  # (H, W): downward diff
    if rect is not None:
        r = jnp.asarray(rect, jnp.int32)
        rx0 = jnp.clip(r[0], 0, w)
        ry0 = jnp.clip(r[1], 0, h)
        rx1 = jnp.clip(r[2], rx0, w)
        ry1 = jnp.clip(r[3], ry0, h)
        ci = jax.lax.broadcasted_iota(jnp.int32, (1, w), 1)
        ri = jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0)
        dxf = jnp.where(ci >= rx1 - 1, 0, dxf)
        dyf = jnp.where(ri >= ry1 - 1, 0, dyf)
    sxr = jnp.concatenate([zx, dxf[..., :-1]], axis=-1)  # dx[col-1]
    syr = jnp.concatenate([zrow, dyf[..., :-1, :]], axis=-2)  # dy[row-1]
    if rect is not None:
        sxr = jnp.where(ci <= rx0, 0, sxr)
        syr = jnp.where(ri <= ry0, 0, syr)
    acc = (dxf + sxr + dyf + syr).astype(jnp.int32)

    peak = (acc >= jnp.asarray(th_fixed, jnp.int32))[None]
    color = peaking_color_u8.astype(jnp.uint8).reshape(4, 1, 1)
    return jnp.where(peak, color, planes)


@jax.jit
def focus_peaking(rgba, th_fixed, peaking_color_u8):
    return interleave(
        focus_peaking_planes(planarize(rgba), th_fixed, peaking_color_u8)
    )
