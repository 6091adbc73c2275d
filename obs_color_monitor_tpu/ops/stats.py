"""Statistics accumulators as int32 scatter-adds (planar).

The reference computes these with per-pixel scalar scatter loops on the CPU
after a GPU->CPU readback (src/vectorscope.c:217-238, src/waveform.c:220-257,
src/histogram.c:357-395).  Here the same counting runs on device as
``.at[].add`` scatters into int32 bins, which XLA lowers to atomic adds:

  * vectorscope (256x256)  = one scatter into 32 private copies of the
                             bins, the copy chosen by the pixel's column,
                             summed after — a flat field's updates spread
                             over 32 addresses instead of one;
  * waveform (256 x W)     = one scatter into (channel, value, column)
                             bins — already spread over W columns;
  * histogram (256 bins)   = the waveform's column sum (identical counting
                             semantics; cheaper than a 768-bin scatter,
                             whose flat-field contention is extreme).

The form of each was chosen on an H100 against the earlier one-hot matmul
forms, on random content and on a flat field (PERF.md, Findings).  All
counts are exact int32 (sums do not depend on order), then saturated exactly
like the reference (u8 min-255 for vectorscope/waveform — saturating
increment commutes with counting — and u32 for the histogram).

Inputs are PLANAR: value planes (C, H, W) u8 + mask (H, W).  Single-frame;
batch via jax.vmap.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

VS_SIZE = 256
WV_SIZE = 256
HI_SIZE = 256

# Private copies of the vectorscope bins (chosen by column, summed after).
_VS_COPIES = 32


# ---------------------------------------------------------------------------
# Histogram
# ---------------------------------------------------------------------------

@jax.jit
def histogram_counts(planes: jax.Array, mask: jax.Array) -> jax.Array:
    """256-bin per-channel counts.

    planes: uint8 (3, H, W); mask: bool (H, W) — pixels with alpha==0 are
    skipped (reference src/histogram.c:385-387).  Returns uint32 (3, 256).
    """
    return histogram_from_waveform(waveform_counts_i32(planes, mask))


def histogram_from_waveform(wv_i32: jax.Array) -> jax.Array:
    """(C, 256, W) i32 waveform counts -> (C, 256) u32 histogram; the
    counting semantics are identical (same values, same alpha skip)."""
    return wv_i32.sum(axis=-1).astype(jnp.uint32)


@functools.partial(
    jax.jit, static_argnames=("sel", "level_fixed", "level_ratio_permille")
)
def histogram_hi_max(
    counts: jax.Array,
    sel: tuple[bool, bool, bool],
    n_pixels: jax.Array | int,
    level_fixed: int,
    level_ratio_permille: int,
) -> jax.Array:
    """Normalization ceiling (reference src/histogram.c:396-402,342-355).

    Static level config; n_pixels may be traced (ROI-dependent).
    Returns uint32 (3,).
    """
    if level_fixed > 0:
        v = jnp.uint32(max(1, int(level_fixed)))
        return jnp.full((3,), v, dtype=jnp.uint32)
    if level_ratio_permille > 0:
        # floor(n*p/1000) computed overflow-safe in uint32: with n = 1000q+r,
        # n*p/1000 = q*p + r*p/1000 exactly.  (A naive uint64 product silently
        # narrows to uint32 under JAX's default x64-off and overflows above
        # ~4.3M pixels; reference src/histogram.c:397-402 uses a real uint64.)
        n = jnp.asarray(n_pixels, dtype=jnp.uint32)
        p = jnp.uint32(level_ratio_permille)
        q, r = n // 1000, n % 1000
        v = q * p + (r * p) // 1000
        v = jnp.maximum(v, 1).astype(jnp.uint32)
        return jnp.full((3,), 1, dtype=jnp.uint32) * v
    hi = jnp.maximum(counts.max(axis=1), 1).astype(jnp.uint32)
    sel_arr = jnp.asarray(sel, dtype=bool)
    return jnp.where(sel_arr, hi, jnp.uint32(1))


@functools.partial(jax.jit, static_argnames=("sel", "logscale"))
def histogram_levels(
    counts: jax.Array, hi_max: jax.Array, sel: tuple[bool, bool, bool], logscale: bool
) -> tuple[jax.Array, jax.Array]:
    """Float draw levels + effective hi_max (reference src/histogram.c:404-417)."""
    sel_arr = jnp.asarray(sel, dtype=bool)[:, None]
    cf = counts.astype(jnp.float32)
    if logscale:
        s = 1.0 / jnp.log(hi_max.astype(jnp.float32) + 1.0)
        lv = jnp.where(counts > 0, jnp.log(cf + 1.0) * s[:, None], 0.0)
        lv = jnp.where(sel_arr, lv, 0.0)
        return lv, jnp.ones((3,), jnp.float32)
    return cf, hi_max.astype(jnp.float32)


# ---------------------------------------------------------------------------
# Vectorscope
# ---------------------------------------------------------------------------

@jax.jit
def vectorscope_counts_i32(
    yuv_planes: jax.Array, mask: jax.Array | None = None
) -> jax.Array:
    """Unsaturated int32 vectorscope counts[v, u] (for cross-device psum
    merges: saturation must happen AFTER the merge to stay bit-exact).

    yuv_planes: uint8 (3, H, W) in Y,U,V plane order; mask: optional bool
    (H, W) restricting which pixels count (the dynamic ROI), None = all.
    """
    u = yuv_planes[1].astype(jnp.int32)
    v = yuv_planes[2].astype(jnp.int32)
    copy = jax.lax.broadcasted_iota(jnp.int32, u.shape, u.ndim - 1) % _VS_COPIES
    idx = (v * VS_SIZE + u) * _VS_COPIES + copy
    upd = 1 if mask is None else mask.astype(jnp.int32).reshape(-1)
    bins = (
        jnp.zeros(VS_SIZE * VS_SIZE * _VS_COPIES, jnp.int32)
        .at[idx.reshape(-1)]
        .add(upd, mode="promise_in_bounds")
    )
    return bins.reshape(VS_SIZE, VS_SIZE, _VS_COPIES).sum(axis=-1)


@jax.jit
def vectorscope_counts(yuv_planes: jax.Array) -> jax.Array:
    """256x256 CbCr occupancy, u8 saturating; counts[v, u], v ascending.

    Every pixel counts — no alpha skip (reference src/vectorscope.c:217-238).
    Saturating increment commutes with counting, so the clamp happens once.
    """
    return jnp.minimum(vectorscope_counts_i32(yuv_planes), 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Waveform
# ---------------------------------------------------------------------------

@jax.jit
def waveform_counts_i32(planes: jax.Array, mask: jax.Array) -> jax.Array:
    """Unsaturated int32 waveform counts (for cross-device psum merges).

    planes: uint8 (C, H, W); mask: bool (H, W).  Returns (C, 256, W).
    """
    c, w = planes.shape[0], planes.shape[2]
    ch = jax.lax.broadcasted_iota(jnp.int32, planes.shape, 0)
    col = jax.lax.broadcasted_iota(jnp.int32, planes.shape, 2)
    idx = (ch * WV_SIZE + planes.astype(jnp.int32)) * w + col
    upd = jnp.broadcast_to(mask, planes.shape).astype(jnp.int32)
    return (
        jnp.zeros(c * WV_SIZE * w, jnp.int32)
        .at[idx.reshape(-1)]
        .add(upd.reshape(-1), mode="promise_in_bounds")
        .reshape(c, WV_SIZE, w)
    )


@jax.jit
def waveform_counts(planes: jax.Array, mask: jax.Array) -> jax.Array:
    """Per-column 256-level counts, u8 saturating.

    planes: uint8 (3, H, W); mask: bool (H, W) (alpha!=0,
    reference src/waveform.c:247-248).  Returns uint8 (3, 256, W) with the
    value axis ascending (reference flips rows at store; we flip at render).
    """
    return jnp.minimum(waveform_counts_i32(planes, mask), 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Channel selection helpers shared by histogram/waveform models
# ---------------------------------------------------------------------------

def select_planes(
    planes: jax.Array, yuv_planes: jax.Array | None, is_yuv: bool
) -> tuple[jax.Array, jax.Array]:
    """(data (3,H,W), mask (H,W)) per component mode.

    planes: the frame's (4,H,W).  YUV-mode surfaces always have alpha=255
    in the reference (the conversion shader writes a=1,
    data/common.effect:30,41), so that mask is all-true.
    """
    if is_yuv:
        assert yuv_planes is not None
        return yuv_planes, jnp.ones(yuv_planes.shape[-2:], dtype=bool)
    return planes[..., :3, :, :], planes[..., 3, :, :] != 0


def apply_channel_select(counts: jax.Array, sel: tuple[bool, bool, bool]) -> jax.Array:
    """Zero out disabled channels (reference zeroes its buffer first)."""
    sel_arr = np.asarray(sel, dtype=bool).reshape((3,) + (1,) * (counts.ndim - 1))
    return counts * jnp.asarray(sel_arr, dtype=counts.dtype)
