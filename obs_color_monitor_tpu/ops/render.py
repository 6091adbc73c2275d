"""Scope renderers: counts -> RGBA images, on device (JAX).

Re-implements the reference draw shaders (data/vectorscope.effect:27-39,
data/waveform.effect:30-83, data/histogram.effect:30-85) as vectorized
integer/float ops.  Tint math is 12-bit fixed point so results are
deterministic across backends; the histogram fill test uses single f32
multiplies (correctly rounded everywhere, no FMA chains).

Channel display mapping: the reference's staging surfaces are BGRA, so in
YUV mode the draw shaders see (.x,.y,.z) = (V, Y, U) (byte order artifact,
reference src/waveform.c:240-255 + GS_BGRX sampling).  This framework keeps
counts in (Y,U,V) order and maps at render: display channel i reads
count channel DISP_YUV[i] = (2, 0, 1)[i] -> identical pixels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..colorspace import Colorspace, VECTORSCOPE_TINT

VS_SIZE = 256

# Stack/parade channel tint matrix rows (reference data/waveform.effect:4-9,
# data/histogram.effect:4-9): display channel i colored color[i].xyz.
_TINT_ROWS = np.asarray(
    [[1.00, 0.41, 0.41], [0.00, 1.00, 0.00], [0.53, 0.53, 1.00]], dtype=np.float64
)
_TINT_FIXED = np.round(_TINT_ROWS * 4096.0).astype(np.int32)  # (3,3) Q12

# Display channel -> count channel (see module docstring).
DISP_RGB = (0, 1, 2)
DISP_YUV = (2, 0, 1)


def _scale_q12(v: jax.Array, coef_q12) -> jax.Array:
    """round(v * coef) with coef in Q12; v int32 >= 0."""
    return (v * jnp.asarray(coef_q12, jnp.int32) + 2048) >> 12


def _compose_rgba(r: jax.Array, g: jax.Array, b: jax.Array) -> jax.Array:
    """Three (H, W) channel planes (int values 0..255) -> (H, W, 4) u8 with
    alpha 255, via one u32 compose + bitcast (same trick as
    convert.planarize)."""
    x = (
        r.astype(jnp.uint32)
        | (g.astype(jnp.uint32) << 8)
        | (b.astype(jnp.uint32) << 16)
        | jnp.uint32(0xFF000000)
    )
    return jax.lax.bitcast_convert_type(x, jnp.uint8)


@functools.partial(jax.jit, static_argnames=("intensity", "cs", "white"))
def render_vectorscope(
    counts: jax.Array, intensity: int, cs: int, white: bool
) -> jax.Array:
    """counts (256,256) u8 [v,u] ascending -> RGBA (256,256,4).

    Shader: r = min(count*intensity/255, 1); white mode rgb = r;
    chroma mode rgb = (color + color_u*(2u-1) + color_v*(1-2v)) * r
    (reference data/vectorscope.effect:27-33, tint constants
    src/vectorscope.c:418-439).  Output row 0 = v=255 (the reference's
    buffer flip, src/vectorscope.c:231).
    """
    v = jnp.minimum(counts[::-1].astype(jnp.int32) * jnp.int32(intensity), 255)
    if white:
        return _compose_rgba(v, v, v)
    tint = VECTORSCOPE_TINT[Colorspace(cs)]
    C = np.round(np.asarray(tint["color"][:3]) * 4096).astype(np.int64)
    Cu = np.round(np.asarray(tint["color_u"]) * 4096).astype(np.int64)
    Cv = np.round(np.asarray(tint["color_v"]) * 4096).astype(np.int64)
    col = jax.lax.broadcasted_iota(jnp.int32, (VS_SIZE, VS_SIZE), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (VS_SIZE, VS_SIZE), 0)
    # (2u-1) = (2col+1-256)/256 ; (1-2v) = (256-(2row+1))/256 at pixel
    # centers; numerators kept integral over denominator 2^12 * 256.
    fu = 2 * col + 1 - 256
    fv = 256 - (2 * row + 1)
    chans = []
    for c in range(3):
        num = jnp.int32(int(C[c]) * 256) + jnp.int32(int(Cu[c])) * fu + jnp.int32(
            int(Cv[c])
        ) * fv  # Q12 * 256 = Q20
        prod = num * v  # |num| < 2^21, v <= 255 -> < 2^29
        out = (prod + (1 << 19)) >> 20
        chans.append(jnp.clip(out, 0, 255))
    return _compose_rgba(*chans)


def _disp_order(yuv_mode: bool) -> tuple[int, int, int]:
    return DISP_YUV if yuv_mode else DISP_RGB


@functools.partial(
    jax.jit, static_argnames=("intensity", "display", "n_components", "yuv_mode")
)
def render_waveform(
    counts: jax.Array,
    intensity: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> jax.Array:
    """counts (3,256,W) u8 ascending -> RGBA image.

    Overlay: each display channel = min(count*intensity, 255) directly
    (reference data/waveform.effect:30-39).  Stack/Parade (n=3) tile bands
    vertically/horizontally, each band's single channel tinted by the fixed
    color matrix; n=2 uses the UV variants (bands .x and .z); n=1 falls back
    to Overlay (reference src/waveform.c:343-358).
    """
    from ..config import DisplayMode

    disp = DisplayMode(display)
    order = _disp_order(yuv_mode)
    w = counts.shape[-1]
    # value image per display channel, flipped so row 0 = level 255; the
    # channel reorder is STATIC indexing (stack of slices), not a gather —
    # a fancy-index gather on the (3,256,W) array cost 0.017 ms/4K frame
    vals = jnp.minimum(
        jnp.stack([counts[order[0]], counts[order[1]], counts[order[2]]])[
            :, ::-1, :
        ].astype(jnp.int32)
        * jnp.int32(intensity),
        255,
    )  # (3, 256, W) display-ordered

    n = n_components
    if n <= 1 or disp == DisplayMode.OVERLAY:
        return _compose_rgba(vals[0], vals[1], vals[2])
    bands = (0, 1, 2) if n == 3 else (0, 2)
    # channel planes per band, concatenated planar, ONE compose at the end
    axis = 0 if disp == DisplayMode.STACK else 1
    chans = []
    for c in range(3):
        chans.append(
            jnp.concatenate(
                [
                    jnp.clip(_scale_q12(vals[b], _TINT_FIXED[b, c]), 0, 255)
                    for b in bands
                ],
                axis=axis,
            )
        )
    return _compose_rgba(*chans)


@functools.partial(
    jax.jit, static_argnames=("level_height", "display", "n_components", "yuv_mode")
)
def render_histogram(
    levels: jax.Array,
    hi_max: jax.Array,
    level_height: int,
    display: int,
    n_components: int,
    yuv_mode: bool,
) -> jax.Array:
    """levels (3,256) f32 + hi_max (3,) f32 -> RGBA bar image.

    Fill test per output pixel: level >= (1 - (row+0.5)/H) * hi_max
    (reference data/histogram.effect:30-39 at pixel centers).  Overlay
    renders all channels into RGB; stack/parade tint per band.
    """
    from ..config import DisplayMode

    disp = DisplayMode(display)
    order = _disp_order(yuv_mode)
    H = level_height
    lv = levels[jnp.asarray(order)]  # (3, 256) display-ordered
    hm = hi_max[jnp.asarray(order)]
    # the row thresholds are a host constant: computed on device, XLA may
    # rewrite the division (e.g. as a reciprocal multiply) and move a
    # threshold by one ulp, which flips the fill test where a level sits
    # exactly on it
    thr = jnp.asarray(
        np.float32(1.0)
        - (np.arange(H, dtype=np.float32)[:, None] + np.float32(0.5))
        / np.float32(H)
    )  # (H, 1)
    # fill[c, row, col] = lv[c, col] >= thr[row] * hm[c]
    fill = lv[:, None, :] >= thr[None, :, :] * hm[:, None, None]  # (3, H, 256)

    n = n_components
    if n <= 1 or disp == DisplayMode.OVERLAY:
        on = [jnp.where(fill[c], jnp.int32(255), jnp.int32(0)) for c in range(3)]
        return _compose_rgba(*on)
    bands = (0, 1, 2) if n == 3 else (0, 2)
    tint_u8 = np.floor(
        np.clip(_TINT_ROWS, 0, 1) * 255.0 + 0.5
    ).astype(np.uint8)  # quantized band colors
    axis = 0 if disp == DisplayMode.STACK else 1
    chans = []
    for c in range(3):
        chans.append(
            jnp.concatenate(
                [
                    jnp.where(fill[b], jnp.int32(int(tint_u8[b, c])), jnp.int32(0))
                    for b in bands
                ],
                axis=axis,
            )
        )
    return _compose_rgba(*chans)


@jax.jit
def blend_overlay(image: jax.Array, overlay: jax.Array) -> jax.Array:
    """Integer srcalpha/invsrcalpha blend, device twin of
    utils.draw.alpha_blend_u8 (same rounding)."""
    a = overlay[..., 3:4].astype(jnp.int32)
    s = overlay[..., :3].astype(jnp.int32)
    d = image[..., :3].astype(jnp.int32)
    rgb = (s * a + d * (255 - a) + 127) // 255
    return jnp.concatenate(
        [rgb.astype(jnp.uint8), image[..., 3:]], axis=-1
    )


@jax.jit
def blend_overlay_planes(planes: jax.Array, overlay_planes: jax.Array) -> jax.Array:
    """Planar twin of blend_overlay: (4, H, W) image, (4, H, W) overlay.

    Same integer srcalpha/invsrcalpha rounding; alpha channel passes through.
    """
    a = overlay_planes[3:4].astype(jnp.int32)
    s = overlay_planes[:3].astype(jnp.int32)
    d = planes[:3].astype(jnp.int32)
    rgb = (s * a + d * (255 - a) + 127) // 255
    return jnp.concatenate([rgb.astype(jnp.uint8), planes[3:]], axis=0)


@functools.partial(jax.jit, static_argnames=("zoom",))
def zoom_center(image: jax.Array, zoom: float) -> jax.Array:
    """Vectorscope mouse-wheel zoom about the center
    (reference src/vectorscope.c:391-404): scale-by-z with offset
    127.5*(1-z), point-sampled.  Static zoom -> host-computed index map.
    """
    if zoom <= 1.01:
        return image
    n = image.shape[0]
    ofst = (n / 2 - 0.5) * (1.0 - zoom)
    src = np.floor((np.arange(n) + 0.5 - ofst) / zoom).astype(np.int64)
    src = np.clip(src, 0, n - 1)
    return image[src][:, src]
