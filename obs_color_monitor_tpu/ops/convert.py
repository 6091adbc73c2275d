"""Device-side color conversion and capture-path ops (JAX).

Replaces the reference's GPU conversion pass + staging readback
(reference src/common.c:170-221, data/common.effect:23-43): frames stay in
device memory, the conversion is exact 12-bit fixed point (see
colorspace.py), and nothing ever leaves the device until a scope's tiny
result is fetched.

LAYOUT: the hot path is PLANAR.  ``planarize`` converts the interleaved
(H, W, 4) u8 frame once at ingest; every *_planes op consumes (C, H, W)
planes, so each channel is a contiguous plane.  The interleaved-signature
functions remain as thin wrappers (tests, spec boundary).

All functions are jittable; colorspace is static.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..colorspace import Colorspace, FIXED_COEFFS, FIXED_SHIFT, LUMA_COEF


@jax.jit
def planarize(rgba: jax.Array) -> jax.Array:
    """(..., H, W, 4) u8 -> (..., 4, H, W) u8 — do this ONCE at ingest.

    Via u32 bitcast + byte shifts: each pixel is read as one u32 word and
    the bytes are shifted out (one memory-bound pass).  Little-endian:
    byte 0 (R) is the low byte.
    """
    x = jax.lax.bitcast_convert_type(rgba, jnp.uint32)  # (..., H, W)
    planes = [
        ((x >> k) & jnp.uint32(0xFF)).astype(jnp.uint8) for k in (0, 8, 16, 24)
    ]
    return jnp.stack(planes, axis=-3)


@jax.jit
def planarize_packed(x32: jax.Array) -> jax.Array:
    """(..., H, W) u32 packed-RGBA view -> (..., 4, H, W) u8 (planarize for
    callers that already bitcast the interleaved frame)."""
    planes = [
        ((x32 >> k) & jnp.uint32(0xFF)).astype(jnp.uint8) for k in (0, 8, 16, 24)
    ]
    return jnp.stack(planes, axis=-3)


def host_packed_view(frame):
    """Host (H, W, 4) u8 C-contiguous frame -> its (H, W) u32 packed view
    (identical bytes, free numpy view); anything else passes through.

    Every ingest entry point normalizes through here."""
    import numpy as np

    if (
        isinstance(frame, np.ndarray)
        and frame.ndim == 3
        and frame.shape[-1] == 4
        and frame.dtype == np.uint8
        and frame.flags["C_CONTIGUOUS"]
    ):
        return frame.view(np.uint32).reshape(frame.shape[:2])
    return frame


@jax.jit
def interleave(planes: jax.Array) -> jax.Array:
    """(..., C, H, W) -> (..., H, W, C); display/spec boundary only."""
    return jnp.moveaxis(planes, -3, -1)


@jax.jit
def planes_to_rgba(planes: jax.Array) -> jax.Array:
    """(4, H, W) u8 -> (H, W, 4) u8 via u32 compose (planarize's
    inverse)."""
    p = planes.astype(jnp.uint32)
    x32 = p[0] | (p[1] << 8) | (p[2] << 16) | (p[3] << 24)
    return jax.lax.bitcast_convert_type(x32, jnp.uint8)


@functools.partial(jax.jit, static_argnames=("cs",))
def rgb_to_yuv_planes(planes: jax.Array, cs: int) -> jax.Array:
    """Quantized RGB->YUV on planes: (..., C>=3, H, W) u8 -> (..., 3, H, W).

    Computed in float32: with the 2^12 coefficient scale every product and
    sum is an integer < 2^22 (exactly representable), so this matches the
    golden model's int64 arithmetic bit-for-bit.
    """
    k = np.asarray(FIXED_COEFFS[Colorspace(cs)], dtype=np.float32)  # (3,4)
    half = np.float32(1 << (FIXED_SHIFT - 1))
    inv = np.float32(1.0 / (1 << FIXED_SHIFT))
    r = planes[..., 0, :, :].astype(jnp.float32)
    g = planes[..., 1, :, :].astype(jnp.float32)
    b = planes[..., 2, :, :].astype(jnp.float32)
    outs = []
    for i in range(3):
        acc = k[i, 0] * r + k[i, 1] * g + k[i, 2] * b + np.float32(k[i, 3] + half)
        q = jnp.floor(acc * inv)
        outs.append(jnp.clip(q, 0.0, 255.0).astype(jnp.uint8))
    return jnp.stack(outs, axis=-3)


@functools.partial(jax.jit, static_argnames=("cs",))
def rgb_to_yuv_u8(rgba: jax.Array, cs: int) -> jax.Array:
    """Interleaved wrapper: uint8 (..., 4) -> uint8 (..., 3) in Y,U,V."""
    return interleave(rgb_to_yuv_planes(planarize(rgba), cs=cs))


@functools.partial(jax.jit, static_argnames=("cs",))
def luma_planes(planes: jax.Array, cs: int) -> jax.Array:
    """Fixed-point luma (scale 255*2^12) as integer-valued float32 (H, W).

    Shared by the zebra / false-color overlays
    (reference data/zebra.effect:29, data/falsecolor.effect:33).
    """
    kr, kg, kb = LUMA_COEF[Colorspace(cs)]
    scale = 1 << FIXED_SHIFT
    K = [np.float32(int(round(c * scale))) for c in (kr, kg, kb)]
    r = planes[..., 0, :, :].astype(jnp.float32)
    g = planes[..., 1, :, :].astype(jnp.float32)
    b = planes[..., 2, :, :].astype(jnp.float32)
    return K[0] * r + K[1] * g + K[2] * b


@functools.partial(jax.jit, static_argnames=("cs",))
def luma_fixed(rgba: jax.Array, cs: int) -> jax.Array:
    """Interleaved wrapper for luma_planes."""
    return luma_planes(planarize(rgba), cs=cs)


@functools.partial(jax.jit, static_argnames=("scale",))
def downscale_planes(planes: jax.Array, scale: int) -> jax.Array:
    """Integer-factor bilinear pre-downscale on (..., C, H, W) planes.

    Implements the reference's target_scale texrender shrink (reference
    src/common.c:141-168,249-250).  The sample position
    (i + 0.5)*s - 0.5 = i*s + (s-1)/2: odd s lands exactly on a texel;
    even s is the midpoint of the middle 2x2 — out = (a+b+c+d+2)>>2,
    bit-identical to the golden model's float path.  All reshapes are
    row-major dim splits; slices are static.  The column selections ride
    bf16 select matmuls (u8 values and 0/1 selects are bf16-exact, f32
    accumulation of at most two terms), bit-exact on every backend.
    """
    if scale <= 1:
        return planes
    h, w = planes.shape[-2], planes.shape[-1]
    oh, ow = h // scale, w // scale
    if oh == 0 or ow == 0:
        raise ValueError(f"frame {w}x{h} too small for scale {scale}")
    x = planes[..., : oh * scale, : ow * scale]

    def row_pairs(csum, a):
        # rows a, a+1 of each block: split of the (non-minor) H axis is free
        rows = csum.reshape(csum.shape[:-2] + (oh, scale, ow))
        return rows[..., :, a, :] + rows[..., :, a + 1, :]

    if scale == 2:
        # Column pairs as a bf16 matmul against the fixed 0/1 pair matrix
        # P[k, j] = [k//2 == j].  Exact: u8 values are exact in bf16,
        # products are the values themselves, and the f32 accumulation of
        # two terms <= 510 is exact.
        wpad = (-x.shape[-1]) % 256
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, wpad)])
        nb = xp.shape[-1] // 256
        xb = xp.reshape(xp.shape[:-1] + (nb, 256)).astype(jnp.bfloat16)
        pair = (
            jax.lax.broadcasted_iota(jnp.int32, (256, 128), 0) // 2
            == jax.lax.broadcasted_iota(jnp.int32, (256, 128), 1)
        ).astype(jnp.bfloat16)
        csum = jax.lax.dot_general(
            xb,
            pair,
            dimension_numbers=(((xb.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (..., H, nb, 128)
        csum = csum.reshape(csum.shape[:-2] + (nb * 128,))[..., :ow]
        rows = csum.reshape(csum.shape[:-2] + (oh, 2, ow))
        s = rows[..., :, 0, :] + rows[..., :, 1, :]
        return jnp.floor((s + 2.0) * 0.25).astype(jnp.uint8)
    if scale == 4:
        # the middle column pair sits inside one u32 word of the block
        x32 = jax.lax.bitcast_convert_type(
            x.reshape(x.shape[:-1] + (ow, 4)), jnp.uint32
        )  # (..., H, ow); bytes 0..3 = the 4 columns of the block
        b1 = ((x32 >> 8) & jnp.uint32(0xFF)).astype(jnp.int32)
        b2 = ((x32 >> 16) & jnp.uint32(0xFF)).astype(jnp.int32)
        s = row_pairs(b1 + b2, 1)
        return ((s + 2) >> 2).astype(jnp.uint8)

    a = scale // 2 - 1
    if scale % 2 == 0:
        # even scales >= 6 (the reference's target_scale goes to 128): pick
        # the two center ROWS of each block (a non-minor split+index), then
        # select+sum the two center COLUMNS with a 0/1 pair matrix.  Exact:
        # u8 operands are bf16-exact, each matmul output sums the two 0/1
        # column hits (<= 510, f32 accumulation), the two row products add
        # to <= 1020 in f32, and floor((s+2)/4) equals the golden (s+2)>>2.
        rows = x.reshape(x.shape[:-2] + (oh, scale, ow * scale))
        ra = rows[..., :, a, :].astype(jnp.bfloat16)
        rb = rows[..., :, a + 1, :].astype(jnp.bfloat16)
        iota_p = jax.lax.broadcasted_iota(jnp.int32, (ow * scale, ow), 0)
        base = (
            jax.lax.broadcasted_iota(jnp.int32, (ow * scale, ow), 1) * scale
            + a
        )
        sel = ((iota_p == base) | (iota_p == base + 1)).astype(jnp.bfloat16)
        mm = lambda t: jax.lax.dot_general(
            t,
            sel,
            dimension_numbers=(((t.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        s = mm(ra) + mm(rb)
        return jnp.floor((s + 2.0) * 0.25).astype(jnp.uint8)

    # odd scales: the sample is a single center texel per block.  The ROW
    # pick is a non-minor split+index; the COLUMN pick is a one-hot select
    # matmul.  Exact: u8 operands are bf16-exact, the 0/1 one-hot
    # contributes a single product per output, f32 accumulate.
    m = (scale - 1) // 2
    x_rows = x.reshape(x.shape[:-2] + (oh, scale, ow * scale))[..., :, m, :]
    sel = (
        jax.lax.broadcasted_iota(jnp.int32, (ow * scale, ow), 0)
        == jax.lax.broadcasted_iota(jnp.int32, (ow * scale, ow), 1) * scale
        + m
    ).astype(jnp.bfloat16)
    out = jax.lax.dot_general(
        x_rows.astype(jnp.bfloat16),
        sel,
        dimension_numbers=(((x_rows.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return out.astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("scale",))
def downscale(rgba: jax.Array, scale: int) -> jax.Array:
    """Interleaved wrapper for downscale_planes."""
    if scale <= 1:
        return rgba
    return interleave(downscale_planes(planarize(rgba), scale=scale))


# NV12 -> RGB planes: limited-range inverse conversion, 12-bit fixed point.
# Same constant table as the native runtime (csrc/ocm_runtime.cpp) — the two
# paths are bit-identical; this one keeps ingest on device (decoders hand us
# NV12; uploading Y+UV is 1.5 bytes/px vs 4 for RGBA).
_NV12_COEF = {
    1: (6537, -1605, -3330, 8263),
    2: (7343, -873, -2183, 8652),
}
_NV12_KY = 4769  # round(255/219 * 4096)


def _nv12_rgb_u8(y: jax.Array, uv: jax.Array, cs: int):
    """Shared NV12 decode body: (H, W) u8 R/G/B channel planes.

    Pure-integer fixed point, bit-identical to the native C++ kernel:
    with Y' = Y-16, C = Cx-128: channel = clip((4769*Y' + K.C + 2048)
    >> 12) (arithmetic shift = floor division).  The 4:2:0 chroma
    upsample doubles columns via a u16-pair bitcast and rows via a
    broadcast-reshape.
    """
    kr_cr, kg_cb, kg_cr, kb_cb = _NV12_COEF[int(cs)]
    h, w = y.shape[-2], y.shape[-1]
    yp = (y.astype(jnp.int32) - 16) * _NV12_KY
    # deinterleave CbCr via u16 bitcast
    uv16 = jax.lax.bitcast_convert_type(
        uv.reshape(uv.shape[:-1] + (w // 2, 2)), jnp.uint16
    ).astype(jnp.int32)
    cb = (uv16 & 0xFF) - 128  # (H/2, W/2)
    cr = (uv16 >> 8) - 128

    def col2(x):  # duplicate each value into adjacent columns
        xu = (x + 128).astype(jnp.uint32)
        return (
            jax.lax.bitcast_convert_type(xu | (xu << 16), jnp.uint16)
            .reshape(x.shape[:-2] + (h // 2, w))
            .astype(jnp.int32)
            - 128
        )

    def row2(x):  # double rows
        return jnp.broadcast_to(
            x[..., :, None, :], x.shape[:-2] + (h // 2, 2, w)
        ).reshape(x.shape[:-2] + (h, w))

    cb, cr = row2(col2(cb)), row2(col2(cr))

    def q(acc):
        return jnp.clip(acc >> 12, 0, 255).astype(jnp.uint8)

    r = q(yp + kr_cr * cr + 2048)
    g = q(yp + kg_cb * cb + kg_cr * cr + 2048)
    b = q(yp + kb_cb * cb + 2048)
    return r, g, b


@functools.partial(jax.jit, static_argnames=("cs",))
def nv12_to_planes(y: jax.Array, uv: jax.Array, cs: int = 2) -> jax.Array:
    """NV12 (y (H,W) u8, uv (H/2, W) u8 interleaved CbCr) -> (4, H, W) u8."""
    h, w = y.shape[-2], y.shape[-1]
    r, g, b = _nv12_rgb_u8(y, uv, cs)
    a = jnp.full((h, w), 255, jnp.uint8)
    return jnp.stack([r, g, b, a], axis=-3)


@functools.partial(jax.jit, static_argnames=("cs",))
def _nv12_to_packed(y: jax.Array, uv: jax.Array, cs: int = 2) -> jax.Array:
    r, g, b = _nv12_rgb_u8(y, uv, cs)
    return (
        r.astype(jnp.uint32)
        | (g.astype(jnp.uint32) << 8)
        | (b.astype(jnp.uint32) << 16)
        | jnp.uint32(0xFF000000)
    )


def nv12_shift(bits: int, msb_aligned: bool = False) -> int:
    """Round-shift that maps a 16-bit-LE NV12-layout sample to the 8-bit
    monitoring domain: bits-8 for LSB-aligned p10/p12/p14/p16 samples, 8
    for MSB-aligned P010 (the 10 significant bits live in the TOP of the
    word, so dropping the low byte drops zero padding + the 2 LSBs).
    0 means plain 8-bit NV12 (no shift, u8 planes)."""
    if bits not in (8, 10, 12, 14, 16):
        raise ValueError(f"bits must be 8/10/12/14/16, got {bits}")
    if bits == 8:
        return 0
    return 8 if msb_aligned else bits - 8


def _shift16_to_u8(plane: jax.Array, shift: int) -> jax.Array:
    """Device twin of the ingest host round-shift (round half up, clip:
    min((v + half) >> shift, 255), pipeline/ingest.py `_to8`)."""
    v = (plane.astype(jnp.int32) + (1 << (shift - 1))) >> shift
    return jnp.minimum(v, 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("cs", "shift"))
def _nv12_16_to_packed(y16, uv16, cs: int = 2, shift: int = 2):
    return _nv12_to_packed(
        _shift16_to_u8(y16, shift), _shift16_to_u8(uv16, shift), cs=cs
    )


def nv12_to_packed(
    y: jax.Array, uv: jax.Array, cs: int = 2, shift: int = 0
) -> jax.Array:
    """NV12 -> the (H, W) u32 packed-RGBA view, decoded ON DEVICE.

    The packed view is what every ingest route consumes, so NV12 frames
    can upload as 1.5 B/px instead of a host-decoded 4 B/px RGBA frame —
    2.7x less host->device traffic, and the fixed-point decode (bit-exact
    twin of csrc/ocm_runtime.cpp ocm_nv12_to_rgba) runs on the device
    instead of the host CPU.

    With ``shift`` > 0 the planes are 16-bit-LE NV12-layout samples
    (P010-family u16 planes, 3 B/px) and the round-shift to the 8-bit
    monitoring domain ALSO runs on device, fused into the decode —
    zero host per-pixel work for high-bit-depth capture.  Compute the
    shift with :func:`nv12_shift`; bit-exact vs the host round-shift
    policy (``pipeline.ingest`` `_to8`).
    Bit-exact twin of the golden/native decoders.
    """
    h, w = y.shape[-2], y.shape[-1]
    if h % 2 or w % 2 or tuple(uv.shape[-2:]) != (h // 2, w):
        raise ValueError(
            f"NV12 geometry: y {tuple(y.shape)} needs even dims and uv "
            f"(H/2, W), got uv {tuple(uv.shape)}"
        )
    if shift:
        if y.dtype != jnp.uint16 or uv.dtype != jnp.uint16:
            raise TypeError(
                f"shift={shift} expects u16 wire planes, got "
                f"{y.dtype}/{uv.dtype}"
            )
        return _nv12_16_to_packed(y, uv, cs=cs, shift=shift)
    if y.dtype != jnp.uint8 or uv.dtype != jnp.uint8:
        # a forgotten shift= on a P010-family buffer must fail loudly, not
        # decode raw 16-bit samples as if they were 8-bit (silently wrong
        # statistics)
        raise TypeError(
            f"NV12 planes must be u8 (pass shift= for 16-bit layouts), "
            f"got {y.dtype}/{uv.dtype}"
        )
    return _nv12_to_packed(y, uv, cs=cs)


def nv12_device_planes(y, uv):
    """Upload (y, uv) host planes with ONE transfer when possible.

    NV12 is one contiguous buffer on every wire that carries it (a file
    read, a decoder output, a capture ring slot) — the y and uv planes a
    caller passes are usually adjacent VIEWS of that buffer.  Detect the
    adjacency and upload the joint (H + H/2, W) block once, then split
    with device-side row slices (async dispatches, memory-bound copies) —
    on a host interconnect that charges per transfer this halves the
    transfers on the NV12 ingest path.  Any
    non-adjacent input (or a dtype that is not u8 / u16 — the 16-bit
    NV12 layouts ride the same joint upload) falls back to two plain
    uploads.  Device-resident inputs pass through untouched.
    """
    if (
        isinstance(y, np.ndarray)
        and isinstance(uv, np.ndarray)
        and y.dtype == uv.dtype
        and y.dtype in (np.uint8, np.uint16)  # u16 = 16-bit NV12 layouts
        and y.ndim == 2
        and uv.ndim == 2
        and y.shape[1] == uv.shape[1]
        and y.flags.c_contiguous
        and uv.flags.c_contiguous
        and np.lib.array_utils.byte_bounds(y)[1]
        == np.lib.array_utils.byte_bounds(uv)[0]
    ):
        h, w = y.shape
        joint = np.lib.stride_tricks.as_strided(
            y, shape=(h + uv.shape[0], w), strides=y.strides
        )  # bounds verified above; `joint` keeps y's buffer alive
        dev = jnp.asarray(joint)
        return dev[:h], dev[h:]
    return jnp.asarray(y), jnp.asarray(uv)


def roi_crop_planes(planes: jax.Array, x0: int, y0: int, x1: int, y1: int) -> jax.Array:
    """Static ROI sub-rect on planes (reference src/common.c:273-282)."""
    return planes[..., y0:y1, x0:x1]


def roi_crop(rgba: jax.Array, x0: int, y0: int, x1: int, y1: int) -> jax.Array:
    """Static ROI sub-rect, interleaved."""
    return rgba[..., y0:y1, x0:x1, :]
