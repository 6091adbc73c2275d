"""Bit-exactness: JAX statistics vs the NumPy golden model.

The golden model (obs_color_monitor_tpu/golden) is the oracle for the
reference's integer accumulation semantics (reference src/vectorscope.c:217-238,
src/waveform.c:220-257, src/histogram.c:357-418).
"""

import numpy as np
import pytest

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.config import Components
from obs_color_monitor_tpu.ops import convert, stats


CS = [Colorspace.BT601, Colorspace.BT709]


@pytest.mark.parametrize("cs", CS)
def test_yuv_conversion_bitexact(small_frame, cs):
    want = golden.rgb_to_yuv_u8(small_frame, cs)
    got = np.asarray(convert.rgb_to_yuv_u8(small_frame, cs=int(cs)))
    np.testing.assert_array_equal(got, want)


def test_yuv_conversion_exhaustive_gray():
    """Every gray level + every single-channel ramp, both colorspaces."""
    for cs in CS:
        k = np.arange(256, dtype=np.uint8)
        for ch in range(4):
            f = np.zeros((1, 256, 4), dtype=np.uint8)
            f[..., 3] = 255
            if ch < 3:
                f[0, :, ch] = k
            else:
                f[0, :, 0] = f[0, :, 1] = f[0, :, 2] = k
            want = golden.rgb_to_yuv_u8(f, cs)
            got = np.asarray(convert.rgb_to_yuv_u8(f, cs=int(cs)))
            np.testing.assert_array_equal(got, want)


def test_yuv_known_values():
    """Anchor points: black, white, primaries (601)."""
    f = np.array(
        [[[0, 0, 0, 255], [255, 255, 255, 255], [255, 0, 0, 255], [0, 0, 255, 255]]],
        dtype=np.uint8,
    )
    y = golden.rgb_to_yuv_u8(f, Colorspace.BT601)
    # black: Y=0, U=0.5-1/256 -> 127, V=0.5 -> 128
    np.testing.assert_array_equal(y[0, 0], [0, 127, 128])
    # white: Y=255 (0.299+0.587+0.114=1), U~127, V~128
    np.testing.assert_array_equal(y[0, 1], [255, 127, 128])
    # red: Y=round(0.299*255)=76, V=round((0.4375+0.5)*255)? no: 0.4375*1+0.5
    assert y[0, 2, 0] == 76
    assert y[0, 2, 2] == 239  # (0.4375+0.5)*255 = 239.06 -> 239
    # blue: U = (0.4375+0.5-1/256)*255 = 238.07 -> 238
    assert y[0, 3, 1] == 238


@pytest.mark.parametrize("cs", CS)
def test_vectorscope_bitexact(small_frame, cs):
    yuv = golden.rgb_to_yuv_u8(small_frame, cs)
    want = golden.vectorscope_counts(yuv)
    got = np.asarray(stats.vectorscope_counts(np.moveaxis(yuv, -1, 0)))
    np.testing.assert_array_equal(got, want)


def test_vectorscope_saturation():
    """A flat frame must saturate its single bin at 255."""
    yuv = np.zeros((64, 64, 3), dtype=np.uint8)
    yuv[..., 1] = 10
    yuv[..., 2] = 20
    want = golden.vectorscope_counts(yuv)
    got = np.asarray(stats.vectorscope_counts(np.moveaxis(yuv, -1, 0)))
    np.testing.assert_array_equal(got, want)
    assert got[20, 10] == 255
    assert got.sum() == 255


@pytest.mark.parametrize(
    "components", [Components.RGB, Components.Y, Components.UV, Components.YUV]
)
def test_waveform_bitexact(small_frame, components):
    cs = Colorspace.BT709
    yuv = golden.rgb_to_yuv_u8(small_frame, cs) if components.is_yuv else None
    want = golden.waveform_counts(small_frame, yuv, components)

    planes = np.moveaxis(small_frame, -1, 0)
    yuvp = None if yuv is None else np.moveaxis(np.asarray(yuv), -1, 0)
    data, mask = stats.select_planes(planes, yuvp, components.is_yuv)
    got = np.asarray(stats.waveform_counts(np.asarray(data), np.asarray(mask)))
    got = np.asarray(stats.apply_channel_select(got, components.channel_select()))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "components", [Components.RGB, Components.Y, Components.UV, Components.YUV]
)
def test_histogram_bitexact(small_frame, components):
    cs = Colorspace.BT601
    yuv = golden.rgb_to_yuv_u8(small_frame, cs) if components.is_yuv else None
    want = golden.histogram_counts(small_frame, yuv, components)

    planes = np.moveaxis(small_frame, -1, 0)
    yuvp = None if yuv is None else np.moveaxis(np.asarray(yuv), -1, 0)
    data, mask = stats.select_planes(planes, yuvp, components.is_yuv)
    got = np.asarray(stats.histogram_counts(np.asarray(data), np.asarray(mask)))
    got = np.asarray(
        stats.apply_channel_select(got.astype(np.uint32), components.channel_select())
    )
    np.testing.assert_array_equal(got, want)


def test_histogram_alpha_skip(small_frame):
    """Alpha-0 pixels must not count in RGB mode (src/histogram.c:385-387)."""
    n_opaque = int((small_frame[..., 3] != 0).sum())
    counts = golden.histogram_counts(small_frame, None, Components.RGB)
    assert counts[0].sum() == n_opaque
    got = np.asarray(
        stats.histogram_counts(
            np.moveaxis(small_frame[..., :3], -1, 0), small_frame[..., 3] != 0
        )
    )
    assert got[0].sum() == n_opaque


def test_vectorscope_counts_all_pixels(small_frame):
    """Vectorscope has NO alpha skip (src/vectorscope.c:225-236)."""
    yuv = golden.rgb_to_yuv_u8(small_frame, Colorspace.BT709)
    want = golden.vectorscope_counts(yuv)
    # total clamped counts <= n_pixels, but unclamped sum == n_pixels
    u = yuv[..., 1].astype(np.int64)
    v = yuv[..., 2].astype(np.int64)
    full = np.bincount((v * 256 + u).reshape(-1), minlength=65536)
    assert full.sum() == small_frame.shape[0] * small_frame.shape[1]
    np.testing.assert_array_equal(
        want, np.minimum(full.reshape(256, 256), 255).astype(np.uint8)
    )


def test_hi_max_modes(small_frame):
    counts = golden.histogram_counts(small_frame, None, Components.RGB)
    h, w = small_frame.shape[:2]
    # auto
    want = golden.histogram_hi_max(counts, Components.RGB, w, h, 0, 0)
    got = np.asarray(
        stats.histogram_hi_max(counts.astype(np.int32), (True, True, True), h * w, 0, 0)
    )
    np.testing.assert_array_equal(got, want)
    # fixed
    want = golden.histogram_hi_max(counts, Components.RGB, w, h, 1000, 0)
    got = np.asarray(
        stats.histogram_hi_max(
            counts.astype(np.int32), (True, True, True), h * w, 1000, 0
        )
    )
    np.testing.assert_array_equal(got, want)
    # ratio 10% -> permille 100: w*h*100/1000
    want = golden.histogram_hi_max(counts, Components.RGB, w, h, 0, 100)
    got = np.asarray(
        stats.histogram_hi_max(counts.astype(np.int32), (True, True, True), h * w, 0, 100)
    )
    np.testing.assert_array_equal(got, want)
    assert want[0] == (w * h * 100) // 1000


def test_hi_max_ratio_large_frames():
    """Ratio mode above 4.3M pixels: n*permille overflows uint32 if computed
    naively (and jnp.uint64 silently narrows to uint32 with x64 off).
    4K at scale 1 = 8.3 MP is in scope (reference src/histogram.c:397-402)."""
    counts = np.zeros((3, 256), np.uint32)
    for h, w, permille in [
        (2160, 3840, 1000),  # 8.3 MP, full ratio
        (2160, 3840, 100),
        (2160, 3840, 999),
        (4320, 7680, 1000),  # 33 MP (8K)
        (2073, 2073, 1000),  # just above the uint32 overflow threshold
        (7, 9, 1),  # tiny: max(1, ...) clamp
    ]:
        want = golden.histogram_hi_max(counts, Components.RGB, w, h, 0, permille)
        got = np.asarray(
            stats.histogram_hi_max(
                counts.astype(np.int32), (True, True, True), h * w, 0, permille
            )
        )
        np.testing.assert_array_equal(got, want)
        assert got[0] == max(1, (h * w * permille) // 1000)


def test_histogram_levels_logscale(small_frame):
    counts = golden.histogram_counts(small_frame, None, Components.RGB)
    h, w = small_frame.shape[:2]
    hi = golden.histogram_hi_max(counts, Components.RGB, w, h, 0, 0)
    want_lv, want_hi = golden.histogram_levels(counts, hi, Components.RGB, True)
    got_lv, got_hi = stats.histogram_levels(
        counts.astype(np.int32), hi.astype(np.uint32), (True, True, True), True
    )
    # float draw levels (not integer statistics): XLA's log approximation is
    # allowed a few ULP vs NumPy; bit-exactness applies to integer counts.
    np.testing.assert_allclose(np.asarray(got_lv), want_lv, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(got_hi), want_hi)


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20])
def test_downscale_bitexact(small_frame, scale):
    """Covers every branch of downscale_planes: passthrough (1), the
    column-pair matmul (2), the u32 bitcast (4), the centre-rows +
    column-pair select matmul for the other even scales (6/8/10/12/16/20),
    and the centre-texel select matmul for odd scales (3/5)."""
    if small_frame.shape[0] < scale or small_frame.shape[1] < scale:
        pytest.skip("frame smaller than scale")
    want = golden.downscale(small_frame, scale)
    got = np.asarray(convert.downscale(small_frame, scale=scale))
    np.testing.assert_array_equal(got, want)


def test_downscale_scale2_is_2x2_mean():
    """At scale 2 the bilinear tap lands exactly between 4 texels."""
    f = np.zeros((4, 4, 4), dtype=np.uint8)
    f[0, 0, 0] = 100
    f[0, 1, 0] = 110
    f[1, 0, 0] = 120
    f[1, 1, 0] = 130
    out = golden.downscale(f, 2)
    assert out[0, 0, 0] == 115  # mean of the 2x2 block


def test_1080p_bitexact(frame_1080p):
    """1080p histogram, vectorscope and waveform vs golden."""
    cs = Colorspace.BT709
    yuv_g = golden.rgb_to_yuv_u8(frame_1080p, cs)
    yuv_j = np.asarray(convert.rgb_to_yuv_u8(frame_1080p, cs=int(cs)))
    np.testing.assert_array_equal(yuv_j, yuv_g)

    planes = np.moveaxis(frame_1080p[..., :3], -1, 0)
    mask = frame_1080p[..., 3] != 0
    want_h = golden.histogram_counts(frame_1080p, None, Components.RGB)
    got_h = np.asarray(stats.histogram_counts(planes, mask))
    np.testing.assert_array_equal(got_h.astype(np.uint32), want_h)

    want_v = golden.vectorscope_counts(yuv_g)
    got_v = np.asarray(stats.vectorscope_counts(np.moveaxis(yuv_j, -1, 0)))
    np.testing.assert_array_equal(got_v, want_v)

    want_w = golden.waveform_counts(frame_1080p, None, Components.RGB)
    got_w = np.asarray(stats.waveform_counts(planes, mask))
    np.testing.assert_array_equal(got_w, want_w)
