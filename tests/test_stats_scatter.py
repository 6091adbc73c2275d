"""The int32 scatter statistics (ops.stats) and the analysis pass vs golden.

The scatter forms count with atomic adds on an accelerator; the worst case
for those is a flat field (every pixel in one bin), so the forms are pinned
to golden on flat, ramp and odd-shape frames as well as random content.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.config import Components
from obs_color_monitor_tpu.ops import stats
from obs_color_monitor_tpu.ops.fused import analyze


def _mk(rng, h, w):
    f = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < 0.1, 0, 255)
    return f


def _vs_full(yuv):
    """Unsaturated golden vectorscope counts[v, u]."""
    u = yuv[..., 1].astype(np.int64).ravel()
    v = yuv[..., 2].astype(np.int64).ravel()
    return np.bincount(v * 256 + u, minlength=65536).reshape(256, 256)


def _wv_full(f):
    """Unsaturated golden RGB waveform counts (alpha skip)."""
    h, w = f.shape[:2]
    keep = f[..., 3] != 0
    xs = np.broadcast_to(np.arange(w), (h, w))[keep]
    out = np.zeros((3, 256, w), np.int64)
    for c in range(3):
        vals = f[..., c].astype(np.int64)[keep]
        out[c] = np.bincount(vals * w + xs, minlength=256 * w).reshape(256, w)
    return out


def _planes(f):
    return jnp.asarray(np.moveaxis(f[..., :3], -1, 0)), jnp.asarray(f[..., 3] != 0)


@pytest.mark.parametrize("shape", [(128, 128), (96, 130), (300, 257)])
def test_vectorscope_counts_i32_bitexact(rng, shape):
    f = _mk(rng, *shape)
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT709)
    got = np.asarray(stats.vectorscope_counts_i32(np.moveaxis(yuv, -1, 0)))
    np.testing.assert_array_equal(got, _vs_full(yuv))
    assert got.sum() == shape[0] * shape[1]  # every pixel counted once


@pytest.mark.parametrize("shape", [(128, 128), (96, 130), (300, 257)])
def test_waveform_counts_i32_bitexact(rng, shape):
    f = _mk(rng, *shape)
    got = np.asarray(stats.waveform_counts_i32(*_planes(f)))
    np.testing.assert_array_equal(got, _wv_full(f))


def test_histogram_from_waveform_bitexact(rng):
    f = _mk(rng, 96, 130)
    wv = stats.waveform_counts_i32(*_planes(f))
    got = np.asarray(stats.histogram_from_waveform(wv))
    np.testing.assert_array_equal(
        got, golden.histogram_counts(f, None, Components.RGB)
    )


def test_vectorscope_unsaturated_flat():
    """Flat image: one bin holds every pixel before clamping."""
    yuv = np.zeros((3, 64, 64), dtype=np.uint8)
    yuv[1] = 7
    yuv[2] = 9
    got = np.asarray(stats.vectorscope_counts_i32(yuv))
    assert got[9, 7] == 64 * 64
    assert got.sum() == 64 * 64


def test_vectorscope_mask_counts_only_selected(rng):
    """The optional mask (the dynamic ROI) counts exactly the selected
    pixels."""
    f = _mk(rng, 40, 72)
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT601)
    mask = np.zeros((40, 72), bool)
    mask[5:30, 9:50] = True
    got = np.asarray(
        stats.vectorscope_counts_i32(np.moveaxis(yuv, -1, 0), jnp.asarray(mask))
    )
    np.testing.assert_array_equal(got, _vs_full(yuv[5:30, 9:50]))


@pytest.mark.parametrize("shape", [(128, 128), (96, 130)])
def test_analyze_vs_wv_hi_bitexact(rng, shape):
    f = _mk(rng, *shape)
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


def _check_analyze(f, scale, yuv_data):
    """analyze at ``scale`` (one data family) vs golden: downscale ->
    convert -> accumulate (reference src/common.c:141-250 + the scope
    loops)."""
    res = analyze(
        f, cs=2, scale=scale, need_vs=True,
        need_wv_rgb=not yuv_data, need_wv_yuv=yuv_data,
        need_hi_rgb=not yuv_data, need_hi_yuv=yuv_data,
    )
    scaled = golden.downscale(f, scale)
    yuv = golden.rgb_to_yuv_u8(scaled, Colorspace.BT709)
    comp = Components.YUV if yuv_data else Components.RGB
    fam = yuv if yuv_data else None
    np.testing.assert_array_equal(
        np.asarray(res.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(res.wv_yuv if yuv_data else res.wv_rgb),
        golden.waveform_counts(scaled, fam, comp),
    )
    np.testing.assert_array_equal(
        np.asarray(res.hi_yuv if yuv_data else res.hi_rgb),
        golden.histogram_counts(scaled, fam, comp),
    )
    np.testing.assert_array_equal(
        np.moveaxis(np.asarray(res.planes), 0, -1), scaled
    )


@pytest.mark.parametrize("shape", [(128, 256), (130, 190), (258, 514)])
@pytest.mark.parametrize("yuv_data", [False, True])
def test_analyze_scale2_bitexact(rng, shape, yuv_data):
    _check_analyze(_mk(rng, *shape), 2, yuv_data)


@pytest.mark.parametrize("shape", [(128, 128), (67, 190)])
@pytest.mark.parametrize("yuv_data", [False, True])
def test_analyze_scale1_bitexact(rng, shape, yuv_data):
    _check_analyze(_mk(rng, *shape), 1, yuv_data)


def _content(kind):
    if kind == "flat":
        f = np.empty((64, 96, 4), np.uint8)
        f[:] = (200, 30, 90, 255)
        return f
    if kind == "ramp":
        f = np.zeros((32, 256, 4), np.uint8)
        f[..., :3] = np.arange(256, dtype=np.uint8)[None, :, None]
        f[..., 3] = 255
        f[::3, ::5, 3] = 0  # some alpha-0 pixels on the ramp
        return f
    h, w = kind
    return _mk(np.random.default_rng(h * 1000 + w), h, w)


CONTENT = ["flat", "ramp", (1, 1), (31, 257), (13, 17)]


@pytest.mark.parametrize("kind", CONTENT, ids=str)
@pytest.mark.parametrize("stat", ["vectorscope", "waveform", "histogram"])
def test_scatter_forms_pinned_to_golden(stat, kind):
    f = _content(kind)
    if stat == "vectorscope":
        yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT709)
        got = np.asarray(stats.vectorscope_counts(np.moveaxis(yuv, -1, 0)))
        want = golden.vectorscope_counts(yuv)
    elif stat == "waveform":
        got = np.asarray(stats.waveform_counts(*_planes(f)))
        want = golden.waveform_counts(f, None, Components.RGB)
    else:
        got = np.asarray(stats.histogram_counts(*_planes(f)))
        want = golden.histogram_counts(f, None, Components.RGB)
    np.testing.assert_array_equal(got, want)
