"""The six-scope full step (api.make_full_step) and the analysis pass
(ops.fused.analyze) vs the NumPy golden model, across shapes that are not
multiples of any block, every downscale branch, both waveform/histogram
data families, and the packed u32 input form."""

import numpy as np
import pytest

import jax.numpy as jnp

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.api import make_full_step
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.config import (
    Components,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    WaveformConfig,
    ZebraConfig,
)
from obs_color_monitor_tpu.ops.fused import analyze

FP = FocusPeakingConfig()


def _frame(seed, h, w, alpha0=0.1):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (h, w, 4), np.uint8)
    f[..., 3] = np.where(rng.random((h, w)) < alpha0, 0, 255)
    return f


def _step(h, w, scale, yuv_data, **kw):
    comp = Components.YUV if yuv_data else Components.RGB
    return make_full_step(
        h, w, cs=Colorspace.BT709, scale=scale,
        waveform=WaveformConfig(components=comp),
        histogram=HistogramConfig(components=comp),
        zebra=ZebraConfig(colorspace=Colorspace.BT709),
        falsecolor=FalseColorConfig(colorspace=Colorspace.BT601),
        focuspeaking=FP, **kw,
    )


def _check_vs_golden(out, f, scale, yuv_data, tm):
    scaled = golden.downscale(f, scale)
    yuv = golden.rgb_to_yuv_u8(scaled, Colorspace.BT709)
    comp = Components.YUV if yuv_data else Components.RGB
    fam = yuv if yuv_data else None
    np.testing.assert_array_equal(
        np.asarray(out.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(out.wv_counts), golden.waveform_counts(scaled, fam, comp)
    )
    np.testing.assert_array_equal(
        np.asarray(out.hi_counts), golden.histogram_counts(scaled, fam, comp)
    )
    to_rgba = lambda p: np.moveaxis(np.asarray(p), 0, -1)  # noqa: E731
    np.testing.assert_array_equal(
        to_rgba(out.zebra), golden.zebra(f, 0.75, 1.0, tm, Colorspace.BT709)
    )
    np.testing.assert_array_equal(
        to_rgba(out.falsecolor), golden.falsecolor(f, Colorspace.BT601)
    )
    np.testing.assert_array_equal(
        to_rgba(out.focuspeaking),
        golden.focus_peaking(f, FP.peaking_threshold, FP.peaking_rgba),
    )


@pytest.mark.parametrize(
    "h4,w4,scale,yuv_data",
    [
        (270, 480, 2, False),
        (135, 240, 1, False),
        (129, 131, 2, True),   # odd dims
        (64, 128, 1, True),
        (65, 144, 2, False),   # odd height: the last row drops at scale 2
        (13, 17, 2, False),    # tiny
        (270, 480, 4, False),  # scale 4: centre-2x2 sampling
        (131, 133, 4, True),   # scale 4, odd dims
        (65, 144, 4, False),   # scale 4, rows that do not divide
        (140, 270, 8, False),  # the generic even-scale selection
        (131, 270, 8, True),   # scale 8, odd height + YUV family
    ],
)
def test_full_step_matches_golden(h4, w4, scale, yuv_data):
    f = _frame(h4 * w4 + scale, h4, w4)
    out = _step(h4, w4, scale, yuv_data)(f, np.float32(2.5))
    _check_vs_golden(out, f, scale, yuv_data, 2.5)


@pytest.mark.parametrize("shape", [(130, 300), (70, 140)])
def test_full_step_scale1_matches_golden(shape):
    """Scale 1 (statistics and overlays on the same full-resolution
    planes), from the (H, W, 4) frame and from its packed u32 view."""
    h, w = shape
    f = _frame(h * w, h, w)
    step = _step(h, w, 1, False)
    _check_vs_golden(step(f, np.float32(2.5)), f, 1, False, 2.5)
    packed = make_full_step(
        h, w, cs=Colorspace.BT709, scale=1, input_format="packed",
        zebra=ZebraConfig(colorspace=Colorspace.BT709),
        falsecolor=FalseColorConfig(colorspace=Colorspace.BT601),
    )
    out = packed(f.view(np.uint32)[..., 0], np.float32(2.5))
    _check_vs_golden(out, f, 1, False, 2.5)


@pytest.mark.parametrize(
    "h4,w4,scale",
    [(270, 480, 2), (65, 144, 2), (64, 130, 1), (140, 300, 4), (140, 300, 8)],
)
def test_full_step_packed_input(h4, w4, scale):
    """input_format="packed" consumes the u32 view of the interleaved frame
    and must match the (H, W, 4) input bit-for-bit in every output."""
    f = _frame(h4 + w4, h4, w4)
    rgba = make_full_step(h4, w4, cs=Colorspace.BT709, scale=scale)
    packed = make_full_step(h4, w4, cs=Colorspace.BT709, scale=scale,
                            input_format="packed")
    a = rgba(f, np.float32(1.5))
    b = packed(f.view(np.uint32)[..., 0], np.float32(1.5))
    for name in a._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            err_msg=name,
        )


def test_full_step_rejects_scale_larger_than_frame():
    step = make_full_step(32, 32, scale=40)
    with pytest.raises(ValueError, match="too small"):
        step(np.zeros((32, 32, 4), np.uint8), np.float32(0.0))
    with pytest.raises(ValueError, match="input_format"):
        make_full_step(32, 32, input_format="yuyv")


def test_analyze_stats_only_matches_golden():
    """The statistics-only pass (what the dock and the hub run): counts
    AND the kept downscaled planes vs golden, at a width that is not a
    multiple of any block."""
    f = _frame(11, 133, 257)
    res = analyze(f, cs=1, scale=2, need_vs=True, need_wv_rgb=True,
                  need_hi_rgb=True, keep_rgba=True)
    scaled = golden.downscale(f, 2)
    yuv = golden.rgb_to_yuv_u8(scaled, Colorspace.BT601)
    np.testing.assert_array_equal(
        np.asarray(res.vs_counts), golden.vectorscope_counts(yuv)
    )
    np.testing.assert_array_equal(
        np.asarray(res.wv_rgb),
        golden.waveform_counts(scaled, None, Components.RGB),
    )
    np.testing.assert_array_equal(
        np.asarray(res.hi_rgb),
        golden.histogram_counts(scaled, None, Components.RGB),
    )
    np.testing.assert_array_equal(
        np.moveaxis(np.asarray(res.planes), 0, -1), scaled
    )


def test_analyze_alpha_skip():
    """Transparent pixels: skipped by the waveform and histogram, counted
    by the vectorscope."""
    rng = np.random.default_rng(7)
    f = rng.integers(0, 256, (96, 160, 4), np.uint8)
    f[..., 3] = 255
    f[:48, :, 3] = 0  # top half transparent, bottom fully opaque
    res = analyze(jnp.asarray(f), cs=1, need_vs=True, need_wv_rgb=True,
                  need_hi_rgb=True)
    assert int(np.asarray(res.hi_rgb).sum()) == 3 * 48 * 160  # opaque only
    np.testing.assert_array_equal(
        np.asarray(res.wv_rgb),
        golden.waveform_counts(f, None, Components.RGB),
    )
    yuv = golden.rgb_to_yuv_u8(f, Colorspace.BT601)
    np.testing.assert_array_equal(
        np.asarray(res.vs_counts), golden.vectorscope_counts(yuv)
    )
