"""Device renderers vs the golden renderer, ALL display/component combos."""

import numpy as np
import pytest

from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.golden import render as grender
from obs_color_monitor_tpu.ops import render as drender


@pytest.fixture(scope="module")
def counts(rng):
    return rng.integers(0, 256, (3, 256, 24), dtype=np.uint8)


@pytest.mark.parametrize("cs", [Colorspace.BT601, Colorspace.BT709])
@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("intensity", [1, 25, 255])
def test_vectorscope_render_golden(rng, cs, white, intensity):
    vs = rng.integers(0, 256, (256, 256), dtype=np.uint8)
    want = grender.render_vectorscope(vs, intensity, cs, white)
    got = np.asarray(
        drender.render_vectorscope(vs, intensity=intensity, cs=int(cs), white=white)
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("display", [0, 1, 2])
@pytest.mark.parametrize("n,yuv", [(3, False), (3, True), (2, True), (1, True)])
def test_waveform_render_golden(counts, display, n, yuv):
    want = grender.render_waveform(counts, 51, display, n, yuv)
    got = np.asarray(
        drender.render_waveform(
            counts, intensity=51, display=display, n_components=n, yuv_mode=yuv
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("display", [0, 1, 2])
@pytest.mark.parametrize("n,yuv", [(3, False), (2, True), (1, True)])
def test_histogram_render_golden(rng, display, n, yuv):
    levels = rng.integers(0, 5000, (3, 256)).astype(np.float32)
    hi = np.asarray([4000.0, 2500.0, 1.0], np.float32)
    want = grender.render_histogram(levels, hi, 64, display, n, yuv)
    got = np.asarray(
        drender.render_histogram(
            levels, hi, level_height=64, display=display, n_components=n, yuv_mode=yuv
        )
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level_height", [200, 64, 2048])
def test_histogram_render_threshold_ties(level_height):
    """Levels sitting EXACTLY on a row threshold (thr[row] * hi_max in f32)
    fill identically on device and in golden: the thresholds are one f32
    expression on both sides, so a tie cannot flip by an ulp."""
    H = level_height
    thr = np.float32(1.0) - (
        np.arange(H, dtype=np.float32) + np.float32(0.5)
    ) / np.float32(H)
    hi = np.asarray([160.0, 4000.0, 999.0], np.float32)
    rows = np.arange(256) % H
    levels = (thr[rows][None, :] * hi[:, None]).astype(np.float32)
    want = grender.render_histogram(levels, hi, H, 0, 3, False)
    got = np.asarray(
        drender.render_histogram(
            levels, hi, level_height=H, display=0, n_components=3, yuv_mode=False
        )
    )
    np.testing.assert_array_equal(got, want)
