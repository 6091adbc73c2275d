"""Bit-exactness: overlay ops (zebra / falsecolor / focuspeaking) vs golden."""

import numpy as np
import pytest

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.golden.reference import peaking_threshold_fixed
from obs_color_monitor_tpu.ops import overlays


CS = [Colorspace.BT601, Colorspace.BT709]


@pytest.mark.parametrize("cs", CS)
@pytest.mark.parametrize("tm", [0.0, 3.7, 11.99])
def test_zebra_bitexact(small_frame, cs, tm):
    want = golden.zebra(small_frame, 0.75, 1.00, tm, cs)
    got = np.asarray(overlays.zebra(small_frame, 0.75, 1.00, tm, cs=int(cs)))
    np.testing.assert_array_equal(got, want)


def test_zebra_stripes_visible():
    """A flat white frame must show diagonal stripes (not all-black)."""
    f = np.full((12, 12, 4), 255, dtype=np.uint8)
    out = golden.zebra(f, 0.75, 1.00, 0.0, Colorspace.BT709)
    black = (out[..., :3] == 0).all(axis=-1)
    assert black.any() and not black.all()
    # stripe runs diagonally: phase constant along anti-diagonals
    for k in range(12):
        diag = black.diagonal(offset=k - 6) if k != 6 else black.diagonal()
    # pixel (0,0): floor(0+0+1+0)=1 mod 6 < 3 -> striped
    assert black[0, 0]
    # pixel (2,0): 3 mod 6 -> not < 3 -> unstriped... floor(0+2+1)=3 -> no
    assert not black[2, 0]


def test_zebra_threshold_range(small_frame):
    """Pixels outside [lo, hi] luma never stripe."""
    out = golden.zebra(small_frame, 0.75, 0.9, 0.0, Colorspace.BT601)
    yuv = golden.rgb_to_yuv_u8(small_frame, Colorspace.BT601)
    changed = (out != small_frame).any(axis=-1)
    # any changed pixel should have luma in approx range (quantized check)
    y = yuv[..., 0][changed]
    if y.size:
        assert y.min() >= int(0.75 * 255) - 1
        assert y.max() <= int(0.9 * 255) + 1


@pytest.mark.parametrize("cs", CS)
def test_falsecolor_bitexact(small_frame, cs):
    want = golden.falsecolor(small_frame, cs)
    got = np.asarray(overlays.falsecolor(small_frame, cs=int(cs)))
    np.testing.assert_array_equal(got, want)


def test_falsecolor_band_boundaries():
    """Gray ramp must traverse all 12 bands in order."""
    ramp = np.zeros((1, 256, 4), dtype=np.uint8)
    ramp[0, :, 0] = ramp[0, :, 1] = ramp[0, :, 2] = np.arange(256)
    ramp[..., 3] = 255
    idx = golden.falsecolor_band_index(ramp, Colorspace.BT709)[0]
    assert idx[0] == 0  # black -> bright purple band
    assert idx[255] == 11  # white (y=1.0) -> red band
    assert (np.diff(idx) >= 0).all()  # monotone
    assert len(np.unique(idx)) == 12
    got = np.asarray(overlays.falsecolor(ramp, cs=int(Colorspace.BT709)))
    np.testing.assert_array_equal(got, golden.falsecolor(ramp, Colorspace.BT709))


@pytest.mark.parametrize("n", [4, 256, 7])
def test_falsecolor_lut_bitexact(small_frame, rng, n):
    lut = rng.integers(0, 256, size=(n, 4), dtype=np.uint8)
    want = golden.falsecolor(small_frame, Colorspace.BT601, lut=lut)
    got = np.asarray(
        overlays.falsecolor_lut(small_frame, lut, cs=int(Colorspace.BT601), lut_n=n)
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("threshold", [0.001, 0.05, 0.1])
def test_focus_peaking_bitexact(small_frame, threshold):
    color = (1.0, 84 / 255.0, 1.0, 1.0)
    want = golden.focus_peaking(small_frame, threshold, color)
    color_u8 = golden.reference.quantize_unorm8(np.asarray(color, np.float32))
    got = np.asarray(
        overlays.focus_peaking(
            small_frame, peaking_threshold_fixed(threshold), color_u8
        )
    )
    np.testing.assert_array_equal(got, want)


def test_focus_peaking_edge_clamp():
    """A flat frame has zero gradient everywhere incl. borders -> no peaks."""
    f = np.full((8, 8, 4), 200, dtype=np.uint8)
    out = golden.focus_peaking(f, 0.001, (1, 0, 0, 1))
    np.testing.assert_array_equal(out, f)
    got = np.asarray(
        overlays.focus_peaking(
            f,
            peaking_threshold_fixed(0.001),
            np.array([255, 0, 0, 255], np.uint8),
        )
    )
    np.testing.assert_array_equal(got, f)


def test_focus_peaking_detects_edge():
    """A vertical step edge must peak along the boundary columns."""
    f = np.zeros((8, 8, 4), dtype=np.uint8)
    f[..., 3] = 255
    f[:, 4:, :3] = 255
    out = golden.focus_peaking(f, 0.05, (1.0, 0.0, 0.0, 1.0))
    red = (out[..., 0] == 255) & (out[..., 1] == 0)
    assert red[:, 3].all() and red[:, 4].all()
    assert not red[:, 0].any() and not red[:, 7].any()


def test_zebra_tm_clock():
    tm = 0.0
    tm = golden.zebra_tm_advance(tm, 1.0)
    assert tm == 4.0
    tm = golden.zebra_tm_advance(tm, 2.5)  # 14 -> wraps
    assert abs(tm - 2.0) < 1e-9


def test_zebra_phase_at_4k_coordinates(rng):
    """Stripe phase stays exact at large x+y (f32 integer-exactness):
    test a strip placed at 4K-scale offsets via a wide frame."""
    f = rng.integers(0, 256, (4, 4000, 4), dtype=np.uint8)
    f[..., 3] = 255
    f[..., :3] = 220  # all striped-eligible
    want = golden.zebra(f, 0.75, 1.00, 7.3, Colorspace.BT709)
    got = np.asarray(overlays.zebra(f, 0.75, 1.00, 7.3, cs=2))
    np.testing.assert_array_equal(got, want)
    # stripes actually present at the far right
    black = (got[..., :3] == 0).all(-1)
    assert black[:, 3900:].any() and not black[:, 3900:].all()


def test_falsecolor_key_streaming_stays_on_device(rng, monkeypatch):
    """FalseColor.apply_planes with show_key must not round-trip through the
    host per frame (the key overlay is a cached device constant)."""
    import jax

    from obs_color_monitor_tpu.config import FalseColorConfig, ShowKey
    from obs_color_monitor_tpu.models.overlays import FalseColor

    fc = FalseColor(FalseColorConfig(show_key=ShowKey.BELOW))
    planes = jax.numpy.asarray(rng.integers(0, 256, (4, 40, 64), dtype=np.uint8))
    out0 = fc.apply_planes(planes)  # warm: builds + uploads the key constant

    fetches = 0
    orig = np.asarray

    def counting(x, *a, **k):
        nonlocal fetches
        if isinstance(x, jax.Array):
            fetches += 1
        return orig(x, *a, **k)

    monkeypatch.setattr(np, "asarray", counting)
    out = fc.apply_planes(planes)
    assert fetches == 0
    assert isinstance(out, jax.Array) and out.shape == out0.shape
    # canvas extension happened (BELOW -> h*12//10) and the legend is there
    assert out.shape == (4, 48, 64)
    from obs_color_monitor_tpu.ops.graticule import (
        composite_overlay,
        falsecolor_key_overlay,
    )
    from obs_color_monitor_tpu.utils.draw import alpha_blend_u8  # noqa: F401

    base = golden.falsecolor(np.moveaxis(np.asarray(planes), 0, -1), Colorspace.BT709)
    canvas = np.zeros((48, 64, 4), np.uint8)
    canvas[..., 3] = 255
    canvas[:40, :64] = base
    key = falsecolor_key_overlay(ShowKey.BELOW, 64, 40, Colorspace.BT709)
    want = composite_overlay(canvas, key)
    np.testing.assert_array_equal(np.moveaxis(np.asarray(out), 0, -1), want)


@pytest.mark.parametrize("shape", [(64, 128), (70, 200)])
@pytest.mark.parametrize("zb_cs,fc_cs", [(2, 2), (1, 2)])
def test_full_step_overlays_per_scope_colorspace(rng, shape, zb_cs, fc_cs):
    """The full step's three overlays vs golden, each scope drawing with
    its OWN colorspace property (reference zbs_render uses
    src->cm.colorspace, src/zebra.c:620), incl. the focus-peaking border
    clamp on every edge."""
    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.config import (
        FalseColorConfig,
        FocusPeakingConfig,
        ZebraConfig,
    )

    f = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
    f[..., 3] = 255
    fp_cfg = FocusPeakingConfig()
    step = make_full_step(
        *shape, scale=2,
        zebra=ZebraConfig(colorspace=zb_cs),
        falsecolor=FalseColorConfig(colorspace=fc_cs),
        focuspeaking=fp_cfg,
    )
    out = step(f, np.float32(7.0))
    for got, want in (
        (out.zebra, golden.zebra(f, 0.75, 1.0, 7.0, Colorspace(zb_cs))),
        (out.falsecolor, golden.falsecolor(f, Colorspace(fc_cs))),
        (out.focuspeaking, golden.focus_peaking(
            f, fp_cfg.peaking_threshold, fp_cfg.peaking_rgba)),
    ):
        np.testing.assert_array_equal(np.moveaxis(np.asarray(got), 0, -1), want)


def test_planes_to_rgba_packs_like_interleave(rng):
    """planes_to_rgba (the dock's planar -> (H, W, 4) compose before its
    slot samplers) is bitwise the interleave of the planes, and its u32
    view is the little-endian pixel packing."""
    import jax.numpy as jnp

    from obs_color_monitor_tpu.ops.convert import planes_to_rgba

    p = rng.integers(0, 256, (4, 52, 200), dtype=np.uint8)
    got = np.asarray(planes_to_rgba(jnp.asarray(p)))
    np.testing.assert_array_equal(got, np.moveaxis(p, 0, -1))
    q = p.astype(np.uint32)
    np.testing.assert_array_equal(
        got.view(np.uint32)[..., 0],
        q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24),
    )
