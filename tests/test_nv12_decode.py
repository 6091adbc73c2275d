"""Device NV12 / 16-bit NV12-layout decode (ops.nv12_to_packed) vs the
native decoder (csrc/ocm_runtime.cpp, or its NumPy twin) and the ingest
host round-shift policy, including geometries that are not multiples of
any tile or band."""

import numpy as np
import pytest

import jax.numpy as jnp

from obs_color_monitor_tpu.ops import convert
from obs_color_monitor_tpu.runtime import native


def _planes(rng, h, w):
    y = rng.integers(0, 256, (h, w), np.uint8)
    uv = rng.integers(0, 256, (h // 2, w), np.uint8)
    # plant fixed-point boundary samples: limited-range ends + neutral
    y[0, :3] = (0, 16, 255)[: w]
    uv[0, :4] = (0, 255, 128, 128)[: w]
    return y, uv


def _packed(rgba):
    return rgba.view(np.uint32)[..., 0]


@pytest.mark.parametrize("cs", [1, 2])
@pytest.mark.parametrize(
    "h,w",
    [
        (64, 128),  # exact power-of-two block
        (48, 64),   # short frame
        (130, 256), # odd half-height uv rows
        (2, 8),     # degenerate minimum
    ],
)
def test_nv12_decode_matches_native(rng, h, w, cs):
    y, uv = _planes(rng, h, w)
    want = _packed(native.nv12_to_rgba(y, uv, cs=cs))
    got = np.asarray(convert.nv12_to_packed(jnp.asarray(y), jnp.asarray(uv), cs=cs))
    np.testing.assert_array_equal(got, want)


def test_nv12_decode_rejects_bad_geometry(rng):
    y, uv = _planes(rng, 16, 16)
    with pytest.raises(ValueError, match="geometry"):
        convert.nv12_to_packed(jnp.asarray(y[:, :15]), jnp.asarray(uv[:, :15]))
    with pytest.raises(ValueError, match="geometry"):
        convert.nv12_to_packed(jnp.asarray(y), jnp.asarray(uv[:4]))


def _planes16(rng, h, w, bits, msb):
    hi = 1 << bits
    y = rng.integers(0, hi, (h, w)).astype(np.uint16)
    uv = rng.integers(0, hi, (h // 2, w)).astype(np.uint16)
    y.flat[:3] = (513, 514, hi - 1) if bits == 10 else (0, 1, hi - 1)
    if msb:
        y, uv = (y << (16 - bits)).astype(np.uint16), (
            uv << (16 - bits)
        ).astype(np.uint16)
    return y, uv


@pytest.mark.parametrize("bits,msb", [(10, False), (10, True), (12, False),
                                      (16, False)])
@pytest.mark.parametrize("h,w", [(64, 128), (130, 254), (2, 4)])
def test_nv12_decode16_matches_host_policy(rng, h, w, bits, msb):
    """The fused shift+decode equals the host round-shift (ingest `_to8`)
    followed by the native 8-bit decode, for every supported depth and both
    alignments."""
    shift = convert.nv12_shift(bits, msb)
    y16, uv16 = _planes16(rng, h, w, bits, msb)

    def to8(a):  # the ingest host policy (pipeline/ingest.py _to8)
        v = (a.astype(np.uint32) + (1 << (shift - 1))) >> shift
        return np.minimum(v, 255).astype(np.uint8)

    want = _packed(native.nv12_to_rgba(to8(y16), to8(uv16), cs=2))
    got = np.asarray(
        convert.nv12_to_packed(jnp.asarray(y16), jnp.asarray(uv16), cs=2,
                               shift=shift)
    )
    np.testing.assert_array_equal(got, want)


def test_wrong_dtype_rejected(rng):
    """A forgotten shift= on u16 wire planes (and the converse) must fail
    loudly — raw 16-bit samples through the 8-bit decode would publish
    silently wrong statistics."""
    y8, uv8 = _planes(rng, 16, 16)
    y16, uv16 = _planes16(rng, 16, 16, 10, False)
    with pytest.raises(TypeError, match="u8"):
        convert.nv12_to_packed(jnp.asarray(y16), jnp.asarray(uv16))
    with pytest.raises(TypeError, match="u16"):
        convert.nv12_to_packed(jnp.asarray(y8), jnp.asarray(uv8), shift=2)


def test_nv12_shift_helper():
    from obs_color_monitor_tpu.ops.convert import nv12_shift

    assert nv12_shift(8) == 0
    assert nv12_shift(10) == 2
    assert nv12_shift(10, msb_aligned=True) == 8
    assert nv12_shift(16) == 8
    with pytest.raises(ValueError, match="bits"):
        nv12_shift(9)
