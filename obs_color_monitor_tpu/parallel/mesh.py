"""Multi-chip scaling: batch-DP over frames + spatial sharding of one stream.

The reference is a single-process single-GPU pipeline; its only concurrency
is the staging-thread handoff (SURVEY.md §2 parallelism table).  The
multi-device scaling story is:

  * **Batch data-parallel** — independent frames sharded on the batch axis
    over a Mesh; zero collectives (per-frame results are tiny and land
    where the frame lives).  This is how multi-stream / offline analysis
    scales over devices.
  * **Spatial sharding (one giant stream)** — a single frame's rows sharded
    over devices via shard_map; each device computes *partial* integer bin
    counts on its row block and a single ``psum`` merges them.
    Saturation is applied after the merge, so results are bit-exact vs the
    single-device path (sums commute; u8 clamp does not).

No other collectives are needed: there is no TP/PP to speak of when the
whole per-frame state is <=256x256 bins (SURVEY.md §5 'distributed
communication backend').
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.convert import planarize, rgb_to_yuv_planes
from ..ops.stats import vectorscope_counts_i32, waveform_counts_i32

BATCH_AXIS = "batch"
SPATIAL_AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None, axis: str = BATCH_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_batch(frames: jax.Array, mesh: Mesh) -> jax.Array:
    """Place (B, H, W, 4) frames with the batch axis sharded over the mesh."""
    return jax.device_put(frames, NamedSharding(mesh, P(BATCH_AXIS)))


def _family(planes, yuv, components: str):
    """Waveform/histogram data family (reference src/waveform.c:148-154):
    'rgb' = RGB planes with the alpha skip; 'yuv' = Y/U/V data with NO
    alpha skip (the reference conversion writes a=1, data/common.effect:30,41).
    """
    if components == "yuv":
        return yuv, jnp.ones(planes.shape[-2:], bool)
    if components == "rgb":
        return planes[:3], planes[3] != 0
    raise ValueError(f"components must be 'rgb' or 'yuv', got {components!r}")


def batch_analyze(
    frames: jax.Array,
    mesh: Mesh,
    cs: int,
    components: str = "rgb",
):
    """Pure batch-DP: vmap the fused stats over sharded frames.

    Returns (vs_counts (B,256,256) u8, hist (B,3,256) u32,
    waveform (B,3,256,W) u8) with outputs sharded like the inputs.
    components selects the waveform/histogram data family (see _family).
    """

    @functools.partial(jax.jit, static_argnames=("cs_", "comp_"))
    def run(f, cs_, comp_):
        def one(frame):
            planes = planarize(frame)
            yuv = rgb_to_yuv_planes(planes, cs=cs_)
            data, mask = _family(planes, yuv, comp_)
            vs, wv = _stats_i32(data, yuv, mask)
            return (
                jnp.minimum(vs, 255).astype(jnp.uint8),
                wv.sum(axis=-1).astype(jnp.uint32),
                jnp.minimum(wv, 255).astype(jnp.uint8),
            )

        return jax.vmap(one)(f)

    with jax.set_mesh(mesh):
        return run(
            shard_batch(frames, mesh),
            cs_=cs,
            comp_=components,
        )


def _stats_i32(data, yuv, mask):
    """Unsaturated (vs (256,256), wv (3,256,W)) int32 — the same ops as
    the single-device step.  data: (3, H, W) waveform family planes."""
    return vectorscope_counts_i32(yuv), waveform_counts_i32(data, mask)


def spatial_analyze(
    frame: jax.Array,
    mesh: Mesh,
    cs: int,
    components: str = "rgb",
):
    """One frame, rows sharded over the mesh; partial bins psum-merged.

    frame: (H, W, 4) u8 with H divisible by the mesh size.  Returns
    (vs u8 (256,256), hist u32 (3,256), waveform u8 (3,256,W)) replicated.
    The histogram is the column sum of the merged waveform (identical
    counting semantics, reference src/histogram.c:357-395).
    """
    (axis,) = mesh.axis_names
    n = mesh.devices.size
    h = frame.shape[0]
    if h % n:
        raise ValueError(f"height {h} not divisible by mesh size {n}")

    def shard_fn(f):
        # f: (H/n, W, 4) — this device's row block
        planes = planarize(f)
        yuv = rgb_to_yuv_planes(planes, cs=cs)
        data, mask = _family(planes, yuv, components)
        vs, wv = _stats_i32(data, yuv, mask)
        # merge partial integer counts across devices, THEN saturate
        vs = jax.lax.psum(vs, axis)
        wv = jax.lax.psum(wv, axis)
        return (
            jnp.minimum(vs, 255).astype(jnp.uint8),
            wv.sum(axis=-1).astype(jnp.uint32),
            jnp.minimum(wv, 255).astype(jnp.uint8),
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(), P(), P()),
        # the accumulators inside the stat ops start as unvarying zeros;
        # skip the varying-manual-axes check rather than threading pvary
        # through code shared with the single-device step
        check_vma=False,
    )
    return jax.jit(fn)(frame)


def spatial_pipeline(
    frame: jax.Array,
    mesh: Mesh,
    cs: int,
    tm: jax.Array | float = 0.0,
    *,
    components: str = "rgb",
    th_low: float = 0.75,
    th_high: float = 1.0,
    zb_cs: int | None = None,
    fc_cs: int | None = None,
    peak_th: int = 3062,
    peak_rgba: tuple[int, int, int, int] = (255, 0, 0, 255),
):
    """The FULL fused pass, rows sharded: stats psum-merged AND the three
    overlay scopes computed in place on each device's row block.

    The reference's ROI hub feeds every consumer — including the overlay
    filters — from one surface (src/roi.c:329-341); the sharded analog keeps
    "one giant stream" whole by running the overlays under the same
    shard_map as the statistics:

      * zebra — the diagonal stripe phase is ``x + y_global + 1 + tm``
        (data/zebra.effect:31); y_global = y_local + row_offset, and the
        phase is additive in integers, so each device folds its row offset
        into the traced tm (no gather, no iota rebasing).
      * false color — pointwise, shards trivially.
      * focus peaking — a 1-row halo exchange between devices
        (``jax.lax.ppermute``): each device receives its neighbours'
        boundary rows, runs the stencil on the 2-row-extended block, and
        keeps the interior.  The mesh-edge devices substitute a copy of
        their own boundary row, which zeroes the cross-shard diff exactly
        like the reference's image-edge clamp (data/focuspeaking.effect:33-38
        pads the forward differences with zeros at the borders).

    Returns (vs u8 (256,256), hist u32 (3,256), waveform u8 (3,256,W),
    zebra, falsecolor, focuspeaking (4,H,W) u8): stats replicated, overlay
    planes sharded on their row axis (they stay where their rows live).
    Bit-exact vs the single-device ops at any mesh size.
    """
    from ..ops.overlays import (
        falsecolor_planes,
        focus_peaking_planes,
        zebra_planes,
    )

    (axis,) = mesh.axis_names
    n = mesh.devices.size
    h = frame.shape[0]
    if h % n:
        raise ValueError(f"height {h} not divisible by mesh size {n}")
    hb = h // n
    zcs = cs if zb_cs is None else zb_cs
    fcs = cs if fc_cs is None else fc_cs

    def shard_fn(f, tm_):
        planes = planarize(f)  # (4, hb, W)
        yuv = rgb_to_yuv_planes(planes, cs=cs)
        data, mask = _family(planes, yuv, components)
        vs, wv = _stats_i32(data, yuv, mask)
        vs = jax.lax.psum(vs, axis)
        wv = jax.lax.psum(wv, axis)

        idx = jax.lax.axis_index(axis)
        off = (idx * hb).astype(jnp.float32)

        zb = zebra_planes(planes, th_low=th_low, th_high=th_high,
                          tm=tm_ + off, cs=zcs)
        fc = falsecolor_planes(planes, cs=fcs)

        # 1-row halo exchange for the focus-peaking stencil: my last row
        # goes DOWN to idx+1 (their "row above"), my first row goes UP to
        # idx-1 (their "row below"); edge devices get no row and fall back
        # to their own boundary row (zero diff == the image-edge clamp)
        top, bot = planes[:, :1], planes[:, -1:]
        if n > 1:
            prev_halo = jax.lax.ppermute(
                bot, axis, [(i, i + 1) for i in range(n - 1)]
            )
            next_halo = jax.lax.ppermute(
                top, axis, [(i + 1, i) for i in range(n - 1)]
            )
            prev_halo = jnp.where(idx == 0, top, prev_halo)
            next_halo = jnp.where(idx == n - 1, bot, next_halo)
        else:
            prev_halo, next_halo = top, bot
        ext = jnp.concatenate([prev_halo, planes, next_halo], axis=1)
        fp = focus_peaking_planes(ext, peak_th, jnp.asarray(peak_rgba, jnp.uint8))
        fp = fp[:, 1 : hb + 1]

        return (
            jnp.minimum(vs, 255).astype(jnp.uint8),
            wv.sum(axis=-1).astype(jnp.uint32),
            jnp.minimum(wv, 255).astype(jnp.uint8),
            zb,
            fc,
            fp,
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(), P(), P(), P(None, axis), P(None, axis), P(None, axis)),
        check_vma=False,  # see spatial_analyze
    )
    return jax.jit(fn)(frame, jnp.asarray(tm, jnp.float32))
