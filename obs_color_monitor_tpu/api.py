"""High-level one-shot API: the full six-scope step as a single jittable fn.

This is the "flagship model" of the framework: one frame in, every scope's
statistics and rendered images out, in one XLA program (the reference needs
six sources + an ROI hub + readback threads for the same result,
SURVEY.md §3).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .colorspace import Colorspace
from .config import (
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
)
from .golden.reference import peaking_threshold_fixed, quantize_unorm8
from .ops import overlays as overlay_ops
from .ops import render as render_ops
from .ops.convert import (
    nv12_to_packed,
    nv12_to_planes,
    planarize,
    planarize_packed,
)
from .ops.fused import analyze
from .ops.stats import apply_channel_select, histogram_hi_max, histogram_levels


class ScopeOutputs(NamedTuple):
    vectorscope: jax.Array  # (256, 256, 4) u8
    waveform: jax.Array  # (256, W', 4) u8
    histogram: jax.Array  # (H', 256, 4) u8
    zebra: jax.Array  # full-res PLANAR (4, H, W) u8
    falsecolor: jax.Array  # (4, H, W) u8
    focuspeaking: jax.Array  # (4, H, W) u8
    vs_counts: jax.Array  # (256, 256) u8
    wv_counts: jax.Array  # (3, 256, W) u8
    hi_counts: jax.Array  # (3, 256) u32


def make_full_step(
    height: int,
    width: int,
    cs: Colorspace = Colorspace.BT709,
    scale: int = 2,
    vectorscope: VectorscopeConfig | None = None,
    waveform: WaveformConfig | None = None,
    histogram: HistogramConfig | None = None,
    zebra: ZebraConfig | None = None,
    falsecolor: FalseColorConfig | None = None,
    focuspeaking: FocusPeakingConfig | None = None,
    input_format: str = "rgba",
    nv12_shift: int = 0,
):
    """Build a jitted (frame, tm) -> ScopeOutputs for a fixed frame shape.

    Statistics run on the ``scale``-downscaled frame (the reference's
    default target_scale=2, src/common.c:124); overlays run full-res.

    input_format:
      * "rgba"   — frame is (H, W, 4) u8 (planarized on device);
      * "packed" — frame is the (H, W) u32 view of the interleaved RGBA
        bytes (IDENTICAL memory: ``arr.view(np.uint32)`` host-side, or
        keep capture buffers u32 end-to-end);
      * "planar" — frame is (4, H, W) u8 (skips planarize);
      * "nv12"   — frame is a (y (H,W) u8, uv (H/2,W) u8) tuple converted
        on device (1.5 bytes/px ingest; csrc spec, bit-exact vs native).
        With ``nv12_shift`` > 0 the planes are 16-bit-LE P010-family u16
        samples; the round-shift to the 8-bit monitoring domain fuses
        into the in-program decode (``ops.nv12_shift`` maps
        bits/msb_aligned to the shift).
    """
    vs_cfg = vectorscope or VectorscopeConfig()
    wv_cfg = waveform or WaveformConfig()
    hi_cfg = histogram or HistogramConfig()
    zb_cfg = zebra or ZebraConfig()
    fc_cfg = falsecolor or FalseColorConfig()
    fp_cfg = focuspeaking or FocusPeakingConfig()
    from .colorspace import calc_colorspace

    cs = int(calc_colorspace(cs))
    # overlay scopes draw with their OWN colorspace property (reference
    # zbs_render uses src->cm.colorspace, src/zebra.c:620)
    zb_cs = int(calc_colorspace(zb_cfg.colorspace))
    fc_cs = int(calc_colorspace(fc_cfg.colorspace))
    sel = hi_cfg.components.channel_select()
    wv_sel = wv_cfg.components.channel_select()
    wv_yuv_mode = wv_cfg.components.is_yuv
    hi_yuv_mode = hi_cfg.components.is_yuv
    peak_color_u8 = quantize_unorm8(np.asarray(fp_cfg.peaking_rgba, np.float32))
    peak_color = jnp.asarray(peak_color_u8)
    peak_th = peaking_threshold_fixed(fp_cfg.peaking_threshold)
    sw, sh = width // scale, height // scale

    if input_format not in ("rgba", "packed", "planar", "nv12"):
        raise ValueError(f"unknown input_format {input_format!r}")
    use_lut = fc_cfg.use_lut and fc_cfg.lut is not None

    @jax.jit
    def step(frame, tm: jax.Array) -> ScopeOutputs:
        # planarize ONCE; stats and overlays all consume planes
        if input_format == "nv12":
            y, uv = frame
            if nv12_shift:
                planes = planarize_packed(
                    nv12_to_packed(y, uv, cs=cs, shift=nv12_shift)
                )
            else:
                planes = nv12_to_planes(y, uv, cs=cs)
        elif input_format == "planar":
            planes = frame
        elif input_format == "packed":
            planes = planarize_packed(frame)
        else:
            planes = planarize(frame)
        res = analyze(
            planes,
            cs=cs,
            scale=scale,
            need_vs=True,
            need_wv_rgb=not wv_yuv_mode,
            need_wv_yuv=wv_yuv_mode,
            need_hi_rgb=not hi_yuv_mode,
            need_hi_yuv=hi_yuv_mode,
            keep_rgba=False,
            is_planar=True,
        )
        vs_img = render_ops.render_vectorscope(
            res.vs_counts,
            intensity=vs_cfg.intensity,
            cs=cs,
            white=vs_cfg.color_type == 0,
        )
        wv_counts = res.wv_yuv if wv_yuv_mode else res.wv_rgb
        wv_counts = apply_channel_select(wv_counts, wv_sel)
        wv_img = render_ops.render_waveform(
            wv_counts,
            intensity=wv_cfg.intensity,
            display=int(wv_cfg.display),
            n_components=wv_cfg.components.n_components,
            yuv_mode=wv_yuv_mode,
        )
        hi_counts = res.hi_yuv if hi_yuv_mode else res.hi_rgb
        hi_counts = apply_channel_select(hi_counts.astype(jnp.int32), sel)
        hi = histogram_hi_max(
            hi_counts,
            sel,
            sw * sh,
            hi_cfg.level_fixed,
            hi_cfg.level_ratio_permille,
        )
        levels, hi_eff = histogram_levels(hi_counts, hi, sel, hi_cfg.logscale)
        hi_img = render_ops.render_histogram(
            levels,
            hi_eff,
            level_height=hi_cfg.level_height,
            display=int(hi_cfg.display),
            n_components=hi_cfg.components.n_components,
            yuv_mode=hi_yuv_mode,
        )
        zb_img = overlay_ops.zebra_planes(
            planes, th_low=zb_cfg.th_low, th_high=zb_cfg.th_high, tm=tm, cs=zb_cs
        )
        if use_lut:
            fc_img = overlay_ops.falsecolor_lut_planes(
                planes,
                jnp.asarray(fc_cfg.lut),
                cs=fc_cs,
                lut_n=fc_cfg.lut.shape[0],
            )
        else:
            fc_img = overlay_ops.falsecolor_planes(planes, cs=fc_cs)
        fp_img = overlay_ops.focus_peaking_planes(planes, peak_th, peak_color)
        return ScopeOutputs(
            vectorscope=vs_img,
            waveform=wv_img,
            histogram=hi_img,
            zebra=zb_img,
            falsecolor=fc_img,
            focuspeaking=fp_img,
            vs_counts=res.vs_counts,
            wv_counts=wv_counts,
            hi_counts=hi_counts.astype(jnp.uint32),
        )

    return step


def make_batched_step(height: int, width: int, mesh=None, **kwargs):
    """Multi-stream serving: (frames (B,H,W,4), tms (B,)) -> batched outputs.

    With a mesh, the batch axis is sharded over devices (pure data-parallel
    — per-stream results are tiny and land where the frame lives; see
    parallel/mesh.py).  Shard inputs with
    ``jax.device_put(frames, NamedSharding(mesh, P("batch")))``.
    """
    step = make_full_step(height, width, **kwargs)
    vstep = jax.vmap(step, in_axes=(0, 0))
    if mesh is None:
        return jax.jit(vstep)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("batch"))
    return jax.jit(vstep, in_shardings=(sh, sh))
