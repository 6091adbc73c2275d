"""Scope base class and the shared capture fan-out hub.

Mirrors the reference's source model: each scope is created with settings,
receives per-frame surfaces through a callback, keeps double-buffered
results, and renders on demand (reference src/common.h:95-114 vtable
contract; double buffering e.g. src/vectorscope.c:46-48,264).

The CaptureHub replaces the cm capture core + ROI hub (reference
src/common.c:223-333, src/roi.c:315-341): one fused device pass per frame,
fanned out to every registered consumer.  Where the reference ORs consumer
flags each tick (src/roi.c:534-540), the hub unions the consumers' needs
into the static flags of ops.fused.analyze.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np

from ..colorspace import Colorspace, calc_colorspace
from ..config import CaptureConfig, ROIConfig
from ..ops.fused import AnalysisResult, analyze

_MISS = object()

# Capture flags (reference src/common.h:90-93).
FLAG_CONVERT_RGB = 1
FLAG_CONVERT_YUV = 2
FLAG_RAW_TEXTURE = 4
FLAG_ROI = 8


@dataclasses.dataclass
class SurfaceData:
    """Per-frame analysis handed to scope callbacks.

    The reference's cm_surface_data carries mapped CPU pointers
    (src/common.h:24-30); here it carries the device-resident results of the
    fused pass plus geometry/colorspace.  Frame data in ``result`` is PLANAR
    (C, H, W) u8 (see ops.convert for the layout rationale).
    """

    result: AnalysisResult
    width: int
    height: int
    colorspace: Colorspace
    # True when ``result.planes`` is the ROI crop (a non-full rect was
    # applied): the preview row must render it plainly rather than
    # re-resolving the rect against the crop's own dimensions
    cropped: bool = False
    # Set by the dock's dynamic-rect streaming route (mid-drag frames,
    # models/dock.py _consume_dynamic): the (x0, y0, x1, y1) rect the
    # statistics were computed WITHIN.  ``result.planes`` is then the FULL
    # scaled capture (width/height are its dims, cropped=False) and the
    # waveform counts are full-width with out-of-rect columns zero — the
    # recompile-free representation of the reference's per-tick crop push
    # during a drag (src/roi.c:478-520).  None on every other route.
    dynamic_rect: Optional[tuple[int, int, int, int]] = None


@dataclasses.dataclass
class Needs:
    """What a scope wants from the fused pass (static jit flags)."""

    vs: bool = False
    wv_rgb: bool = False
    wv_yuv: bool = False
    hi_rgb: bool = False
    hi_yuv: bool = False
    rgba: bool = False

    def __or__(self, other: "Needs") -> "Needs":
        return Needs(
            self.vs or other.vs,
            self.wv_rgb or other.wv_rgb,
            self.wv_yuv or other.wv_yuv,
            self.hi_rgb or other.hi_rgb,
            self.hi_yuv or other.hi_yuv,
            self.rgba or other.rgba,
        )


class Scope:
    """Base scope: settings, double-buffered results, render-on-demand."""

    def __init__(self, config: CaptureConfig):
        self.config = config
        self.flags = 0
        # double buffer (reference tex_buf[2] / w_tex_buf flip)
        self._buf: list[Optional[object]] = [None, None]
        self._w_buf = 0

    # -- settings -----------------------------------------------------------
    def update(self, **settings) -> None:
        """Apply settings like the reference's ``*_update`` callbacks."""
        for k, v in settings.items():
            if not hasattr(self.config, k):
                raise KeyError(f"{type(self).__name__} has no setting {k!r}")
            try:
                setattr(self.config, k, v)
            except AttributeError as e:
                # read-only derived properties (level_fixed, ...) are not
                # settings; surface them on the same unknown-setting path
                raise KeyError(
                    f"{type(self).__name__} setting {k!r} is read-only"
                ) from e
        self.config.__post_init__()

    @property
    def colorspace(self) -> Colorspace:
        return calc_colorspace(self.config.colorspace)

    # -- capture contract ---------------------------------------------------
    def needs(self) -> Needs:
        raise NotImplementedError

    def surface_cb(self, surface: SurfaceData) -> None:
        """Consume one frame's analysis (reference cm_surface_cb_t)."""
        raise NotImplementedError

    def tick(self, seconds: float = 1.0 / 60.0) -> None:
        """Per-display-frame bookkeeping (reference video_tick)."""

    # -- double buffer ------------------------------------------------------
    def _publish(self, value) -> None:
        self._buf[self._w_buf] = value
        self._w_buf ^= 1

    def _read(self):
        return self._buf[self._w_buf ^ 1]

    # -- bypass (reference cm_bypass_render, src/common.c:413-428) ----------
    _bypass_planes = None

    def _store_bypass(self, surface: "SurfaceData") -> None:
        if getattr(self.config, "bypass", False) and surface.result.planes is not None:
            self._bypass_planes = surface.result.planes

    def render_bypass(self):
        """The scaled captured frame itself (reference bypass mode);
        device-resident RGBA."""
        if self._bypass_planes is None:
            return None
        from ..ops.convert import planes_to_rgba

        return planes_to_rgba(self._bypass_planes)

    # -- cached device constants (graticules, key legends) -------------------
    _const_cache: Optional[dict] = None

    def _device_const(self, key, build):
        """Host-built overlays are constant per config: build once, keep on
        device (streamed frames must not re-upload them every render)."""
        if self._const_cache is None:
            self._const_cache = {}
        hit = self._const_cache.get(key, _MISS)
        if hit is _MISS:
            v = build()
            hit = None if v is None else jax.device_put(np.ascontiguousarray(v))
            self._const_cache[key] = hit
        return hit

    # -- output -------------------------------------------------------------
    def render_leaves(self):
        """The published DEVICE buffers this scope's render reads, as a
        tuple, or None before the first frame (or when this scope has no
        fused-render support).  Together with :meth:`render_traced` this
        lets the dock fuse every scope's render into ONE jitted program
        (buffers must be arguments there, not closure captures — captures
        would constant-fold and retrace every frame)."""
        return None

    def render_traced(self, *leaves):
        """Pure traced render: leaves (as from render_leaves) -> RGBA image.
        Must equal render_image() given the same published state; everything
        else it reads (config, cached device constants) is static per
        :meth:`render_trace_key`."""
        raise NotImplementedError

    def render_trace_key(self):
        """Hashable of every non-leaf value render_traced reads — the dock's
        fused-render cache key (a change forces a rebuild).  Revalidated
        every streamed frame, so it must be cheap (config_key, not repr)."""
        from ..config import config_key

        return config_key(self.config)

    def render_image(self):
        """DEVICE-resident RGBA u8 image (jax.Array), or None before the
        first frame.  No host transfer happens here — the dock composites
        scope images on device and fetches the panel once."""
        lv = self.render_leaves()
        return None if lv is None else self.render_traced(*lv)

    def render(self) -> Optional[np.ndarray]:
        """RGBA u8 image of the scope, or None before the first frame."""
        img = self.render_image()
        return None if img is None else np.asarray(img)

    @property
    def width(self) -> int:
        raise NotImplementedError

    @property
    def height(self) -> int:
        raise NotImplementedError


class CaptureHub:
    """Shared capture + fan-out (reference roi.c / common.c collapsed).

    One hub per capture target.  Consumers register like the reference's
    ``roi_register_source`` (src/roi.c:315-327); every processed frame runs
    ONE fused device pass and invokes every consumer's callback with the
    same SurfaceData (src/roi.c:329-341).

    Interleave: with ``interleave=n``, only every (n+1)-th frame is
    processed (reference src/roi.c:266-277,523-532) to trade latency for
    throughput.
    """

    def __init__(self, config: Optional[ROIConfig] = None):
        self.config = config or ROIConfig()
        self.consumers: list[Scope] = []
        self._i_interleave = 0
        self._rendered = False
        self.last_surface: Optional[SurfaceData] = None
        self.frames_processed = 0
        self.frames_skipped = 0
        # scaled (pre-crop) capture dims of the last processed frame
        self.capture_size: Optional[tuple[int, int]] = None
        # the resolved rect the last processed frame was PUBLISHED under —
        # consumers displaying the crop need ITS origin, which a rect
        # change after publication (e.g. a mid-drag commit) moves past
        self.published_rect: Optional[tuple[int, int, int, int]] = None

    def register(self, scope: Scope) -> None:
        self.consumers.append(scope)

    def unregister(self, scope: Scope) -> None:
        self.consumers.remove(scope)

    @property
    def colorspace(self) -> Colorspace:
        return calc_colorspace(self.config.colorspace)

    def union_needs(self) -> Needs:
        n = Needs()
        for c in self.consumers:
            n = n | c.needs()
        return n

    def tick(self) -> None:
        """Advance the interleave counter (reference src/roi.c:523-532)."""
        if self._rendered:
            self._i_interleave += 1
            if self._i_interleave > self.config.interleave:
                self._i_interleave = 0
        self._rendered = False
        for c in self.consumers:
            c.tick()

    def process(
        self, frame: jax.Array | np.ndarray, is_planar: bool = False
    ) -> Optional[SurfaceData]:
        """Analyze one frame and fan out; None if interleave-skipped.

        frame: (H, W, 4) u8, (4, H, W) with is_planar=True (skips the
        on-device planarize), or the (H, W) u32 packed view of the
        interleaved bytes (identical memory).
        """
        self._rendered = True
        if self._i_interleave != 0 and self.config.interleave > 0:
            self.frames_skipped += 1
            return None

        # host u8 frames upload as their (H, W) u32 view — identical bytes,
        # free on the host (numpy view)
        if not is_planar:
            from ..ops.convert import host_packed_view

            frame = host_packed_view(frame)
        is_packed = not is_planar and getattr(frame, "ndim", 3) == 2
        if is_planar or is_packed:
            h, w = frame.shape[-2], frame.shape[-1]
        else:
            h, w = frame.shape[-3], frame.shape[-2]
        scale = self.config.target_scale
        sw, sh = w // scale, h // scale
        if sw <= 0 or sh <= 0:
            # frame smaller than the scale divisor: skip, like the reference
            # (src/common.c:251-254 returns without staging)
            self.frames_skipped += 1
            return None
        rect = self.config.resolve_rect(sw, sh)
        full = rect == (0, 0, sw, sh)
        # scaled capture dims BEFORE the crop: the coordinate space of
        # interactive ROI selection (reference roi.c works on the full
        # target; the dock's mouse bridge needs this when the preview
        # band displays only the crop)
        self.capture_size = (sw, sh)
        self.published_rect = rect
        needs = self.union_needs()
        cs = self.colorspace

        from ..pipeline import profiler

        with profiler.probe("render_target"):
            result = analyze(
                frame,
                cs=int(cs),
                scale=scale,
                rect=None if full else rect,
                need_vs=needs.vs,
                need_wv_rgb=needs.wv_rgb,
                need_wv_yuv=needs.wv_yuv,
                need_hi_rgb=needs.hi_rgb,
                need_hi_yuv=needs.hi_yuv,
                keep_rgba=True,
                is_planar=is_planar,
                is_packed=is_packed,
            )
        cw = rect[2] - rect[0]
        ch = rect[3] - rect[1]
        surface = SurfaceData(
            result=result, width=cw, height=ch, colorspace=cs,
            cropped=not full,
        )
        self.last_surface = surface
        for c in self.consumers:
            with profiler.probe(f"surface_cb:{type(c).__name__}"):
                c.surface_cb(surface)
        self.frames_processed += 1
        return surface

    def process_nv12(self, y, uv, cs: Optional[int] = None, shift: int = 0):
        """NV12 frame in: decode ON DEVICE to the packed u32 RGBA view,
        then the normal :meth:`process` fan-out.

        Uploads 1.5 B/px (y + interleaved uv) instead of a host-decoded
        4 B/px RGBA frame, and the fixed-point decode (bit-exact twin of
        the native csrc decoder) runs on the accelerator.  ``cs`` is the
        DECODE colorimetry (the stream's own, like ``ingest.*Source(cs=)``);
        it defaults to the hub's analysis colorspace.  With ``shift`` > 0
        the planes are 16-bit-LE P010-family u16 samples and the
        round-shift to the monitoring domain also runs on device
        (``ops.nv12_shift`` maps bits/msb_aligned to the shift).
        """
        from ..ops.convert import nv12_device_planes, nv12_to_packed

        cs_i = int(cs) if cs is not None else int(self.colorspace)
        return self.process(nv12_to_packed(
            *nv12_device_planes(y, uv), cs=cs_i, shift=shift
        ))

    def set_roi(self, x0: int, y0: int, x1: int, y1: int) -> None:
        """Select a sub-rect in scaled coordinates (replaces the reference's
        interactive drag state machine, src/roi.c:343-521)."""
        self.config.x0, self.config.y0 = x0, y0
        self.config.x1, self.config.y1 = x1, y1


class StandaloneScopeMixin:
    """A scope driving its own private hub (the reference's non-ROI path,
    where each cm_source owns a texrender/staging pipeline,
    src/common.c:430-454)."""

    def attach_private_hub(self, capture: CaptureConfig) -> CaptureHub:
        hub = CaptureHub(
            ROIConfig(
                target_scale=capture.target_scale,
                colorspace=capture.colorspace,
                interleave=0,
            )
        )
        hub.register(self)  # type: ignore[arg-type]
        self._hub = hub
        return hub

    def push_frame(self, frame) -> None:
        self._hub.tick()
        self._hub.process(frame)

    def push_nv12(
        self, y, uv, cs: Optional[int] = None, shift: int = 0
    ) -> None:
        """NV12 frame in, decoded on device (CaptureHub.process_nv12)."""
        self._hub.tick()
        self._hub.process_nv12(y, uv, cs=cs, shift=shift)
