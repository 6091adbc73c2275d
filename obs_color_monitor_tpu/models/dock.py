"""Composite "dock" view: all scopes off one shared capture
(reference src/scope-widget.cpp).

The reference dock creates an ROI source plus six scopes all targeting it,
so one capture feeds everything (src/scope-widget.cpp:19-25,542-561); the
draw callback stacks the shown scopes vertically with per-scope aspect
rules (src/scope-widget.cpp:99-175).  Here the Dock owns a CaptureHub with
the six scopes registered, and ``render`` composites the SHOWN ones with the
same layout rules — by default the reference's new-dock panel (ROI preview
band + five scopes; focus peaking opt-in, src/scope-widget.cpp:496-506).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import numpy as np

from ..config import (
    DockConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    HistogramConfig,
    ROIConfig,
    VectorscopeConfig,
    WaveformConfig,
    ZebraConfig,
)
from .base import CaptureHub, Scope
from .histogram import Histogram
from .overlays import FalseColor, FocusPeaking, Zebra
from .vectorscope import Vectorscope
from .waveform import Waveform

# Dock scope order (reference src/scope-widget.cpp:19-25): ROI preview,
# vectorscope, waveform, histogram, zebra, false color, focus peaking.
SCOPE_ORDER = (
    "roi",
    "vectorscope",
    "waveform",
    "histogram",
    "zebra",
    "falsecolor",
    "focuspeaking",
)


def _composite(cy: int, cx: int, spec: tuple, images: tuple):
    """Device panel composite for a static layout: nearest resizes (or the
    focus-peaking centered crop) + row-band concatenation.  Pixel-identical
    to the reference draw order (src/scope-widget.cpp:99-175)."""
    from ..dock_step import _resize_nearest_rgba, compose_vstack

    patches = []
    for ((h_src, w_src), x0, y0, w, h, crop), img in zip(spec, images):
        if crop is not None:
            cy0, cx0 = crop
            patch = img[cy0 : cy0 + h, cx0 : cx0 + w]
        else:
            patch = _resize_nearest_rgba(img, h, w)
        patches.append((x0, y0, patch))
    return compose_vstack(patches, cx, cy)


class _NV12Pending(NamedTuple):
    """A deferred NV12 frame on the streaming route: raw (y, uv) planes +
    decode colorimetry.  The decode folds INTO the cached stream / dynamic
    dock step (ops.nv12_to_packed traced in-program), so the wire-format
    capture route stays one device program — and 1.5 B/px of host->device
    traffic — per frame.  ``shift`` > 0 marks 16-bit-LE P010-family u16
    planes (3 B/px); the monitoring-domain round-shift fuses into the
    same in-program decode."""

    y: object
    uv: object
    cs: int
    shift: int = 0


# the reference draws up to 4 border edges + 4 handles x 3 lines each
_MAX_INDICATOR_SEGS = 16


@jax.jit
def _segments_px(panel, segs):
    """1-px green axis-aligned line segments at PANEL coordinates — the
    drag/hover indicator vertices of the reference's draw_roi_rect
    (src/roi.c:183-242), drawn over the finished panel so any render route
    shows live mouse feedback without retracing (segs is a dynamic
    (_MAX_INDICATOR_SEGS, 4) i32 of inclusive (x0, y0, x1, y1) spans,
    normalized so x0<=x1, y0<=y1; x0 < 0 marks an empty slot)."""
    import jax.numpy as jnp

    h, w = panel.shape[0], panel.shape[1]
    segs = jnp.asarray(segs, jnp.int32)
    ri = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    mask = jnp.zeros((h, w), jnp.bool_)
    for i in range(_MAX_INDICATOR_SEGS):
        x0, y0, x1, y1 = segs[i, 0], segs[i, 1], segs[i, 2], segs[i, 3]
        mask |= (
            (x0 >= 0)
            & (ri >= y0) & (ri <= y1)
            & (ci >= x0) & (ci <= x1)
        )
    green = jnp.asarray([0, 255, 0, 255], jnp.uint8)
    return jnp.where(mask[..., None], green, panel)


@jax.jit
def _shaded_preview(planes, rect):
    """ROI selection shading on device: 50% black outside the rect + green
    border (reference draw_roi_range / draw_roi_rect, src/roi.c:207-265).

    rect is a DYNAMIC (4,) i32 array (x0, y0, x1, y1): dragging the
    selection never recompiles — one program serves every rect (the
    border/outside tests are iota comparisons, not slices)."""
    import jax.numpy as jnp

    from ..ops.convert import planes_to_rgba

    rect = jnp.asarray(rect, jnp.int32)
    x0, y0, x1, y1 = rect[0], rect[1], rect[2], rect[3]
    h, w = planes.shape[-2], planes.shape[-1]
    ri = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    outside = (ri < y0) | (ri >= y1) | (ci < x0) | (ci >= x1)
    in_cols = (ci >= x0) & (ci < x1)
    in_rows = (ri >= y0) & (ri < y1)
    border = (((ri == y0) | (ri == y1 - 1)) & in_cols) | (
        ((ci == x0) | (ci == x1 - 1)) & in_rows
    )

    def shade(p):
        return jnp.where(
            outside, (p.astype(jnp.int32) * 128) // 255, p.astype(jnp.int32)
        ).astype(jnp.uint8)

    chans = [shade(planes[0]), shade(planes[1]), shade(planes[2]), planes[3]]
    green = (0, 255, 0, 255)
    chans = [
        jnp.where(border, jnp.uint8(green[c]), chans[c]) for c in range(4)
    ]
    return planes_to_rgba(jnp.stack(chans))


class _RoiPreview(Scope):
    """The dock's row 0: the captured frame itself (the ROI source's own
    render, reference src/roi.c:279-315)."""

    def __init__(self, hub: CaptureHub):
        super().__init__(hub.config)
        self._hub = hub
        # whether each published buffer is an ROI crop (paired with _buf)
        self._buf_cropped = [False, False]

    def needs(self):
        from .base import Needs

        return Needs(rgba=True)

    def surface_cb(self, surface) -> None:
        if surface.result.planes is not None:
            self._size = (surface.width, surface.height)
            self._buf_cropped[self._w_buf] = surface.cropped
            self._publish(surface.result.planes)

    def _full_rect(self, planes) -> bool:
        h, w = planes.shape[-2], planes.shape[-1]
        return self._hub.config.resolve_rect(w, h) == (0, 0, w, h)

    def render_leaves(self):
        v = self._read()
        if v is None:
            return None
        if self._buf_cropped[self._w_buf ^ 1]:
            # the published planes ARE the rect crop: render plainly (the
            # static dock step shows the same; re-resolving the rect
            # against the crop's own dims would shade it a second time)
            return (v,)
        if self._full_rect(v):
            return (v,)
        h, w = v.shape[-2], v.shape[-1]
        rect = self._hub.config.resolve_rect(w, h)
        # the rect is a LEAF: dragging must not retrace the fused program
        return (v, np.asarray(rect, np.int32))

    def render_trace_key(self):
        v = self._read()
        if v is None:
            return (self._hub.config.target_scale, None)
        shaded = not self._buf_cropped[self._w_buf ^ 1] and not self._full_rect(v)
        return (self._hub.config.target_scale, shaded)

    def render_traced(self, planes, rect=None):
        if rect is None:
            from ..ops.convert import planes_to_rgba

            return planes_to_rgba(planes)
        return _shaded_preview(planes, rect)

    @property
    def width(self) -> int:
        return getattr(self, "_size", (0, 0))[0]

    @property
    def height(self) -> int:
        return getattr(self, "_size", (0, 0))[1]


class Dock:
    """Shared capture + all six scopes (shown per config; default = ROI
    preview + five, reference new-dock) + vertical-stack compositor."""

    def __init__(
        self,
        config: Optional[DockConfig] = None,
        roi: Optional[ROIConfig] = None,
        vectorscope: Optional[VectorscopeConfig] = None,
        waveform: Optional[WaveformConfig] = None,
        histogram: Optional[HistogramConfig] = None,
        zebra: Optional[ZebraConfig] = None,
        falsecolor: Optional[FalseColorConfig] = None,
        focuspeaking: Optional[FocusPeakingConfig] = None,
    ):
        self.config = config or DockConfig()
        self.hub = CaptureHub(roi or ROIConfig())
        # scopes share the hub: detach their private hubs and register
        self.vectorscope = Vectorscope(vectorscope)
        self.waveform = Waveform(waveform)
        self.histogram = Histogram(histogram)
        self.zebra = Zebra(zebra)
        self.falsecolor = FalseColor(falsecolor)
        self.focuspeaking = FocusPeaking(focuspeaking)
        self.roi_preview = _RoiPreview(self.hub)
        self.scopes: dict[str, Scope] = {
            "roi": self.roi_preview,
            "vectorscope": self.vectorscope,
            "waveform": self.waveform,
            "histogram": self.histogram,
            "zebra": self.zebra,
            "falsecolor": self.falsecolor,
            "focuspeaking": self.focuspeaking,
        }
        self.hub.consumers = [self.scopes[k] for k in SCOPE_ORDER]
        # per-scope display rects from the last render, for mouse routing
        # (reference src/scope-widget.cpp:146-153,241-428)
        self._rects: dict[str, tuple[int, int, int, int]] = {}
        self._composite_fns: dict = {}
        # fused render programs: one jitted call renders every scope AND
        # composites (key -> (fn, rects, included scope names))
        self._fused_render_fns: dict = {}
        self._fused_specs: dict = {}  # fkey -> static composite spec
        # stream-step programs: analyze + publish + every render + composite
        # as ONE program (key -> (fn, rects, publish metadata)); None
        # disables the route (tests pinning the fused path set this)
        self._stream_fns: dict | None = {}
        # (fast_key, entry) of the last served stream frame — the steady-
        # state shortcut past per-frame key/leaf rederivation
        self._stream_fast: tuple | None = None
        self._pending = None  # frame pushed but not yet analyzed
        self._rendered_since_push = True
        self.roi_interact = None  # created when the ROI preview is shown
        # last streamed rect: a change routes the frame onto the dynamic-
        # rect device step (zero recompiles) until the rect settles
        self._last_stream_rect = None
        # whether the LAST-rendered roi band displays the crop (vs the
        # full capture), and that crop's capture-space origin SNAPSHOTTED
        # at render time: the mouse bridge and sizing outline translate
        # between band pixels and capture coordinates with these.  The
        # origin must NOT be re-resolved from live config at event time —
        # a move-drag changes the committed rect between renders, and a
        # live offset would compound every mouse event into runaway drift
        self._roi_shows_crop = False
        self._roi_crop_origin = (0, 0)
        # rect under which the currently-published scope leaves were
        # produced: the stream/fused programs' layout spec is derived from
        # those leaves, so a frame whose rect differs must resync through
        # the hub fan-out first (else the new rect's analysis would be
        # composed into the OLD rect's slot layout)
        self._leaves_rect = None

    def shown(self, name: str) -> bool:
        return bool(getattr(self.config, f"show_{name}"))

    def _stream_ok(self) -> bool:
        """Steady-state push/render streaming can defer the analysis into
        render_async's ONE-program stream step.  Requires: warmed-up fused
        render (layout + every leaf known), exactly the default consumers
        (a custom consumer's surface_cb must see every processed frame),
        and no bypass (dock_step-less semantics)."""
        if self._stream_fns is None or os.environ.get("OCM_NO_STREAM_STEP"):
            return False
        if not self._fused_render_fns:
            return False
        if self.hub.consumers != [self.scopes[k] for k in SCOPE_ORDER]:
            return False
        return not any(
            getattr(self.scopes[k].config, "bypass", False)
            for k in SCOPE_ORDER
        )

    def push_frame(self, frame) -> None:
        """One video frame in: tick + shared analyze + fan-out.

        Steady-state streaming (push/render alternation with the default
        consumers) defers the analysis into :meth:`render_async`, which
        runs analyze + every scope render + the composite as ONE cached
        device program per frame — each separate program execution pays a
        dispatch, and this route pays exactly one.
        Push-without-render patterns, custom hub consumers, and bypass all
        take the reference-shaped hub fan-out unchanged.

        Deferral is observable host-side: between push_frame(f) and the
        next render, scope reads (histogram.counts(), hub.last_surface,
        frames_processed...) still show the PREVIOUS frame — the render
        call publishes f's statistics together with its panel.  A
        push-then-poll consumer that needs f's statistics before any
        render should call :meth:`flush` first (or drive hub.process
        directly, bypassing the stream route)."""
        # a previously pushed frame that was never rendered flushes through
        # the hub first (under its own tick state, which is still current)
        # so published statistics advance exactly like the legacy path
        self.flush()
        rendered = self._rendered_since_push
        self._rendered_since_push = False
        self.hub.tick()
        if rendered and self._stream_ok():
            self._pending = frame
        else:
            if self.hub.process(frame) is not None:
                self._leaves_rect = self.hub.published_rect

    def push_nv12(
        self, y, uv, cs: Optional[int] = None, shift: int = 0
    ) -> None:
        """NV12 frame in: the raw (y, uv) planes upload as-is (1.5 B/px
        instead of a host-decoded 4 B/px RGBA frame) and the fixed-point
        decode (bit-exact twin of the native csrc decoder) runs ON DEVICE.

        On the steady-state streaming route the decode folds INTO the
        one-program stream step — NV12 frames, like rgba/packed ones, cost
        exactly one device program per frame (the reference's pipeline is
        one path regardless of source format, src/common.c:223-333).
        Other routes decode via CaptureHub.process_nv12 (one extra
        dispatch).  ``cs`` is the decode colorimetry (defaults to the
        hub's analysis colorspace).  With ``shift`` > 0 the planes are
        16-bit-LE P010-family u16 samples (3 B/px) and the
        monitoring-domain round-shift fuses into the SAME in-program
        decode — zero host per-pixel work for high-bit-depth capture
        (``ops.nv12_shift`` maps bits/msb_aligned to the shift;
        ``ingest.NV12Source.nv12_shift`` carries it for file sources).
        """
        cs_i = int(cs) if cs is not None else int(self.hub.colorspace)
        self.flush()
        rendered = self._rendered_since_push
        self._rendered_since_push = False
        self.hub.tick()
        from ..ops.convert import nv12_device_planes

        pending = _NV12Pending(*nv12_device_planes(y, uv), cs_i, int(shift))
        if rendered and self._stream_ok():
            self._pending = pending
        else:
            if self._hub_process(pending) is not None:
                self._leaves_rect = self.hub.published_rect

    def _hub_process(self, frame):
        """hub.process, dispatching deferred-NV12 frames through the
        device decode (the legacy fan-out's extra dispatch)."""
        if isinstance(frame, _NV12Pending):
            return self.hub.process_nv12(
                frame.y, frame.uv, cs=frame.cs, shift=frame.shift
            )
        return self.hub.process(frame)

    def flush(self) -> None:
        """Analyze any deferred frame NOW through the hub fan-out, so
        host-side scope reads reflect the latest pushed frame without a
        render (see push_frame on deferral)."""
        if self._pending is not None:
            f, self._pending = self._pending, None
            if self._hub_process(f) is not None:
                self._leaves_rect = self.hub.published_rect

    def render(
        self, width: Optional[int] = None, height: Optional[int] = None
    ) -> np.ndarray:
        """Host panel: render_async + ONE device->host transfer."""
        panel = self.render_async(width, height)
        return panel if panel is None else np.asarray(panel)

    def render_async(
        self, width: Optional[int] = None, height: Optional[int] = None
    ):
        """Composite all shown scopes (reference draw,
        src/scope-widget.cpp:99-175): vertical stack, each scope centered;
        vectorscope forced square; ROI/zebra/falsecolor/focuspeaking keep
        their aspect; waveform/histogram stretch.

        The composite runs ON DEVICE (nearest resizes + static slices) and
        the finished panel is fetched in ONE transfer — scope images never
        individually cross the host boundary (one fetch per panel instead
        of one per scope).

        Steady-state streaming goes further: when every shown scope exposes
        its published buffers (render_leaves/render_traced), ALL scope
        renders and the composite fuse into ONE cached jitted program; and
        with push/render alternation + default consumers the ANALYSIS fuses
        in too (the stream step, see _consume_stream) — one device program
        per frame end to end (one dispatch instead of one per scope).  The
        legacy per-scope route still runs
        the first frame after any config/shape change (it discovers the
        layout) and whenever a scope opts out (bypass).

        Returns the DEVICE-resident panel (jax.Array) — dispatch is async,
        so a streaming loop can run ahead of the device and fetch (or
        encode) panels wherever it sinks them; ``render`` wraps this with
        the single blocking transfer.

        While an ROI drag is in progress, the in-progress selection
        rectangle is outlined over the panel (reference draw_roi_rect,
        src/roi.c:236-265) and mid-drag rect changes are served by the
        dynamic-rect device step — zero recompiles (see
        _consume_dynamic)."""
        panel = self._render_async_impl(width, height)
        ri = self.roi_interact
        if panel is None or ri is None:
            return panel
        segs = ri.indicator_segments()
        band = self._rects.get("roi")
        if not segs or band is None:
            return panel
        x0b, y0b, wb, hb, ws, hs = band
        # segments are in scaled-CAPTURE coords; when the band displays
        # the crop, shift by the DISPLAYED crop's origin (snapshotted at
        # render time) before scaling to band pixels
        ox, oy = self._roi_crop_origin

        def mx(v):
            return x0b + (v - ox) * wb // max(ws, 1)

        def my(v):
            return y0b + (v - oy) * hb // max(hs, 1)

        arr = np.full((_MAX_INDICATOR_SEGS, 4), -1, np.int32)
        for i, (ax, ay, bx, by) in enumerate(segs[:_MAX_INDICATOR_SEGS]):
            # CLIP to the band: a segment partially off the displayed view
            # keeps only its visible part; one entirely off-view is dropped
            # (clamping endpoints would collapse it onto the band edge as a
            # spurious line, e.g. an outside handle left of a crop view)
            sx0, sy0 = max(mx(min(ax, bx)), x0b), max(my(min(ay, by)), y0b)
            sx1 = min(mx(max(ax, bx)), x0b + wb - 1)
            sy1 = min(my(max(ay, by)), y0b + hb - 1)
            if sx0 <= sx1 and sy0 <= sy1:
                arr[i] = (sx0, sy0, sx1, sy1)
        return _segments_px(panel, arr)

    def _render_async_impl(
        self, width: Optional[int] = None, height: Optional[int] = None
    ):
        cx = width or self.config.width
        cy = height or self.config.height
        self._rendered_since_push = True

        shown = [n for n in SCOPE_ORDER if self.shown(n)]
        if self._pending is not None:
            panel = self._consume_stream(cx, cy, shown)
            if panel is not None:
                return panel
            # fell through (interleave skip / cache miss fallback): the
            # frame was processed or skipped; render from published buffers
        # OCM_NO_FUSED_RENDER=1 keeps the legacy per-scope route (e.g. short
        # batch runs where the fused program's one extra compile never pays)
        fast = not os.environ.get("OCM_NO_FUSED_RENDER") and not any(
            getattr(self.scopes[n].config, "bypass", False) for n in shown
        )
        entries = None
        if fast:
            entries = [(n, self.scopes[n].render_leaves()) for n in shown]
            # don't fuse (or cache) while any shown scope has no published
            # buffers yet (e.g. the waveform's tick-gated read buffer on the
            # very first frame): its key is transient — one more frame and
            # the program would be rebuilt, wasting the first compile
            if any(lv is None for _, lv in entries):
                fast = False
        if fast:
            fkey = self._fused_key(cy, cx, entries)
            cached = self._fused_render_fns.get(fkey)
            if cached is not None:
                fn, rects, included = cached
                self._rects = dict(rects)
                self._set_roi_view()
                by_name = dict(entries)
                leaves = [l for n in included for l in by_name[n]]
                return fn(*leaves)
        n_src = len(shown)
        self._rects = {}
        self._set_roi_view()
        spec: list[tuple] = []
        images: list = []
        included: list[str] = []
        y0 = 0
        for k, name in enumerate(shown):
            img = self.scopes[name].render_image()
            h_slot = (cy - y0) // (n_src - k)
            if img is None:
                y0 += h_slot
                continue
            h_src, w_src = int(img.shape[0]), int(img.shape[1])
            w, h = cx, h_slot
            keep_aspect = name in ("roi", "zebra", "falsecolor") or (
                name == "focuspeaking" and not self.focuspeaking.config.actual_size
            )
            if name == "vectorscope":
                w = h = min(w, h)
            elif keep_aspect and w_src > 0 and h_src > 0:
                if w * h_src > h * w_src:
                    w = h * w_src // h_src
                elif h * w_src > w * h_src:
                    h = w * h_src // w_src
            crop = None
            if (
                name == "focuspeaking"
                and self.focuspeaking.config.actual_size
                and w_src > 0
            ):
                # 1:1 pixel mapping, centered, cropped to the slot
                # (reference set_actual_size_matrix, focuspeaking.c:203-220)
                w, h = min(w, w_src), min(h, h_src)
                crop = ((h_src - h) // 2, (w_src - w) // 2)
            if w > 0 and h > 0:
                x0 = (cx - w) // 2
                spec.append(((h_src, w_src), x0, y0, w, h, crop))
                images.append(img)
                included.append(name)
                self._rects[name] = (x0, y0, w, h, w_src, h_src)
            y0 += h_slot

        key = (cy, cx, tuple(spec))
        fn = self._composite_fns.get(key)
        if fn is None:
            if len(self._composite_fns) > 32:  # bound growth under live resizing
                self._composite_fns.clear()
            fn = jax.jit(functools.partial(_composite, cy, cx, tuple(spec)))
            self._composite_fns[key] = fn
        panel = fn(tuple(images))
        if fast:
            # build the fused program for subsequent frames: scope renders +
            # composite in one jit, published buffers as ARGUMENTS (captures
            # would constant-fold and retrace every frame)
            by_name = dict(entries)
            lens = {n: len(by_name[n]) for n in included}
            spec_t = tuple(spec)
            scopes = self.scopes

            def _fused(*leaves):
                imgs = []
                i = 0
                for n in included:
                    imgs.append(scopes[n].render_traced(*leaves[i : i + lens[n]]))
                    i += lens[n]
                return _composite(cy, cx, spec_t, tuple(imgs))

            if len(self._fused_render_fns) > 8:
                self._fused_render_fns.clear()
                self._fused_specs.clear()
            self._fused_render_fns[fkey] = (
                jax.jit(_fused),
                dict(self._rects),
                tuple(included),
            )
            self._fused_specs[fkey] = spec_t
        return panel

    def _fused_key(self, cy: int, cx: int, entries) -> tuple:
        """Cache key of the fused/stream render programs: panel geometry +
        every scope's leaf signature and static trace key."""
        return (
            cy,
            cx,
            tuple(
                (
                    n,
                    None
                    if lv is None
                    else tuple((l.shape, l.dtype) for l in lv),
                    self.scopes[n].render_trace_key(),
                )
                for n, lv in entries
            ),
        )

    def _consume_stream(self, cx: int, cy: int, shown: list):
        """Run the deferred frame through the ONE-program stream step:
        analyze + hub fan-out publication + every scope render + composite
        in a single cached jitted call.

        Bit-identical to hub.process + the fused render: the program body
        replays the actual surface_cb/render_traced code on the traced
        analysis at trace time (state snapshot/restore), with the
        waveform's tick-gated read buffer carried as a cross-frame leaf
        (reference wvs_tick one-frame latency, src/waveform.c:394-400) and
        the zebra clock a traced scalar.  Returns the device panel, or
        None after a fallback (interleave skip, missing warmup state) —
        the caller then renders from the published buffers as usual."""
        frame, self._pending = self._pending, None
        hub = self.hub
        hub._rendered = True
        if hub._i_interleave != 0 and hub.config.interleave > 0:
            hub.frames_skipped += 1
            return None  # skipped: panel re-renders the published buffers
        nv12 = isinstance(frame, _NV12Pending)
        if nv12:
            # raw (y, uv) planes: the stream program decodes in-program to
            # the packed view (one dispatch AND 1.5 B/px uploads)
            is_packed = True
            h, w = frame.y.shape[-2], frame.y.shape[-1]
        else:
            # mirror hub.process's free host-side u8 -> packed u32 view
            from ..ops.convert import host_packed_view

            frame = host_packed_view(frame)
            is_packed = getattr(frame, "ndim", 3) == 2
            if is_packed:
                h, w = frame.shape[-2], frame.shape[-1]
            else:
                h, w = frame.shape[-3], frame.shape[-2]
        scale = hub.config.target_scale
        sw, sh = w // scale, h // scale
        if sw <= 0 or sh <= 0:
            hub.frames_skipped += 1
            return None
        # keep the hub's capture dims live on the stream route too (mouse
        # geometry reads them; hub.process may never run again steady-state)
        hub.capture_size = (sw, sh)
        rect = hub.config.resolve_rect(sw, sh)
        full = rect == (0, 0, sw, sh)
        cw, ch = rect[2] - rect[0], rect[3] - rect[1]
        if not full:
            # a mid-drag or just-changed rect is served by the dynamic-rect
            # device step: one cached program for EVERY rect (a per-rect
            # stream program would cold-compile per drag step); once the
            # rect settles the exact per-rect stream path resumes below
            from .roi_interact import DRAG_FIRST, DRAG_MOVE, DRAG_RESIZE

            ri = self.roi_interact
            drag = ri is not None and bool(
                ri.flags & (DRAG_FIRST | DRAG_MOVE | DRAG_RESIZE)
            )
            changed = (
                self._last_stream_rect is not None
                and self._last_stream_rect != rect
            )
            self._last_stream_rect = rect
            if drag or changed:
                panel = self._consume_dynamic(frame, cx, cy, rect)
                if panel is not None:
                    return panel
        else:
            self._last_stream_rect = rect
        if self._leaves_rect != rect:
            # the published leaves belong to a different rect (warmup, a
            # just-settled drag — the dynamic route publishes full-capture
            # leaves — or a programmatic rect change): one hub-fan-out
            # frame republishes every leaf at THIS rect, so the stream/
            # fused programs below are always built from rect-consistent
            # specs
            self._hub_process(frame)
            self._leaves_rect = rect
            return None
        wv = self.waveform
        wv_prev = wv._buf[wv._r_buf]
        frame_sig = (
            (
                "nv12",
                tuple(frame.y.shape),
                tuple(frame.uv.shape),
                frame.cs,
                frame.shift,
            )
            if nv12
            else (tuple(frame.shape), frame.dtype)
        )
        # Steady-state fast path: every input the fused/stream key derives
        # from is covered by (geometry, rect, colorspace, the generation-
        # memoized config keys) — when none changed since the last served
        # frame, the cached program is provably the same one, so skip
        # re-deriving the per-scope leaf signatures and fused key (~0.13 ms
        # of per-frame Python on this 1-core host; the published leaf
        # SHAPES only change with a config generation bump or a capture/
        # rect change, both in this key).
        fastk = (
            cx, cy, is_packed, frame_sig, scale, int(hub.colorspace),
            rect, tuple(shown), self._device_confkey(full),
        )
        cached = self._stream_fast
        if cached is not None and cached[0] == fastk and wv_prev is not None:
            entry = cached[1]
        else:
            entries = [(n, self.scopes[n].render_leaves()) for n in shown]
            if wv_prev is None or any(lv is None for _, lv in entries):
                self._hub_process(frame)  # warmup missing: legacy fan-out
                return None
            fkey = self._fused_key(cy, cx, entries)
            skey = (fkey, is_packed, frame_sig, scale, int(hub.colorspace),
                    rect)
            entry = self._stream_fns.get(skey)
            if entry is None:
                fentry = self._fused_render_fns.get(fkey)
                spec = self._fused_specs.get(fkey)
                if fentry is None or spec is None:
                    self._hub_process(frame)  # layout unknown: legacy route
                    return None
                entry = self._build_stream_fn(
                    cx, cy, spec, fentry[1], fentry[2],
                    is_packed, scale, rect, full, cw, ch,
                    nv12_cs=frame.cs if nv12 else None,
                    nv12_shift=frame.shift if nv12 else 0,
                )
                if len(self._stream_fns) > 8:
                    self._stream_fns.clear()
                self._stream_fns[skey] = entry
            self._stream_fast = (fastk, entry)
        fn, rects, wv_fam_yuv, hi_fam_yuv = entry
        self._rects = dict(rects)
        self._roi_shows_crop = not full
        self._roi_crop_origin = (rect[0], rect[1]) if not full else (0, 0)
        tm = np.float32(self.zebra.tm)
        panel, vs_c, wv_c, hi_c, planes = fn(
            (frame.y, frame.uv) if nv12 else frame, tm, wv_prev
        )
        # publish-back: exactly what each scope's surface_cb stores
        cs = hub.colorspace
        for n in ("zebra", "falsecolor", "focuspeaking"):
            s = self.scopes[n]
            s._size = (cw, ch)
            s._publish((planes, cs))
        rp = self.roi_preview
        rp._size = (cw, ch)
        rp._buf_cropped[rp._w_buf] = not full
        rp._publish(planes)
        vsc = self.vectorscope
        vsc._buf_cs[vsc._w_buf] = cs
        vsc._publish(vs_c)
        wv._buf_width[wv._w_buf] = cw
        wv._buf_rect[wv._w_buf] = None
        wv._publish(wv_c)
        self.histogram._publish((hi_c, cw * ch))
        from ..ops.fused import AnalysisResult
        from .base import SurfaceData

        hub.last_surface = SurfaceData(
            result=AnalysisResult(
                yuv_planes=None,
                vs_counts=vs_c,
                wv_rgb=None if wv_fam_yuv else wv_c,
                wv_yuv=wv_c if wv_fam_yuv else None,
                hi_rgb=None if hi_fam_yuv else hi_c,
                hi_yuv=hi_c if hi_fam_yuv else None,
                planes=planes,
            ),
            width=cw,
            height=ch,
            colorspace=cs,
        )
        hub.frames_processed += 1
        return panel

    def _build_stream_fn(
        self, cx, cy, spec, rects, included,
        is_packed, scale, rect, full, cw, ch, nv12_cs=None, nv12_shift=0,
    ):
        """Build the jitted stream-step program for one (layout, frame
        shape, hub config) state.  With ``nv12_cs`` the program takes raw
        (y, uv) planes and decodes them in-program (one dispatch for the
        wire-format route too)."""
        from ..ops.fused import analyze
        from .base import SurfaceData

        hub = self.hub
        scopes = self.scopes
        consumers = [scopes[k] for k in SCOPE_ORDER]
        needs = hub.union_needs()
        cs = hub.colorspace
        wv = self.waveform
        wv_fam_yuv = wv.config.components.is_yuv
        hi_fam_yuv = self.histogram.config.components.is_yuv
        spec_t = tuple(spec)
        included_t = tuple(included)

        def _stream(frame, tm, wv_prev):
            # trace-time only: replay the hub fan-out + scope renders on
            # the traced analysis, then restore the host-side buffers
            if nv12_cs is not None:
                from ..ops.convert import nv12_to_packed

                frame = nv12_to_packed(
                    frame[0], frame[1], cs=nv12_cs, shift=nv12_shift
                )
            res = analyze(
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
                is_packed=is_packed,
            )
            surface = SurfaceData(
                result=res, width=cw, height=ch, colorspace=cs,
                cropped=not full,
            )
            saved = [(c, list(c._buf), c._w_buf) for c in consumers]
            try:
                for c in consumers:
                    c.surface_cb(surface)
                # the tick-gated read buffer holds LAST frame's counts —
                # the carried leaf (publish above wrote the other buffer)
                wv._buf[wv._r_buf] = wv_prev
                imgs = []
                for n in included_t:
                    s = scopes[n]
                    if n == "zebra":
                        # the stripe clock must be the TRACED scalar, not
                        # the host float render_leaves would bake in
                        lv = (s._read()[0], tm)
                    else:
                        lv = s.render_leaves()
                    imgs.append(s.render_traced(*lv))
            finally:
                for c, buf, wb in saved:
                    c._buf = buf
                    c._w_buf = wb
            panel = _composite(cy, cx, spec_t, tuple(imgs))
            wv_new = res.wv_yuv if wv_fam_yuv else res.wv_rgb
            hi_new = res.hi_yuv if hi_fam_yuv else res.hi_rgb
            return panel, res.vs_counts, wv_new, hi_new, res.planes

        return jax.jit(_stream), dict(rects), wv_fam_yuv, hi_fam_yuv

    def _consume_dynamic(self, frame, cx, cy, rect):
        """Serve a mid-drag / just-changed-rect streamed frame from the
        dynamic-rect one-program step (make_dock_step(dynamic_roi=True)):
        ONE cached program serves EVERY rect, so interactive drags run at
        video rate with zero recompiles (the reference's drag is a crop
        realloc, src/roi.c:343-521; a per-rect stream program here would
        cold-compile on every rect change).

        Panel semantics follow the dynamic dock step (the preview row
        shows the FULL capture with drag shading; overlay slots fit the
        rect inside static bands).  EVERY consumer is published fresh —
        the reference pushes the changed crop to all consumers every tick
        (roi_send_range, src/roi.c:478-520) — in the recompile-free
        representation (SurfaceData.dynamic_rect): exact rect statistics
        for vectorscope/histogram, full-width waveform counts whose rect
        slice is exact (Waveform.counts() returns that slice), and the
        FULL scaled capture as the preview/overlay planes (in-rect overlay
        pixels bit-match the crop's, tests/test_dynamic_roi.py rect-parity;
        rect-sized crops would retrace per rect).  ``hub.last_surface`` is
        the same fresh surface, marked with ``dynamic_rect``.  Stats
        scopes hidden in the dock config keep their last publication (the
        dynamic step only computes shown statistics).  Returns the device
        panel, or None to fall back."""
        hub = self.hub
        try:
            out = self._device_step_out(frame, float(self.zebra.tm), cx, cy)
        except NotImplementedError:
            return None
        if not self._device_step_dynamic:
            return None  # static fallback build: no recompile-free win
        step = self._device_step
        # mouse routing follows the device step's static bands (source
        # dims of the full-band overlay slots are the bands themselves)
        self._rects = {
            n: (
                r[0], r[1], r[2], r[3],
                step.dims[n][0] or r[2], step.dims[n][1] or r[3],
            )
            for n, r in step.rects.items()
        }
        self._roi_shows_crop = False  # dynamic preview = full capture
        self._roi_crop_origin = (0, 0)
        cs = hub.colorspace
        scap_w, scap_h = hub.capture_size
        # RAW counts, like every other route: channel selection stays a
        # read/render-time concern, so a components change between publish
        # and read behaves identically on all routes
        wv_fam_yuv = self.waveform.config.components.is_yuv
        hi_fam_yuv = self.histogram.config.components.is_yuv
        wv_c = out.wv_counts if self.shown("waveform") else None
        hi_c = out.hi_counts if self.shown("histogram") else None
        from ..ops.fused import AnalysisResult
        from .base import SurfaceData

        surface = SurfaceData(
            result=AnalysisResult(
                yuv_planes=None,
                vs_counts=out.vs_counts if self.shown("vectorscope") else None,
                wv_rgb=None if wv_fam_yuv else wv_c,
                wv_yuv=wv_c if wv_fam_yuv else None,
                hi_rgb=None if hi_fam_yuv else hi_c,
                hi_yuv=hi_c if hi_fam_yuv else None,
                planes=out.planes,
            ),
            width=scap_w,
            height=scap_h,
            colorspace=cs,
            cropped=False,
            dynamic_rect=tuple(rect),
        )
        for k in SCOPE_ORDER:
            self.scopes[k].surface_cb(surface)
        hub.last_surface = surface
        hub.frames_processed += 1
        return out.panel

    def render_device(
        self,
        frame,
        tm: float = 0.0,
        width: Optional[int] = None,
        height: Optional[int] = None,
    ) -> np.ndarray:
        """One-program panel render: the whole dock as a single XLA program
        (dock_step.make_dock_step), rebuilt when configs/shape change.

        Unlike push_frame+render (which fetches each scope separately),
        this is one device call per frame.
        """
        cx = width or self.config.width
        cy = height or self.config.height
        return np.asarray(self._device_step_out(frame, tm, cx, cy).panel)

    def _device_confkey(self, full: bool) -> tuple:
        """Cheap value-identity of every config the device step bakes in
        (per-frame on the dynamic streaming route).  The ROI rect fields
        are EXCLUDED when non-full: the dynamic step takes the rect as a
        runtime input, so dragging must not rebuild."""
        from ..config import config_key

        return (
            config_key(
                self.hub.config,
                skip=() if full else ("x0", "y0", "x1", "y1"),
            ),
            config_key(self.config),
            config_key(self.vectorscope.config),
            config_key(self.waveform.config),
            config_key(self.histogram.config),
            config_key(self.zebra.config),
            # (config_key sans lut, LUT fingerprint) — generation-memoized
            self.falsecolor.render_trace_key(),
            config_key(self.focuspeaking.config),
        )

    def _device_step_out(self, frame, tm: float, cx: int, cy: int):
        """Run the cached one-program dock step; returns the device-resident
        DockStepOutput (panel + stats)."""
        from ..dock_step import make_dock_step

        # (H, W, 4) u8 or the zero-copy (H, W) u32 packed view; host u8
        # frames are re-viewed as u32 for free (see CaptureHub.process).
        # _NV12Pending frames build an nv12-input step (decode in-program)
        nv12_cs, nv12_shift = None, 0
        if isinstance(frame, _NV12Pending):
            h, w = frame.y.shape[-2], frame.y.shape[-1]
            nv12_cs, nv12_shift = frame.cs, frame.shift
        else:
            from ..ops.convert import host_packed_view

            frame = host_packed_view(frame)
            if getattr(frame, "ndim", 3) == 2:
                h, w = frame.shape[-2], frame.shape[-1]
            else:
                h, w = frame.shape[-3], frame.shape[-2]
        scale = self.hub.config.target_scale
        self.hub.capture_size = (w // scale, h // scale)
        rect = self.hub.config.resolve_rect(w // scale, h // scale)
        full = rect == (0, 0, w // scale, h // scale)
        key = (
            h, w, cx, cy, full, nv12_cs, nv12_shift,
            self._device_confkey(full),
        )
        rebuild = getattr(self, "_device_step_key", None) != key or (
            getattr(self, "_device_step_rect", None) is not None
            and self._device_step_rect != rect
        )
        if rebuild:
            kwargs = dict(
                cs=self.hub.colorspace,
                scale=scale,
                out_width=cx,
                out_height=cy,
                dock=self.config,
                vectorscope=self.vectorscope.config,
                waveform=self.waveform.config,
                histogram=self.histogram.config,
                zebra=self.zebra.config,
                falsecolor=self.falsecolor.config,
                focuspeaking=self.focuspeaking.config,
            )
            if nv12_cs is not None:
                kwargs.update(
                    input_format="nv12", nv12_cs=nv12_cs,
                    nv12_shift=nv12_shift,
                )
            self._device_step_rect = None
            if full:
                self._device_step = make_dock_step(h, w, **kwargs)
                self._device_step_dynamic = False
            else:
                try:
                    self._device_step = make_dock_step(
                        h, w, dynamic_roi=True, **kwargs
                    )
                    self._device_step_dynamic = True
                except NotImplementedError:
                    # configs outside the dynamic step's coverage (none
                    # from this entry point today): static rebuild per rect
                    self._device_step = make_dock_step(
                        h, w, roi_rect=rect, **kwargs
                    )
                    self._device_step_dynamic = False
                    self._device_step_rect = rect
            self._device_step_key = key
        arg = (frame.y, frame.uv) if nv12_cs is not None else frame
        if self._device_step_dynamic:
            out = self._device_step(
                arg, np.float32(tm), np.asarray(rect, np.int32)
            )
        else:
            out = self._device_step(arg, np.float32(tm))
        return out

    # -- mouse routing (reference src/scope-widget.cpp:241-428) --------------
    def _hit(self, x: int, y: int):
        """(name, scope-local x, scope-local y) for a canvas position."""
        for name, (x0, y0, w, h, w_src, h_src) in self._rects.items():
            if x0 <= x < x0 + w and y0 <= y < y0 + h:
                sx = (x - x0) * w_src // max(w, 1)
                sy = (y - y0) * h_src // max(h, 1)
                return name, sx, sy
        return None, 0, 0

    def mouse_wheel(self, x: int, y: int, delta_y: int) -> None:
        """Wheel over the vectorscope zooms it (reference routes
        obs_source_send_mouse_wheel; vectorscope.c:473-482)."""
        name, _, _ = self._hit(x, y)
        if name == "vectorscope":
            self.vectorscope.zoom_by(delta_y)

    def _set_roi_view(self) -> None:
        """Snapshot what the roi band is about to display (published
        planes): crop or full, and the crop's capture-space origin — the
        rect the planes were PUBLISHED under (_leaves_rect), not the live
        config (a mid-drag commit must not move the offset until the
        display catches up)."""
        rp = self.roi_preview
        self._roi_shows_crop = bool(rp._buf_cropped[rp._w_buf ^ 1])
        if not self._roi_shows_crop:
            self._roi_crop_origin = (0, 0)
        elif self._leaves_rect is not None:
            self._roi_crop_origin = (self._leaves_rect[0], self._leaves_rect[1])
        elif self.hub.published_rect is not None:
            # a consumer driving hub.process directly (never push_frame):
            # the rect the hub last PUBLISHED under — not the live config,
            # which a mid-drag commit may already have moved past the
            # displayed crop (the drift class e3ca59d fixed for push_frame)
            r = self.hub.published_rect
            self._roi_crop_origin = (r[0], r[1])
        else:
            self._roi_crop_origin = (0, 0)

    def _roi_band_coords(self, x: int, y: int):
        """PANEL coords -> scaled-CAPTURE coords through the roi band
        transform, UNCLAMPED — a drag may run outside the band and the
        reference keeps translating through the grabbed scope's rect
        (get_source_from_mouse, scope-widget.cpp:241-263).  When the band
        displays the crop, the DISPLAYED crop's origin (snapshotted at
        render time) offsets into capture space."""
        band = self._rects.get("roi")
        if band is None:
            return None
        x0b, y0b, wb, hb, ws, hs = band
        ox, oy = self._roi_crop_origin
        return (
            (x - x0b) * ws // max(wb, 1) + ox,
            (y - y0b) * hs // max(hb, 1) + oy,
        )

    def _ensure_roi_interact(self):
        if self.roi_interact is None:
            from .roi_interact import InteractiveROI

            # the interact space is the scaled CAPTURE (the reference's ROI
            # source always shows the full target, src/roi.c:279-315) — not
            # the preview's published dims, which may be the crop
            w, h = self.hub.capture_size or (
                self.roi_preview.width or 1,
                self.roi_preview.height or 1,
            )
            self.roi_interact = InteractiveROI(width=w, height=h)
            # seed the committed rect from the hub config (the reference's
            # roi source keeps x0in.. across settings loads, src/roi.c)
            c = self.hub.config
            self.roi_interact.x0in, self.roi_interact.y0in = c.x0, c.y0
            self.roi_interact.x1in, self.roi_interact.y1in = c.x1, c.y1
        elif self.hub.capture_size:
            # the reference recomputes roi_get_width/height per event
            # (src/roi.c:146-156): handle geometry and clamps must track a
            # capture-resolution change, not the dims at first interaction
            ri = self.roi_interact
            ri.width, ri.height = self.hub.capture_size
        return self.roi_interact

    def _roi_dragging(self) -> bool:
        from .roi_interact import DRAG_FIRST, DRAG_MOVE, DRAG_RESIZE

        ri = self.roi_interact
        return ri is not None and bool(
            ri.flags & (DRAG_FIRST | DRAG_MOVE | DRAG_RESIZE)
        )

    def mouse_move(self, x: int, y: int) -> None:
        from .roi_interact import DRAG_MOVE

        name, _, _ = self._hit(x, y)
        if name == "roi" or self._roi_dragging():
            # a drag grabs the pointer: moves keep routing to the roi band
            # even outside it (reference INTERACT_KEEP_SOURCE,
            # scope-widget.cpp:241-263,372-374)
            c = self._roi_band_coords(x, y)
            if c is None:
                return
            r = self._ensure_roi_interact()
            before = r.rect()
            r.mouse_move(*c)
            # a move-drag changes the committed rect continuously; the
            # reference pushes it to consumers every tick (roi_send_range,
            # src/roi.c:478-520) — apply live (the dynamic streaming route
            # serves every rect from one compiled program)
            if (r.flags & DRAG_MOVE) and r.rect() != before:
                r.apply_to(self.hub)
        elif self.roi_interact is not None and self.roi_interact.flags:
            # hover moved onto another scope: the reference sends a LEAVE
            # to the previously-hovered source (scope-widget.cpp:379-380),
            # clearing the hover handle indicators
            self.roi_interact.mouse_move(0, 0, leave=True)

    def mouse_down(self, x: int, y: int) -> None:
        name, _, _ = self._hit(x, y)
        if name == "roi":
            c = self._roi_band_coords(x, y)
            if c is None:
                return
            self._ensure_roi_interact().mouse_down(*c)

    def mouse_up(self, x: int, y: int) -> None:
        name, _, _ = self._hit(x, y)
        if name == "roi" or self._roi_dragging():
            # releases outside the band still finish the grabbed drag
            # (reference KEEP_SOURCE on release, scope-widget.cpp:329)
            c = self._roi_band_coords(x, y)
            if c is None:
                return
            r = self._ensure_roi_interact()
            r.mouse_up(*c)
            r.apply_to(self.hub)
