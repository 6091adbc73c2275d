"""Waveform scope (reference src/waveform.c).

Per-column 256-level intensity map with RGB/Luma/Chroma/YUV component
select, overlay/stack/parade display, horizontal graticule lines.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import Components, DisplayMode, WaveformConfig
from ..ops import render as render_ops
from ..ops.graticule import waveform_graticule
from ..ops.stats import apply_channel_select
from .base import (
    FLAG_CONVERT_RGB,
    FLAG_CONVERT_YUV,
    Needs,
    Scope,
    StandaloneScopeMixin,
    SurfaceData,
)

WV_SIZE = 256


class Waveform(Scope, StandaloneScopeMixin):
    def __init__(self, config: Optional[WaveformConfig] = None):
        config = config or WaveformConfig()
        super().__init__(config)
        self._r_buf = 0  # published on tick (reference wvs_tick, waveform.c:394-400)
        self._buf_width = [0, 0]
        # (x0, x1) column range of valid data when the published buffer is
        # FULL-width with out-of-rect columns zero (the dock's dynamic-rect
        # mid-drag publication); None = the buffer is exactly its own rect
        self._buf_rect = [None, None]
        self._update_flags()
        self.attach_private_hub(config)

    def _update_flags(self) -> None:
        c = self.config.components
        # reference src/waveform.c:100-102
        self.flags = (FLAG_CONVERT_RGB if (c & Components.RGB) else 0) | (
            FLAG_CONVERT_YUV if c.is_yuv else 0
        )

    def update(self, **settings) -> None:
        super().update(**settings)
        self._update_flags()

    def needs(self) -> Needs:
        yuv = self.config.components.is_yuv
        return Needs(wv_rgb=not yuv, wv_yuv=yuv, rgba=self.config.bypass)

    def surface_cb(self, surface: SurfaceData) -> None:
        self._store_bypass(surface)
        res = surface.result
        counts = res.wv_yuv if self.config.components.is_yuv else res.wv_rgb
        if counts is None:
            return
        # publish the RAW fused-pass buffer: channel selection is deferred
        # into render_traced so the callback issues ZERO device dispatches
        # (each eager op is a separate program execution with its own
        # dispatch).  Selection is config-static, so it rides the (cached)
        # render program for free.
        self._buf_width[self._w_buf] = surface.width
        if surface.dynamic_rect is not None:
            # full-width counts valid within the rect's columns (dock
            # dynamic-rect route; see SurfaceData.dynamic_rect)
            self._buf_rect[self._w_buf] = (
                surface.dynamic_rect[0], surface.dynamic_rect[2]
            )
        else:
            self._buf_rect[self._w_buf] = None
        self._publish(counts)

    def counts(self) -> Optional[np.ndarray]:
        """Channel-selected u8 counts of the published buffer (the value
        the reference's dbuf holds after its zero-first accumulate,
        src/waveform.c:220-257); for tests/tools.

        When the buffer came from the dock's dynamic-rect route (mid-drag
        frames) it is full-capture-width with only the rect's columns
        populated; the rect slice is returned so host reads track the live
        rect exactly, like the reference's per-tick crop push
        (src/roi.c:478-520)."""
        v = self._read()
        if v is None:
            return None
        out = np.asarray(
            apply_channel_select(v, self.config.components.channel_select())
        )
        rect = self._buf_rect[self._w_buf ^ 1]
        return out if rect is None else out[:, :, rect[0] : rect[1]]

    def tick(self, seconds: float = 1.0 / 60.0) -> None:
        # the read buffer only advances on tick (reference waveform.c:394-400)
        self._r_buf = self._w_buf ^ 1

    def render_leaves(self):
        if self.config.bypass:
            return None
        counts = self._buf[self._r_buf]  # tick-gated read buffer
        return None if counts is None else (counts,)

    def render_trace_key(self):
        from ..config import config_key

        return (config_key(self.config), self._buf_width[self._r_buf])

    def render_traced(self, counts):
        n = self.config.components.n_components
        img = render_ops.render_waveform(
            apply_channel_select(
                counts, self.config.components.channel_select()
            ),
            intensity=self.config.intensity,
            display=int(self.config.display),
            n_components=n,
            yuv_mode=self.config.components.is_yuv,
        )
        key = (
            self.config.graticule_lines,
            self._buf_width[self._r_buf],
            int(self.config.display),
            n,
        )
        overlay = self._device_const(key, lambda: waveform_graticule(*key))
        if overlay is not None:
            img = render_ops.blend_overlay(img, overlay)
        return img

    def render_image(self):
        if self.config.bypass:
            return self.render_bypass()
        return super().render_image()

    @property
    def width(self) -> int:
        rect = self._buf_rect[self._r_buf]
        w = self._buf_width[self._r_buf] if rect is None else rect[1] - rect[0]
        if self.config.display == DisplayMode.PARADE:
            return w * self.config.components.n_components
        return w

    @property
    def height(self) -> int:
        if self.config.display == DisplayMode.STACK:
            return WV_SIZE * self.config.components.n_components
        return WV_SIZE
