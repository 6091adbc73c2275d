"""Model-layer + pipeline semantics: double-buffering, fan-out, interleave,
drop-on-full, dock composite, bit-exactness end-to-end through the hub."""

import time

import numpy as np
import pytest

from obs_color_monitor_tpu import golden
from obs_color_monitor_tpu.colorspace import Colorspace
from obs_color_monitor_tpu.config import (
    Components,
    HistogramConfig,
    ROIConfig,
    VectorscopeConfig,
    WaveformConfig,
)
from obs_color_monitor_tpu.models import (
    CaptureHub,
    Dock,
    Histogram,
    Vectorscope,
    Waveform,
    Zebra,
)
from obs_color_monitor_tpu.pipeline import FrameQueue, PipelineDriver


FRAME = None


@pytest.fixture(scope="module")
def frame(rng):
    f = rng.integers(0, 256, size=(96, 128, 4), dtype=np.uint8)
    f[..., 3] = 255
    return f


def test_vectorscope_end_to_end(frame):
    vs = Vectorscope(VectorscopeConfig(target_scale=1, colorspace=Colorspace.BT709))
    assert vs.render() is None  # nothing before first frame
    vs.push_frame(frame)
    img = vs.render()
    assert img.shape == (256, 256, 4)
    # counts bit-exact through the whole model stack
    yuv = golden.rgb_to_yuv_u8(frame, Colorspace.BT709)
    want = golden.vectorscope_counts(yuv)
    got = np.asarray(vs._read())
    np.testing.assert_array_equal(got, want)


def test_waveform_needs_tick_to_publish(frame):
    wv = Waveform(WaveformConfig(target_scale=1))
    wv.push_frame(frame)  # tick happens before process in hub
    # after push (tick->process), read buffer points at the just-written one
    # only on the NEXT tick (reference wvs_tick, src/waveform.c:394-400)
    first = wv.render()
    wv._hub.tick()
    second = wv.render()
    assert second is not None
    want = golden.waveform_counts(frame, None, Components.RGB)
    got = np.asarray(wv._buf[wv._r_buf])
    np.testing.assert_array_equal(got, want)


def test_histogram_scaled_capture(frame):
    his = Histogram(HistogramConfig(target_scale=2))
    his.push_frame(frame)
    scaled = golden.downscale(frame, 2)
    want = golden.histogram_counts(scaled, None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)
    img = his.render()
    assert img.shape == (200, 256, 4)


def test_hub_fanout_shares_one_pass(frame):
    """N consumers, one analyze call (the ROI-hub collapse)."""
    hub = CaptureHub(ROIConfig(target_scale=1, interleave=0))
    vs = Vectorscope(VectorscopeConfig())
    wv = Waveform(WaveformConfig())
    his = Histogram(HistogramConfig())
    hub.consumers = [vs, wv, his]
    hub.tick()
    surface = hub.process(frame)
    assert surface is not None
    assert surface.result.vs_counts is not None
    assert surface.result.wv_rgb is not None
    assert surface.result.hi_rgb is not None
    assert vs._read() is not None and his._read() is not None


def test_hub_interleave(frame):
    """interleave=1 -> every 2nd frame processed (reference roi.c:266-277)."""
    hub = CaptureHub(ROIConfig(target_scale=1, interleave=1))
    his = Histogram(HistogramConfig())
    hub.register(his)
    processed = 0
    for i in range(6):
        hub.tick()
        if hub.process(frame) is not None:
            processed += 1
    assert processed == 3
    assert hub.frames_skipped == 3


def test_hub_roi_rect(frame):
    hub = CaptureHub(ROIConfig(target_scale=1, x0=8, y0=4, x1=72, y1=68))
    his = Histogram(HistogramConfig())
    hub.register(his)
    hub.tick()
    hub.process(frame)
    crop = golden.roi_crop(frame, 8, 4, 72, 68)
    want = golden.histogram_counts(crop, None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)


def test_queue_drop_on_full():
    q = FrameQueue(depth=3)
    assert q.push(1) and q.push(2) and q.push(3)
    assert not q.push(4)  # dropped
    assert q.n_dropped == 1
    assert q.pop() == 1
    assert q.push(4)


def test_pipeline_driver(frame):
    his = Histogram(HistogramConfig(target_scale=1))
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        for _ in range(5):
            drv.push_frame(frame)
            time.sleep(0.01)
        drv.flush()
    finally:
        drv.stop()
    s = drv.stats
    assert s["processed"] >= 1
    assert s["pushed"] + s["dropped"] == 5 or s["pushed"] == 5
    want = golden.histogram_counts(golden.downscale(frame, 1), None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)


def test_driver_fed_dock_rides_stream_route(rng):
    """A driver-fed Dock consumes through the ONE-program stream step: the
    worker's push/render alternation engages the same cached stream
    program as a hand-driven streaming loop — in steady state the legacy
    hub fan-out NEVER runs (zero hub.process calls), exactly one stream
    program exists, every panel reaches on_panel in order, and panels +
    published statistics bit-match a directly-driven dock on the same
    frame sequence.  The reference has ONE pipeline regardless of sink
    (src/common.c:375-403); this pins that the queue/thread capability
    and the fast streaming path COMPOSE."""
    from obs_color_monitor_tpu.config import DockConfig

    frames = []
    for _ in range(8):
        f = rng.integers(0, 256, size=(48, 96, 4), dtype=np.uint8)
        f[..., 3] = 255
        frames.append(f)

    def mk():
        return Dock(
            DockConfig(show_roi=False),
            roi=ROIConfig(interleave=0, target_scale=1),
        )

    dock = mk()
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(np.asarray(p)))
    n_fanout = []
    drv.start()
    try:
        # warmup: 3 frames discover the layout and build the stream program
        for f in frames[:3]:
            assert drv.push_frame(f)
            drv.flush()
        # steady state: the legacy fan-out must never run again
        orig_process = dock.hub.process

        def counting(frame_):
            n_fanout.append(1)
            return orig_process(frame_)

        dock.hub.process = counting
        for f in frames[3:]:
            assert drv.push_frame(f)
            drv.flush()
    finally:
        drv.stop()
        dock.hub.process = orig_process
    assert n_fanout == []  # one device program per frame: stream step only
    assert len(dock._stream_fns) == 1
    assert dock.hub.frames_processed == 8
    assert drv.stats["processed"] == 8 and drv.stats["errors"] == 0
    assert len(panels) == 8

    # bit-parity with a hand-driven streaming dock on the same sequence
    ref = mk()
    for i, f in enumerate(frames):
        ref.push_frame(f)
        want = np.asarray(ref.render_async())
        np.testing.assert_array_equal(panels[i], want, err_msg=f"frame {i}")
    np.testing.assert_array_equal(
        dock.histogram.counts(), ref.histogram.counts()
    )
    np.testing.assert_array_equal(dock.waveform.counts(), ref.waveform.counts())


def test_driver_requires_exactly_one_consumer(frame):
    with pytest.raises(ValueError, match="exactly one"):
        PipelineDriver()
    with pytest.raises(ValueError, match="exactly one"):
        PipelineDriver(CaptureHub(ROIConfig()), dock=Dock())


def test_driver_push_nv12_rides_stream_route(rng):
    """Wire-format frames through the composed pipeline: push_nv12 stages
    the plane upload on the producer thread and enqueues the device
    planes; the worker consumes through the dock's NV12 stream deferral
    (decode traced IN the one-program stream step).  Steady state must
    show exactly one stream program and panels bit-matching a hand-driven
    dock.push_nv12 on the same wire bytes — the reference's pipeline is
    one path regardless of source format (src/common.c:223-333)."""
    from obs_color_monitor_tpu.config import DockConfig

    H, W = 48, 96
    bufs = [
        rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
        for _ in range(6)
    ]

    def mk():
        return Dock(
            DockConfig(show_roi=False),
            roi=ROIConfig(interleave=0, target_scale=1),
        )

    dock = mk()
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(np.asarray(p)))
    from obs_color_monitor_tpu.ops import convert as conv

    decode_calls = []
    orig_decode = conv.nv12_to_packed
    drv.start()
    try:
        for b in bufs[:3]:  # warmup: program builds (trace-time decodes)
            assert drv.push_nv12(b[:H], b[H:])
            drv.flush()
        # steady state: ZERO eager decode dispatches — the decode is
        # traced INSIDE the one stream program (same contract as
        # test_stream_step.py::test_nv12_stream_one_program)
        conv.nv12_to_packed = lambda *a, **k: (
            decode_calls.append(1), orig_decode(*a, **k))[1]
        for b in bufs[3:]:
            assert drv.push_nv12(b[:H], b[H:])
            drv.flush()
    finally:
        drv.stop()
        conv.nv12_to_packed = orig_decode
    assert decode_calls == []
    assert len(panels) == 6
    assert len(dock._stream_fns) == 1  # decode folded into ONE program
    assert dock.hub.frames_processed == 6

    ref = mk()
    for i, b in enumerate(bufs):
        ref.push_nv12(b[:H], b[H:])
        want = np.asarray(ref.render_async())
        np.testing.assert_array_equal(panels[i], want, err_msg=f"frame {i}")
    np.testing.assert_array_equal(
        dock.histogram.counts(), ref.histogram.counts()
    )


def test_driver_hub_mode_push_nv12(rng):
    """push_nv12 in bare-hub mode decodes through hub.process_nv12 and
    publishes bit-exact statistics (native decoder twin)."""
    from obs_color_monitor_tpu.runtime import native as gold

    H, W = 24, 48
    b = rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
    his = Histogram(HistogramConfig(target_scale=1))
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        assert drv.push_nv12(b[:H], b[H:])
        drv.flush()
    finally:
        drv.stop()
    rgba = gold.nv12_to_rgba(b[:H], b[H:], cs=int(his._hub.colorspace))
    want = golden.histogram_counts(rgba, None, Components.RGB)
    np.testing.assert_array_equal(his.counts(), want)


def test_driver_push_nv12_rejects_native_queue():
    his = Histogram(HistogramConfig())
    drv = PipelineDriver(his._hub, native_queue_shape=(16, 32))
    with pytest.raises(ValueError, match="native"):
        drv.push_nv12(np.zeros((16, 32), np.uint8), np.zeros((8, 32), np.uint8))


def test_driver_push_nv12_stages_on_producer_side(rng):
    """push_nv12 issues the plane upload BEFORE the frame enters the
    queue (the reference's graphics-thread staging, common.c:335-403):
    the queued NV12Frame must hold device arrays, not host numpy — so the
    transfer overlaps whatever the worker is running."""
    import jax

    from obs_color_monitor_tpu.pipeline import NV12Frame

    H, W = 16, 32
    b = rng.integers(0, 256, (H * 3 // 2, W), dtype=np.uint8)
    his = Histogram(HistogramConfig())
    drv = PipelineDriver(his._hub)  # not started: frame stays queued
    assert drv.push_nv12(b[:H], b[H:])
    queued = drv.queue.pop(timeout=1.0)
    assert isinstance(queued, NV12Frame)
    assert isinstance(queued.y, jax.Array) and isinstance(queued.uv, jax.Array)
    np.testing.assert_array_equal(np.asarray(queued.y), b[:H])
    np.testing.assert_array_equal(np.asarray(queued.uv), b[H:])


def test_zebra_scope_animates(frame):
    zb = Zebra()
    zb.push_frame(frame)
    img0 = zb.render()
    assert img0 is not None
    tm0 = zb.tm
    zb.push_frame(frame)
    assert zb.tm > tm0  # stripe clock advanced (src/zebra.c:660-666)


def test_dock_composite(frame):
    dock = Dock()
    dock.push_frame(frame)
    dock.push_frame(frame)  # interleave default 1: 2nd frame processes? (1st does)
    img = dock.render(width=256, height=900)
    assert img.shape == (900, 256, 4)
    assert (img[..., 3] == 255).all()
    # something was drawn
    assert img[..., :3].sum() > 0
    # default dock mirrors ScopeWidget::default_properties
    # (scope-widget.cpp:496-506): ROI preview + 5 scopes, focus peaking off
    assert dock.shown("roi") and dock.shown("vectorscope")
    assert not dock.shown("focuspeaking")


def test_dock_shared_capture_counts(frame):
    """Dock scopes see the same frame: histogram == golden of scaled frame."""
    dock = Dock(roi=ROIConfig(target_scale=2, interleave=0))
    dock.push_frame(frame)
    scaled = golden.downscale(frame, 2)
    want = golden.histogram_counts(scaled, None, Components.RGB)
    np.testing.assert_array_equal(dock.histogram.counts(), want)
    want_vs = golden.vectorscope_counts(
        golden.rgb_to_yuv_u8(scaled, Colorspace.BT709)
    )
    np.testing.assert_array_equal(np.asarray(dock.vectorscope._read()), want_vs)


def test_scope_update_settings(frame):
    vs = Vectorscope()
    vs.update(intensity=100)
    assert vs.config.intensity == 100
    with pytest.raises(KeyError):
        vs.update(nonexistent=1)
    # clamping like the reference property ranges
    vs.update(intensity=0)
    assert vs.config.intensity == 1


def test_property_clamps_reference_ranges():
    """Property ranges match the reference dialogs: graticule_lines is a
    fixed list {0,1,2,4,5,10} (src/waveform.c:160-168), level_fixed_value
    50..65535 and level_ratio_value 1..100 (src/histogram.c:263-265)."""
    from obs_color_monitor_tpu.config import HistogramConfig, WaveformConfig

    for given, want in ((3, 2), (7, 5), (8, 10), (-1, 0), (100, 10), (5, 5)):
        assert WaveformConfig(graticule_lines=given).graticule_lines == want
    hc = HistogramConfig(level_fixed_value=10, level_ratio_value=0.1)
    assert hc.level_fixed_value == 50
    assert hc.level_ratio_value == 1.0
    hc = HistogramConfig(level_fixed_value=100000, level_ratio_value=1000.0)
    assert hc.level_fixed_value == 65535
    assert hc.level_ratio_value == 100.0


def test_bypass_mode(frame):
    """Bypass renders the scaled captured frame (reference cm_bypass_render,
    src/common.c:413-428)."""
    from obs_color_monitor_tpu.config import HistogramConfig as HC

    his = Histogram(HC(target_scale=2, bypass=True))
    his.push_frame(frame)
    img = his.render()
    want = golden.downscale(frame, 2)
    np.testing.assert_array_equal(img, want)
    # turning bypass off goes back to bars
    his.update(bypass=False)
    his.push_frame(frame)
    his._hub.tick()
    assert his.render().shape == (200, 256, 4)


def test_profiler_probes(frame):
    """Probe names mirror the reference's ENABLE_PROFILE sections
    (src/common.c:10-21)."""
    from obs_color_monitor_tpu.pipeline import profiler

    profiler.reset()
    profiler.enable(True)
    try:
        his = Histogram(HistogramConfig(target_scale=1))
        his.push_frame(frame)
        s = profiler.summary()
        assert "render_target" in s
        assert s["render_target"]["count"] == 1
        assert any(k.startswith("surface_cb:") for k in s)
    finally:
        profiler.enable(False)
        profiler.reset()


def test_driver_survives_consumer_exception(frame, caplog):
    """A failing consumer drops the frame but keeps the pipeline alive."""
    import logging

    class Bomb(Histogram):
        def __init__(self):
            super().__init__(HistogramConfig(target_scale=1))
            self.calls = 0

        def surface_cb(self, surface):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            super().surface_cb(surface)

    bomb = Bomb()
    drv = PipelineDriver(bomb._hub)
    drv.start()
    try:
        with caplog.at_level(logging.ERROR, "obs_color_monitor_tpu.pipeline"):
            for _ in range(3):
                drv.push_frame(frame)
                time.sleep(0.05)
            drv.flush()
    finally:
        drv.stop()
    assert drv.n_errors >= 1
    assert bomb.calls >= 2  # thread kept going after the failure


def test_pipeline_driver_restart(frame):
    """stop() then start() must process frames again (a restarted driver
    gets a fresh queue — the closed one rejects every push forever)."""
    his = Histogram(HistogramConfig(target_scale=1))
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        assert drv.push_frame(frame)
        drv.flush()
        n1 = drv.hub.frames_processed
        assert n1 >= 1
        drv.stop()
        assert not drv.push_frame(frame)  # closed queue drops
        drv.start()
        assert drv.push_frame(frame)  # fresh queue accepts again
        drv.flush()
        assert drv.hub.frames_processed > n1
    finally:
        drv.stop()


def test_driver_dock_mode_restart(rng):
    """A restarted dock-mode driver keeps serving the stream route: the
    warmed stream program survives stop()/start() (it is dock state, not
    driver state), panels keep flowing to on_panel, and frame counting
    continues."""
    from obs_color_monitor_tpu.config import DockConfig

    f = rng.integers(0, 256, size=(48, 96, 4), dtype=np.uint8)
    f[..., 3] = 255
    dock = Dock(DockConfig(show_roi=False),
                roi=ROIConfig(interleave=0, target_scale=1))
    panels = []
    drv = PipelineDriver(dock=dock, on_panel=lambda p: panels.append(p))
    drv.start()
    try:
        for _ in range(3):
            assert drv.push_frame(f)
            drv.flush()
        n_progs = len(dock._stream_fns)
        drv.stop()
        assert not drv.push_frame(f)  # closed queue drops
        drv.start()
        assert drv.push_frame(f)
        drv.flush()
    finally:
        drv.stop()
    assert len(panels) == 4
    assert dock.hub.frames_processed == 4
    assert len(dock._stream_fns) == n_progs == 1  # no rebuild across restart


def test_pipeline_driver_flush_counts_inflight(frame):
    """flush() waits for frames the worker has POPPED but not yet finished
    (the queue-length check alone can't see them)."""
    his = Histogram(HistogramConfig(target_scale=1))
    drv = PipelineDriver(his._hub)
    drv.start()
    try:
        for _ in range(4):
            drv.push_frame(frame)
        drv.flush()
        # every accepted push was fully consumed by flush-return time
        assert drv._consumed == drv.queue.n_pushed
        assert drv.hub.frames_processed + drv.hub.frames_skipped == drv._consumed
    finally:
        drv.stop()
