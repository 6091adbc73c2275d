"""Pipeline driver: ingest thread + bounded queue + async device dispatch.

The reference pipeline is: graphics thread renders + stages (GPU->CPU copy
enqueued), a per-source pthread maps the staging surface and runs the CPU
accumulators, results publish through a double buffer (reference
src/common.c:223-403, SURVEY.md §3.2).  The device-side equivalent keeps the
same *shape* — producer, bounded queue with drop, consumer, double-buffered
publication — but the consumer merely *dispatches* the fused device pass
(JAX is async; the device runs ahead of the host) and publication happens
when results are consumed.

``jax.block_until_ready`` is called only at the sink (render/metrics), never
per frame in the hot path.
"""

from __future__ import annotations

import logging
import threading
from typing import NamedTuple, Optional

import jax
import numpy as np

from ..models.base import CaptureHub
from . import profiler
from .queue import DEFAULT_QUEUE_DEPTH, FrameQueue

log = logging.getLogger("obs_color_monitor_tpu.pipeline")


class NV12Frame(NamedTuple):
    """A wire-format frame in the driver queue: raw (y, uv) planes +
    decode colorimetry (``shift`` > 0 = 16-bit P010-family planes).  The
    planes are already device-resident by the time this sits in the
    queue — push_nv12 stages the upload on the PRODUCER thread, the
    analog of the reference's graphics thread staging the texture while
    the pipeline thread still works the previous frame
    (src/common.c:335-403), so the transfer overlaps the previous frame's
    device work."""

    y: object
    uv: object
    cs: Optional[int]
    shift: int


class PipelineDriver:
    """Drives a CaptureHub — or a whole Dock — from a frame stream.

    push_frame() is the producer side (non-blocking, drop-on-full); a worker
    thread dispatches the hub's fused pass in frame order.  Mirrors the
    reference's one-pipeline-thread-per-source design
    (src/common.c:430-454), generalized to the shared-hub case.

    With ``dock=`` the worker consumes through the Dock's push/render
    deferral instead of the bare hub fan-out: each frame runs
    ``dock.push_frame`` + ``dock.render_async`` — push/render alternation
    is exactly what engages the ONE-program stream step (analysis + hub
    publication + every scope render + composite in a single cached device
    program per frame, models/dock.py), so a driver-fed dock gets the fast
    streaming path the reference's single pipeline gets by construction
    (src/common.c:375-403).  ``on_panel`` (optional) receives each
    device-resident panel on the worker thread — a sink can fetch/encode
    it (blocking there is fine; dispatch already happened).  The worker
    serializes all dock access under the driver lock; cross-thread reads
    should use the scopes' double-buffered accessors (counts()/render()),
    which is what they exist for.

    The CLI ``--live`` loop (``__main__.py``) deliberately does NOT sit
    on this driver: its readback pipelining (publish frame i−1 while
    frame i's host copy is in flight) and upload-before-publish ordering
    need per-frame index bookkeeping across produce/publish, which the
    fire-and-forget ``on_panel`` contract would hide.  Both stacks share
    the same one-program consume path; the driver is the embedding
    surface (queue + thread + drop/backpressure), the CLI loop is the
    paced-source surface.
    """

    def __init__(
        self,
        hub: Optional[CaptureHub] = None,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        native_queue_shape: Optional[tuple[int, ...]] = None,
        *,
        dock=None,
        on_panel=None,
    ):
        if (hub is None) == (dock is None):
            raise ValueError("pass exactly one of hub= or dock=")
        if dock is not None:
            hub = dock.hub
        self._dock = dock
        self._on_panel = on_panel
        self.hub = hub
        self._queue_depth = queue_depth
        self._native_queue_shape = native_queue_shape
        self.queue = self._make_queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()
        self._state_lock = threading.Lock()  # start/stop mutual exclusion
        self._queue_closed = False
        self._consumed = 0  # frames fully handled by the worker (see flush)
        self.n_errors = 0

    def _make_queue(self):
        if self._native_queue_shape is not None:
            # fixed-shape ingest -> use the C++ queue (one memcpy, no GIL
            # contention with the consumer thread)
            from ..runtime import NativeFrameQueue

            return NativeFrameQueue(self._queue_depth, self._native_queue_shape)
        return FrameQueue(self._queue_depth)

    # -- lifecycle (reference start/stop_pipeline_thread) -------------------
    def start(self) -> None:
        with self._state_lock:
            if self._running:
                return
            if self._queue_closed:
                # a closed queue rejects every push forever — a restarted
                # driver needs a fresh one (queue counters restart with it,
                # so the consumed counter restarts too to keep flush exact)
                self.queue = self._make_queue()
                self._queue_closed = False
                self._consumed = 0
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="color-monitor", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._state_lock:
            if not self._running:
                return
            self._running = False
            self.queue.close()
            self._queue_closed = True
            if self._thread is not None:
                self._thread.join()
                self._thread = None

    # -- producer ------------------------------------------------------------
    def push_frame(self, frame: np.ndarray | jax.Array) -> bool:
        """Non-blocking enqueue; False = dropped (queue full)."""
        return self.queue.push(frame)

    def push_nv12(self, y, uv, cs: Optional[int] = None, shift: int = 0) -> bool:
        """Enqueue a wire-format NV12/P010 frame (raw planes, decode on
        device — see Dock.push_nv12).  The host→device upload is issued
        HERE, on the producer thread, before the frame enters the queue: the
        transfer overlaps whatever program the worker's previous frame is
        running, which is the reference's stage-on-the-graphics-thread
        pattern
        (src/common.c:335-403).  Non-blocking; False = dropped."""
        if self._native_queue_shape is not None:
            raise ValueError(
                "push_nv12 needs the object queue; the native fixed-shape "
                "queue carries single packed frames only"
            )
        from ..ops.convert import nv12_device_planes

        y, uv = nv12_device_planes(y, uv)  # staged upload (async dispatch)
        return self.queue.push(NV12Frame(y, uv, cs, int(shift)))

    # -- consumer ------------------------------------------------------------
    def _loop(self) -> None:
        log.debug("entering pipeline thread")  # reference common.c:376
        while self._running:
            frame = self.queue.pop(timeout=0.1)
            if frame is None:
                continue
            try:
                with self._lock:
                    with profiler.probe("pipeline_loop"):
                        self._consume(frame)
            except Exception:
                # a consumer failure must not kill the pipeline thread;
                # the frame is dropped and counted
                self.n_errors += 1
                log.exception("pipeline frame failed (frame dropped)")
            finally:
                # counted only once the frame is fully handled — flush()
                # compares this against the queue's accepted-push count,
                # which a queue-length check can't do (a popped-but-not-
                # yet-processed frame is invisible to both the length
                # and the lock)
                self._consumed += 1
        log.debug("leaving pipeline thread")

    def _consume(self, frame) -> None:
        """One frame through the configured consumer: the dock's
        push/render deferral (one-program stream route) or the bare hub
        fan-out (dock.push_frame ticks the hub itself)."""
        if self._dock is not None:
            if isinstance(frame, NV12Frame):
                self._dock.push_nv12(
                    frame.y, frame.uv, cs=frame.cs, shift=frame.shift
                )
            else:
                self._dock.push_frame(frame)
            panel = self._dock.render_async()
            if panel is not None and self._on_panel is not None:
                self._on_panel(panel)
        else:
            self.hub.tick()
            if isinstance(frame, NV12Frame):
                self.hub.process_nv12(
                    frame.y, frame.uv, cs=frame.cs, shift=frame.shift
                )
            else:
                self.hub.process(frame)

    # -- synchronous convenience ----------------------------------------------
    def process_now(self, frame) -> None:
        """Run one frame synchronously through the configured consumer
        (tests/tools)."""
        with self._lock:
            self._consume(frame)

    def flush(self, timeout: float = 10.0) -> None:
        """Wait until the queue drains and in-flight work lands.

        "Landed" = the worker finished every frame the queue ACCEPTED
        (``_consumed`` catches up to ``n_pushed``); then the last published
        device results are synced.  The sync is ``block_until_ready`` —
        correctness never depends on it (JAX arrays are futures: any later
        read blocks until the real value), it only bounds WHEN in-flight
        device work finishes."""
        import time

        t0 = time.monotonic()
        while (
            self._running
            and self._consumed < self.queue.n_pushed
            and time.monotonic() - t0 < timeout
        ):
            time.sleep(0.001)
        with self._lock:
            s = self.hub.last_surface
        if s is not None:
            for leaf in jax.tree_util.tree_leaves(s.result):
                leaf.block_until_ready()

    # -- metrics ---------------------------------------------------------------
    @property
    def stats(self) -> dict:
        return {
            "pushed": self.queue.n_pushed,
            "dropped": self.queue.n_dropped,
            "processed": self.hub.frames_processed,
            "interleave_skipped": self.hub.frames_skipped,
            "errors": self.n_errors,
        }
