"""obs_color_monitor_tpu — a video-scope framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
obs-color-monitor OBS Studio plugin (reference: norihiro/obs-color-monitor):
six video-analysis scopes — vectorscope, waveform, histogram, zebra,
false color, focus peaking — plus a shared ROI/scale-down capture hub and a
composite "dock" view.

Where the reference renders on the GPU, reads pixels back to the CPU and
accumulates counts in scalar C loops (reference src/common.c:335-454,
src/vectorscope.c:217-238), this framework keeps frames resident in device
memory and computes every statistic on the accelerator:

  * the 256x256 CbCr vectorscope occupancy and the per-column waveform are
    int32 scatter-adds,
  * the 256-bin histograms are the waveform's column sums,
  * overlay scopes (zebra / false color / focus peaking) are fused
    elementwise/stencil ops,

all of it bit-exact against the NumPy golden model in
:mod:`obs_color_monitor_tpu.golden` (the test oracle the reference lacks).

Layout:
  golden/    NumPy golden model — exact integer semantics, the test oracle
  ops/       device ops: convert, stats, overlays, render
  models/    the scopes themselves (property model mirrors the reference)
  parallel/  device mesh, batch-DP sharding, cross-device bin merges
  pipeline/  frame queue, drop/interleave policy, double-buffering, driver
  runtime/   native (C++) host runtime: bounded frame queue, NV12 unpack
"""

from .colorspace import Colorspace, calc_colorspace
from .config import (
    VectorscopeConfig,
    WaveformConfig,
    HistogramConfig,
    ZebraConfig,
    FalseColorConfig,
    FocusPeakingConfig,
    ROIConfig,
    DockConfig,
    Components,
    DisplayMode,
    LevelMode,
)

__version__ = "0.1.0"


def make_full_step(*args, **kwargs):
    """All six scopes, one jitted program (see api.make_full_step)."""
    from .api import make_full_step as f

    return f(*args, **kwargs)


def make_dock_step(*args, **kwargs):
    """The composited dock panel as one jitted program
    (see dock_step.make_dock_step)."""
    from .dock_step import make_dock_step as f

    return f(*args, **kwargs)

__all__ = [
    "Colorspace",
    "calc_colorspace",
    "VectorscopeConfig",
    "WaveformConfig",
    "HistogramConfig",
    "ZebraConfig",
    "FalseColorConfig",
    "FocusPeakingConfig",
    "ROIConfig",
    "DockConfig",
    "Components",
    "DisplayMode",
    "LevelMode",
]
