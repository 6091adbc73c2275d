"""Time two exact XLA forms of each statistic on the accelerator.

For the vectorscope, the waveform and the histogram this times

  * the one-hot form: one-hot operands reduced by an int8 matmul or a sum
    (the formulation the statistics were first written in),
  * the scatter form: a plain ``.at[].add`` into int32 bins, and
  * the forms ``ops.stats`` keeps (marked "kept"): the vectorscope into 32
    column-chosen private bin copies, the histogram as the waveform's
    column sum,

on a stack of 4K-at-scale-2 capture frames (1920x1080), for two contents:
uniform random values, and a flat field where every pixel lands in one bin
(the worst case for atomics).  Both forms are exact (int32 sums do not
depend on order); each is checked against the NumPy golden model first.

Usage: python benchmarks/stat_forms.py [--frames K]
Prints one JSON line per (statistic, form, content) and fails without an
accelerator.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from obs_color_monitor_tpu import golden  # noqa: E402
from obs_color_monitor_tpu.colorspace import Colorspace  # noqa: E402
from obs_color_monitor_tpu.config import Components  # noqa: E402
from obs_color_monitor_tpu.ops import stats  # noqa: E402

H, W = 1080, 1920  # 3840x2160 at target_scale=2
_CHUNK = 8192
_WV_ROWS = 8
_HI_CHUNK = 65536


def _one_hot(vals, n, dtype=jnp.int8):
    iota = jax.lax.broadcasted_iota(jnp.int32, vals.shape + (n,), vals.ndim)
    return (vals.astype(jnp.int32)[..., None] == iota).astype(dtype)


def _chunks(x, chunk):
    """Flatten the trailing (H, W) of x and pad to whole chunks; returns
    (chunked x, chunked validity)."""
    x = x.reshape(x.shape[:-2] + (-1,))
    n = x.shape[-1]
    pad = (-n) % chunk
    valid = jnp.arange(n + pad) < n
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    return (x.reshape(x.shape[:-1] + (-1, chunk)),
            valid.reshape(-1, chunk))


def vs_onehot(yuv):
    uv, valid = _chunks(yuv[1:], _CHUNK)

    def body(acc, args):
        (u, v), m = args
        a = _one_hot(u, 256) * m[:, None].astype(jnp.int8)
        b = _one_hot(v, 256)
        return acc + jax.lax.dot_general(
            b, a, (((0,), (0,)), ((), ())), preferred_element_type=jnp.int32
        ), None

    return jax.lax.scan(
        body, jnp.zeros((256, 256), jnp.int32),
        ((uv[0], uv[1]), valid),
    )[0]


def vs_scatter(yuv):
    idx = yuv[2].astype(jnp.int32) * 256 + yuv[1].astype(jnp.int32)
    return (
        jnp.zeros(256 * 256, jnp.int32)
        .at[idx.reshape(-1)]
        .add(1, mode="promise_in_bounds")
        .reshape(256, 256)
    )


def vs_scatter_copies(yuv, copies=32, inner=True):
    """Scatter into ``copies`` private copies of the bins, chosen by the
    pixel's column, then sum them: a flat field's updates spread over
    ``copies`` addresses instead of one.  inner=True keeps the copies of a
    bin adjacent in memory (the library form, ops.stats, at 32 copies),
    False puts each copy in its own 256 KiB block."""
    x = jax.lax.broadcasted_iota(jnp.int32, yuv.shape[1:], 1) % copies
    idx = yuv[2].astype(jnp.int32) * 256 + yuv[1].astype(jnp.int32)
    idx = idx * copies + x if inner else x * 65536 + idx
    bins = (
        jnp.zeros(65536 * copies, jnp.int32)
        .at[idx.reshape(-1)]
        .add(1, mode="promise_in_bounds")
    )
    if inner:
        return bins.reshape(256, 256, copies).sum(axis=-1)
    return bins.reshape(copies, 256, 256).sum(axis=0)


def wv_onehot(data, mask):
    h, w = data.shape[1], data.shape[2]
    pad = (-h) % _WV_ROWS
    d = jnp.pad(data, ((0, 0), (0, pad), (0, 0)))
    m = jnp.pad(mask, ((0, pad), (0, 0)))
    d = d.reshape(3, -1, _WV_ROWS, w).swapaxes(0, 1)
    m = m.reshape(-1, _WV_ROWS, w)

    def body(acc, dm):
        oh = _one_hot(dm[0], 256) * dm[1][None, :, :, None].astype(jnp.int8)
        return acc + jnp.moveaxis(oh.sum(axis=1, dtype=jnp.int32), -1, 1), None

    return jax.lax.scan(body, jnp.zeros((3, 256, w), jnp.int32), (d, m))[0]


def hi_onehot(data, mask):
    d, valid = _chunks(data, _HI_CHUNK)
    m, _ = _chunks(mask[None], _HI_CHUNK)
    m = (m[0] & valid).astype(jnp.int8)

    def body(acc, dm):
        d, mm = dm
        outs = []
        for ch in range(3):
            hi = _one_hot(d[ch] >> 4, 16) * mm[:, None]
            lo = _one_hot(d[ch] & 15, 16)
            outs.append(jax.lax.dot_general(
                hi, lo, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            ).reshape(256))
        return acc + jnp.stack(outs), None

    return jax.lax.scan(
        body, jnp.zeros((3, 256), jnp.int32), (d.swapaxes(0, 1), m)
    )[0]


def hi_scatter(data, mask):
    c = jax.lax.broadcasted_iota(jnp.int32, data.shape, 0)
    idx = c * 256 + data.astype(jnp.int32)
    upd = jnp.broadcast_to(mask, data.shape).astype(jnp.int32)
    return (
        jnp.zeros(3 * 256, jnp.int32)
        .at[idx.reshape(-1)]
        .add(upd.reshape(-1), mode="promise_in_bounds")
        .reshape(3, 256)
    )


def make_frames(content: str, k: int, seed: int = 0) -> np.ndarray:
    """(k, H, W, 4) u8 capture frames: 'random' (about 5% alpha-0 pixels)
    or 'flat' (one RGBA value per frame, opaque)."""
    rng = np.random.default_rng(seed)
    if content == "random":
        f = rng.integers(0, 256, (k, H, W, 4), np.uint8)
        f[..., 3] = np.where(rng.random((k, H, W)) < 0.05, 0, 255)
        return f
    f = np.empty((k, H, W, 4), np.uint8)
    for i in range(k):
        f[i] = (*rng.integers(0, 256, 3), 255)
    return f


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if jax.devices()[0].platform == "cpu":
        sys.exit("stat_forms.py measures the accelerator; no accelerator found")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    from obs_color_monitor_tpu.ops.convert import rgb_to_yuv_planes

    forms = {
        "vectorscope": {
            "onehot": vs_onehot,
            "scatter": vs_scatter,
            "scatter_16_inner": lambda y: vs_scatter_copies(y, 16),
            "scatter_32_inner (kept)": stats.vectorscope_counts_i32,
            "scatter_64_inner": lambda y: vs_scatter_copies(y, 64),
            "scatter_32_outer": lambda y: vs_scatter_copies(y, inner=False),
        },
        "waveform": {"onehot": wv_onehot,
                     "scatter (kept)": stats.waveform_counts_i32},
        "histogram": {
            "onehot": hi_onehot,
            "scatter": hi_scatter,
            "from_waveform (kept)": stats.histogram_counts,
        },
    }
    for content in ("random", "flat"):
        host = make_frames(content, args.frames)
        frames = jax.device_put(np.ascontiguousarray(np.moveaxis(host, -1, 1)))
        yuv_all = jax.jit(jax.vmap(lambda p: rgb_to_yuv_planes(p, cs=2)))(frames)
        g_yuv = golden.rgb_to_yuv_u8(host[0], Colorspace.BT709)
        want = {
            "vectorscope": np.bincount(
                g_yuv[..., 2].astype(np.int64).ravel() * 256
                + g_yuv[..., 1].ravel(), minlength=65536,
            ).reshape(256, 256),
            "waveform": None,
            "histogram": golden.histogram_counts(host[0], None, Components.RGB),
        }
        g_wv = golden.waveform_counts(host[0], None, Components.RGB)
        for stat, by_form in forms.items():
            for form, fn in by_form.items():
                if stat == "vectorscope":
                    one = lambda p, y, fn=fn: fn(y)
                else:
                    one = lambda p, y, fn=fn: fn(p[:3], p[3] != 0)
                run = jax.jit(lambda ps, ys, one=one: jax.lax.map(
                    lambda py: one(*py), (ps, ys)))
                t0 = time.perf_counter()
                out = run(frames, yuv_all)
                out.block_until_ready()
                compile_s = time.perf_counter() - t0
                got = np.asarray(out[0])
                if stat == "waveform":
                    ok = np.array_equal(np.minimum(got, 255).astype(np.uint8), g_wv)
                else:
                    ok = np.array_equal(got.astype(np.int64),
                                        want[stat].astype(np.int64))
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    run(frames, yuv_all).block_until_ready()
                    ts.append(time.perf_counter() - t0)
                ms = float(np.median(ts)) * 1e3 / args.frames
                print(json.dumps({
                    "stat": stat, "form": form, "content": content,
                    "ms_per_frame": ms, "exact": bool(ok),
                    "first_call_s": compile_s,
                    "device": jax.devices()[0].device_kind,
                }), flush=True)
                if not ok:
                    sys.exit(f"{stat}/{form}/{content} differs from golden")


if __name__ == "__main__":
    main()
