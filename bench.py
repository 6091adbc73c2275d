"""Benchmark: all six scopes, fused, on 4K frames, one card.

Runs ``make_full_step`` (statistics at target_scale=2, overlays at full
resolution — the reference's default settings) over device-resident 4K
frames in the packed u32 form, inside one jitted ``fori_loop`` of N frames,
and times the loop on the host clock up to ``block_until_ready``.  Prints
the card's name and power limit, then ONE JSON line:
    {"metric": ..., "value": fps, "unit": "fps", "ms_per_frame": ..., "device": ...}

Keeping the work honest:
  * anti-hoist: iteration i reads frame ``i % 2`` of two distinct
    device-resident frames, so nothing that reads the frame is
    loop-invariant (the dynamic index fuses into its consumer; no copy);
  * liveness: every output is fully checksummed, so XLA can drop none of
    the step.

Usage: python bench.py [frames_per_loop]   (fails without an accelerator)
"""

import json
import subprocess
import sys
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from obs_color_monitor_tpu.api import make_full_step
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform == "cpu":
        sys.exit("bench.py measures the accelerator; JAX found none")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)

    H, W = 2160, 3840  # 4K
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    reps = 7

    step = make_full_step(H, W, cs=Colorspace.BT709, scale=2,
                          input_format="packed")

    def checksum(out):
        return sum(jnp.sum(leaf.astype(jnp.int32)) for leaf in out)

    @jax.jit
    def run(frames):
        def body(i, acc):
            out = step(frames[i % 2], i.astype(jnp.float32) * 0.0667)
            return acc + checksum(out)

        return jax.lax.fori_loop(0, n, body, jnp.int32(0))

    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, size=(2, H, W, 4), dtype=np.uint8)
    rgba[..., 3] = np.where(rng.random((2, H, W)) < 0.05, 0, 255)
    frames = jax.device_put(rgba.view(np.uint32).reshape(2, H, W))

    t0 = time.perf_counter()
    run(frames).block_until_ready()  # compile + warm-up
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(frames).block_until_ready()
        times.append(time.perf_counter() - t0)
    ms = float(np.median(times)) * 1e3 / n
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "4K_frames_per_sec_all6_scopes_1card",
        "value": 1e3 / ms,
        "unit": "fps",
        "ms_per_frame": ms,
        "ms_per_frame_min": min(times) * 1e3 / n,
        "frames_per_loop": n,
        "compile_s": compile_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
