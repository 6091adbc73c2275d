"""Multi-host worker: one PROCESS of the 2-process jax.distributed test.

Run by tests/test_multihost.py as `python _multihost_worker.py <pid> <port>`.
Each process owns 2 local CPU devices (a 2-host x 2-device cluster analog: the
"rows" mesh spans 4 devices, so the spatial psum crosses the process
boundary over the distributed backend, and the focus-peaking 1-row
``ppermute`` halo is exchanged between device 1 (process 0) and device 2
(process 1) — the hop between hosts).  Every process ingests ONLY its own row block
(host-local ingest, the deployment shape of examples/multihost_distributed
.py) and asserts the replicated psum-merged statistics and its addressable
overlay shards bit-match the single-machine golden model — the SURVEY §5
"distributed communication backend" obligation, executed for real.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

N_PROC = 2


def main() -> None:
    pid, port = int(sys.argv[1]), sys.argv[2]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=N_PROC,
        process_id=pid,
    )
    assert jax.process_count() == N_PROC
    devs = jax.devices()
    local = jax.local_devices()
    assert len(devs) == 2 * N_PROC and len(local) == 2

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from obs_color_monitor_tpu import golden
    from obs_color_monitor_tpu.colorspace import Colorspace
    from obs_color_monitor_tpu.config import Components
    from obs_color_monitor_tpu.golden.reference import peaking_threshold_fixed
    from obs_color_monitor_tpu.parallel import spatial_analyze, spatial_pipeline

    # Deterministic frame both processes can derive (golden runs on the
    # FULL frame; each process only UPLOADS its own rows).  Crafted so the
    # interesting physics crosses the process boundary:
    #   * flat-gray region -> one (u, v) bin saturates only AFTER the
    #     cross-process psum (160 rows-worth > 255 globally, <= 80 per
    #     half),
    #   * bright rows at every device boundary (rows 0/16/32/48; row 32 is
    #     the PROCESS boundary) -> focus peaking needs the halo row from
    #     the other process to be bit-right.
    H, W = 64, 40
    rng = np.random.default_rng(7)
    full = rng.integers(0, 256, size=(H, W, 4), dtype=np.uint8)
    full[..., 3] = 255
    full[rng.random((H, W)) < 0.05, 3] = 0
    full[:, :10, :3] = 128  # flat gray block: global-only saturation
    full[::16, :, :3] = 255  # edges exactly at shard boundaries
    tm = 3.25
    peak_fixed = peaking_threshold_fixed(0.05)

    mesh = Mesh(np.asarray(devs).reshape(-1), ("rows",))
    sh = NamedSharding(mesh, P("rows"))
    hb = H // len(devs)  # rows per device

    # host-local ingest: this process materializes ONLY its devices' rows
    shards = []
    for j, d in enumerate(local):
        g = pid * len(local) + j  # global device index on the rows axis
        shards.append(jax.device_put(full[g * hb : (g + 1) * hb], d))
    frame = jax.make_array_from_single_device_arrays((H, W, 4), sh, shards)

    # --- spatial_analyze: psum-merged bins across the process boundary ---
    vs, hi, wv = spatial_analyze(frame, mesh, cs=2)
    yuv = golden.rgb_to_yuv_u8(full, Colorspace.BT709)
    want_vs = golden.vectorscope_counts(yuv)
    assert want_vs.max() == 255, "saturation not exercised"
    np.testing.assert_array_equal(np.asarray(vs), want_vs)
    np.testing.assert_array_equal(
        np.asarray(hi), golden.histogram_counts(full, None, Components.RGB)
    )
    np.testing.assert_array_equal(
        np.asarray(wv), golden.waveform_counts(full, None, Components.RGB)
    )

    # --- spatial_pipeline: overlays in place + cross-process fp halo ------
    vs2, hi2, wv2, zb, fc, fp = spatial_pipeline(
        frame, mesh, cs=2, tm=tm, th_low=0.5, th_high=0.9, peak_th=peak_fixed
    )
    np.testing.assert_array_equal(np.asarray(vs2), want_vs)
    np.testing.assert_array_equal(
        np.asarray(hi2), golden.histogram_counts(full, None, Components.RGB)
    )

    def check_local_rows(got, want_rgba, name):
        # overlay planes stay sharded (4, H, W) on axis 1; each process can
        # fetch only its addressable shards — compare those rows exactly
        n_checked = 0
        for s in got.addressable_shards:
            sl = s.index[1]
            np.testing.assert_array_equal(
                np.moveaxis(np.asarray(s.data), 0, -1),
                want_rgba[sl],
                err_msg=f"{name} rows {sl}",
            )
            n_checked += 1
        assert n_checked == len(local)

    check_local_rows(zb, golden.zebra(full, 0.5, 0.9, tm, Colorspace.BT709), "zebra")
    check_local_rows(fc, golden.falsecolor(full, Colorspace.BT709), "falsecolor")
    want_fp = golden.focus_peaking(full, 0.05, (1.0, 0.0, 0.0, 1.0))
    check_local_rows(fp, want_fp, "focuspeaking")
    # the crafted boundary rows actually produce cross-process peaking work
    assert (want_fp[32] != full[32]).any()

    print(f"MULTIHOST_OK p{pid}", flush=True)


if __name__ == "__main__":
    main()
