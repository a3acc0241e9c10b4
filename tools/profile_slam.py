"""Device-trace profiling of the streaming SLAM step.

Runs the bench-slam shape (per-particle maps, scan merges) under
``jax.profiler.trace`` and aggregates the device X-events by op name so
kernel work on the mapping path targets the measured bottleneck.

Usage:  python tools/profile_slam.py [--particles 4096] [--cpu]
Prints the top-k ops by total device time plus the step total.
"""

import argparse
import dataclasses
import glob
import gzip
import json
import os
import tempfile
import time
from collections import defaultdict


def aggregate_trace(trace_dir, top=30):
    """Aggregate the chrome-trace events from a jax.profiler trace dir."""
    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    with gzip.open(path, "rt") as fh:
        data = json.load(fh)
    # device-lane complete events: pid whose process_name names a device
    pid_names = {}
    for ev in data["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev["pid"]] = ev["args"].get("name", "")
    dev_pids = {
        p for p, n in pid_names.items()
        if "/device" in n.lower() or "Device" in n
    }
    agg = defaultdict(lambda: [0.0, 0])
    total = 0.0
    for ev in data["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("pid") not in dev_pids:
            continue
        name = ev.get("name", "?")
        dur = ev.get("dur", 0) / 1e3  # us -> ms
        agg[name][0] += dur
        agg[name][1] += 1
        total += dur
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return rows, total, path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "slam_trace"))
    ap.add_argument("--wheel-delta", type=float, default=0.3,
                    dest="wheel_delta",
                    help="wheel advance per step (10 frames); ~4.7 "
                    "makes the 0.1 m reference measurement gate fire "
                    "EVERY frame (measurement-heavy platforms)")
    ap.add_argument("--gate", default="",
                    help="'dist,angle_deg' override of the "
                    "measurement gate (reference default 0.1,10); "
                    "'0,0' = fire every frame regardless of speed")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import streaming
    from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu.models.asguard import AsguardSim

    n = args.particles

    def terrain(x, y):
        return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
            0.5 * np.asarray(y)
        )

    gate_kw = {}
    if args.gate:
        from slam_eslam_tpu.config import UpdateThreshold

        d, a = (float(v) for v in args.gate.split(","))
        gate_kw["measurement_threshold"] = UpdateThreshold(
            d, np.deg2rad(a))
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        grid_size=10.0, grid_resolution=0.25,
        map_pool_blocks=4 * n, map_chain_length=3,
        map_pool_color=False,
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2
        ),
        **gate_kw,
    )
    f = EmbodiedSlamFilter(config=cfg)
    sim = AsguardSim(terrain=terrain)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False)
    q = np.array([1.0, 0, 0, 0], np.float32)
    n_rays = 64
    scan_meta = (jnp.asarray(-np.pi / 2, jnp.float32),
                 jnp.asarray(np.pi / n_rays, jnp.float32))
    frame_list = []

    def cb(s):
        frame_list.append([
            s.contact_state(), jnp.asarray(q),
            jnp.asarray(s.position, jnp.float32),
            jnp.full((n_rays,), 2.0, jnp.float32),
            scan_meta, jnp.asarray(False),
        ])

    for _ in range(args.steps):
        sim.step(wheel_delta=args.wheel_delta, on_substep=cb)
        frame_list[-1][5] = jnp.asarray(True)
    stacked = streaming.stack_frames([tuple(fr) for fr in frame_list])
    frames = len(frame_list)

    carry0 = streaming.StreamingState.create(f.state, f.pool)
    run = streaming.make_slam_scan_runner(cfg, laser2body=(np.eye(3),
                                                           np.zeros(3)))
    t0 = time.time()
    carry, aux = run(carry0, stacked)
    jax.block_until_ready(aux["centroid"])
    print(f"compile+first: {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    carry, aux = run(carry0, stacked)
    jax.block_until_ready(aux["centroid"])
    dt = time.time() - t0
    print(f"steady: {dt * 1e3:.1f} ms for {frames} frames "
          f"({frames / dt:.1f} fps); "
          f"measurement fired {int(np.asarray(aux['updated']).sum())}"
          f"/{frames}, mapped {int(np.asarray(aux['mapped']).sum())}",
          flush=True)

    with jax.profiler.trace(args.trace_dir):
        carry, aux = run(carry0, stacked)
        jax.block_until_ready(aux["centroid"])

    rows, total, path = aggregate_trace(args.trace_dir, top=args.top)
    print(f"trace: {path}\ntotal device time: {total:.2f} ms")
    for name, (ms, cnt) in rows:
        print(f"{ms:9.3f} ms  x{cnt:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
