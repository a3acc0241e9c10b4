"""Device-trace profiling of the full filter step (bench.py shape).

Aggregates per-op device time over the scan so each fusion of the
step (gather + contact fold, resample, centroid) is attributable.

Usage: python tools/profile_filter.py [--particles 100000]
"""

import argparse
import dataclasses
import os
import tempfile
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--contact-cap", type=int, default=8,
                    dest="contact_cap")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "filter_trace"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.filter import step as steplib
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import sim as simlib
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from profile_slam import aggregate_trace

    from slam_eslam_tpu.utils import geometry

    n = args.particles
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
    )

    def terrain(x, y):
        return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
            0.9 * np.asarray(y)
        )

    grid = simlib.terrain_grid(
        terrain, nx=400, ny=400, resolution=0.05, origin=(-10.0, -10.0)
    )
    lookup = make_lookup(cfg, grid)
    state = pe.PoseEstimatorState.create(cfg, args.contact_cap)
    particles = pe.init_gaussian(
        jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05,
        0.2, 0.3,
    )
    state = dataclasses.replace(state, particles=particles)

    sim = simlib.TrajectorySim(terrain, speed=0.05)
    css, qs = [], []
    for _ in range(args.steps):
        sim.step()
        cs = sim.contact_state(noise=0.005).compact(args.contact_cap)
        css.append(cs)
        qs.append(np.asarray(geometry.quat_from_yaw(np.float32(0.0))))
    contact_states = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *css
    )
    orientations = jnp.asarray(np.stack(qs), jnp.float32)

    run = steplib.make_scan_runner(cfg, lookup)
    t0 = time.time()
    out_state, cents = run(state, contact_states, orientations)
    jax.block_until_ready(cents)
    print(f"compile+first: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    out_state, cents = run(state, contact_states, orientations)
    jax.block_until_ready(cents)
    dt = time.time() - t0
    print(f"steady: {dt * 1e3:.2f} ms for {args.steps} steps "
          f"({dt / args.steps / (n * args.contact_cap) * 1e9:.2f} "
          "ns/query)", flush=True)

    with jax.profiler.trace(args.trace_dir):
        out_state, cents = run(state, contact_states, orientations)
        jax.block_until_ready(cents)
    rows, total, path = aggregate_trace(args.trace_dir, top=args.top)
    print(f"trace: {path}\ntotal device time: {total:.2f} ms")
    for name, (ms, cnt) in rows:
        print(f"{ms:9.3f} ms  x{cnt:<5d} {name[:110]}")


if __name__ == "__main__":
    main()
