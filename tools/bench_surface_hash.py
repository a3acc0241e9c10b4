"""SurfaceHash benchmarks.

Measures, on the current backend:

1. ``SurfaceHash.create`` at reference scale — a 400x400-cell grid x 16
   headings (the ``useShared`` precompute the reference runs on startup,
   ``SurfaceHash.hpp:155-231``): compile time and steady-state run time.
2. The in-loop cost of hash reinjection in the streaming SLAM scan:
   fps with the reinjection ``lax.cond`` compiled in vs a hash-free
   scan, at the bench SLAM shape.

Usage: python tools/bench_surface_hash.py [--cpu] [--particles 4096]
Prints one JSON line.
"""

import argparse
import dataclasses
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--grid-cells", type=int, default=400,
                    dest="grid_cells")
    ap.add_argument("--angles", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from slam_eslam_tpu.config import (Config, ContactModelConfig,
                                       SurfaceHashConfig)
    from slam_eslam_tpu.filter import streaming
    from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu.filter.surface_hash import SurfaceHash
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.models.asguard import AsguardSim

    out = {"metric": "surface_hash", "backend": jax.default_backend()}

    def terrain(x, y):
        return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
            0.9 * np.asarray(y)
        )

    # ---- 1. create at reference scale ----
    g = args.grid_cells
    grid = simlib.terrain_grid(
        terrain, nx=g, ny=g, resolution=0.05,
        origin=(-g * 0.05 / 2, -g * 0.05 / 2),
    )
    hcfg = SurfaceHashConfig(angular_steps=args.angles)
    t0 = time.time()
    h = SurfaceHash.create(hcfg, grid)
    jax.block_until_ready(h.bucket_count)
    out["create_compile_first_s"] = round(time.time() - t0, 2)
    t0 = time.time()
    h = SurfaceHash.create(hcfg, grid)
    jax.block_until_ready(h.bucket_count)
    out["create_steady_s"] = round(time.time() - t0, 3)
    out["create_cells_x_angles"] = g * g * args.angles
    out["n_valid_candidates"] = int(h.n_valid)

    # ---- 2. in-loop reinjection cost (streaming scan) ----
    n = args.particles

    def sim_terrain(x, y):
        return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
            0.5 * np.asarray(y)
        )

    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        grid_size=10.0, grid_resolution=0.25,
        map_pool_blocks=4 * n, map_chain_length=3,
        map_pool_color=False,
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2
        ),
    )
    # the hash the filter actually uses in-loop: built from a grid at
    # the SLAM scale (the shared env grid of the drive)
    env = simlib.terrain_grid(
        sim_terrain, nx=96, ny=96, resolution=0.25,
        origin=(-12.0, -12.0),
    )
    hash_cfg = SurfaceHashConfig(angular_steps=args.angles, period=10)
    hash_ = SurfaceHash.create(hash_cfg, env)

    sim = AsguardSim(terrain=sim_terrain)
    q = np.array([1.0, 0, 0, 0], np.float32)
    n_rays = 64
    scan_meta = (jnp.asarray(-np.pi / 2, jnp.float32),
                 jnp.asarray(np.pi / n_rays, jnp.float32))
    frame_list, full_cs = [], []

    def cb(s):
        cs = s.contact_state()
        full_cs.append(cs)
        frame_list.append([
            cs.compact(8), jnp.asarray(q),
            jnp.asarray(s.position, jnp.float32),
            jnp.full((n_rays,), 2.0, jnp.float32),
            scan_meta, jnp.asarray(False),
        ])

    for _ in range(args.steps):
        sim.step(wheel_delta=0.3, on_substep=cb)
        frame_list[-1][5] = jnp.asarray(True)
    stacked = streaming.stack_frames([tuple(fr) for fr in frame_list])
    frames = len(frame_list)
    odos = streaming.precompute_odometry(
        20, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *full_cs),
        jnp.stack([jnp.asarray(q)] * frames), cfg=cfg,
    )
    lb = (np.eye(3), np.zeros(3))

    for tag, hh in (("hash_off", None), ("hash_on", hash_)):
        f = EmbodiedSlamFilter(config=cfg)
        f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
               use_shared_map=False, num_contact_points=20)
        run = streaming.make_slam_scan_runner(
            cfg, laser2body=lb, hash_=hh, external_odometry=True)
        carry0 = streaming.StreamingState.create(f.state, f.pool)
        t0 = time.time()
        carry, aux = run(carry0, stacked, odos)
        jax.block_until_ready(aux["centroid"])
        out[f"{tag}_compile_first_s"] = round(time.time() - t0, 1)
        dt = float("inf")
        for _ in range(args.repeats):
            carry0 = streaming.StreamingState.create(f.state, f.pool)
            t0 = time.time()
            carry, aux = run(carry0, stacked, odos)
            jax.block_until_ready(aux["centroid"])
            dt = min(dt, time.time() - t0)
        out[f"{tag}_fps"] = round(frames / dt, 1)
    out["reinjection_cost_ms_per_frame"] = round(
        (1.0 / out["hash_on_fps"] - 1.0 / out["hash_off_fps"]) * 1e3, 3
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
