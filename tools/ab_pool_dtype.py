"""bf16-vs-f32 map-pool accuracy A/B (VERDICT r3 #6).

The bfloat16 pool (``Config.map_pool_dtype='bfloat16'``) is the
recommended 100k-particle configuration; until round 4 its only
validation was tolerance-based kernel parity.  This harness runs the
reference-style statistical experiment END TO END through the pool: the
full streaming SLAM loop (per-particle COW maps, laser merges, contact
updates — the ``bench.py --mode slam`` shape) over ``--runs`` seeded
Monte-Carlo drives on synthetic terrain, once per pool dtype, and
reports

* xy ATE of the weighted-centroid track vs the kinematic ground truth
  (mean over the final third of each drive, aggregated over runs), and
* the per-step z estimation error (mean/std over runs x steps),

mirroring the reference's exp1 z-error harness
(``/root/reference/test/testMap.cpp:358-435``, ``test/map/exp1.conf``)
with the map replaced by the pool under test.

Usage: python tools/ab_pool_dtype.py [--runs 10 --steps 120
       --particles 256] [--gpu]
Prints one JSON line with both dtypes' stats and the deltas.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def run_dtype(dtype, args, jax, jnp):
    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import streaming
    from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu.models.asguard import AsguardSim

    n = args.particles

    # rolling base + rock field: distinctive local relief gives the
    # contact model xy observability (smooth sinusoids are self-similar
    # at the robot's scale and the track drifts along-route)
    rng_rocks = np.random.default_rng(7)
    rocks = np.stack([
        rng_rocks.uniform(-6, 6, 80), rng_rocks.uniform(-6, 6, 80),
        rng_rocks.uniform(0.10, 0.30, 80),
        rng_rocks.uniform(0.25, 0.45, 80),
    ], axis=1)

    def terrain(x, y):
        x, y = np.asarray(x, float), np.asarray(y, float)
        base = (0.15 * np.sin(0.7 * x) + 0.12 * np.cos(0.5 * y))
        d2 = ((x[..., None] - rocks[:, 0]) ** 2
              + (y[..., None] - rocks[:, 1]) ** 2)
        r = (rocks[:, 2] * np.exp(-d2 / (2 * rocks[:, 3] ** 2))).sum(-1)
        return base + r

    cfg = dataclasses.replace(
        Config(),
        particle_count=n,
        min_effective=n // 2,
        grid_size=10.0,
        grid_resolution=0.25,
        map_pool_blocks=n + 64,
        map_chain_length=3,
        map_pool_color=False,
        map_pool_dtype=dtype,
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2
        ),
    )
    lb = (np.eye(3), np.zeros(3))
    run = streaming.make_slam_scan_runner(cfg, laser2body=lb,
                                          external_odometry=True)

    env = None
    if args.seed_env:
        # clone-from-env regime (PoseEstimator.cpp:47-62): every
        # particle's pool map starts as a copy of the environment grid,
        # so the contact updates localise THROUGH the pool under test
        # from step one — absolute ATE then reflects pool precision,
        # not open-loop SLAM drift
        from slam_eslam_tpu.models import sim as simlib

        env = simlib.terrain_grid(
            terrain, nx=96, ny=96, resolution=0.25,
            origin=(-12.0, -12.0),
        )

    n_rays = 64
    scan_meta = (
        jnp.asarray(-np.pi / 2, jnp.float32),
        jnp.asarray(np.pi / n_rays, jnp.float32),
    )

    ates, zerrs = [], []
    for r in range(args.runs):
        rng = np.random.default_rng(1000 + r)
        f = EmbodiedSlamFilter(config=cfg)
        sim = AsguardSim(terrain=terrain)
        f.init(
            pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
            use_shared_map=False,
            shared_grid=env,
            num_contact_points=20,
            # per-run Monte-Carlo variation comes from the filter's own
            # sampled odometry/measurement noise (fresh PRNG key) plus
            # measurement noise on the contact points below — the
            # kinematic track itself is the fixed exp1-style course
            key=jax.random.PRNGKey(3000 + r),
        )
        q = np.array([1.0, 0, 0, 0], np.float32)
        frame_list, full_cs, truth = [], [], []

        def cb(s):
            cs = s.contact_state()
            cs = dataclasses.replace(
                cs,
                position=cs.position + jnp.asarray(
                    rng.normal(0.0, args.contact_noise,
                               np.asarray(cs.position).shape),
                    jnp.float32,
                ),
            )
            full_cs.append(cs)
            cs = cs.compact(args.contact_cap)
            frame_list.append([
                cs, jnp.asarray(q),
                jnp.asarray(s.position, jnp.float32),
                jnp.full((n_rays,), 2.0, jnp.float32),
                scan_meta, jnp.asarray(False),
            ])
            truth.append(np.asarray(s.position, np.float64))

        for _ in range(args.steps):
            sim.step(wheel_delta=0.3, on_substep=cb)
            frame_list[-1][5] = jnp.asarray(True)
        stacked = streaming.stack_frames([tuple(fr) for fr in frame_list])
        # odometry from the FULL (uncompacted) contact stream —
        # compaction breaks its slot correspondence (see
        # BodyContactState.compact)
        odos = streaming.precompute_odometry(
            np.asarray(full_cs[0].contact).shape[0],
            jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *full_cs),
            jnp.stack([jnp.asarray(q)] * len(frame_list)), cfg=cfg,
        )

        carry0 = streaming.StreamingState.create(f.state, f.pool)
        carry, aux = run(carry0, stacked, odos)
        cents = np.asarray(aux["centroid"], np.float64)
        gt = np.stack(truth)
        tail = slice(len(gt) * 2 // 3, None)
        ates.append(
            float(np.mean(np.linalg.norm(
                cents[tail, :2] - gt[tail, :2], axis=1)))
        )
        zerrs.append(cents[tail, 2] - gt[tail, 2])
    zerr = np.concatenate(zerrs)
    return {
        "ate_mean": float(np.mean(ates)),
        "ate_std": float(np.std(ates)),
        "z_err_mean": float(np.mean(zerr)),
        "z_err_std": float(np.std(zerr)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--contact-cap", type=int, default=8,
                    dest="contact_cap")
    ap.add_argument("--contact-noise", type=float, default=0.005,
                    dest="contact_noise")
    ap.add_argument("--no-seed-env", action="store_false",
                    dest="seed_env", default=True,
                    help="pure-SLAM regime (blank maps): ATE then "
                    "includes open-loop drift — only the f32-vs-bf16 "
                    "DELTA is meaningful")
    ap.add_argument("--gpu", action="store_true",
                    help="run on the GPU (default: CPU — the "
                    "storage-rounding effect under test is backend-"
                    "independent)")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")

    out = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.time()
        out[dtype] = run_dtype(dtype, args, jax, jnp)
        out[dtype]["wall_s"] = round(time.time() - t0, 1)
        print(f"# {dtype}: {out[dtype]}", file=sys.stderr, flush=True)
    out["delta"] = {
        k: out["bfloat16"][k] - out["float32"][k]
        for k in ("ate_mean", "z_err_mean", "z_err_std")
    }
    out["config"] = {
        "runs": args.runs, "steps": args.steps,
        "particles": args.particles,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
