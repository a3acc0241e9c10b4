"""Stage-level profiling of the filter step on the current backend.

Times project / weighting / resample / full-step separately and dumps
XLA cost analysis, so kernel work targets the measured bottleneck
rather than a guess.  Run on the GPU (default env) or CPU (--cpu).
"""

import argparse
import dataclasses
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--contact-cap", type=int, default=0,
                    dest="contact_cap")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.core import filter as pf
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import sim as simlib
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

    n_contacts = args.contact_cap or 20
    state = pe.PoseEstimatorState.create(cfg, n_contacts)
    particles = pe.init_gaussian(
        jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05,
        0.2, 0.3,
    )
    o = dataclasses.replace(
        state.odometry,
        delta_xy=jnp.array([0.0, 0.05]),
        sigma_xy=jnp.array([0.01, 0.02]),
        sigma_yaw=jnp.asarray(0.01),
        sigma_z=jnp.asarray(0.01),
        initialized=jnp.ones((), bool),
    )
    state = dataclasses.replace(state, particles=particles, odometry=o)

    sim = simlib.TrajectorySim(terrain, speed=0.05)
    sim.step()
    cs = sim.contact_state()
    if args.contact_cap:
        cs = cs.compact(args.contact_cap)
    q = geometry.quat_identity()

    stages = {
        "project": jax.jit(lambda s: pe.project(s, q, cfg)),
        "update_weights": jax.jit(
            lambda s: pe.update_weights(s, cs, q, lookup, cfg)[0]
        ),
        "update_full": jax.jit(
            lambda s: pe.update(s, cs, q, lookup, cfg)[0]
        ),
        "resample_only": jax.jit(
            lambda s: pf.take(
                s.particles,
                pf.resample_stratified(
                    jax.random.PRNGKey(0),
                    pf.normalize_weights(s.particles.weight)[0],
                    n,
                ),
            )
        ),
        "rng_only": jax.jit(
            lambda s: jax.random.normal(s.key, (n, 2))
        ),
        "centroid": jax.jit(lambda s: pe.centroid(s.particles, q)),
    }

    print(f"devices: {jax.devices()}  particles: {n}")
    for name, fn in stages.items():
        lowered = fn.lower(state)
        compiled = lowered.compile()
        out = fn(state)
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = fn(state)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        ca = compiled.cost_analysis() or {}
        flops = ca.get("flops", float("nan"))
        bytes_ = ca.get("bytes accessed", float("nan"))
        print(
            f"{name:>16}: {best * 1e3:8.2f} ms   "
            f"flops={flops:.3g} bytes={bytes_:.3g}"
        )


if __name__ == "__main__":
    main()
