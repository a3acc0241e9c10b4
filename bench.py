"""Benchmark: full filter step throughput on one GPU.

Measures the per-frame main path of the reference pipeline
(``EmbodiedSlamFilter.cpp:353-369``: odometry + propagate + contact
weighting + resample) at benchmark scale (default 100k particles vs the
reference's 250, ``Configuration.hpp:87``), rolled over a trajectory with
``lax.scan`` so the whole run is one device dispatch.

Prints ONE JSON line: particle-updates/s (or SLAM frames/s with
``--mode slam``), with the device it ran on.  ``vs_baseline`` normalises
against the BASELINE.md target operating point — 100k particles at
real-time rate (10 Hz) = 1e6 particle-updates/s.  Exits non-zero when
JAX finds no GPU: a CPU time is not a device number.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--particles", type=int, default=None,
        help="particle count (default: 100000 for --mode filter, "
        "1024 for --mode slam — per-particle maps scale memory with "
        "particles x map area)",
    )
    # 150 steps per dispatch: the whole trajectory is one device call,
    # so per-dispatch latency amortises out of the per-step number
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument(
        "--contact-cap", type=int, default=8, dest="contact_cap",
        help="compact contact states to this many candidates "
        "(semantics-preserving when >= active count; 0 disables)",
    )
    ap.add_argument(
        "--mode", choices=["filter", "slam"], default="filter",
        help="filter: localisation step throughput (headline); "
        "slam: full EmbodiedSlamFilter loop with per-particle maps, "
        "laser merges and surface-hash reinjection",
    )
    ap.add_argument(
        "--grid-size", type=float, default=10.0, dest="grid_size",
        help="(slam mode) per-particle grid extent in metres",
    )
    ap.add_argument(
        "--grid-res", type=float, default=0.25, dest="grid_res",
        help="(slam mode) per-particle grid resolution in metres",
    )
    ap.add_argument(
        "--donate", action="store_true",
        help="(slam mode) donate the carry to the runner: halves peak "
        "HBM for large pools (each repeat rebuilds the carry)",
    )
    ap.add_argument(
        "--pool-dtype", choices=["float32", "bfloat16"],
        default="float32", dest="pool_dtype",
        help="(slam mode) storage dtype of the map pool's float patch "
        "fields; bfloat16 = 10 B/patch-slot",
    )
    ap.add_argument(
        "--visual", action="store_true",
        help="(slam mode) enable the scan-match visual update "
        "(use_visual_update; w *= match^0.1 per particle)",
    )
    ap.add_argument(
        "--chain-len", type=int, default=3, dest="chain_len",
        help="(slam mode) per-particle map chain length; steady state "
        "pins ~particles*chain_len pool blocks",
    )
    ap.add_argument(
        "--pool-blocks", type=int, default=0, dest="pool_blocks",
        help="(slam mode) map-pool block capacity (0 = 4x particles: "
        "a MOVING robot rolls blocks over and pins ~chain_len "
        "live blocks per particle plus COW copies; the old n+64 "
        "default only sufficed because the pre-round-4 harness fed "
        "the odometry compacted states and the robot never moved)",
    )
    ap.add_argument(
        "--min-effective", type=int, default=-1, dest="min_effective",
        help="ESS resampling threshold (default: particles/5; 0 "
        "disables resampling — for stage attribution)",
    )
    ap.add_argument(
        "--ablate", choices=["none", "noupdate", "nolookup"],
        default="none",
        help="stage ablation for marginal-cost attribution: "
        "'noupdate' = project+centroid only; 'nolookup' = full update "
        "math with a constant fake lookup (no map gather)",
    )
    args = ap.parse_args()
    if args.particles is None:
        args.particles = 1024 if args.mode == "slam" else 100_000

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    device = gpu_device()

    if args.mode == "slam":
        return bench_slam(args, device)

    import jax
    import jax.numpy as jnp

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.filter import step as steplib
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.utils import geometry

    n = args.particles
    cfg = dataclasses.replace(
        Config(),
        particle_count=n,
        min_effective=(n // 5 if args.min_effective < 0
                       else args.min_effective),
        contact_model=ContactModelConfig(contact_point_radius=0.0),
    )

    def terrain(x, y):
        return 0.25 * np.sin(1.3 * np.asarray(x)) + 0.2 * np.cos(
            0.9 * np.asarray(y)
        )

    # reference-default grid scale: 20 m at 0.05 m resolution
    # (Configuration.hpp:101-103)
    grid = simlib.terrain_grid(
        terrain, nx=400, ny=400, resolution=0.05, origin=(-10.0, -10.0)
    )
    # the production lookup seam (EmbodiedSlamFilter._update_fn uses the
    # same factory): exact packed gather + contact fold
    lookup = make_lookup(cfg, grid)

    state = pe.PoseEstimatorState.create(cfg, args.contact_cap or 20)
    particles = pe.init_gaussian(
        jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05, 0.2, 0.3
    )
    state = dataclasses.replace(state, particles=particles)

    # pre-generate the input trajectory on host, stack on device
    sim = simlib.TrajectorySim(terrain, speed=0.05)
    css, qs = [], []
    for _ in range(args.steps):
        (pos, yaw), _ = sim.step()
        cs = sim.contact_state(noise=0.005)
        if args.contact_cap:
            cs = cs.compact(args.contact_cap)
        css.append(cs)
        qs.append(np.asarray(geometry.quat_from_yaw(np.float32(yaw))))
    contact_states = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *css
    )
    orientations = jnp.asarray(np.stack(qs), jnp.float32)

    if args.ablate == "nolookup":
        # constant fake map: update math runs, the gather doesn't
        def lookup(map_id, pts):  # noqa: F811
            shape = pts.shape[:-1]
            return (jnp.ones(shape, bool), jnp.zeros(shape, jnp.float32),
                    jnp.full(shape, 0.1, jnp.float32),
                    jnp.zeros(shape + (3,), jnp.float32))

        lookup.batched = True

    if args.ablate == "noupdate":
        # project + centroid only (no measurement update at all)
        from slam_eslam_tpu.filter.step import cfg_odo
        from slam_eslam_tpu.models import odometry as odom_lib

        def one_step(state, inp):
            cs, q = inp
            state = dataclasses.replace(
                state,
                odometry=odom_lib.update(state.odometry, cs, q,
                                         cfg_odo(cfg)),
            )
            state = pe.project(state, q, cfg)
            c_pos, _ = pe.centroid(state.particles, q)
            return state, c_pos

        @jax.jit
        def run(state, contact_states, orientations):
            return jax.lax.scan(
                one_step, state, (contact_states, orientations)
            )
    else:
        run = steplib.make_scan_runner(cfg, lookup)

    # compile + warm up
    t0 = time.time()
    out_state, cents = run(state, contact_states, orientations)
    jax.block_until_ready(cents)
    compile_s = time.time() - t0

    best = float("inf")
    for _ in range(args.repeats):
        t0 = time.time()
        out_state, cents = run(state, contact_states, orientations)
        jax.block_until_ready(cents)
        best = min(best, time.time() - t0)

    pu_per_s = n * args.steps / best
    result = {
        "metric": "particle_updates_per_sec",
        "value": pu_per_s,
        "unit": "particle-updates/s",
        "vs_baseline": pu_per_s / 1.0e6,
        "ms_per_step": best / args.steps * 1e3,
        "compile_s": compile_s,
        "device": device_record(device),
    }
    print(json.dumps(result))
    print(
        f"# {n} particles x {args.steps} steps: best {best:.3f}s "
        f"(compile+first {compile_s:.1f}s)",
        file=sys.stderr,
    )


def gpu_device():
    """The first JAX device; exits non-zero when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform {dev.platform!r})")
    return dev


def device_record(dev):
    import jax

    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def bench_slam(args, device):
    """Full SLAM loop, device-resident: contact updates + motion-gated
    per-particle scan match/merge fused into one ``lax.scan`` dispatch
    (``filter/streaming.py``) — measures device compute, not host
    dispatch latency (BASELINE config #3 shape; the reference operates
    250 particles; per-particle maps at 100k would need ~TB of map
    memory in any design)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import streaming
    from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu.models.asguard import AsguardSim

    n = args.particles

    def terrain(x, y):
        return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
            0.5 * np.asarray(y)
        )

    cfg = dataclasses.replace(
        Config(),
        particle_count=n,
        min_effective=n // 2,
        grid_size=args.grid_size,
        grid_resolution=args.grid_res,
        map_pool_blocks=args.pool_blocks or 4 * n,
        map_chain_length=args.chain_len,
        map_pool_color=False,  # perf config: no slip/texture fusion
        map_pool_dtype=args.pool_dtype,
        use_visual_update=args.visual,
        contact_model=ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2
        ),
    )
    f = EmbodiedSlamFilter(config=cfg)
    sim = AsguardSim(terrain=terrain)
    # the carry's odometry state is sized for the FULL contact set: the
    # odometry chain is precomputed from uncompacted states (compaction
    # breaks its across-frame slot correspondence — round-4 find; the
    # measurement update still consumes the compacted frames)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False,
           num_contact_points=20)
    q = np.array([1.0, 0, 0, 0], np.float32)

    n_rays = 64
    scan_meta = (
        jnp.asarray(-np.pi / 2, jnp.float32),
        jnp.asarray(np.pi / n_rays, jnp.float32),
    )
    lb = (np.eye(3), np.zeros(3))

    steps = args.steps if args.steps != 10 else 20
    # pre-generate the frame stream (scan on each step's last substep)
    frame_list = []
    full_cs = []

    def cb(s):
        cs = s.contact_state()
        full_cs.append(cs)
        if args.contact_cap:
            cs = cs.compact(args.contact_cap)
        frame_list.append([
            cs, jnp.asarray(q),
            jnp.asarray(s.position, jnp.float32),
            jnp.full((n_rays,), 2.0, jnp.float32),
            scan_meta, jnp.asarray(False),
        ])

    for _ in range(steps):
        sim.step(wheel_delta=0.3, on_substep=cb)
        frame_list[-1][5] = jnp.asarray(True)
    stacked = streaming.stack_frames([tuple(fr) for fr in frame_list])
    frames = len(frame_list)
    # odometry from the FULL contact stream (slot correspondence)
    qs_stack = jnp.stack([jnp.asarray(q)] * frames)
    odos = streaming.precompute_odometry(
        20,
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *full_cs),
        qs_stack, cfg=cfg,
    )

    run = streaming.make_slam_scan_runner(cfg, laser2body=lb,
                                          donate=args.donate,
                                          external_odometry=True)

    carry = streaming.StreamingState.create(f.state, f.pool)
    if args.donate:
        # donation consumes the carry buffers; the carry CHAINS through
        # the repeats (output pool reuses the input pool's memory), so
        # peak HBM is ONE pool + step temporaries — the configuration
        # that fits 100k particles (f.pool would otherwise pin a second
        # full pool)
        f.state = f.pool = None

    t0 = time.time()
    carry, aux = run(carry, stacked, odos)
    jax.block_until_ready(aux["centroid"])
    compile_s = time.time() - t0

    dt = float("inf")
    for _ in range(args.repeats):
        if not args.donate:
            carry = streaming.StreamingState.create(f.state, f.pool)
            jax.block_until_ready(carry.pool.mean)
        t0 = time.time()
        carry, aux = run(carry, stacked, odos)
        jax.block_until_ready(aux["centroid"])
        dt = min(dt, time.time() - t0)

    result = {
        "metric": "slam_frames_per_sec",
        "value": frames / dt,
        "unit": f"frames/s @ {n} particles, per-particle maps",
        "vs_baseline": frames / dt / 100.0,
        "pool_dtype": args.pool_dtype,
        "compile_s": compile_s,
        "device": device_record(device),
    }
    print(json.dumps(result))
    print(
        f"# {frames} contact frames ({steps} scan frames, "
        f"{int(np.asarray(aux['mapped']).sum())} merges gated in, "
        f"{int(np.asarray(aux['updated']).sum())} measurement updates) "
        f"in {dt:.3f}s (compile+first {compile_s:.1f}s), "
        f"map patches={int(jnp.sum(carry.pool.valid))}, "
        f"alloc_failed={int(carry.alloc_failed)}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
