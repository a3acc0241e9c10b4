"""Smoke test of the SLAM engine on NVIDIA GPUs, through its public
entry points at the sizes its users run.

Run from the root of a checkout::

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the multi-device path only

One card, one process:

* **device** — the card's name and power limit (``nvidia-smi``, in a
  child process that stays off JAX), the JAX version and device kind;
* **localisation** — 100,000 particles on a 400x400 @ 0.05 m map with 4
  patch slots per cell (the ``Configuration.hpp`` default scale):
  sampled lookups equal a NumPy oracle exactly; 150 steps through
  ``filter.step.make_scan_runner`` (the benchmark regime, an update
  every step) give the step time; 150 Asguard contact frames through
  ``filter.step.make_filter_step``, gated by the reference's
  measurement threshold as ``EmbodiedSlamFilter`` gates them, keep the
  centroid within ``ATE_BOUND_M`` of the simulator's ground truth; and
  one weighting step, with the full contact state (XLA fold) and at the
  contact cap (the Triton fold kernel), agrees with the same step on
  the CPU device;
* **streaming SLAM** — the ``bench.py --mode slam`` shape at 4,096
  particles (10 m @ 0.25 m blocks, chain length 3, a pool of 4N blocks)
  through ``filter.streaming.make_slam_scan_runner``: no allocation
  failures, patches written, and one frame's merge and chain lookup
  agree with the same functions on the CPU device;
* **host-driven API** — ``EmbodiedSlamFilter`` in per-particle mode at
  1,024 particles, 20 steps of contact and laser updates (as
  ``examples/slam_demo.py``);
* **chip tests** — ``pytest -m chip tests/test_chip.py`` in this process.

``--four`` runs ``__graft_entry__.mesh_checks`` on a 4-card ``('dp',)``
mesh (sharded filter step, co-located sharded-pool SLAM scan, ppermute
resample, meshed Schur solve, each against its single-device
reference) and nothing else.

Every number is printed with the card's name beside it; none is claimed
as a result.  The last line is one JSON object, ``{"ok": true,
"device": {"platform", "kind", "count"}}``.  Without a GPU, or when any
phase fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Centroid xy error bound (m), mean over the second half of the gated
# Asguard traverse: the particles start with a 0.3 m spread; the CPU
# rehearsal at 4,096 particles reads 0.04 m.
ATE_BOUND_M = 0.15
# Card-vs-CPU tolerance of one weighting step (weight, z_delta,
# pose_var): at the contact cap the card runs the Triton fold, the CPU
# the XLA fold; the two backends' exp/div/sqrt differ by a few ulp and
# the group sums associate in another order, and the weight's exponent
# (sq - d1*delta) cancels, which can magnify a few-ulp difference
# ~100x.  The fold has no matmul, so TF32 plays no part.
UPDATE_RTOL, UPDATE_ATOL = 1e-4, 1e-6


def terrain(x, y):
    """The streaming-SLAM benchmark terrain (``bench.py --mode slam``)."""
    return 0.15 * np.sin(0.7 * np.asarray(x)) + 0.12 * np.cos(
        0.5 * np.asarray(y)
    )


def card_lines():
    """``nvidia-smi`` name and power limit of every card (no JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def memory_line(compiled):
    """One line from ``compiled.memory_analysis()``."""
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: none"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f[:-len('_size_in_bytes')]}={getattr(ma, f)}" for f in fields
    )


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def lookup_oracle(data, origin, resolution, pts, z_window):
    """NumPy reference of the packed patch lookup: per query, the valid
    slot (stdev >= 0) of its cell whose mean is nearest to z within
    ``z_window``; first slot on ties."""
    nx, ny, c2 = data.shape
    k = c2 // 2
    ix = np.floor((pts[:, 0] - origin[0]) / np.float32(resolution))
    iy = np.floor((pts[:, 1] - origin[1]) / np.float32(resolution))
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    cell = data[np.where(inb, ix, 0), np.where(inb, iy, 0)]
    means, stdevs = cell[:, :k], cell[:, k:]
    dist = np.abs(means - pts[:, 2:3])
    cand = (stdevs >= 0) & (dist <= z_window)
    best = np.argmin(np.where(cand, dist, np.inf), axis=1)
    rows = np.arange(len(pts))
    found = inb & cand.any(axis=1)
    return found, means[rows, best], np.abs(stdevs[rows, best])


def sample_queries(rng, nx, ny, origin, resolution, n, ground):
    """Queries at cell interiors (no floor ambiguity), 1/16 of them
    outside the grid, z near the terrain or far from it."""
    ix = rng.integers(-8, nx + 8, n)
    iy = rng.integers(-8, ny + 8, n)
    frac = rng.uniform(0.1, 0.9, (n, 2))
    x = (origin[0] + (ix + frac[:, 0]) * resolution).astype(np.float32)
    y = (origin[1] + (iy + frac[:, 1]) * resolution).astype(np.float32)
    z = ground(x, y) + rng.normal(0.0, 0.3, n)
    far = rng.random(n) < 0.1
    z = np.where(far, z + rng.choice([-4.0, 4.0], n), z)
    return np.stack([x, y, z.astype(np.float32)], axis=1)


def phase_localisation(particles=100_000, steps=150, cells=400,
                       resolution=0.05, contact_cap=8, queries=4096,
                       repeats=3, log=print):
    """Localisation at full size through ``make_scan_runner``."""
    import jax
    import jax.numpy as jnp

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.filter import step as steplib
    from slam_eslam_tpu.mapping import mls_grid
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.models.asguard import AsguardSim
    from slam_eslam_tpu.utils import geometry

    n = particles
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
    )
    half = cells * resolution / 2.0
    grid = simlib.terrain_grid(terrain, nx=cells, ny=cells,
                               resolution=resolution, origin=(-half, -half))
    packed = mls_grid.PackedLookup.from_grid(grid)
    lookup = make_lookup(cfg, packed)

    # lookups on sampled queries equal the NumPy oracle exactly
    rng = np.random.default_rng(0)
    origin = np.asarray(packed.origin)
    pts = sample_queries(rng, cells, cells, origin, resolution, queries,
                         terrain)
    f, m, s, _ = jax.jit(lambda p: lookup(None, p))(jnp.asarray(pts))
    fo, mo, so = lookup_oracle(np.asarray(packed.data), origin, resolution,
                               pts, cfg.mls_z_window)
    f, m, s = np.asarray(f), np.asarray(m), np.asarray(s)
    if not (np.array_equal(f, fo) and np.array_equal(m[fo], mo[fo])
            and np.array_equal(s[fo], so[fo])):
        raise AssertionError(
            f"lookup differs from the NumPy oracle on "
            f"{int((f != fo).sum())} found flags / "
            f"{int((m[fo] != mo[fo]).sum())} means"
        )
    log(f"lookup == NumPy oracle on {queries} sampled queries "
        f"({int(fo.sum())} hits)")

    # step time: the benchmark regime (bench.py), an update every step
    state = pe.PoseEstimatorState.create(cfg, contact_cap)
    state = dataclasses.replace(state, particles=pe.init_gaussian(
        jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05,
        0.2, 0.3,
    ))
    sim = simlib.TrajectorySim(terrain, speed=0.05)
    css, qs = [], []
    for _ in range(steps):
        (pos, yaw), _ = sim.step()
        css.append(sim.contact_state(noise=0.005).compact(contact_cap))
        qs.append(np.asarray(geometry.quat_from_yaw(np.float32(yaw))))
    contact_states = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                            *css)
    orientations = jnp.asarray(np.stack(qs), jnp.float32)

    run = steplib.make_scan_runner(cfg, lookup)
    t0 = time.perf_counter()
    compiled = run.lower(state, contact_states, orientations).compile()
    compile_s = time.perf_counter() - t0
    out_state, cents = compiled(state, contact_states, orientations)
    jax.block_until_ready(cents)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out_state, cents = compiled(state, contact_states, orientations)
        jax.block_until_ready(cents)
        best = min(best, time.perf_counter() - t0)
    if not np.isfinite(np.asarray(cents)).all():
        raise AssertionError("non-finite centroids")
    log(f"localisation {n} particles x {steps} steps: compile "
        f"{compile_s:.2f} s, steady {best / steps * 1e3:.4f} ms/step, "
        f"{n * steps / best:.6g} particle-updates/s")
    log(memory_line(compiled))

    # tracking: Asguard contact frames, measurement-gated like
    # EmbodiedSlamFilter (distance since the last update on the
    # body2odometry pose, Configuration.hpp:98)
    asg = AsguardSim(terrain=terrain)
    frames, truth = [], []

    def cb(s):
        frames.append((s.contact_state(), s.orientation))
        truth.append(s.position[:2].copy())

    while len(frames) < steps:
        asg.step(wheel_delta=0.3, on_substep=cb)
    state = pe.PoseEstimatorState.create(cfg, len(frames[0][0].valid))
    state = dataclasses.replace(state, particles=pe.init_gaussian(
        jax.random.PRNGKey(1), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05,
        float(asg.position[2]), 0.3,
    ))
    step = steplib.make_filter_step(cfg, lookup)
    centroid = jax.jit(lambda p, q: pe.centroid(p, q)[0])
    anchor, track, updates = truth[0], [], 0
    t0 = time.perf_counter()
    for (cs, q), pos in zip(frames[:steps], truth):
        gate = (np.float32(np.linalg.norm(pos - anchor)), np.float32(0.0))
        state, aux = step(state, cs, jnp.asarray(q), gate)
        if cfg.measurement_threshold.test(*gate):
            anchor, updates = pos, updates + 1
        track.append(centroid(state.particles, jnp.asarray(q)))
    err = np.linalg.norm(np.asarray(jnp.stack(track))[:, :2]
                         - np.stack(truth[:steps]), axis=1)
    track_s = time.perf_counter() - t0
    ate = float(err[steps // 2:].mean())
    if not np.isfinite(ate) or ate > ATE_BOUND_M:
        raise AssertionError(f"centroid xy ATE {ate} m > {ATE_BOUND_M} m")
    log(f"tracking {n} particles, {steps} Asguard frames ({updates} gated "
        f"updates) in {track_s:.2f} s incl. compile: xy ATE {ate:.4f} m "
        f"(bound {ATE_BOUND_M}), travelled "
        f"{np.linalg.norm(truth[steps - 1] - truth[0]):.3f} m")
    last = (state, frames[steps - 1][0],
            jnp.asarray(frames[steps - 1][1]), packed)

    # one weighting step on the card and on the CPU device
    cpu = jax.devices("cpu")[0]

    def weigh(state, cs, q, packed):
        res = pe.update_weights(state, cs, q, make_lookup(cfg, packed),
                                cfg)[1]
        return res.weight, res.z_delta, res.pose_var, res.measurement_valid

    weigh = jax.jit(weigh)
    # the full contact state folds in XLA; at the contact cap the card
    # folds with the Triton kernel (fold_triton.kernel_wins)
    for cs in (last[1], last[1].compact(contact_cap)):
        args = (last[0], cs) + last[2:]
        on_card = weigh(*args)
        on_cpu = weigh(*jax.device_put(args, cpu))
        valid = np.asarray(on_card[3])
        if not (valid.any()
                and np.array_equal(valid, np.asarray(on_cpu[3]))):
            raise AssertionError("measurement_valid differs card vs CPU")
        for name, a, b in zip(("weight", "z_delta", "pose_var"), on_card,
                              on_cpu):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                                       err_msg=name)
        log(f"weighting step, {len(cs.valid)} contact points: card == CPU "
            f"(rtol {UPDATE_RTOL}, atol {UPDATE_ATOL}) on "
            f"{int(valid.sum())} valid particles")
    return {"compile_s": compile_s, "ms_per_step": best / steps * 1e3,
            "updates_per_s": n * steps / best, "ate_m": ate}


def phase_slam(particles=4096, steps=150, grid_size=10.0, grid_res=0.25,
               chain_len=3, contact_cap=8, n_rays=64, repeats=2,
               log=print):
    """Per-particle streaming SLAM (``bench.py --mode slam`` shape)."""
    import jax
    import jax.numpy as jnp

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter import streaming
    from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu.mapping import map_pool as mp
    from slam_eslam_tpu.mapping import projection
    from slam_eslam_tpu.models.asguard import AsguardSim

    n = particles
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 2,
        grid_size=grid_size, grid_resolution=grid_res,
        map_pool_blocks=4 * n, map_chain_length=chain_len,
        map_pool_color=False,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2),
    )
    f = EmbodiedSlamFilter(config=cfg)
    sim = AsguardSim(terrain=terrain)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False, num_contact_points=20)
    q = np.array([1.0, 0, 0, 0], np.float32)
    scan_meta = (jnp.asarray(-np.pi / 2, jnp.float32),
                 jnp.asarray(np.pi / n_rays, jnp.float32))
    frame_list, full_cs = [], []

    def cb(s):
        cs = s.contact_state()
        full_cs.append(cs)
        frame_list.append([
            cs.compact(contact_cap), jnp.asarray(q),
            jnp.asarray(s.position, jnp.float32),
            jnp.full((n_rays,), 2.0, jnp.float32), scan_meta,
            jnp.asarray(False),
        ])

    for _ in range(steps):
        sim.step(wheel_delta=0.3, on_substep=cb)
        frame_list[-1][5] = jnp.asarray(True)
    stacked = streaming.stack_frames([tuple(fr) for fr in frame_list])
    frames = len(frame_list)
    odos = streaming.precompute_odometry(
        20, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *full_cs),
        jnp.stack([jnp.asarray(q)] * frames), cfg=cfg,
    )
    lb = (np.eye(3), np.zeros(3))
    run = streaming.make_slam_scan_runner(cfg, laser2body=lb,
                                          external_odometry=True)
    carry0 = streaming.StreamingState.create(f.state, f.pool)
    patches0 = int(jnp.sum(f.pool.valid))
    t0 = time.perf_counter()
    compiled = run.lower(carry0, stacked, odos).compile()
    compile_s = time.perf_counter() - t0
    carry, aux = compiled(carry0, stacked, odos)
    jax.block_until_ready(aux["centroid"])
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        carry, aux = compiled(carry0, stacked, odos)
        jax.block_until_ready(aux["centroid"])
        best = min(best, time.perf_counter() - t0)
    failed = int(carry.alloc_failed)
    patches = int(jnp.sum(carry.pool.valid))
    if failed != 0:
        raise AssertionError(f"alloc_failed = {failed}")
    if patches <= patches0:
        raise AssertionError(f"no patches written ({patches0} -> {patches})")
    log(f"streaming slam {n} particles, {frames} frames "
        f"({int(np.asarray(aux['mapped']).sum())} merges, "
        f"{int(np.asarray(aux['updated']).sum())} measurement updates): "
        f"compile {compile_s:.2f} s, {frames / best:.6g} frames/s, "
        f"patches {patches0} -> {patches}, alloc_failed 0")
    log(memory_line(compiled))

    # one frame's merge and chain lookup, card vs CPU device
    p = carry.filter.particles
    scan = projection.LaserScan(
        ranges=jnp.linspace(0.8, 2.5, n_rays, dtype=jnp.float32),
        start_angle=scan_meta[0], angular_resolution=scan_meta[1],
    )
    pts, valid = projection.scan_to_points(scan, cfg.max_sensor_range)
    cloud = projection.project_points(pts, valid, lb[0], lb[1],
                                      jnp.asarray(q))

    def map_frame(pool, p, cloud, update_idx):
        pool, _ = mp.ensure_unique_active(pool)
        return mp.merge_cloud_all(
            pool, p.xy, p.yaw, p.z, p.z_sigma, cloud, update_idx,
            patch_thickness=cfg.grid_patch_thickness,
            gap_size=cfg.grid_gap_size,
        )

    def lookup_frame(pool, p, contacts):
        pts = (p.xy[:, None, :] + contacts[None, :, :2])
        pts = jnp.concatenate(
            [pts, p.z[:, None, None] + contacts[None, :, 2:3]], axis=-1)
        lk = mp.chain_lookup(pool, cfg.mls_z_window)
        return jax.vmap(lk)(jnp.arange(pool.n), pts)[:3]

    contacts = jnp.asarray(full_cs[-1].position)
    cpu = jax.devices("cpu")[0]
    args = (carry.pool, p, cloud, carry.update_idx)
    a = jax.jit(map_frame)(*args)
    b = jax.jit(map_frame)(*jax.device_put(args, cpu))
    check_merge_statistical(a, b)
    la = jax.jit(lookup_frame)(a, p, contacts)
    lb_ = jax.jit(lookup_frame)(*jax.device_put((b, p, contacts), cpu))
    fa, fb = np.asarray(la[0]), np.asarray(lb_[0])
    agree = (fa == fb).mean()
    both = fa & fb
    if agree < 0.999 or not both.any():
        raise AssertionError(f"chain lookup found-agreement {agree}")
    np.testing.assert_allclose(np.asarray(la[1])[both],
                               np.asarray(lb_[1])[both], rtol=1e-4,
                               atol=1e-5)
    log(f"merge + chain lookup card == CPU ({int(both.sum())} hits, "
        f"found agreement {agree:.6f})")
    return {"compile_s": compile_s, "frames_per_s": frames / best}


def check_merge_statistical(a, b):
    """Merged pools on two devices.  Multi-point cells accumulate in a
    different order, and f32 associativity can flip a fuse/gap/insert
    branch on a threshold: >= 99.9% of slots with identical flags,
    matching slots value-close, patch counts within 0.1%."""
    ma, mb = np.asarray(a.meta), np.asarray(b.meta)
    agree = (ma == mb).mean()
    if agree < 0.999:
        raise AssertionError(f"meta agreement {agree:.6f} < 99.9%")
    both = ((ma & 1) != 0) & ((mb & 1) != 0) & (ma == mb)
    for fld in ("mean", "stdev") if both.any() else ():
        x = np.asarray(getattr(a, fld), np.float32)[both]
        y = np.asarray(getattr(b, fld), np.float32)[both]
        close = np.isclose(x, y, rtol=1e-4, atol=1e-5).mean()
        if close < 0.999:
            raise AssertionError(f"{fld}: only {close:.6f} close")
    na, nb = int((ma & 1).sum()), int((mb & 1).sum())
    if abs(na - nb) > max(1, int(0.001 * nb)):
        raise AssertionError(f"patch counts {na} vs {nb}")


def phase_host_api(particles=1024, steps=20, n_rays=64, log=print):
    """``EmbodiedSlamFilter`` per-particle mode, as examples/slam_demo.py."""
    import jax.numpy as jnp

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.filter.eslam_filter import EmbodiedSlamFilter
    from slam_eslam_tpu.mapping import projection as proj
    from slam_eslam_tpu.models.asguard import AsguardSim

    def ground(x, y):
        return 0.15 * np.sin(0.6 * np.asarray(x)) + 0.1 * np.cos(
            0.5 * np.asarray(y))

    cfg = dataclasses.replace(
        Config(), particle_count=particles, min_effective=particles // 2,
        grid_size=10.0, grid_resolution=0.25,
        map_pool_blocks=4 * particles, map_chain_length=3,
        contact_model=ContactModelConfig(contact_point_radius=0.0,
                                         min_contacts=2),
    )
    f = EmbodiedSlamFilter(config=cfg)
    sim = AsguardSim(terrain=ground)
    f.init(pose=(np.array([0.0, 0.0, sim.position[2]]), 0.0),
           use_shared_map=False)
    q = np.array([1.0, 0, 0, 0], np.float32)
    angles = np.linspace(-np.pi / 2, np.pi / 2, n_rays) + np.pi / 2

    def make_scan(s):
        ranges = np.full(n_rays, np.inf, np.float32)
        origin = s.position + [0, 0, 0.3]
        for i, a in enumerate(angles):
            d = np.array([np.cos(a + s.yaw), np.sin(a + s.yaw), -0.15])
            d /= np.linalg.norm(d)
            for t in np.arange(0.3, 4.0, 0.05):
                pt = origin + t * d
                if pt[2] <= ground(pt[0], pt[1]):
                    ranges[i] = t
                    break
        return proj.LaserScan(
            ranges=jnp.asarray(ranges), start_angle=jnp.asarray(0.0),
            angular_resolution=jnp.asarray(np.pi / (n_rays - 1)),
        )

    pitch = 0.15
    laser_rot = np.array([[np.cos(pitch), 0, np.sin(pitch)], [0, 1, 0],
                          [-np.sin(pitch), 0, np.cos(pitch)]])
    swap = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    laser2body = (swap @ laser_rot, np.array([0.0, 0.1, 0.3]))

    contact_frames, mapped, errs = 0, 0, []
    t0 = time.perf_counter()
    for _ in range(steps):
        def on_sub(s):
            nonlocal contact_frames
            contact_frames += 1
            f.update_contact((q, s.position.astype(np.float64)),
                             s.contact_state())

        sim.step(wheel_delta=0.3, on_substep=on_sub)
        mapped += bool(f.update_scan(
            (q, sim.position.astype(np.float64)), make_scan(sim),
            laser2body))
        c_pos, _ = f.get_centroid()
        errs.append(np.linalg.norm(np.asarray(c_pos)[:2] - sim.position[:2]))
    wall = time.perf_counter() - t0
    patches = int(jnp.sum(f.pool.valid))
    if not (np.all(np.isfinite(errs)) and mapped > 0 and patches > 0):
        raise AssertionError(
            f"host API: errs finite {np.all(np.isfinite(errs))}, "
            f"{mapped} scans merged, {patches} patches")
    if max(errs) > 0.5:
        raise AssertionError(f"host API centroid xy error {max(errs)} m")
    log(f"host api {particles} particles: {contact_frames} contact + "
        f"{steps} scan frames in {wall:.2f} s incl. compile, {mapped} "
        f"scans merged, {patches} patches, max xy err {max(errs):.4f} m")
    return {"wall_s": wall}


def phase_chip_tests(log=print):
    """The ``chip``-marked tests, in this process."""
    import pytest

    class Count:
        passed = skipped = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            elif report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1

    count = Count()
    rc = pytest.main(
        ["-q", "-m", "chip", "-p", "no:cacheprovider",
         os.path.join(ROOT, "tests", "test_chip.py")],
        plugins=[count],
    )
    if rc != 0 or count.failed or count.skipped or not count.passed:
        raise AssertionError(
            f"chip tests: rc {rc}, {count.passed} passed, "
            f"{count.skipped} skipped, {count.failed} failed")
    log(f"chip tests: {count.passed} passed")


def phase_four(log=print):
    """The multi-device path on a 4-card mesh, against single device."""
    import __graft_entry__ as entry

    from slam_eslam_tpu.parallel import sharding as shd

    t0 = time.perf_counter()
    # contact cap 8: the filter step folds with the Triton kernel
    entry.mesh_checks(
        shd.make_mesh(4), n_particles=100_000, grid_cells=64, n_contacts=8,
        slam_particles=4096, slam_grid=(10.0, 0.25),
        log=lambda m: log(f"{m} (+{time.perf_counter() - t0:.1f} s)"),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path on 4 cards")
    args = ap.parse_args(argv)

    try:
        import slam_eslam_tpu
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 1
    pkg_root = os.path.dirname(os.path.dirname(slam_eslam_tpu.__file__))
    if os.path.realpath(pkg_root) != os.path.realpath(ROOT):
        print(f"chip_smoke: run from a checkout (package at {pkg_root})",
              file=sys.stderr)
        return 1

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    cards = card_lines()
    card = cards[0]
    for line in cards:
        print(f"card: {line}")
    print(f"jax {jax.__version__}, device_kind {devices[0].device_kind}, "
          f"{len(devices)} device(s)")

    def log(msg):
        print(f"[{card}] {msg}", flush=True)

    phases = ([("four", phase_four)] if args.four else [
        ("localisation", phase_localisation),
        ("streaming slam", phase_slam),
        ("host api", phase_host_api),
        ("chip tests", phase_chip_tests),
    ])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn(log=log)
        log(f"phase {name} ok in {time.perf_counter() - t0:.1f} s, "
            f"peak_bytes_in_use {peak_bytes(devices[0])}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
