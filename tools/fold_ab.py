"""Contact-fold A/B on one GPU: the production fold (the Triton kernel
on CUDA) vs the plain-XLA fold (``lookup.gather_fold``) vs no fold,
inside the scan-rolled filter step (``filter.step.make_scan_runner``) at
the ``bench.py`` shape (100k particles, 400x400 @ 0.05 m, K = 4, 150
steps), at each contact count of ``--contacts`` (8: the contact cap;
20: the full Asguard contact state, ``bench.py --contact-cap 0``).

    python tools/fold_ab.py --check   # compile the kernel, compare, stop
    python tools/fold_ab.py           # + time the variants A B C C B A
    python tools/fold_ab.py --trace   # + device time per kernel, 1 scan

Prints one line per measurement with the card's name; the variants run
in one process, interleaved, so they share a card and its clocks.
"""

import argparse
import collections
import dataclasses
import glob
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--contacts", type=int, nargs="+", default=[8, 20])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("fold_ab: no GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.splitlines()[0].strip()

    def log(msg):
        print(f"[{card}] {msg}", flush=True)

    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.mapping import mls_grid
    from slam_eslam_tpu.mapping.lookup import gather_fold, make_lookup
    from slam_eslam_tpu.models import sim as simlib

    import chip_smoke

    n = args.particles
    cfg = dataclasses.replace(
        Config(), particle_count=n, min_effective=n // 5,
        contact_model=ContactModelConfig(contact_point_radius=0.0),
    )
    grid = simlib.terrain_grid(chip_smoke.terrain, nx=400, ny=400,
                               resolution=0.05, origin=(-10.0, -10.0))
    packed = mls_grid.PackedLookup.from_grid(grid)
    kernel_fold = make_lookup(cfg, packed).fold
    xla_fold = gather_fold(packed, cfg.mls_z_window)

    for cap in args.contacts:
        log(f"--- contacts {cap} ---")
        fold_ab(cap, n, cfg, packed, kernel_fold, xla_fold, args, log)


def fold_ab(cap, n, cfg, packed, kernel_fold, xla_fold, args, log):
    """The fold alone, then the three scans, at ``cap`` contact points."""
    import jax
    import jax.numpy as jnp

    from slam_eslam_tpu.core.state import BodyContactState
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.filter import step as steplib
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import sim as simlib
    from slam_eslam_tpu.utils import geometry

    import chip_smoke

    # the kernel at its real width against the XLA fold
    rng = np.random.default_rng(0)
    c = cap
    xy = rng.normal(0.0, 0.3, (2, 1, n)) + rng.normal(0.0, 0.3, (2, c, 1))
    xq, yq = (jnp.asarray(a, jnp.float32) for a in xy)
    zq = jnp.asarray(chip_smoke.terrain(np.asarray(xq), np.asarray(yq))
                     + rng.normal(0.0, 0.05, (c, n)), jnp.float32)
    act = jnp.asarray((rng.random((c, 1)) < 0.8), jnp.float32)
    seg = np.arange(c) * 4 // c  # four wheels, as the Asguard groups
    onehot = jnp.asarray(np.eye(4, dtype=np.float32)[seg])
    mv = jnp.full((1, n), 0.01, jnp.float32)
    fa = jax.jit(lambda q, m: xla_fold(q, act, m, onehot=onehot,
                                       correction=0.33))
    fb = jax.jit(lambda q, m: kernel_fold(q, act, m, onehot=onehot,
                                          correction=0.33))
    t0 = time.perf_counter()
    b = jax.block_until_ready(fb((xq, yq, zq), mv))
    log(f"triton fold compiled + ran in {time.perf_counter() - t0:.2f} s")
    a = fa((xq, yq, zq), mv)
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-4,
                               atol=1e-5)
    log(f"triton fold == XLA fold on [{c}, {n}] queries "
        f"({int(np.asarray(a[4]).sum())} groups)")
    for name, f in (("xla", fa), ("triton", fb)):
        best = float("inf")
        for _ in range(20):
            t0 = time.perf_counter()
            jax.block_until_ready(f((xq, yq, zq), mv))
            best = min(best, time.perf_counter() - t0)
        log(f"fold alone {name}: {best * 1e6:.1f} us per call "
            "(host clock, dispatch included)")
    if args.check:
        return

    state = pe.PoseEstimatorState.create(cfg, cap)
    state = dataclasses.replace(state, particles=pe.init_gaussian(
        jax.random.PRNGKey(0), n, (0.0, 0.0), 0.0, (0.3, 0.3), 0.05,
        0.2, 0.3,
    ))
    sim = simlib.TrajectorySim(chip_smoke.terrain, speed=0.05)
    css, qs = [], []
    for _ in range(args.steps):
        (_, yaw), _ = sim.step()
        css.append(sim.contact_state(noise=0.005).compact(cap))
        qs.append(np.asarray(geometry.quat_from_yaw(np.float32(yaw))))
    cs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *css)
    qs = jnp.asarray(np.stack(qs), jnp.float32)
    assert isinstance(cs, BodyContactState)

    def variant(fold):
        c2 = dataclasses.replace(cfg, contact_model=dataclasses.replace(
            cfg.contact_model, fold_lookup=fold is not None))
        lk = make_lookup(c2, packed)
        if fold == "xla":
            lk.fold = xla_fold
        run = steplib.make_scan_runner(c2, lk)
        t0 = time.perf_counter()
        compiled = run.lower(state, cs, qs).compile()
        log(f"{fold or 'no fold'}: compile {time.perf_counter() - t0:.2f} s")
        jax.block_until_ready(compiled(state, cs, qs))
        return compiled

    runs = {"xla": variant("xla"), "triton": variant("triton"),
            "none": variant(None)}
    ref = np.asarray(runs["xla"](state, cs, qs)[1])
    got = np.asarray(runs["triton"](state, cs, qs)[1])
    log(f"centroid track triton vs xla: max |diff| "
        f"{np.abs(got - ref).max():.3g} m")
    times = {k: [] for k in runs}
    order = ["xla", "triton", "none", "none", "triton", "xla"]
    for _ in range(args.repeats):
        for name in order:
            t0 = time.perf_counter()
            jax.block_until_ready(runs[name](state, cs, qs))
            times[name].append(time.perf_counter() - t0)
    # pairs in the order run: (xla, triton) then (triton, xla) per round
    wins = sum(t < x for x, t in zip(times["xla"], times["triton"]))
    log(f"triton faster than xla in {wins} of {len(times['xla'])} pairs")
    for name, ts in times.items():
        q1, q3 = np.percentile(ts, [25, 75]) / args.steps * 1e3
        log(f"scan {name}: quartiles {q1:.4f} / {q3:.4f} ms/step")
        best = min(ts)
        log(f"scan {name}: best {best / args.steps * 1e3:.4f} ms/step, "
            f"median {np.median(ts) / args.steps * 1e3:.4f} ms/step over "
            f"{len(ts)} runs, {n * args.steps / best:.6g} "
            "particle-updates/s")

    if args.trace:
        for name in ("xla", "triton"):
            trace_scan(runs[name], (state, cs, qs), name, args.steps, log)


def trace_scan(compiled, args, name, steps, log, top=8):
    """Device time of one traced scan: busy time per GPU line and the
    ``top`` kernels by device time (``jax.profiler`` xplane)."""
    import jax
    from jax.profiler import ProfileData

    trace_dir = tempfile.mkdtemp(prefix=f"fold_ab_{name}_")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(compiled(*args))
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    kernels = collections.Counter()
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            busy = sum(e.duration_ns for e in events) / 1e6
            log(f"trace {name}: {plane.name} line {line.name!r}: "
                f"{len(events)} events, {busy:.4f} ms "
                f"({busy / steps * 1e3:.2f} us/step)")
            if "stream" in line.name.lower():
                for e in events:
                    kernels[e.name] += e.duration_ns
    for kname, ns in kernels.most_common(top):
        log(f"trace {name}: kernel {kname[:80]!r}: {ns / 1e6:.4f} ms "
            f"({ns / 1e3 / steps:.2f} us/step)")

if __name__ == "__main__":
    main()
