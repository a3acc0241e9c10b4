"""Weak-scaling harness: sharded filter step over 1..K devices.

On this machine real multi-chip hardware is unavailable; the harness
runs the full sharded step (particles x dp mesh, distributed systematic
resampling) over virtual CPU devices to validate the scaling *path* and
measure parallel efficiency of the compiled program.  On a real pod the
same script reports chips-scaling (run with JAX_PLATFORMS unset).

Weak scaling: particles per device held constant; efficiency =
t(1 device) / t(K devices).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=8192)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", default=None)
    ap.add_argument(
        "--fixed-total", type=int, default=0, dest="fixed_total",
        help="hold the TOTAL particle count fixed and vary the shard "
        "count instead of weak scaling.  On a virtual CPU mesh this is "
        "the honest proxy: all shards share the host cores, so "
        "weak-scaling efficiency just measures host saturation; with "
        "fixed total work, t(K)/t(1) isolates the partitioning "
        "overhead XLA adds (halo copies, collective stubs, reshards)",
    )
    args = ap.parse_args()

    max_dev = max(args.devices)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={max_dev}"
        ).strip()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    if args.cpu is not False:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import __graft_entry__ as g
    from slam_eslam_tpu.filter import step as steplib
    from slam_eslam_tpu.parallel import sharding as shd

    have = len(jax.devices())
    results = {}
    t1 = None
    for k in args.devices:
        if k > have:
            print(f"# skipping {k} devices (have {have})")
            continue
        mesh = shd.make_mesh(k)
        n = args.fixed_total or args.per_device * k
        cfg, lookup, state, cs, q = g._build(n, nx=64, ny=64, mesh=mesh)
        state = shd.shard_state(state, mesh)
        fn = steplib.make_filter_step(cfg, lookup, mesh=mesh)
        gate = (np.float32(1.0), np.float32(0.0))
        out, _ = fn(state, cs, q, gate)
        jax.block_until_ready(out.particles.weight)
        best = float("inf")
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out, _ = fn(state, cs, q, gate)
            jax.block_until_ready(out.particles.weight)
            best = min(best, time.perf_counter() - t0)
        if t1 is None:
            t1 = best
        results[k] = {"n": n, "sec": best}
        if args.fixed_total:
            results[k]["partitioning_overhead"] = best / t1
            label = f"overhead={best / t1:.2f}x"
        else:
            results[k]["weak_scaling_eff"] = t1 / best
            label = f"eff={t1 / best:.2f}"
        if jax.devices()[0].platform == "cpu":
            # virtual devices share host cores: efficiency here only
            # validates the sharded path, not real scaling
            results[k]["note"] = "virtual-cpu-mesh"
        print(
            f"devices={k:2d}  particles={n:8d}  {best * 1e3:8.2f} ms "
            + label
        )
    key = "fixed_total_scaling" if args.fixed_total else "weak_scaling"
    print(json.dumps({key: results}))


if __name__ == "__main__":
    main()
