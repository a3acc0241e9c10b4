"""Standalone resample-path microbenchmark (VERDICT r3 #2a).

Measures, at bench scale (100k particles by default), the pieces of the
ESS-gated resample: cumsum+index computation (binary-search
``jnp.searchsorted`` vs the two-level wide search at several block
sizes), the packed 10-field particle gather (``take_packed``), and the
identity-index gather that the restructured ``pose_estimator.update``
now pays on non-resampling steps.

Each variant runs under ``lax.scan`` (``--iters`` per dispatch) so the
per-dispatch overhead amortises away.

Usage: python tools/profile_resample.py [--particles 100000] [--cpu]
"""

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from slam_eslam_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from slam_eslam_tpu.core import filter as pf
    from slam_eslam_tpu.core.state import ParticleSet

    n = args.particles
    key = jax.random.PRNGKey(0)
    # realistic post-measurement weights: lognormal-ish concentration
    logw = 2.5 * jax.random.normal(key, (n,))
    w = jax.nn.softmax(logw)
    particles = ParticleSet.zeros(n)
    u = jax.random.uniform(jax.random.PRNGKey(1), (n,))
    positions = (jnp.arange(n, dtype=jnp.float32) + u) / n

    def timed(name, fn, *a):
        f = jax.jit(
            lambda *xs: jax.lax.scan(
                lambda c, _: (tuple(jax.tree.leaves(fn(*c))), None),
                xs, None, length=args.iters
            )[0]
        )
        out = f(*a)
        jax.block_until_ready(out)
        t0 = time.time()
        out = f(*a)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / args.iters * 1e3
        print(f"{name:34s} {dt:8.3f} ms", flush=True)
        return out

    # index computation variants (carry the weights through the scan so
    # nothing hoists; positions closed over — loop-invariant like the
    # stratum grid in production, where only u is fresh)
    def via(method, block=128):
        def f(wc):
            idx = pf._resample_from_positions(
                wc, positions, block=block, method=method
            )
            # fold idx back into the carry so the scan can't dead-code it
            return wc + 1e-12 * idx.astype(wc.dtype)

        return f

    timed("searchsorted (bisect)", via("bisect"), w)
    for blk in (64, 128, 256):
        timed(f"wide block={blk}", via("wide", blk), w)

    # exactness cross-check (±1 allowed where a position collides with
    # a 1-ulp non-monotone dip in the float cumsum — binary search and
    # counting legitimately disagree there; see _resample_from_positions)
    i0 = np.asarray(
        pf._resample_from_positions(w, positions, method="bisect")
    )
    for blk in (64, 128, 256):
        i1 = np.asarray(
            pf._resample_from_positions(w, positions, block=blk)
        )
        d = np.abs(i0.astype(np.int64) - i1)
        assert d.max() <= 1 and (d > 0).sum() <= 5, (
            f"wide block={blk}: {int((d > 0).sum())} mismatches, "
            f"max {int(d.max())}"
        )
    print("exactness: wide == bisect (±1 on sub-ulp ties)", flush=True)

    # gather cost: packed 10-field take with sorted indices
    idx_sorted = jnp.sort(
        jax.random.randint(jax.random.PRNGKey(2), (n,), 0, n)
    ).astype(jnp.int32)
    ident = jnp.arange(n, dtype=jnp.int32)

    def take_fn(p, idx):
        def f(c):
            out = pf.take_packed(p, idx)
            return (c + out.weight[0],)

        return f

    c0 = (jnp.zeros(()),)
    timed("take_packed (random sorted idx)", take_fn(particles, idx_sorted),
          *c0)
    timed("take_packed (identity idx)", take_fn(particles, ident), *c0)

    # full current production piece: normalize + gated idx + always-take
    def full(wc):
        wn, ess = pf.normalize_weights(wc)
        idx = jax.lax.cond(
            ess < 1e12,  # always fire (worst case)
            lambda x: pf.resample_stratified(jax.random.PRNGKey(3), x, n),
            lambda x: ident,
            wn,
        )
        out = pf.take_packed(particles, idx)
        return wc + 1e-12 * out.weight


    timed("normalize+idx-cond+take (fires)", full, w)

    # ---- decomposition ----
    def cumsum_only(wc):
        cs = jnp.cumsum(wc)
        return wc + 1e-12 * cs[-1]

    timed("cumsum only", cumsum_only, w)

    nb = -(-n // 128)
    pad = nb * 128 - n

    def level1_only(wc):
        cs = jnp.cumsum(wc)
        cpad = jnp.concatenate([cs, jnp.full((pad,), jnp.inf)])
        blocks = cpad.reshape(nb, 128)
        maxes = blocks[:, 127]
        nfull = jnp.sum(maxes[None, :] < positions[:, None], axis=1,
                        dtype=jnp.int32)
        return wc + 1e-12 * nfull.astype(wc.dtype)

    timed("cumsum+level1 compare-all", level1_only, w)

    table = jax.random.normal(jax.random.PRNGKey(4), (nb, 128))

    def rowgather(wc):
        b = jnp.clip((wc[:1] + jnp.arange(n)).astype(jnp.int32), 0, nb - 1)
        rows = jnp.take(table, b, axis=0, indices_are_sorted=True)
        return wc + 1e-12 * rows[:, 0]

    timed("row gather [N,128]", rowgather, w)

    field = jnp.arange(n, dtype=jnp.float32)

    def onegather(wc):
        i = jnp.clip((wc[:1] + jnp.arange(n)).astype(jnp.int32), 0, n - 1)
        g = jnp.take(field, i, indices_are_sorted=True)
        return wc + 1e-12 * g

    timed("single [N] f32 gather", onegather, w)

    # cond boundary cost: take_packed inside a lax.cond, predicate as a
    # runtime scalar — measure the never-firing and always-firing cases
    def cond_take(pred):
        def f(wc):
            out = jax.lax.cond(
                pred,
                lambda p: pf.take_packed(p, idx_sorted),
                lambda p: p,
                particles,
            )
            return wc + 1e-12 * out.weight[0]

        return f

    timed("cond(take) skip-side", cond_take(jnp.asarray(False)), w)
    timed("cond(take) fire-side", cond_take(jnp.asarray(True)), w)


if __name__ == "__main__":
    main()
