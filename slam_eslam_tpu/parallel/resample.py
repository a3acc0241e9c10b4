"""Distributed systematic resampling over a device mesh.

The reference resamples with a sequential cumulative-sum walk on one
core (``/root/reference/src/ParticleFilter.hpp:85-108``).  Sharded over
a ``('dp',)`` mesh the exact same statistics are preserved with:

1. ``psum`` of per-shard weight sums  -> global normaliser + ESS,
2. one shared scalar uniform draw     -> identical global stratum
   positions ``(k + u) / N`` on every shard (systematic scheme),
3. ``all_gather`` of the [N] weight vector (4 B/particle — cheap even
   at 1M particles) -> every shard runs the same searchsorted and
   learns the *global* source index of each of its local output slots,
4. an index gather of the particle pytree — cross-shard particle
   migration that XLA lowers to all-to-all-style collectives.

Two call styles:

* ``resample_sharded``  — plain jit + sharding constraints; XLA derives
  the collectives (the default; composes with the rest of the step).
* ``resample_shard_map`` — explicit ``shard_map`` with hand-placed
  ``psum``/``all_gather`` (the performance-controlled path; also the
  executable documentation of the comm pattern).

Both return ``(indices, ess)`` computed from *normalised* weights; the
caller gathers its pytrees (particles + map-chain ids migrate together,
keeping particle/map consistency — SURVEY hard-part #3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def resample_sharded(key, weights, mesh):
    """jit+constraint formulation: identical math to the single-chip
    ``core.filter.resample_systematic``; sharding makes XLA insert the
    collectives."""
    from slam_eslam_tpu.core import filter as pf

    if mesh is not None:
        weights = jax.lax.with_sharding_constraint(
            weights, NamedSharding(mesh, P("dp"))
        )
    w, ess = pf.normalize_weights(weights)
    idx = pf.resample_systematic(key, w, w.shape[0])
    return idx, ess


def make_ppermute_resampler(mesh, scheme="stratified"):
    """Adapter for ``filter.pose_estimator.update(resampler=...)``:
    ``(key, weights, particles) -> (particles, idx_global)`` using the
    ring-hop exchange below.  ``scheme='stratified'`` matches the
    reference's default resampling statistics."""

    def resampler(key, weights, particles):
        out, idxg, _ = resample_ppermute(
            key, weights, particles, mesh, scheme=scheme
        )
        return out, idxg

    return resampler


def make_gather_resampler(mesh):
    """Adapter for ``filter.pose_estimator.update(resampler=...)``: its
    default stratified resample (wide search + packed particle gather)
    with the ancestor indices pinned to ``'dp'``, so each device draws
    and searches for its own output slots only.  Left to sharding
    propagation, the GPU compile of the meshed filter step computes
    every slot on every device."""
    from slam_eslam_tpu.core import filter as pf

    sharding = NamedSharding(mesh, P("dp"))

    def resampler(key, weights, particles):
        idx = jax.lax.with_sharding_constraint(
            pf.resample_stratified(key, weights, particles.n), sharding
        )
        return pf.take_packed(particles, idx), idx

    return resampler


def resample_ppermute(key, weights, payload, mesh, scheme="systematic"):
    """Distributed systematic resample that also *moves the particle
    payload*, using ring ``ppermute`` hops instead of gathering payloads
    globally.

    The all-gather formulations move O(N) particle bytes per device
    (every shard sees every particle).  But systematic resampling maps a
    *contiguous* range of global strata to each source shard, so a
    shard's outputs come from shards at ring distance <= h_max, where
    h_max is set by the realised weight imbalance — 0 or 1 in the
    tracking regime, P-1 only under total weight collapse.  This
    implementation:

    1. ``psum``/``all_gather`` of the P per-shard weight *sums* (tiny)
       -> global shard boundaries, normaliser, ESS;
    2. every shard computes, for each of its output slots, the source
       shard (searchsorted over the P boundaries) and the global stratum
       position;
    3. a ``lax.while_loop`` rotates (payload, local-cumsum) buffers
       around the ring in both directions simultaneously, stopping at
       the *global* max hop distance (``pmax`` — uniform trip count);
       at each hop every shard resolves the slots whose source is the
       shard currently passing through (local searchsorted + gather).

    Per-device traffic: ``2 * h_max * bytes(shard)`` vs
    ``(P-1) * bytes(shard)`` for the all-gather path.

    ``payload``: pytree with leading axis N (sharded over 'dp').
    ``scheme``: ``'systematic'`` (single shared offset, lowest variance)
    or ``'stratified'`` (independent per-stratum offsets — the
    reference's scheme, ``ParticleFilter.hpp:85-108``); both produce
    globally sorted stratum positions, which is what makes the source
    ranges contiguous per shard.
    Returns ``(payload_out, idx_global, ess)``; ``idx_global`` is the
    per-output-slot global source index (for verification — the payload
    move is equivalent to ``tree_map(lambda a: a[idx_global], payload)``).
    """
    n = weights.shape[0]
    if scheme == "systematic":
        u = jax.random.uniform(key, (), weights.dtype)
    elif scheme == "stratified":
        # every shard regenerates the identical global [N] offset vector
        # (deterministic from the shared key — no communication) and
        # slices its own slots
        u = jax.random.uniform(key, (n,), weights.dtype)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    def local(w_local, payload_local):
        axis = "dp"
        p = jax.lax.axis_size(axis)
        d = jax.lax.axis_index(axis)
        nl = w_local.shape[0]

        # 1. global normalisation + ESS (degenerate -> uniform reset,
        #    ParticleFilter.hpp:51-59)
        total = jax.lax.psum(jnp.sum(w_local), axis)
        ok = (total > 0) & jnp.isfinite(total)
        w_n = jnp.where(ok, w_local / jnp.where(ok, total, 1.0), 1.0 / n)
        ess = 1.0 / jax.lax.psum(jnp.sum(w_n * w_n), axis)

        # shard boundaries over the unit interval.  Lower bounds come
        # from the raw cumsum: applying them after the last-bound fixup
        # would shift the last shard's offset by ~1e-6 and misresolve
        # strata landing within that margin of a particle boundary.
        sums = jax.lax.all_gather(jnp.sum(w_n), axis)        # [P]
        cums = jnp.cumsum(sums)
        offsets = cums - sums                                # lower bounds
        bounds = cums.at[-1].set(jnp.maximum(cums[-1], 1.0 + 1e-6))

        # 2. my output slots: global stratum positions + source shard
        kk = d * nl + jnp.arange(nl, dtype=w_n.dtype)
        uk = u if u.ndim == 0 else jax.lax.dynamic_slice(u, (d * nl,), (nl,))
        pos = (kk + uk) / n
        src = jnp.clip(
            jnp.searchsorted(bounds, pos, side="right"), 0, p - 1
        ).astype(jnp.int32)

        delta = src - d
        h_fwd = jax.lax.pmax(jnp.maximum(jnp.max(delta), 0), axis)
        h_bwd = jax.lax.pmax(jnp.maximum(jnp.max(-delta), 0), axis)
        h_max = jnp.maximum(h_fwd, h_bwd)

        cum = jnp.cumsum(w_n)                                # local cumsum

        def resolve(source_shard, cum_s, payload_s, out, idxg):
            """Fill the output slots whose source is ``source_shard``
            from that shard's (cumsum, payload) buffers."""
            il = jnp.clip(
                jnp.searchsorted(
                    offsets[source_shard] + cum_s, pos, side="left"
                ),
                0, nl - 1,
            ).astype(jnp.int32)
            mask = src == source_shard
            take = jax.tree_util.tree_map(lambda a: a[il], payload_s)
            out = jax.tree_util.tree_map(
                lambda o, t: jnp.where(
                    mask.reshape((nl,) + (1,) * (t.ndim - 1)), t, o
                ),
                out, take,
            )
            idxg = jnp.where(mask, source_shard * nl + il, idxg)
            return out, idxg

        # hop 0: local sources
        idxg0 = jnp.full((nl,), -1, jnp.int32)
        out0, idxg0 = resolve(d, cum, payload_local, payload_local, idxg0)

        def body(carry):
            h, out, idxg, pf_, cf_, pb_, cb_ = carry
            psize = p  # static mesh size
            fwd = [(i, (i - 1) % psize) for i in range(psize)]
            bwd = [(i, (i + 1) % psize) for i in range(psize)]
            pf_ = jax.tree_util.tree_map(
                lambda a: jax.lax.ppermute(a, axis, fwd), pf_
            )
            cf_ = jax.lax.ppermute(cf_, axis, fwd)
            pb_ = jax.tree_util.tree_map(
                lambda a: jax.lax.ppermute(a, axis, bwd), pb_
            )
            cb_ = jax.lax.ppermute(cb_, axis, bwd)
            out, idxg = resolve((d + h) % psize, cf_, pf_, out, idxg)
            out, idxg = resolve((d - h) % psize, cb_, pb_, out, idxg)
            return h + 1, out, idxg, pf_, cf_, pb_, cb_

        def cond(carry):
            return carry[0] <= h_max

        _, out, idxg, *_ = jax.lax.while_loop(
            cond, body,
            (jnp.int32(1), out0, idxg0,
             payload_local, cum, payload_local, cum),
        )
        return out, idxg, ess[None]

    out, idxg, ess = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P("dp")),
    )(weights, payload)
    return out, idxg, ess[0]


def resample_shard_map(key, weights, mesh):
    """Explicit collective formulation (see module docstring)."""
    n = weights.shape[0]
    u = jax.random.uniform(key, (), weights.dtype)

    def local(w_local):
        axis = "dp"
        n_local = w_local.shape[0]
        shard = jax.lax.axis_index(axis)

        # 1. global normalisation + ESS via psum
        total = jax.lax.psum(jnp.sum(w_local), axis)
        ok = (total > 0) & jnp.isfinite(total)
        w_norm = jnp.where(
            ok, w_local / jnp.where(ok, total, 1.0), 1.0 / n
        )
        ess = 1.0 / jax.lax.psum(jnp.sum(w_norm * w_norm), axis)

        # 2-3. identical global positions; all-gathered weights
        w_all = jax.lax.all_gather(w_norm, axis, tiled=True)   # [N]
        cumsum = jnp.cumsum(w_all)
        cumsum = cumsum.at[-1].set(jnp.maximum(cumsum[-1], 1.0 + 1e-6))
        k = (
            shard * n_local
            + jnp.arange(n_local, dtype=w_all.dtype)
        )
        positions = (k + u) / n
        idx = jnp.searchsorted(cumsum, positions, side="left")
        idx = jnp.clip(idx, 0, n - 1).astype(jnp.int32)
        return idx, ess[None]

    idx, ess = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P("dp"),),
        out_specs=(P("dp"), P("dp")),
    )(weights)
    return idx, ess[0]
