"""Generic particle-filter core: weight bookkeeping, ESS, resampling.

Array-program rebuild of the reference's header-only SIR filter template
(``/root/reference/src/ParticleFilter.hpp``).  The reference stores
particles as an ``std::vector`` of structs and resamples with a sequential
cumulative-sum walk; here particles are structure-of-arrays pytrees and
resampling is a fixed-shape ``cumsum`` + ``searchsorted`` — O(N log N) work
that XLA maps entirely onto the VPU with no host round-trips, and that
generalises directly to the distributed (sharded) formulation in
``slam_eslam_tpu.parallel``.

All functions are pure and jittable; randomness comes from explicit
``jax.random`` keys (counter-based, splittable — replaces the seeded
``boost::minstd_rand`` at ``ParticleFilter.hpp:24-32,177``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def weights_sum(weights):
    """Total weight (``ParticleFilter.hpp:34-39``)."""
    return jnp.sum(weights)


def weights_avg(weights):
    """Mean weight (``ParticleFilter.hpp:41-44``)."""
    return jnp.mean(weights)


def normalize_weights(weights):
    """Normalise weights in place; return ``(normalized, ess)``.

    Matches ``ParticleFilter.hpp:46-70`` including the degenerate-sum
    fallback: when the total weight is <= 0 (or non-finite) every particle
    is reset to uniform 1/N.  ``ess`` is the effective sample size
    ``1 / sum(w^2)``.
    """
    n = weights.shape[0]
    total = jnp.sum(weights)
    uniform = jnp.full_like(weights, 1.0 / n)
    ok = (total > 0.0) & jnp.isfinite(total)
    normalized = jnp.where(ok, weights / jnp.where(ok, total, 1.0), uniform)
    ess = 1.0 / jnp.sum(normalized * normalized)
    return normalized, ess


def effective_sample_size(weights):
    _, ess = normalize_weights(weights)
    return ess


def _resample_from_positions(weights, positions, block=128,
                             positions_sorted=True, method="wide"):
    """Map stratum positions in [0,1) to particle indices.

    Equivalent to the reference's cumulative-sum walk
    (``ParticleFilter.hpp:96-105``): index k gets the first particle whose
    cumulative weight reaches ``positions[k]`` — i.e.
    ``idx[k] = #{i : cumsum[i] < positions[k]}`` (the ``side="left"``
    stopping rule ``while (sum_w < sum_r) ++idx``).

    ``method="wide"`` (default) computes that count with a two-level
    wide search instead of ``jnp.searchsorted``, whose binary search
    lowers to a ``log2(N)``-iteration while loop with a [Q] gather per
    iteration (whether the wide search wins on a GPU is not measured).
    Level 1 counts the cumsum *blocks* that lie entirely below each
    position (one [Q, N/block] compare-all, no gather); level 2
    row-gathers each position's single
    partial block ([Q, block] contiguous rows) and counts inside it.
    Identical indices to the binary search except where a position
    collides (within 1 ulp) with a non-monotone dip of the float
    cumsum — rounding can make ``cumsum`` decrease by an ulp, where
    bisection and counting legitimately disagree by ±1 (the reference's
    sequential walk gives a third answer there; all are statistically
    equivalent).  ``method="bisect"`` keeps the searchsorted lowering.

    ``positions_sorted``: stratified/systematic positions are
    non-decreasing, which the row gather is annotated with (multinomial
    passes False).
    """
    n = weights.shape[0]
    cumsum = jnp.cumsum(weights)
    # guard against round-off: force the last cumsum entry to cover 1.0
    cumsum = cumsum.at[-1].set(jnp.maximum(cumsum[-1], 1.0 + 1e-6))
    if method == "bisect":
        idx = jnp.searchsorted(cumsum, positions, side="left")
        return jnp.clip(idx, 0, n - 1).astype(jnp.int32)
    if n <= 2 * block:
        # small enough for a single compare-all
        idx = jnp.sum(
            cumsum[None, :] < positions[:, None], axis=1, dtype=jnp.int32
        )
        return jnp.clip(idx, 0, n - 1)
    nb = -(-n // block)
    pad = nb * block - n
    cpad = (
        jnp.concatenate([cumsum, jnp.full((pad,), jnp.inf, cumsum.dtype)])
        if pad
        else cumsum
    )
    blocks = cpad.reshape(nb, block)
    # block b's last entry is its max (cumsum is non-decreasing); a block
    # whose max is < pos contributes `block` full counts
    maxes = blocks[:, block - 1]
    nfull = jnp.sum(
        maxes[None, :] < positions[:, None], axis=1, dtype=jnp.int32
    )
    # the guard above makes the global max >= 1 + 1e-6 > any position,
    # so nfull <= nb - 1 always; min() is belt-and-braces
    b = jnp.minimum(nfull, nb - 1)
    rows = jnp.take(blocks, b, axis=0,
                    indices_are_sorted=positions_sorted)
    local = jnp.sum(
        rows < positions[:, None], axis=1, dtype=jnp.int32
    )
    return jnp.clip(b * block + local, 0, n - 1)


def resample_stratified(key, weights, num_samples):
    """Stratified resampling: one uniform draw per stratum.

    Matches ``ParticleFilter.hpp:85-108``: ``u_k = (k + U_k) / N`` with
    independent ``U_k ~ U[0,1)``.  Note the reference copies particles
    *with their (normalised) weights* — resetting to uniform is the
    caller's choice, as in the reference.

    Returns int32 indices ``[num_samples]`` into the source particle set.
    """
    u = jax.random.uniform(key, (num_samples,), dtype=weights.dtype)
    k = jnp.arange(num_samples, dtype=weights.dtype)
    positions = (k + u) / num_samples
    return _resample_from_positions(weights, positions)


def resample_systematic(key, weights, num_samples):
    """Systematic resampling: a single uniform offset for all strata.

    Not in the reference (which offers stratified + multinomial); added
    because the single-draw variant has the lowest variance and is the
    natural distributed scheme — every shard can recompute the global
    stratum positions from one shared scalar draw (see
    ``parallel/resample.py``).
    """
    u = jax.random.uniform(key, (), dtype=weights.dtype)
    k = jnp.arange(num_samples, dtype=weights.dtype)
    positions = (k + u) / num_samples
    return _resample_from_positions(weights, positions)


def resample_multinomial(key, weights, num_samples):
    """Multinomial resampling (``ParticleFilter.hpp:120-148``).

    The reference resets resampled weights to 1/N (``:140``); callers
    should do the same when using this scheme.
    """
    u = jax.random.uniform(key, (num_samples,), dtype=weights.dtype)
    return _resample_from_positions(weights, u, positions_sorted=False)


def best_particle_index(weights):
    """Argmax weight (``ParticleFilter.hpp:160-173``)."""
    return jnp.argmax(weights)


def take(particles, idx):
    """Gather a particle pytree by index — the SoA analogue of copying
    ``Particle`` structs during resampling (``ParticleFilter.hpp:104``)."""
    return jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), particles)


def take_packed(particles, idx):
    """``take`` specialised for ``ParticleSet``: pack the 10 per-particle
    fields into one ``[N, 10]`` int32 matrix (float fields bitcast — the
    round trip is exact for every value incl. NaN/inf), do ONE
    row-contiguous gather, unpack.

    Why: one ``[N, 10]`` row gather reads contiguous rows where ten
    separate ``[N]`` gathers issue ten index streams.  Resampling
    indices are non-decreasing (stratified /
    systematic), which the gather is annotated with.
    """
    from slam_eslam_tpu.core.state import ParticleSet

    p = particles
    as_bits = lambda a: jax.lax.bitcast_convert_type(
        a.astype(jnp.float32), jnp.int32
    )
    packed = jnp.concatenate(
        [
            as_bits(p.x)[:, None],
            as_bits(p.y)[:, None],
            as_bits(p.yaw)[:, None],
            as_bits(p.z)[:, None],
            as_bits(p.z_sigma)[:, None],
            as_bits(p.weight)[:, None],
            as_bits(p.mprob)[:, None],
            p.floating.astype(jnp.int32)[:, None],
            p.n_contacts.astype(jnp.int32)[:, None],
            p.map_id.astype(jnp.int32)[:, None],
        ],
        axis=1,
    )                                                   # [N, 10] int32
    g = jnp.take(packed, idx, axis=0, indices_are_sorted=True)
    as_f32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.float32)
    return ParticleSet(
        x=as_f32(g[:, 0]),
        y=as_f32(g[:, 1]),
        yaw=as_f32(g[:, 2]),
        z=as_f32(g[:, 3]),
        z_sigma=as_f32(g[:, 4]),
        weight=as_f32(g[:, 5]),
        mprob=as_f32(g[:, 6]),
        floating=g[:, 7] != 0,
        n_contacts=g[:, 8],
        map_id=g[:, 9],
    )
