"""Pose estimator: the eslam SIR localization filter.

Array-program rebuild of ``eslam::PoseEstimator``
(``/root/reference/src/PoseEstimator.{hpp,cpp}``): particles over
(x, y, yaw, z, zSigma) driven by sampled contact-odometry deltas,
weighted by the contact model against an MLS map, resampled on low ESS.

The reference's per-particle loops (propagation ``PoseEstimator.cpp:
196-237``; the OpenMP weighting hot loop ``:272-327``) become ``vmap``
over the particle axis — note the reference's parallel loop races on
shared scratch state (``:262,288-326``, flag default off); the
functional rewrite has no shared scratch by construction and is safe at
any width.  All randomness is drawn in fused batches from splittable
keys.

Everything here is pure: ``(state, inputs) -> state``; the whole
project+update step jits into one XLA computation and shards over the
particle axis (see ``slam_eslam_tpu.parallel``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from slam_eslam_tpu.config import Config
from slam_eslam_tpu.core import filter as pf
from slam_eslam_tpu.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu.models import contact_model as cm
from slam_eslam_tpu.models import odometry as odom
from slam_eslam_tpu.utils import geometry


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["particles", "odometry", "key", "max_weight", "step"],
    meta_fields=[],
)
@dataclasses.dataclass
class PoseEstimatorState:
    particles: ParticleSet
    odometry: odom.FootContactOdometry
    key: jax.Array        # PRNG key
    max_weight: jax.Array  # [] float32 (PoseEstimator.hpp:154)
    step: jax.Array        # [] int32 — project-call counter (hash period)

    @staticmethod
    def create(cfg: Config, num_contact_points, key=None):
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        return PoseEstimatorState(
            particles=ParticleSet.zeros(cfg.particle_count),
            odometry=odom.FootContactOdometry.create(num_contact_points),
            key=key,
            max_weight=jnp.zeros(()),
            step=jnp.zeros((), jnp.int32),
        )


def init_gaussian(key, n, mu_xy, mu_yaw, sigma_xy, sigma_yaw, zpos, zsigma):
    """Gaussian particle initialisation (``PoseEstimator.cpp:88-102``).

    The reference constructs particles with weight 0, which the first
    ``normalizeWeights`` then resets to uniform (``ParticleFilter.hpp:
    51-59``); we initialise uniform directly — observably identical.
    """
    kxy, kyaw = jax.random.split(key)
    xy = jnp.asarray(mu_xy) + jax.random.normal(kxy, (n, 2)) * jnp.asarray(
        sigma_xy
    )
    yaw = jnp.asarray(mu_yaw) + jax.random.normal(kyaw, (n,)) * jnp.asarray(
        sigma_yaw
    )
    p = ParticleSet.zeros(n)
    return dataclasses.replace(
        p,
        x=xy[:, 0].astype(jnp.float32),
        y=xy[:, 1].astype(jnp.float32),
        yaw=yaw.astype(jnp.float32),
        z=jnp.full((n,), zpos, jnp.float32),
        z_sigma=jnp.full((n,), zsigma, jnp.float32),
    )


def weighting_function(x, alpha=0.1, beta=0.9, gamma=0.05):
    """Piecewise-linear recovery schedule (``PoseEstimator.cpp:104-128``)."""
    a = (1.0 - gamma) / (alpha - beta)
    b = 1.0 - alpha * a
    return jnp.where(x < alpha, 1.0, jnp.where(x < beta, a * x + b, gamma))


def project(
    state: PoseEstimatorState,
    orientation,
    cfg: Config,
    use_hash: bool = False,
):
    """Propagate particles with a sampled odometry delta
    (``PoseEstimator::project``, ``PoseEstimator.cpp:184-242``).

    Per particle: noise-sampled 2-D odometry delta, random y-slip with
    probability ``slip_factor``, yaw-deviation penalty (x0.7 outside
    ``max_yaw_deviation`` of the IMU heading), z propagation, and — when
    the max weight collapsed below ``spread_threshold`` and no hash is in
    use — recovery spreading noise.  Hash reinjection itself lives in the
    orchestrator (it needs the map).  Returns the new state.
    """
    p = state.particles
    n = p.n
    key, k_delta, k_slip1, k_slip2, k_spread_xy, k_spread_yaw = (
        jax.random.split(state.key, 6)
    )

    yaw_meas = geometry.yaw_from_quat(orientation)
    z_delta, z_var = odom.z_delta_and_var(state.odometry, orientation)

    dxy, dyaw = odom.pose_delta_samples_2d(state.odometry, k_delta, n)
    # slip model (PoseEstimator.cpp:199-202): with prob slip_factor the
    # longitudinal (y) component shrinks by U(0,1)
    slip = jax.random.uniform(k_slip1, (n,)) < cfg.slip_factor
    shrink = jax.random.uniform(k_slip2, (n,))
    dx0 = dxy[:, 0]
    dy0 = dxy[:, 1] * jnp.where(slip, shrink, 1.0)

    # body->world rotation, expanded on [N] components (no [N, 2]
    # intermediate; see the split x/y storage of ParticleSet)
    c, s = jnp.cos(p.yaw), jnp.sin(p.yaw)
    x = p.x + c * dx0 - s * dy0
    y = p.y + s * dx0 + c * dy0
    yaw = p.yaw + dyaw

    weight = p.weight
    if cfg.max_yaw_deviation > 0.0:
        dev = jnp.arctan2(jnp.sin(yaw - yaw_meas), jnp.cos(yaw - yaw_meas))
        weight = jnp.where(
            jnp.abs(dev) > cfg.max_yaw_deviation, weight * 0.7, weight
        )

    z = p.z + z_delta
    z_sigma = jnp.sqrt(p.z_sigma**2 + z_var)

    if not use_hash and cfg.spread_threshold > 0.0:
        # recovery spreading (PoseEstimator.cpp:224-236): scales with how
        # far the max weight has collapsed
        spread = weighting_function(
            state.max_weight, 0.0, cfg.spread_threshold, 0.0
        )
        trans_fac = cfg.spread_translation_factor * spread
        rot_fac = cfg.spread_rotation_factor * spread
        noise = jax.random.normal(k_spread_xy, (n, 2)) * trans_fac
        x = x + noise[:, 0]
        y = y + noise[:, 1]
        yaw = yaw + jax.random.normal(k_spread_yaw, (n,)) * rot_fac

    particles = dataclasses.replace(
        p, x=x, y=y, yaw=yaw, z=z, z_sigma=z_sigma, weight=weight
    )
    return dataclasses.replace(
        state, particles=particles, key=key, step=state.step + 1
    )


def bind_lookup(map_lookup, map_id):
    """Bind the per-particle ``map_id`` onto a lookup, FORWARDING its
    capability attributes (``soa``: accepts SoA flat queries; ``fold``:
    in-kernel contact fold) — a bare lambda would silently strip them
    and drop ``evaluate_pose_batch`` back to the slow AoS path."""
    if getattr(map_lookup, "batched", False):
        bound = lambda pts: map_lookup(map_id, pts)
    else:
        bound = lambda pts: jax.vmap(map_lookup)(map_id, pts)
    bound.soa = getattr(map_lookup, "soa", False)
    fold = getattr(map_lookup, "fold", None)
    if fold is not None:
        bound.fold = fold
    return bound


def update_weights(
    state: PoseEstimatorState,
    contact_state: BodyContactState,
    orientation,
    map_lookup,
    cfg: Config,
    terrain_prob=None,
):
    """Contact-likelihood weighting of all particles
    (``PoseEstimator::updateWeights``, ``PoseEstimator.cpp:257-352``).

    ``map_lookup(map_id, points [C, 3]) -> (found, mean, stdev, color)``
    is the map seam, vmapped over particles with each particle's map id
    (shared-map mode passes the same grid for every id).

    Reference behaviours replicated exactly:

    * the measurement weight enters the particle weight twice — once
      directly (``:300``) and once via ``mprob`` in the discount pass
      (``:329-345``);
    * the group-count discount ``(discount * floating_weight)^(4 - #cp)``
      applies to every particle, with ``#cp`` the number of *found*
      contact points whether or not the measurement was valid;
    * ``max_weight`` decays by ``discount_factor`` when no particle saw
      any contact point (``:347-348``).

    Returns ``(new_state, aux)`` where ``aux`` carries the per-particle
    ``ContactEvalResult`` for debug capture (``log_debug``).
    """
    cstate = cm.set_contact_points(contact_state, orientation)
    p = state.particles
    rot, trans = p.pose_matrix()
    meas_var = p.z_sigma**2 + cfg.measurement_error**2

    # batched fast path: only the map gather is vmapped; the group
    # reductions run as one-hot matmuls (see evaluate_pose_batch).
    # Lookups that handle the full [N, C, 3] batch themselves (shape-
    # polymorphic) declare ``batched = True``.
    batch_lookup = bind_lookup(map_lookup, p.map_id)
    res = cm.evaluate_pose_batch(
        cstate, rot, trans, meas_var, batch_lookup, cfg.contact_model,
        terrain_prob=terrain_prob, with_debug_points=cfg.log_debug,
    )
    valid = res.measurement_valid

    # Kalman z update for particles with a valid measurement
    # (PoseEstimator.cpp:293-296)
    _, new_z, new_zvar = jax.vmap(cm.update_z_position_estimate)(
        res, p.z, p.z_sigma**2
    )
    z = jnp.where(valid, new_z, p.z)
    z_sigma = jnp.where(valid, jnp.sqrt(new_zvar), p.z_sigma)

    weight = jnp.where(valid, p.weight * res.weight, p.weight)
    mprob = jnp.where(valid, res.weight, 1.0)
    floating = ~valid

    data_particles = jnp.sum(valid)
    inv_cp = 1.0 / jnp.maximum(res.n_contacts.astype(weight.dtype), 1.0)
    sum_data_weights = jnp.sum(
        jnp.where(valid, jnp.power(res.weight, inv_cp), 0.0)
    )
    floating_weight = jnp.where(
        data_particles > 0,
        sum_data_weights / jnp.maximum(data_particles, 1),
        1.0,
    )

    # group-count discount pass (PoseEstimator.cpp:329-345)
    expo = 4.0 - res.n_contacts.astype(weight.dtype)
    factor = mprob * jnp.power(
        cfg.discount_factor * floating_weight, expo
    )
    weight = weight * factor

    total_points = jnp.sum(jnp.where(valid, res.n_contacts, 0))
    max_meas = jnp.max(jnp.where(valid, res.weight, 0.0))
    max_weight = jnp.where(
        total_points == 0, state.max_weight * cfg.discount_factor, max_meas
    )

    particles = dataclasses.replace(
        p,
        z=z,
        z_sigma=z_sigma,
        weight=weight,
        mprob=mprob,
        floating=floating,
        n_contacts=res.n_contacts,
    )
    new_state = dataclasses.replace(
        state, particles=particles, max_weight=max_weight
    )
    return new_state, res


def update(
    state: PoseEstimatorState,
    contact_state: BodyContactState,
    orientation,
    map_lookup,
    cfg: Config,
    terrain_prob=None,
    resampler=None,
):
    """Measurement update + ESS-gated resampling
    (``PoseEstimator::update``, ``PoseEstimator.cpp:244-255``).

    ``resampler``: optional override ``(key, weights, particles) ->
    (particles, idx)`` — e.g. ``parallel.resample.make_ppermute_resampler``
    for ring-hop payload exchange on a device mesh (the default gather
    formulation is correct on a mesh too, just heavier on the links).

    Returns ``(state, aux)``; ``aux.resampled`` reports whether the
    resample branch fired (map cloning hooks key off it).
    """
    state, res = update_weights(
        state, contact_state, orientation, map_lookup, cfg, terrain_prob
    )
    p = state.particles
    weight, ess = pf.normalize_weights(p.weight)

    key, k_rs = jax.random.split(state.key)
    do_resample = ess < cfg.min_effective
    p_norm = dataclasses.replace(p, weight=weight)

    def resample(p_norm):
        # stratified resampling carries the normalised weights with the
        # copied particles (ParticleFilter.hpp:104)
        if resampler is not None:
            return resampler(k_rs, weight, p_norm)
        idx = pf.resample_stratified(k_rs, weight, p.n)
        # packed single-gather copy (10 [N] gathers -> one [N,10] row
        # gather; exact — see core.filter.take_packed).  Ancestor
        # indices come from the two-level wide search
        # (core.filter._resample_from_positions; compare against
        # searchsorted with tools/profile_resample.py)
        return pf.take_packed(p_norm, idx), idx

    def skip(p_norm):
        return p_norm, jnp.arange(p.n, dtype=jnp.int32)

    # lax.cond: the wide search + packed particle gather only run on
    # resampling steps (whether an unconditional gather with an
    # idx-only cond, or no cond at all, is faster on a GPU is not
    # measured: tools/profile_resample.py)
    particles, idx = jax.lax.cond(do_resample, resample, skip, p_norm)

    state = dataclasses.replace(state, particles=particles, key=key)
    aux = {"eval": res, "ess": ess, "resampled": do_resample,
           "resample_idx": idx}
    return state, aux


def centroid(particles: ParticleSet, orientation, wrap_safe=False):
    """Weighted-mean pose (``PoseEstimator::getCentroid``,
    ``PoseEstimator.cpp:354-383``).

    Returns ``(position [3], quaternion [4])`` where the quaternion is
    ``R_z(mean_yaw) * removeYaw(orientation)``.

    ``wrap_safe``: the reference takes a plain weighted mean of yaw
    (``PoseEstimator.cpp:368``) which is wrong across the +-pi wrap
    (two particles at +-179 deg average to ~0 deg); True uses the
    circular mean instead (``Config.wrap_safe_centroid``).
    """
    w, _ = pf.normalize_weights(particles.weight)
    # per-axis [N] sums over the split x/y fields
    cx = jnp.sum(particles.x * w)
    cy = jnp.sum(particles.y * w)
    if wrap_safe:
        yaw = jnp.arctan2(
            jnp.sum(jnp.sin(particles.yaw) * w),
            jnp.sum(jnp.cos(particles.yaw) * w),
        )
    else:
        yaw = jnp.sum(particles.yaw * w)
    z = jnp.sum(particles.z * w)
    q = geometry.quat_mul(
        geometry.quat_from_yaw(yaw), geometry.remove_yaw(orientation)
    )
    return jnp.array([cx, cy, z]), q
