"""Fused filter steps: project + update as single jitted computations.

The per-frame main path of the reference
(``EmbodiedSlamFilter::update(body2odometry, BodyContactState, ltc)``,
``/root/reference/src/EmbodiedSlamFilter.cpp:353-369``): odometry update,
particle propagation, and (gated) measurement update — here fused into
one XLA computation so a whole tracking step is a single device dispatch
(and a single cache entry), optionally sharded over a device mesh.

``make_scan_runner`` additionally rolls an entire input *trajectory*
through ``lax.scan`` on device — the benchmark path: zero host round
trips per step.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from slam_eslam_tpu.config import Config
from slam_eslam_tpu.core.state import BodyContactState
from slam_eslam_tpu.filter import pose_estimator as pe
from slam_eslam_tpu.models import odometry as odom
from slam_eslam_tpu.parallel import resample as dres
from slam_eslam_tpu.parallel import sharding as shd


def make_filter_step(cfg: Config, map_lookup=None, mesh=None, jit=True,
                     lookup_factory=None, resampler=None):
    """Build ``step(state, contact_state, orientation, gate[, map_state])
    -> (state, aux)``.

    Runs odometry -> project -> distance/angle-gated measurement update
    (``measurementThreshold.test(...)``, ``EmbodiedSlamFilter.cpp:360``,
    with the intended distance/angle argument order — the reference has
    them swapped, ``Configuration.hpp:23-26``).  The gate is traced with
    ``lax.cond`` so the whole step stays one compiled program.

    Pass either a closed-over ``map_lookup`` (static map; embedded as a
    compile-time constant) or a ``lookup_factory(map_state)`` — the map
    then travels as a runtime argument, so map updates don't retrace.

    ``resampler``: optional resampling override forwarded to
    ``pose_estimator.update`` (e.g. the ppermute ring exchange on
    meshes, ``parallel.resample.make_ppermute_resampler(mesh)``); on a
    mesh it defaults to ``parallel.resample.make_gather_resampler``.
    """
    if resampler is None and mesh is not None:
        resampler = dres.make_gather_resampler(mesh)

    def step(state, contact_state: BodyContactState, orientation, gate_ref,
             map_state=None):
        lookup = (
            lookup_factory(map_state) if lookup_factory is not None
            else map_lookup
        )
        new_odo = odom.update(
            state.odometry, contact_state, orientation, cfg_odo(cfg)
        )
        state = dataclasses.replace(state, odometry=new_odo)
        state = pe.project(state, orientation, cfg)
        state = dataclasses.replace(
            state, particles=shd.constrain_particles(state.particles, mesh)
        )

        # measurement gating on accumulated motion since the last update
        dist, angle = gate_ref
        do_update = cfg.measurement_threshold.test(dist, angle)

        def do(state):
            s, aux = pe.update(
                state, contact_state, orientation, lookup, cfg,
                resampler=resampler,
            )
            return dataclasses.replace(
                s, particles=shd.constrain_particles(s.particles, mesh)
            ), aux["ess"]

        def skip(state):
            return state, jnp.asarray(jnp.inf, jnp.float32)

        state, ess = jax.lax.cond(do_update, do, skip, state)
        # the particles leave the step sharded like they entered it: the
        # GPU compile gives the gate's cond replicated results otherwise
        state = dataclasses.replace(
            state, particles=shd.constrain_particles(state.particles, mesh)
        )
        return state, {"ess": ess, "updated": do_update}

    return jax.jit(step) if jit else step


def cfg_odo(cfg: Config):
    from slam_eslam_tpu.config import OdometryConfig

    return OdometryConfig(seed=cfg.seed)


def make_scan_runner(cfg: Config, map_lookup, mesh=None):
    """Roll a whole trajectory on device with ``lax.scan``.

    ``inputs`` is a pytree of per-step arrays (leading time axis):
    ``contact_state`` (stacked BodyContactState) and ``orientation``
    [T, 4].  Measurement updates run every step (the benchmark regime).
    Returns the final state plus per-step centroids [T, 3].
    """
    resampler = None if mesh is None else dres.make_gather_resampler(mesh)

    def one_step(state, inp):
        cs, q = inp
        new_odo = odom.update(state.odometry, cs, q, cfg_odo(cfg))
        state = dataclasses.replace(state, odometry=new_odo)
        state = pe.project(state, q, cfg)
        state = dataclasses.replace(
            state, particles=shd.constrain_particles(state.particles, mesh)
        )
        state, _ = pe.update(state, cs, q, map_lookup, cfg,
                             resampler=resampler)
        state = dataclasses.replace(
            state, particles=shd.constrain_particles(state.particles, mesh)
        )
        c_pos, _ = pe.centroid(state.particles, q,
                               wrap_safe=cfg.wrap_safe_centroid)
        return state, c_pos

    @jax.jit
    def run(state, contact_states, orientations):
        return jax.lax.scan(
            one_step, state, (contact_states, orientations)
        )

    return run
