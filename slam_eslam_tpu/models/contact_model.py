"""Terrain-contact measurement model.

Array-program rebuild of ``eslam::ContactModel``
(``/root/reference/src/ContactModel.{hpp,cpp}``): the probabilistic
likelihood of a particle pose given the robot's kinematic contact-point
candidates and an MLS elevation map.

The reference walks contact points sequentially per particle, closing
variable-length "groups" (wheels) as it goes (``ContactModel.cpp:117-224``).
Here the group loop becomes mask-based segmented reductions over a fixed
point count ``C`` (see ``BodyContactState.segments``), so the whole model
is a branch-free vector program that ``vmap``s over particles; the only
gather is the map lookup, injected as a batched callback — the same seam
the reference uses (``ContactModel.hpp:115-118``), which keeps the model
unit-testable against scripted fake maps.

Numerical note: the contact likelihood ratio pdf/cdf
(``ContactModel.cpp:104-115``) is evaluated in log space
(``logpdf - logcdf``) so deep-tail z-values that would underflow boost's
``cdf`` to 0 (ratio -> inf) stay finite here.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from slam_eslam_tpu.config import ContactModelConfig
from slam_eslam_tpu.core.state import BodyContactState
from slam_eslam_tpu.utils import geometry

# contact probability below which a candidate is skipped
# (fixed in the reference, ContactModel.cpp:136)
CONTACT_THRESHOLD = 0.2


def set_contact_points(state: BodyContactState, orientation):
    """Rotate contact candidates into the yaw-compensated frame.

    Matches ``ContactModel::setContactPoints`` (``ContactModel.cpp:21-41``):
    positions are pre-rotated by ``removeYaw(orientation)``; the particle
    pose later applies only translation + yaw.
    """
    q = geometry.remove_yaw(orientation)
    return dataclasses.replace(
        state, position=geometry.quat_rotate(q[None, :], state.position)
    )


def lowest_point_per_group(state: BodyContactState):
    """Per-group lowest contact candidate (``ContactModel.cpp:48-92``).

    Groups are consecutive runs of equal non-negative ``groupId``;
    ungrouped points (-1) pass through unchanged.  Returns
    ``(points [C, 3], mask [C])`` where ``mask`` marks one entry per
    group (the z-lowest) / per ungrouped point; and a per-point
    ``is_lowest [C]`` contact indicator matching
    ``updateContactStateUsingLowestPointHeuristic``: grouped points get
    contact 1 for the selected point and 0 otherwise, ungrouped points
    keep their contact value.
    """
    seg, num_seg = state.segments()
    z = jnp.where(state.valid, state.position[..., 2], jnp.inf)
    seg_min = jax.ops.segment_min(z, seg, num_segments=num_seg)
    is_min = (z == seg_min[seg]) & state.valid
    # break ties: keep only the first index achieving the min in each run
    idx = jnp.arange(state.c)
    first_min = jax.ops.segment_min(
        jnp.where(is_min, idx, state.c), seg, num_segments=num_seg
    )
    is_lowest = (idx == first_min[seg])
    grouped = state.group_id >= 0
    new_contact = jnp.where(
        grouped, is_lowest.astype(state.contact.dtype), state.contact
    )
    return state.position, is_lowest & state.valid, new_contact


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "measurement_valid", "weight", "z_delta", "z_var", "pose_var",
        "n_contacts", "cp_point", "cp_zdiff", "cp_zvar", "cp_prob", "cp_ok",
        "sp_point", "sp_prob", "sp_ok",
    ],
    meta_fields=[],
)
@dataclasses.dataclass
class ContactEvalResult:
    """Output of ``evaluate_pose`` (one particle; vmaps to a batch).

    Scalar fields mirror the reference accessors ``getWeight/getZDelta/
    getZVar`` (``ContactModel.hpp:124-141``) and the internal
    ``m_poseVar``; ``cp_*`` arrays are the per-group environment contact
    points (``eslam::ContactPoint``, ``PoseParticle.hpp:20-43``) with a
    validity mask (fixed segment count = C).  ``sp_*`` arrays are the
    per-contact-point slip-debug payload (``eslam::SlipPoint``,
    ``PoseParticle.hpp:45-50``, produced by ``matchTerrain``,
    ``ContactModel.cpp:248-254``) — captured only when the slip update
    runs with debug points enabled, zeros otherwise.
    """

    measurement_valid: jax.Array  # bool — >= min_contacts groups found
    weight: jax.Array             # float32 — joint contact probability
    z_delta: jax.Array            # float32 — proposed z correction
    z_var: jax.Array              # float32 — variance of the correction
    pose_var: jax.Array           # float32 — summed map variance (m_poseVar)
    n_contacts: jax.Array         # int32 — number of contact points
    cp_point: jax.Array           # [S, 3]
    cp_zdiff: jax.Array           # [S]
    cp_zvar: jax.Array            # [S]
    cp_prob: jax.Array            # [S] terrain/slip probability
    cp_ok: jax.Array              # [S] bool
    sp_point: jax.Array = None    # [C, 3] slip-point world position
    sp_prob: jax.Array = None     # [C] joint terrain probability
    sp_ok: jax.Array = None       # [C] bool — classification existed


def contact_likelihood_ratio(z, sigma, correction):
    """pdf/cdf contact-vs-no-contact ratio (``ContactModel.cpp:104-115``),
    computed stably in log space."""
    s = sigma * correction
    return jnp.exp(norm.logpdf(z, 0.0, s) - norm.logcdf(z, 0.0, s))


_MILLS_U0 = -3.0
_MILLS_CF_DEPTH = 8


def _mills_ratio(u):
    """Inverse Mills ratio ``phi(u) / Phi(u)`` from elementwise ops.

    The contact likelihood ratio (``ContactModel.cpp:104-115``) is
    ``pdf(z;0,s)/cdf(z;0,s) = mills(z/s)/s``.  The fold evaluates it
    with a two-branch approximation built from ``exp``/``div``/
    ``select`` only, so the whole fold fuses into one elementwise pass:

    * ``u >= -3``: ``phi/Phi`` with Abramowitz-Stegun 7.1.26 ``erfc``
      (abs err 1.5e-7);
    * ``u < -3``: the Laplace continued fraction
      ``lambda(u) = x + 1/(x + 2/(x + 3/...))`` (x = -u, depth 8).

    Max relative error 5.2e-5 over u in [-30, 12] vs scipy (asserted in
    ``tests/test_contact_fold.py``).
    """
    u = u.astype(jnp.float32)
    a = u * jnp.float32(-0.7071067811865476)        # -u / sqrt(2)
    x = jnp.abs(a)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = poly * jnp.exp(-x * x)
    cphi = 0.5 * jnp.where(a >= 0, e, 2.0 - e)      # Phi(u)
    phi = jnp.float32(0.3989422804014327) * jnp.exp(-0.5 * u * u)
    lam_a = phi / jnp.maximum(cphi, 1e-38)
    xx = jnp.maximum(-u, 0.5)
    tcf = xx
    for j in range(_MILLS_CF_DEPTH, 0, -1):
        tcf = xx + j / tcf
    return jnp.where(u >= _MILLS_U0, lam_a, tcf)


def _contact_rows(found, mean, stdev, z, av, mv, correction):
    """Per-query contact-model quantities of the fold.

    ``found``/``mean``/``stdev`` are the z-selected lookup results (any
    matching shape), ``z`` the query heights, ``av`` the 0/1 active
    mask, ``mv`` the per-query measurement variance.  Returns the five
    group-sum integrands ``(ratio, ratio*zdiff, ratio*zvar,
    ratio*pose_var, contrib)`` replicating ``ContactModel.cpp:160-208``
    (see ``evaluate_pose``).
    """
    zdiff = z - mean
    pose_var = stdev * stdev
    zvar = pose_var + mv
    s = jnp.sqrt(zvar) * correction
    ratio = _mills_ratio(zdiff / s) / s
    contrib = av * found
    rm = jnp.where(contrib > 0.5, ratio, 0.0)
    return rm, rm * zdiff, rm * zvar, rm * pose_var, contrib


def _contact_group_stats(rm, rz, rv, rp, contrib, act_col, seg_oh,
                         n_seg):
    """Segment sums + group-level contact math + per-particle totals.

    All inputs are contact-grid arrays: rows = contact points, columns =
    particles.  ``act_col [C, 1]`` is the active mask, ``seg_oh [C, S]``
    the segment membership.  Returns the five per-particle rows
    ``(d1, d2, sq, pose_var, n_contacts)`` [1, N] from which
    ``evaluate_pose_batch`` reconstructs the reference weighting
    (``ContactModel.cpp:262-317``):

      delta  = d1 / d2
      sum_i (zdiff_i - delta)^2 / zvar_i  =  sq - d1^2 / d2
    """
    tp = rm.shape[-1]
    zero = jnp.zeros((1, tp), jnp.float32)
    d1, d2, sq, pv, nc = zero, zero, zero, zero, zero
    cp = rm.shape[0]
    for s in range(n_seg):
        mcol = seg_oh[:, s:s + 1]                       # [C, 1]
        m = jnp.broadcast_to(mcol, (cp, tp))
        rsum = jnp.sum(rm * m, axis=0, keepdims=True)   # [1, N]
        zds = jnp.sum(rz * m, axis=0, keepdims=True)
        zvs = jnp.sum(rv * m, axis=0, keepdims=True)
        pvs = jnp.sum(rp * m, axis=0, keepdims=True)
        ncb = jnp.sum(contrib * m, axis=0, keepdims=True)
        act_s = jnp.sum(act_col * mcol)                 # scalar
        # group invalid when any active member missed the map
        # (ContactModel.cpp:189-190): n_contrib < n_active
        ok = (ncb >= act_s - 0.5) & (ncb > 0.5) & (rsum > 1e-9)
        okf = ok.astype(jnp.float32)
        safe = jnp.where(ok, rsum, 1.0)
        czd = jnp.where(ok, zds / safe, 0.0)            # cp_zdiff
        inv = okf * safe / jnp.where(ok, zvs, 1.0)      # 1 / cp_zvar
        d1 = d1 + czd * inv
        d2 = d2 + inv
        sq = sq + czd * czd * inv
        pv = pv + okf * pvs / safe
        nc = nc + okf
    return d1, d2, sq, pv, nc


def contact_fold_sums(found, mean, stdev, z, av, mv, act_col, seg_oh,
                      correction):
    """Contact fold on ``[C, N]`` contact-grid lookup results: the
    likelihood ratio, group reductions and per-particle sums of
    ``evaluate_pose_batch`` in one pass.  Returns ``[8, N]`` float32
    rows ``(d1, d2, sq, pose_var, n_contacts, 0, 0, 0)``."""
    cp, n = found.shape
    rows = _contact_rows(
        found.astype(jnp.float32), mean, jnp.abs(stdev), z, av,
        jnp.broadcast_to(mv, (cp, n)), correction)
    n_seg = seg_oh.shape[1]
    d1, d2, sq, pv, nc = _contact_group_stats(
        *rows, act_col.astype(jnp.float32), seg_oh.astype(jnp.float32),
        n_seg)
    return jnp.concatenate(
        [d1, d2, sq, pv, nc, jnp.zeros((3, n), jnp.float32)], axis=0)


def evaluate_pose(
    state: BodyContactState,
    rot,
    trans,
    meas_var,
    map_lookup,
    cfg: ContactModelConfig,
    terrain_prob=None,
):
    """Evaluate the contact likelihood of one particle pose.

    Functional equivalent of ``ContactModel::evaluatePose``
    (``ContactModel.cpp:117-224``) followed by ``evaluateWeight``
    (``:262-317``):

    * transform candidates to world: ``T * p - (0, 0, r)``,
    * query the map through ``map_lookup(points [C,3]) ->
      (found, mean, stdev, color)``,
    * per group: likelihood-ratio-weighted averaging of ``zdiff``/``zvar``
      (a group is invalidated when any active member misses the map,
      ``:189-190``),
    * precision-weighted z-delta + joint shape probability.

    One documented deviation: the reference stores the *first* queried
    point of a group as the debug contact-point position
    (``ContactModel.cpp:174``); we store the max-ratio (dominant) member,
    which is what the upstream unit tests actually assert
    (``test/testContactModel.cpp:314-318``).

    ``terrain_prob``: optional ``[C]`` per-point slip/terrain probability
    (from ``models.terrain``); group products feed ``cp_prob``
    (``ContactModel.cpp:207-208,226-260``).
    """
    # reference guard (ContactModel.cpp:122-123); only checkable for
    # concrete (non-traced) variances
    try:
        if float(meas_var) == 0.0:
            raise ValueError(
                "using a zero measurement variance leads to singularities"
            )
    except TypeError:
        pass

    c = state.c
    seg, num_seg = state.segments()

    active = state.valid & ~(state.contact < CONTACT_THRESHOLD)  # NaN -> active

    world = (jnp.dot(state.position, rot.T,
                     precision=jax.lax.Precision.HIGHEST)
             + trans) - jnp.array(
        [0.0, 0.0, cfg.contact_point_radius], dtype=state.position.dtype
    )
    found, mean, stdev, color = map_lookup(world)

    zdiff = world[..., 2] - mean
    pose_var = stdev * stdev
    zvar = pose_var + meas_var
    ratio = contact_likelihood_ratio(
        zdiff, jnp.sqrt(zvar), cfg.contact_likelihood_correction
    )

    contrib = active & found
    ratio = jnp.where(contrib, ratio, 0.0)

    # group validity: no active member may miss the map (ContactModel.cpp:189-190)
    miss = active & ~found
    group_valid = ~(
        jax.ops.segment_max(
            miss.astype(jnp.int32), seg, num_segments=num_seg
        ).astype(bool)
    )

    rsum = jax.ops.segment_sum(ratio, seg, num_segments=num_seg)
    zdiff_sum = jax.ops.segment_sum(ratio * zdiff, seg, num_segments=num_seg)
    zvar_sum = jax.ops.segment_sum(ratio * zvar, seg, num_segments=num_seg)
    pvar_sum = jax.ops.segment_sum(ratio * pose_var, seg, num_segments=num_seg)
    seg_any = jax.ops.segment_max(
        contrib.astype(jnp.int32), seg, num_segments=num_seg
    ).astype(bool)

    cp_ok = group_valid & seg_any & (rsum > 1e-9)
    safe_rsum = jnp.where(cp_ok, rsum, 1.0)
    cp_zdiff = jnp.where(cp_ok, zdiff_sum / safe_rsum, 0.0)
    cp_zvar = jnp.where(cp_ok, zvar_sum / safe_rsum, jnp.inf)
    m_pose_var = jnp.sum(jnp.where(cp_ok, pvar_sum / safe_rsum, 0.0))

    # representative (max-ratio) surface point per group
    neg_ratio = jnp.where(contrib, ratio, -jnp.inf)
    seg_maxr = jax.ops.segment_max(neg_ratio, seg, num_segments=num_seg)
    idx = jnp.arange(c)
    is_rep = contrib & (neg_ratio == seg_maxr[seg])
    rep_idx = jax.ops.segment_min(
        jnp.where(is_rep, idx, c - 1), seg, num_segments=num_seg
    )
    rep_idx = jnp.clip(rep_idx, 0, c - 1)
    surface = jnp.concatenate([world[:, :2], mean[:, None]], axis=-1)
    cp_point = surface[rep_idx]

    # terrain / slip probability per group (product over members).
    # ``terrain_prob`` may be a callable of (group_id, patch_color) —
    # the visual classification comes from the queried patch colour
    # (matchTerrain, ContactModel.cpp:238-240) — or a precomputed [C]
    # array.  Callables may return ``(prob, has_classification)``; the
    # mask feeds the slip-point debug payload.
    terrain_prob, sp_has = _resolve_terrain_prob(
        terrain_prob, state.group_id, color
    )
    if terrain_prob is not None:
        logp = jnp.where(contrib, jnp.log(jnp.maximum(terrain_prob, 1e-30)), 0.0)
        cp_prob = jnp.exp(
            jax.ops.segment_sum(logp, seg, num_segments=num_seg)
        )
        # slip-point debug capture (SlipPoint, ContactModel.cpp:248-254):
        # one entry per contact point whose wheel had a classification
        sp_point = world
        sp_prob = terrain_prob
        sp_ok = contrib & sp_has
    else:
        cp_prob = jnp.ones((num_seg,), dtype=world.dtype)
        sp_point = jnp.zeros_like(world)
        sp_prob = jnp.ones((c,), world.dtype)
        sp_ok = jnp.zeros((c,), bool)

    n_contacts = jnp.sum(cp_ok).astype(jnp.int32)
    measurement_valid = n_contacts >= cfg.min_contacts

    if cfg.weighting == "chitta":
        weight, z_delta, z_var = evaluate_weight_chitta(
            cp_zdiff, cp_zvar, cp_ok, meas_var
        )
    else:
        weight, z_delta, z_var = _evaluate_weight(
            cp_zdiff, cp_zvar, cp_prob, cp_ok, cfg
        )

    return ContactEvalResult(
        measurement_valid=measurement_valid,
        weight=weight,
        z_delta=z_delta,
        z_var=z_var,
        pose_var=m_pose_var,
        n_contacts=n_contacts,
        cp_point=cp_point,
        cp_zdiff=cp_zdiff,
        cp_zvar=cp_zvar,
        cp_prob=cp_prob,
        cp_ok=cp_ok,
        sp_point=sp_point,
        sp_prob=sp_prob,
        sp_ok=sp_ok,
    )


def _resolve_terrain_prob(terrain_prob, group_id, color):
    """Normalise the ``terrain_prob`` argument: callables may return a
    ``[...]`` probability array or ``(prob, has_classification)``;
    default mask = grouped points."""
    if callable(terrain_prob):
        out = terrain_prob(group_id, color)
        if isinstance(out, tuple):
            return out
        terrain_prob = out
    if terrain_prob is None:
        return None, None
    return terrain_prob, jnp.broadcast_to(group_id >= 0, terrain_prob.shape)


def _evaluate_weight(cp_zdiff, cp_zvar, cp_prob, cp_ok, cfg):
    """Precision-weighted z-delta + joint probability
    (``ContactModel::evaluateWeight``, ``ContactModel.cpp:262-317``)."""
    inv_var = jnp.where(cp_ok, 1.0 / cp_zvar, 0.0)
    d1 = jnp.sum(jnp.where(cp_ok, cp_zdiff, 0.0) * inv_var)
    d2 = jnp.sum(inv_var)
    safe_d2 = jnp.where(d2 > 0, d2, 1.0)
    delta = d1 / safe_d2

    odiff2 = jnp.where(
        cp_ok, (cp_zdiff - delta) ** 2 / cp_zvar, 0.0
    )
    log_pz = jnp.zeros(())
    if cfg.use_shape_update:
        log_pz = log_pz - 0.5 * jnp.sum(odiff2)
    if cfg.use_slip_update:
        log_pz = log_pz + jnp.sum(
            jnp.where(cp_ok, jnp.log(jnp.maximum(cp_prob, 1e-30)), 0.0)
        )
    weight = jnp.exp(log_pz)

    z_delta = -delta
    z_var = jnp.where(d2 > 0, 1.0 / safe_d2, jnp.inf)
    return weight, z_delta, z_var


def evaluate_pose_batch(
    state: BodyContactState,
    rot,
    trans,
    meas_var,
    map_lookup_batch,
    cfg: ContactModelConfig,
    terrain_prob=None,
    with_debug_points=False,
):
    """Batched ``evaluate_pose`` over N particles — the hot path.

    Semantically identical to ``jax.vmap(evaluate_pose)`` (asserted by
    tests), but the group segmentation is a property of the *shared*
    contact state, so the per-group segmented reductions become one-hot
    ``[C, S]`` matmuls instead of per-particle scatters inside vmap.

    Args: ``rot [N,3,3]``, ``trans [N,3]``, ``meas_var [N]``;
    ``map_lookup_batch(points [N,C,3]) -> (found, mean, stdev, color)``
    each ``[N,C]`` (+ color ``[N,C,3]``).

    ``with_debug_points=False`` skips the per-group representative
    surface point (a [N,C,S] argmax used only for the ``log_debug``
    payload, ``Configuration.hpp:203-206``).
    """
    c = state.c
    n = rot.shape[0]
    seg, num_seg = state.segments()
    dtype = state.position.dtype

    onehot = (
        seg[:, None] == jnp.arange(num_seg, dtype=seg.dtype)[None, :]
    ).astype(dtype)                                           # [C, S]

    active = state.valid & ~(state.contact < CONTACT_THRESHOLD)  # [C]

    fold_fn = getattr(map_lookup_batch, "fold", None)
    use_fold = (
        fold_fn is not None
        and cfg.fold_lookup
        and cfg.weighting != "chitta"
        and terrain_prob is None
        and not with_debug_points
    )
    if use_fold:
        # Contact fold (``lookup.fold``, see ``contact_fold_sums``):
        # contact-grid [C, N] world queries in, per-particle weighting
        # stats [8, N] out; the likelihood ratio, group reductions and
        # per-particle sums fuse with the gather, so no per-query array
        # is written between them.
        pxc = state.position[:, 0][:, None]                   # [C, 1]
        pyc = state.position[:, 1][:, None]
        pzc = state.position[:, 2][:, None]
        wx_cn = (rot[:, 0, 0][None, :] * pxc
                 + rot[:, 0, 1][None, :] * pyc
                 + rot[:, 0, 2][None, :] * pzc
                 + trans[:, 0][None, :])                      # [C, N]
        wy_cn = (rot[:, 1, 0][None, :] * pxc
                 + rot[:, 1, 1][None, :] * pyc
                 + rot[:, 1, 2][None, :] * pzc
                 + trans[:, 1][None, :])
        wz_cn = (rot[:, 2, 0][None, :] * pxc
                 + rot[:, 2, 1][None, :] * pyc
                 + rot[:, 2, 2][None, :] * pzc
                 + trans[:, 2][None, :] - cfg.contact_point_radius)
        act_col = active.astype(dtype)[:, None]               # [C, 1]
        mv_row = meas_var.astype(dtype)[None, :]              # [1, N]
        out8 = fold_fn(
            (wx_cn, wy_cn, wz_cn), act_col, mv_row, onehot=onehot,
            correction=cfg.contact_likelihood_correction,
        )
        d1, d2, sq, pv, ncf = (out8[0], out8[1], out8[2], out8[3],
                               out8[4])
        n_contacts = jnp.round(ncf).astype(jnp.int32)
        measurement_valid = n_contacts >= cfg.min_contacts
        safe_d2 = jnp.where(d2 > 0, d2, 1.0)
        delta = d1 / safe_d2
        # sum_i (zdiff_i - delta)^2 / zvar_i == sq - d1 * delta
        log_pz = (-0.5 * (sq - d1 * delta) if cfg.use_shape_update
                  else jnp.zeros_like(sq))
        return ContactEvalResult(
            measurement_valid=measurement_valid,
            weight=jnp.exp(log_pz),
            z_delta=-delta,
            z_var=jnp.where(d2 > 0, 1.0 / safe_d2, jnp.inf),
            pose_var=pv,
            n_contacts=n_contacts,
            # the fold returns per-particle sums only; it is disabled
            # whenever group-level debug payloads are requested
            cp_point=jnp.zeros((n, num_seg, 3), dtype),
            cp_zdiff=jnp.zeros((n, num_seg), dtype),
            cp_zvar=jnp.full((n, num_seg), jnp.inf, dtype),
            cp_prob=jnp.ones((n, num_seg), dtype),
            cp_ok=jnp.zeros((n, num_seg), bool),
            sp_point=jnp.zeros((n, c, 3), dtype),
            sp_prob=jnp.ones((n, c), dtype),
            sp_ok=jnp.zeros((n, c), bool),
        )
    if getattr(map_lookup_batch, "soa", False):
        # SoA query path: build the world points as three FLAT [N*C]
        # arrays with broadcast arithmetic (no einsum), so the lookup
        # consumes flat query vectors and no [N, C, 3] array is built.
        px = state.position[None, :, 0]
        py = state.position[None, :, 1]
        pz = state.position[None, :, 2]
        wxf = (rot[:, 0, 0:1] * px + rot[:, 0, 1:2] * py
               + rot[:, 0, 2:3] * pz + trans[:, 0:1]).reshape(-1)
        wyf = (rot[:, 1, 0:1] * px + rot[:, 1, 1:2] * py
               + rot[:, 1, 2:3] * pz + trans[:, 1:2]).reshape(-1)
        wzf = (rot[:, 2, 0:1] * px + rot[:, 2, 1:2] * py
               + rot[:, 2, 2:3] * pz + trans[:, 2:3]
               - cfg.contact_point_radius).reshape(-1)
        found_f, mean_f, stdev_f = map_lookup_batch((wxf, wyf, wzf))
        found = found_f.reshape(n, c)
        mean = mean_f.reshape(n, c)
        stdev = stdev_f.reshape(n, c)
        color = None  # SoA lookups never carry colour
        zdiff = (wzf - mean_f).reshape(n, c)
        world = (
            jnp.stack([wxf, wyf, wzf], axis=-1).reshape(n, c, 3)
            if with_debug_points else None
        )
    else:
        world = jnp.einsum("nij,cj->nci", rot, state.position,
                           precision=jax.lax.Precision.HIGHEST) + trans[
            :, None, :
        ] - jnp.array([0.0, 0.0, cfg.contact_point_radius], dtype)

        found, mean, stdev, color = map_lookup_batch(world)    # [N, C]

        zdiff = world[..., 2] - mean
    pose_var = stdev * stdev
    zvar = pose_var + meas_var[:, None]
    ratio = contact_likelihood_ratio(
        zdiff, jnp.sqrt(zvar), cfg.contact_likelihood_correction
    )

    contrib = active[None, :] & found                          # [N, C]
    ratio_m = jnp.where(contrib, ratio, 0.0)
    miss = active[None, :] & ~found

    # value-carrying one-hot reduction: exact f32 (no TF32/bf16 passes)
    seg_sum = lambda x: jnp.dot(x, onehot,
                                precision=jax.lax.Precision.HIGHEST)
    rsum = seg_sum(ratio_m)
    zdiff_sum = seg_sum(ratio_m * zdiff)
    zvar_sum = seg_sum(ratio_m * zvar)
    pvar_sum = seg_sum(ratio_m * pose_var)
    group_valid = seg_sum(miss.astype(dtype)) == 0
    seg_any = seg_sum(contrib.astype(dtype)) > 0

    cp_ok = group_valid & seg_any & (rsum > 1e-9)
    safe_rsum = jnp.where(cp_ok, rsum, 1.0)
    cp_zdiff = jnp.where(cp_ok, zdiff_sum / safe_rsum, 0.0)
    cp_zvar = jnp.where(cp_ok, zvar_sum / safe_rsum, jnp.inf)
    m_pose_var = jnp.sum(
        jnp.where(cp_ok, pvar_sum / safe_rsum, 0.0), axis=-1
    )

    if with_debug_points:
        big = jnp.where(contrib, ratio, -jnp.inf)              # [N, C]
        per_seg = jnp.where(
            onehot.astype(bool)[None], big[..., None], -jnp.inf
        )                                                      # [N, C, S]
        rep_idx = jnp.argmax(per_seg, axis=1)                  # [N, S]
        surface = jnp.concatenate(
            [world[..., :2], mean[..., None]], axis=-1
        )                                                      # [N, C, 3]
        cp_point = jnp.take_along_axis(
            surface, rep_idx[..., None], axis=1
        )
    else:
        cp_point = jnp.zeros((n, num_seg, 3), dtype)

    terrain_prob, sp_has = _resolve_terrain_prob(
        terrain_prob, state.group_id, color
    )
    if terrain_prob is not None:
        logp = jnp.where(
            contrib, jnp.log(jnp.maximum(terrain_prob, 1e-30)), 0.0
        )
        cp_prob = jnp.exp(seg_sum(logp))
    else:
        cp_prob = jnp.ones((n, num_seg), dtype)

    if terrain_prob is not None and with_debug_points:
        # slip-point debug payload (SlipPoint, ContactModel.cpp:248-254)
        sp_point = world
        sp_prob = jnp.broadcast_to(terrain_prob, (n, c))
        sp_ok = contrib & sp_has
    else:
        sp_point = jnp.zeros((n, c, 3), dtype)
        sp_prob = jnp.ones((n, c), dtype)
        sp_ok = jnp.zeros((n, c), bool)

    n_contacts = jnp.sum(cp_ok, axis=-1).astype(jnp.int32)
    measurement_valid = n_contacts >= cfg.min_contacts

    if cfg.weighting == "chitta":
        # ChittaContactModel::evaluateWeight (ContactModel.cpp:342-361),
        # batched: anchor at the minimum zdiff, sum squared residuals
        any_ok = jnp.any(cp_ok, axis=-1)
        zmin = jnp.min(jnp.where(cp_ok, cp_zdiff, jnp.inf), axis=-1)
        zmin = jnp.where(any_ok, zmin, 0.0)
        z_t = jnp.sum(
            jnp.where(cp_ok, (cp_zdiff - zmin[:, None]) ** 2, 0.0),
            axis=-1,
        )
        weight = jnp.exp(-z_t / (2.0 * meas_var))
        delta = zmin
        z_var_out = jnp.asarray(meas_var, dtype)
    else:
        # weighting (evaluateWeight), batched
        inv_var = jnp.where(cp_ok, 1.0 / cp_zvar, 0.0)
        d1 = jnp.sum(jnp.where(cp_ok, cp_zdiff, 0.0) * inv_var, axis=-1)
        d2 = jnp.sum(inv_var, axis=-1)
        safe_d2 = jnp.where(d2 > 0, d2, 1.0)
        delta = d1 / safe_d2
        odiff2 = jnp.where(
            cp_ok, (cp_zdiff - delta[:, None]) ** 2 / cp_zvar, 0.0
        )
        log_pz = jnp.zeros((n,), dtype)
        if cfg.use_shape_update:
            log_pz = log_pz - 0.5 * jnp.sum(odiff2, axis=-1)
        if cfg.use_slip_update:
            log_pz = log_pz + jnp.sum(
                jnp.where(cp_ok, jnp.log(jnp.maximum(cp_prob, 1e-30)), 0.0),
                axis=-1,
            )
        weight = jnp.exp(log_pz)
        z_var_out = jnp.where(d2 > 0, 1.0 / safe_d2, jnp.inf)

    return ContactEvalResult(
        measurement_valid=measurement_valid,
        weight=weight,
        z_delta=-delta,
        z_var=z_var_out,
        pose_var=m_pose_var,
        n_contacts=n_contacts,
        cp_point=cp_point,
        cp_zdiff=cp_zdiff,
        cp_zvar=cp_zvar,
        cp_prob=cp_prob,
        cp_ok=cp_ok,
        sp_point=sp_point,
        sp_prob=sp_prob,
        sp_ok=sp_ok,
    )


def evaluate_weight_chitta(cp_zdiff, cp_zvar, cp_ok, meas_var):
    """Literature-variant weighting (``ChittaContactModel::evaluateWeight``,
    ``ContactModel.cpp:342-361``): anchor at the minimum zdiff, sum squared
    residuals of the rest.  Returns ``(weight, z_delta, z_var)``."""
    zmin = jnp.min(jnp.where(cp_ok, cp_zdiff, jnp.inf))
    z_delta = -zmin
    # the anchor contributes (zmin - zmin)^2 = 0, so summing over all
    # selected points matches the reference's skip-first loop
    z_t = jnp.sum(jnp.where(cp_ok, (cp_zdiff + z_delta) ** 2, 0.0))
    weight = jnp.exp(-z_t / (2.0 * meas_var))
    return weight, z_delta, jnp.asarray(meas_var, cp_zvar.dtype)


def update_z_position_estimate(result: ContactEvalResult, z_pos, z_var):
    """1-D Kalman z update with outlier rejection
    (``ContactModel::updateZPositionEstimate``, ``ContactModel.cpp:319-340``).

    Returns ``(accepted, new_z_pos, new_z_var)``; on rejection (normalised
    innovation > 1) the inputs pass through unchanged.
    """
    z_pos = jnp.asarray(z_pos, jnp.result_type(float))
    z_var = jnp.asarray(z_var, z_pos.dtype)
    n = jnp.maximum(result.n_contacts, 1).astype(z_pos.dtype)
    pose_var = result.pose_var / n
    delta_var = jnp.maximum(z_var - pose_var, 1e-9)

    accepted = jnp.abs(result.z_delta / jnp.sqrt(delta_var)) <= 1.0

    gain = z_var / (z_var + result.z_var)
    new_z = z_pos + gain * result.z_delta
    var_gain = delta_var / (delta_var + result.z_var)
    new_var = pose_var + (1.0 - var_gain) * delta_var

    return (
        accepted,
        jnp.where(accepted, new_z, z_pos),
        jnp.where(accepted, new_var, z_var),
    )
