"""Device-resident streaming SLAM: the whole orchestrator loop under
``lax.scan``.

``EmbodiedSlamFilter`` (``filter/eslam_filter.py``) is a host-side
driver that dispatches 2-3 jitted graphs per frame, so per-dispatch
latency bounds it.  This module fuses the *entire* per-frame pipeline
of the reference (``EmbodiedSlamFilter.cpp:353-369`` contact
path + ``:311-351`` laser path) into one jitted scan body:

* odometry update + particle propagation            (every frame)
* measurement gate -> contact weighting + resample  (``lax.cond``)
* map-chain duplication on resample (COW ints — replaces cloneMaps)
* mapping gate -> rollover + scan match + merge     (``lax.cond``)
* optional hash reinjection every ``period`` steps  (``lax.cond``)

The motion gates are computed on device from the per-frame
``body2odometry`` input (position + quaternion), exactly the quantity
the reference gates on — with the intended distance/angle argument
order (the reference swaps them, ``Configuration.hpp:23-26``).

A whole trajectory then runs as ONE device dispatch
(``make_slam_scan_runner``), which is also the honest benchmark shape:
it measures device compute, not host dispatch latency.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from slam_eslam_tpu.config import Config
from slam_eslam_tpu.core.state import BodyContactState
from slam_eslam_tpu.filter import pose_estimator as pe
from slam_eslam_tpu.filter.step import cfg_odo
from slam_eslam_tpu.mapping import map_pool as mp
from slam_eslam_tpu.mapping import projection
from slam_eslam_tpu.models import odometry as odom
from slam_eslam_tpu.utils import geometry


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["filter", "pool", "ud_pos", "ud_q", "map_pos", "map_q",
                 "cam_pos", "cam_q", "update_idx", "alloc_failed"],
    meta_fields=[],
)
@dataclasses.dataclass
class StreamingState:
    """Carry of the fused SLAM scan: filter + map pool + motion-gate
    anchors (the reference's ``udPose``/``mapPose``/``stereoPose``,
    ``EmbodiedSlamFilter.cpp:128,243,313``)."""

    filter: pe.PoseEstimatorState
    pool: mp.MapPool
    ud_pos: jax.Array       # [3] — body2odometry position at last update
    ud_q: jax.Array         # [4]
    map_pos: jax.Array      # [3] — laser pose position at last mapping
    map_q: jax.Array        # [4]
    cam_pos: jax.Array      # [3] — camera pose position at last merge
    cam_q: jax.Array        # [4]
    update_idx: jax.Array   # [] int32
    alloc_failed: jax.Array  # [] int32 — cumulative pool exhaustion

    @staticmethod
    def create(filter_state, pool):
        # each leaf gets its OWN buffer (no shared references): a donated
        # carry must not contain the same buffer twice, or Execute()
        # rejects the double donation
        far = lambda: jnp.array([1000.0, 0.0, 0.0], jnp.float32)
        qid = lambda: jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32)
        zero = lambda: jnp.zeros((), jnp.int32)
        return StreamingState(
            filter=filter_state, pool=pool,
            ud_pos=far(), ud_q=qid(), map_pos=far(), map_q=qid(),
            cam_pos=far(), cam_q=qid(),
            update_idx=zero(),
            alloc_failed=zero(),
        )


def _quat_angle(qa, qb):
    """Rotation angle between two unit quaternions."""
    d = jnp.abs(jnp.sum(qa * qb))
    return 2.0 * jnp.arccos(jnp.clip(d, -1.0, 1.0))


def make_slam_step(cfg: Config, laser2body=None, hash_=None,
                   match=None, update=True, mesh=None,
                   camera2body=None, camera_intrinsics=None,
                   camera_texture=False, odometry_config=None,
                   external_odometry=False):
    """Build the fused per-frame SLAM step.

    ``step(carry: StreamingState, frame) -> (StreamingState, aux)`` with
    ``frame = (contact_state, q [4], body_pos [3], scan_ranges [R],
    scan_meta (start_angle, angular_resolution), has_scan [])``.
    With ``camera2body`` set, two more entries follow:
    ``(..., dimg [H, W], has_dimg [])`` — the distance-image camera path
    of the reference (``EmbodiedSlamFilter.cpp:239-309``), gated by
    ``mapping_camera_threshold`` on its own ``stereoPose`` anchor and
    always merged (match=False, update=True, ``:301``).  With
    ``camera_texture=True`` a final ``timg [H, W, 3]`` entry supplies
    per-frame RGB riding on the merged patches (the ImageRGB24 input,
    ``:259-275``; needs a colour-carrying pool).

    ``laser2body``: static (rot [3,3], trans [3]) sensor extrinsics.
    ``camera_intrinsics``: static (scale_x, scale_y, center_x, center_y)
    of the distance image (the reference builds its ``DistanceGrid``
    once from the first image's parameters, ``:247-252``).
    ``match``: scan-match visual update (default ``cfg.use_visual_update``,
    ``EmbodiedSlamFilter.cpp:342``); ``update``: merge scans into the
    per-particle maps (per-particle mode; ``:344``).

    ``mesh``: shard the particle axis (particles + per-particle chain
    rows) AND the map-block pool over a ``('dp',)`` mesh.  With
    ``cfg.map_pool_shards == mesh size``, block allocation is
    range-local (``mapping.map_pool._allocate``), so a particle's
    active block always lives on its own device: merges, COW copies and
    head lookups are shard-local, and map memory per device scales
    down with the mesh.  Chain tails can reference remote blocks after
    resampling migration — those lookups cross devices (bounded: at most
    ``chain_len - 1`` stale references per particle, re-homed at the
    next rollover).  Tested equal to the single-device run on the
    virtual mesh (the allocation pattern depends on
    ``map_pool_shards``, never on the device count).
    """
    if match is None:
        match = cfg.use_visual_update
    odo_cfg = odometry_config if odometry_config is not None else cfg_odo(cfg)
    threshold = cfg.grid_size / 2.0 * cfg.grid_threshold
    l_rot = (jnp.eye(3, dtype=jnp.float32) if laser2body is None
             else jnp.asarray(laser2body[0], jnp.float32))
    l_trans = (jnp.zeros(3, jnp.float32) if laser2body is None
               else jnp.asarray(laser2body[1], jnp.float32))
    if camera2body is not None:
        c_rot = jnp.asarray(camera2body[0], jnp.float32)
        c_trans = jnp.asarray(camera2body[1], jnp.float32)
        if camera_intrinsics is None:
            raise ValueError(
                "camera2body needs camera_intrinsics=(scale_x, scale_y, "
                "center_x, center_y)"
            )

    def constrain(st, pool):
        if mesh is None:
            return st, pool
        from slam_eslam_tpu.parallel import sharding as shd

        st = dataclasses.replace(
            st, particles=shd.constrain_particles(st.particles, mesh)
        )
        return st, shd.constrain_pool(pool, mesh)

    def step(carry: StreamingState, frame):
        odo_state = None
        if external_odometry:
            # the frame's contact state may be COMPACTED to the active
            # candidate set for the measurement update; the stance-foot
            # odometry differences contact points BY SLOT across frames
            # (odometry.update), which per-frame compaction breaks (the
            # selected subset changes) — so the odometry state arrives
            # precomputed from the FULL contact stream
            # (``precompute_odometry``) instead of updating in-scan
            frame, odo_state = frame
        timg = None
        if camera2body is not None and camera_texture:
            (cs, q, body_pos, ranges, scan_meta, has_scan,
             dimg, has_dimg, timg) = frame
        elif camera2body is not None:
            (cs, q, body_pos, ranges, scan_meta, has_scan,
             dimg, has_dimg) = frame
        else:
            cs, q, body_pos, ranges, scan_meta, has_scan = frame
        body_pos = jnp.asarray(body_pos, jnp.float32)

        # ---- proprioceptive path (EmbodiedSlamFilter.cpp:353-369) ----
        st = carry.filter
        st = dataclasses.replace(
            st,
            odometry=(odo_state if external_odometry
                      else odom.update(st.odometry, cs, q, odo_cfg)),
        )
        st = pe.project(st, q, cfg, use_hash=hash_ is not None)

        dist = jnp.linalg.norm(body_pos - carry.ud_pos)
        angle = _quat_angle(q, carry.ud_q)
        do_update = cfg.measurement_threshold.test(dist, angle)

        def do_meas(op):
            st, pool = op
            lookup = mp.chain_lookup(pool, cfg.mls_z_window)
            st, aux = pe.update(st, cs, q, lookup, cfg)
            # chains follow the resampled particles (identity index when
            # the ESS branch did not fire) — replaces cloneMaps
            # (PoseEstimator.cpp:249-253) with an O(N) int gather
            pool = pool.resample(aux["resample_idx"])
            p = st.particles
            st = dataclasses.replace(
                st, particles=dataclasses.replace(
                    p, map_id=jnp.arange(p.n, dtype=jnp.int32)
                )
            )
            return st, pool, body_pos, q

        def skip_meas(op):
            st, pool = op
            return st, pool, carry.ud_pos, carry.ud_q

        st, pool, ud_pos, ud_q = jax.lax.cond(
            do_update, do_meas, skip_meas, (st, carry.pool)
        )

        # hash reinjection every `period` projections
        # (PoseEstimator.cpp:239-241)
        if hash_ is not None:
            period = max(1, hash_.config.period)
            st = jax.lax.cond(
                st.step % period == 0,
                lambda s: hash_.reinject(s, cs, q, cfg),
                lambda s: s,
                st,
            )

        # ---- laser mapping path (EmbodiedSlamFilter.cpp:311-351) ----
        start_angle, ang_res = scan_meta
        laser_pos = body_pos + geometry.quat_rotate(
            q[None], l_trans[None]
        )[0]
        mdist = jnp.linalg.norm(laser_pos - carry.map_pos)
        mangle = _quat_angle(q, carry.map_q)
        do_map = has_scan & cfg.mapping_threshold.test(mdist, mangle)

        scan = projection.LaserScan(
            ranges=ranges, start_angle=start_angle,
            angular_resolution=ang_res,
        )
        pts, valid = projection.scan_to_points(scan, cfg.max_sensor_range)
        cloud = projection.project_points(pts, valid, l_rot, l_trans, q)
        if update and cfg.grid_use_negative_information:
            # negative information rides the LASER path only
            # (EmbodiedSlamFilter.cpp:160; the camera distMlsOp has none)
            free_pts, free_mask = projection.free_space_points(
                pts, valid, l_rot, l_trans, q
            )

        def do_mapping(op):
            st, pool, update_idx, failed = op
            p = st.particles
            if update:
                pool, f1 = mp.ensure_unique_active(
                    pool, shards=cfg.map_pool_shards
                )
                pool, f2 = mp.rollover(pool, p.xy, threshold,
                                       shards=cfg.map_pool_shards)
                failed = failed + f1 + f2
                if cfg.grid_use_negative_information:
                    pool = mp.apply_negative_cloud_all(
                        pool, p.xy, p.yaw, p.z, free_pts, free_mask
                    )
            if match:
                w = mp.match_cloud_all(
                    pool, p.xy, p.yaw, p.z, p.z_sigma, cloud,
                    sampling=10, sigma=0.2, z_window=cfg.mls_z_window,
                )
                # visualWeighting = 0.1 (EmbodiedSlamFilter.cpp:219-220)
                weight = p.weight * jnp.power(jnp.maximum(w, 1e-30), 0.1)
                st = dataclasses.replace(
                    st, particles=dataclasses.replace(p, weight=weight)
                )
            if update:
                pool = mp.merge_cloud_all(
                    pool, p.xy, p.yaw, p.z, p.z_sigma, cloud, update_idx,
                    patch_thickness=cfg.grid_patch_thickness,
                    gap_size=cfg.grid_gap_size,
                )
                update_idx = update_idx + 1
            return st, pool, update_idx, failed, laser_pos, q

        def skip_mapping(op):
            st, pool, update_idx, failed = op
            return (st, pool, update_idx, failed,
                    carry.map_pos, carry.map_q)

        st, pool, update_idx, failed, map_pos, map_q = jax.lax.cond(
            do_map, do_mapping, skip_mapping,
            (st, pool, carry.update_idx, carry.alloc_failed),
        )

        # ---- camera mapping path (EmbodiedSlamFilter.cpp:239-309) ----
        cam_pos, cam_q = carry.cam_pos, carry.cam_q
        if camera2body is not None:
            sx, sy, ctr_x, ctr_y = camera_intrinsics
            img = projection.DistanceImage(
                data=dimg,
                scale_x=jnp.asarray(sx, jnp.float32),
                scale_y=jnp.asarray(sy, jnp.float32),
                center_x=jnp.asarray(ctr_x, jnp.float32),
                center_y=jnp.asarray(ctr_y, jnp.float32),
            )
            cpts, cvalid = projection.distance_image_to_points(
                img, cfg.max_sensor_range
            )
            ccolor = (
                projection.texture_colors(img, timg)
                if timg is not None else None
            )
            ccloud = projection.project_points(
                cpts, cvalid, c_rot, c_trans, q, color=ccolor
            )
            cam_now = body_pos + geometry.quat_rotate(
                q[None], c_trans[None]
            )[0]
            cdist = jnp.linalg.norm(cam_now - carry.cam_pos)
            cangle = _quat_angle(q, carry.cam_q)
            do_cam = has_dimg & cfg.mapping_camera_threshold.test(
                cdist, cangle
            )

            def do_cam_map(op):
                st, pool, update_idx, failed = op
                p = st.particles
                pool, f1 = mp.ensure_unique_active(
                    pool, shards=cfg.map_pool_shards
                )
                pool, f2 = mp.rollover(pool, p.xy, threshold,
                                       shards=cfg.map_pool_shards)
                # camera merges are always update-only
                # (processMap(scanMap, false, true), :301)
                pool = mp.merge_cloud_all(
                    pool, p.xy, p.yaw, p.z, p.z_sigma, ccloud, update_idx,
                    patch_thickness=cfg.grid_patch_thickness,
                    gap_size=cfg.grid_gap_size,
                )
                return (st, pool, update_idx + 1, failed + f1 + f2,
                        cam_now, q)

            def skip_cam_map(op):
                st, pool, update_idx, failed = op
                return (st, pool, update_idx, failed,
                        carry.cam_pos, carry.cam_q)

            st, pool, update_idx, failed, cam_pos, cam_q = jax.lax.cond(
                do_cam, do_cam_map, skip_cam_map,
                (st, pool, update_idx, failed),
            )

        st, pool = constrain(st, pool)

        c_pos, _ = pe.centroid(st.particles, q,
                               wrap_safe=cfg.wrap_safe_centroid)
        out = StreamingState(
            filter=st, pool=pool, ud_pos=ud_pos, ud_q=ud_q,
            map_pos=map_pos, map_q=map_q, cam_pos=cam_pos, cam_q=cam_q,
            update_idx=update_idx, alloc_failed=failed,
        )
        # best-particle pose (x, y, z, yaw): keyframe clouds extract
        # from the BEST particle's map, so keyframes must anchor at ITS
        # pose — anchoring at the centroid mis-places the cloud by the
        # particle-vs-centroid offset (metres at stretch drift), which
        # scattered every closure alignment (round-5 find)
        bi = jnp.argmax(st.particles.weight)
        best_pose = jnp.stack([
            st.particles.x[bi], st.particles.y[bi],
            st.particles.z[bi], st.particles.yaw[bi],
        ])
        aux = {"centroid": c_pos, "updated": do_update, "mapped": do_map,
               "best_pose": best_pose}
        if camera2body is not None:
            aux["cam_mapped"] = do_cam
        return out, aux

    return step


def make_slam_scan_runner(cfg: Config, laser2body=None, hash_=None,
                          match=None, update=True, mesh=None,
                          camera2body=None, camera_intrinsics=None,
                          camera_texture=False, donate=False,
                          odometry_config=None, external_odometry=False):
    """Roll a whole frame stream through the fused SLAM step on device.

    ``run(carry, frames) -> (carry, aux)`` — ``frames`` is the per-frame
    input pytree of ``make_slam_step`` with a leading time axis.  One
    dispatch per trajectory; all gating happens on device.

    ``donate=True`` donates the carry (filter + map pool) to the call —
    halves peak HBM for large pools (the input pool buffer is reused
    for the output) at the cost of invalidating the passed-in carry.

    ``external_odometry=True``: ``run(carry, frames, odos)`` with
    ``odos`` the stacked per-frame odometry states from
    ``precompute_odometry`` — REQUIRED whenever the frames' contact
    states are compacted (``BodyContactState.compact``), because the
    stance-foot odometry differences contact points by slot across
    frames and compaction re-selects the slots every frame.
    """
    step = make_slam_step(cfg, laser2body=laser2body, hash_=hash_,
                          match=match, update=update, mesh=mesh,
                          camera2body=camera2body,
                          camera_intrinsics=camera_intrinsics,
                          camera_texture=camera_texture,
                          odometry_config=odometry_config,
                          external_odometry=external_odometry)

    if external_odometry:
        @partial(jax.jit, donate_argnums=(0,) if donate else ())
        def run(carry: StreamingState, frames, odos):
            return jax.lax.scan(step, carry, (frames, odos))
    else:
        @partial(jax.jit, donate_argnums=(0,) if donate else ())
        def run(carry: StreamingState, frames):
            return jax.lax.scan(step, carry, frames)

    return run


def precompute_odometry(num_points, contact_states, orientations,
                        odo_cfg=None, cfg: Config = None):
    """Per-frame odometry states from the FULL (uncompacted) contact
    stream: one ``lax.scan`` of ``odometry.update`` over the
    trajectory.  The odometry chain is particle-independent, so it can
    be hoisted out of the per-particle SLAM scan and its result fed to
    ``make_slam_scan_runner(external_odometry=True)`` while the frames
    carry measurement-compacted contact states.

    ``contact_states``: stacked ``BodyContactState`` with leading time
    axis (C = ``num_points``, uncompacted); ``orientations [T, 4]``.
    Returns the stacked ``FootContactOdometry`` pytree ([T, ...]).
    """
    if odo_cfg is None:
        odo_cfg = cfg_odo(cfg) if cfg is not None else cfg_odo(Config())

    @jax.jit
    def run(cs, qs):
        def body(odo, inp):
            c, q = inp
            new = odom.update(odo, c, q, odo_cfg)
            return new, new

        odo0 = odom.FootContactOdometry.create(num_points)
        _, states = jax.lax.scan(body, odo0, (cs, qs))
        return states

    return run(contact_states, orientations)


def stack_frames(frames):
    """Host helper: list of per-frame tuples -> stacked input pytree."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *frames
    )


def frames_from_log(path, camera=False, texture=False):
    """Recorded traverse (native log) -> the stacked frame pytree of
    ``make_slam_step``, via the batched C gather path
    (``io.logio.load_stream``): the whole log becomes a handful of
    contiguous host buffers and then device arrays — no per-record
    Python decode.  Requires pose records for the motion gates.

    Returns ``(frames, ts [T])``.  With ``camera=True`` the frames
    include the distance-image entries (requires DISTANCE_IMAGE records)
    and the return is ``(frames, ts, intrinsics)`` — pass ``intrinsics``
    as ``camera_intrinsics`` to ``make_slam_scan_runner``.  With
    ``texture=True`` the frames additionally carry per-frame RGB
    textures (TEXTURE_IMAGE records; pass ``camera_texture=True`` to the
    runner, which then needs a colour-carrying pool).
    """
    import numpy as np

    from slam_eslam_tpu.io import logio

    s = logio.load_stream(path)
    t = s["contact"].shape[0]
    if s["pose"] is None:
        raise ValueError(
            "streaming replay needs pose records (the motion-gate input)"
        )
    if s["orientation"] is None:
        raise ValueError("streaming replay needs orientation records")
    contact = s["contact"]
    # stacked [T, ...] leaves (lax.scan slices the leading axis)
    cs = BodyContactState(
        position=jnp.asarray(contact["position"], jnp.float32),
        contact=jnp.asarray(contact["contact"], jnp.float32),
        slip=jnp.asarray(contact["slip"], jnp.float32),
        group_id=jnp.asarray(contact["group_id"], jnp.int32),
        valid=jnp.ones(contact["contact"].shape, bool),
    )
    if s["scan_ranges"] is not None:
        ranges = jnp.asarray(s["scan_ranges"])
        start, res = s["scan_meta"]
    else:  # no scans: feed empty rays, gate never fires
        ranges = jnp.zeros((t, 1), jnp.float32)
        start, res = 0.0, 1.0
    meta = (
        jnp.full((t,), start, jnp.float32),
        jnp.full((t,), res, jnp.float32),
    )
    frames = (
        cs,
        jnp.asarray(s["orientation"]),
        jnp.asarray(s["pose"][:, :3]),
        ranges,
        meta,
        jnp.asarray(s["has_scan"]),
    )
    if not camera:
        return frames, np.asarray(s["ts"])
    if s["dimg"] is None:
        raise ValueError(
            f"camera=True but {path} has no DISTANCE_IMAGE records"
        )
    frames = frames + (
        jnp.asarray(s["dimg"]), jnp.asarray(s["has_dimg"])
    )
    if texture:
        if s["timg"] is None:
            raise ValueError(
                f"texture=True but {path} has no TEXTURE_IMAGE records"
            )
        frames = frames + (jnp.asarray(s["timg"]),)
    return frames, np.asarray(s["ts"]), s["dimg_meta"]
