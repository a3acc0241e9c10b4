"""Embodied-SLAM orchestrator: the application-level API.

Array-program rebuild of ``eslam::EmbodiedSlamFilter``
(``/root/reference/src/EmbodiedSlamFilter.{hpp,cpp}``): owns the contact
odometry, pose estimator, shared or per-particle MLS maps, and the
sensor projection pipelines; gates measurement/mapping updates on
accumulated motion; merges scans into every particle's map.

Functional-core / OO-shell: this class is a thin host-side driver; all
state is device pytrees and all per-step work runs in a handful of
jitted functions (map state travels as arguments, so map growth never
retraces).  Motion gating happens host-side on the (host-provided)
odometry input transform, exactly the information the reference gates on
(``EmbodiedSlamFilter.cpp:243,313,360``) — the device graphs stay
branch-free.

API parity map (reference -> here):
  init(env, pose, useSharedMap, hashConfig)      -> init(...)
  update(body2odo, BodyContactState, ltc)        -> update_contact(...)
  update(body2odo, LaserScan, laser2body)        -> update_scan(...)
  update(body2odo, DistanceImage, camera2body)   -> update_distance_image(...)
  update(Featurecloud*) stub returning false     -> update_featurecloud(...)
  processMap(scanMap, match, update)             -> process_map(...)
  getParticles/getBestParticleIndex/getCentroid  -> same names (snake_case)
  createGridTemplate/createMapTemplate           -> make_grid_template(...)
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

from slam_eslam_tpu.config import Config, OdometryConfig, SurfaceHashConfig
from slam_eslam_tpu.core import filter as pf
from slam_eslam_tpu.core.state import BodyContactState
from slam_eslam_tpu.filter import pose_estimator as pe
from slam_eslam_tpu.mapping import map_pool as mp
from slam_eslam_tpu.mapping import mls_grid, projection
from slam_eslam_tpu.mapping.lookup import make_lookup
from slam_eslam_tpu.utils import geometry


def _affine(q, t):
    m = np.eye(4)
    m[:3, :3] = np.asarray(geometry.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    m[:3, 3] = np.asarray(t)
    return m


def _motion(delta):
    dist = float(np.linalg.norm(delta[:3, 3]))
    angle = float(
        np.arccos(np.clip((np.trace(delta[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
    )
    return dist, angle


class EmbodiedSlamFilter:
    """See module docstring.  Construction mirrors the reference ctor
    (``EmbodiedSlamFilter.cpp:13-23``)."""

    def __init__(self, odometry_config: OdometryConfig = None,
                 config: Config = None):
        self.config = config or Config()
        self.odometry_config = odometry_config or OdometryConfig()
        self.state: pe.PoseEstimatorState | None = None
        self.shared_grid: mls_grid.MLSGrid | None = None
        self.pool: mp.MapPool | None = None
        self.use_shared_map = True
        self.hash = None
        # motion gates, "far away" init as in the reference (:128)
        far = np.eye(4)
        far[0, 3] = 1000.0
        self.ud_pose = far.copy()
        self.map_pose = far.copy()
        self.stereo_pose = far.copy()
        self.update_idx = 0
        self._jit_cache = {}

    # ------------------------------------------------------------------
    # construction helpers (createGridTemplate / createMapTemplate,
    # EmbodiedSlamFilter.cpp:25-67)
    # ------------------------------------------------------------------

    def make_grid_template(self, origin_xy=(0.0, 0.0), center=None):
        cfg = self.config
        n = int(round(cfg.grid_size / cfg.grid_resolution))
        if center is not None:
            origin_xy = (
                center[0] - cfg.grid_size / 2.0,
                center[1] - cfg.grid_size / 2.0,
            )
        return mls_grid.MLSGrid.create(
            n, n, cfg.grid_resolution, origin_xy, cfg.mls_patches_per_cell
        )

    # ------------------------------------------------------------------
    # init (EmbodiedSlamFilter.cpp:70-177)
    # ------------------------------------------------------------------

    def init(self, pose, shared_grid: mls_grid.MLSGrid = None,
             use_shared_map=True, hash_config: SurfaceHashConfig = None,
             num_contact_points=20, key=None):
        """``pose`` = (position [3], yaw).  In shared-map mode a
        prebuilt MLS grid must be supplied (the reference throws when the
        environment has none, ``EmbodiedSlamFilter.cpp:104``).

        In per-particle mode (``use_shared_map=False``) a supplied
        ``shared_grid`` seeds every particle's map with a copy of that
        environment grid — the reference's clone-from-env semantics
        (finds the env MLSGrid, then ``setEnvironment`` +  ``cloneMaps``
        deep-clones it per particle, ``EmbodiedSlamFilter.cpp:75-126``,
        ``PoseEstimator.cpp:47-62``); without one, a fresh blank
        template centred on the start pose is used (pure SLAM).
        The surface hash builds from ``shared_grid`` in EITHER mode
        (``EmbodiedSlamFilter.cpp:93-98``), enabling global
        relocalisation in full-SLAM runs."""
        cfg = self.config
        position, yaw = np.asarray(pose[0], np.float64), float(pose[1])
        self.use_shared_map = use_shared_map

        if use_shared_map:
            if shared_grid is None:
                raise ValueError(
                    "shared-map mode requires an MLS grid "
                    "(EmbodiedSlamFilter.cpp:104)"
                )
            self.shared_grid = shared_grid
            self.pool = None
        else:
            template = (
                shared_grid if shared_grid is not None
                else self.make_grid_template(center=position[:2])
            )
            self.pool = mp.MapPool.from_template(
                template, cfg.particle_count, cfg.map_pool_blocks,
                cfg.map_chain_length, with_color=cfg.map_pool_color,
                shards=cfg.map_pool_shards,
                dtype=jnp.dtype(cfg.map_pool_dtype),
            )
            self.shared_grid = None

        key = key if key is not None else jax.random.PRNGKey(cfg.seed)
        key, k_init = jax.random.split(key)

        self.state = pe.PoseEstimatorState.create(
            cfg, num_contact_points, key=key
        )
        use_hash = hash_config is not None and hash_config.use_hash
        if use_hash:
            from slam_eslam_tpu.filter import surface_hash as sh

            if shared_grid is None:
                raise ValueError(
                    "the surface hash precomputes over a prebuilt "
                    "environment grid — pass shared_grid "
                    "(EmbodiedSlamFilter.cpp:93-98 builds the hash from "
                    "the env's MLSGrid in both map modes)"
                )
            self.hash = sh.SurfaceHash.create(hash_config, shared_grid)
            particles = self.hash.sample_particles(
                k_init, cfg.particle_count
            )
        else:
            particles = pe.init_gaussian(
                k_init, cfg.particle_count,
                position[:2], yaw,
                (cfg.initial_translation_error[0],
                 cfg.initial_translation_error[1]),
                cfg.initial_rotation_error[2],
                position[2],
                cfg.initial_translation_error[2] + 1e-3,
            )
        if not use_shared_map:
            particles = dataclasses.replace(
                particles,
                map_id=jnp.arange(cfg.particle_count, dtype=jnp.int32),
            )
        self.state = dataclasses.replace(self.state, particles=particles)
        return self

    # ------------------------------------------------------------------
    # jitted cores
    # ------------------------------------------------------------------

    def _update_fn(self):
        if "update" not in self._jit_cache:
            cfg = self.config
            shared = self.use_shared_map
            use_slip = cfg.contact_model.use_slip_update

            @jax.jit
            def f(state, cs, q, map_state, wheel_probs, wheel_valid):
                # production lookup: the exact packed gather with its
                # contact fold (the slip update reads patch colours ->
                # unpacked gather)
                lookup = (
                    make_lookup(cfg, map_state)
                    if shared
                    else mp.chain_lookup(map_state, cfg.mls_z_window)
                )
                terrain_prob = None
                if use_slip:
                    from slam_eslam_tpu.models import terrain as terr

                    terrain_prob = lambda gid, color: terr.per_point_probability(
                        gid, color, wheel_probs, wheel_valid,
                        with_mask=True,  # feeds spoints debug capture
                    )
                state, aux = pe.update(
                    state, cs, q, lookup, cfg, terrain_prob=terrain_prob
                )
                return state, aux["resampled"], aux["resample_idx"], aux["ess"]

            self._jit_cache["update"] = f
        return self._jit_cache["update"]

    def _project_fn(self):
        if "project" not in self._jit_cache:
            cfg = self.config
            use_hash = self.hash is not None

            @jax.jit
            def f(state, cs, q):
                odo_cfg = self.odometry_config
                from slam_eslam_tpu.models import odometry as odom

                new_odo = odom.update(state.odometry, cs, q, odo_cfg)
                state = dataclasses.replace(state, odometry=new_odo)
                return pe.project(state, q, cfg, use_hash=use_hash)

            self._jit_cache["project"] = f
        return self._jit_cache["project"]

    def _process_map_fn(self, match, update):
        key = ("pm", match, update)
        if key not in self._jit_cache:
            cfg = self.config
            threshold = cfg.grid_size / 2.0 * cfg.grid_threshold

            @jax.jit
            def f(state, pool, cloud, update_idx, free_pts, free_mask):
                p = state.particles
                n_failed = jnp.zeros((), jnp.int32)
                if update:
                    pool_u, f1 = mp.ensure_unique_active(
                        pool, shards=cfg.map_pool_shards
                    )
                    pool_u, f2 = mp.rollover(
                        pool_u, p.xy, threshold,
                        shards=cfg.map_pool_shards,
                    )
                    pool = pool_u
                    n_failed = f1 + f2
                    if free_pts is not None:
                        # laser-path negative information
                        # (EmbodiedSlamFilter.cpp:160)
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
                    state = dataclasses.replace(
                        state,
                        particles=dataclasses.replace(p, weight=weight),
                    )
                if update:
                    pool = mp.merge_cloud_all(
                        pool, p.xy, p.yaw, p.z, p.z_sigma, cloud,
                        update_idx,
                        patch_thickness=cfg.grid_patch_thickness,
                        gap_size=cfg.grid_gap_size,
                    )
                return state, pool, n_failed

            self._jit_cache[key] = f
        return self._jit_cache[key]

    # ------------------------------------------------------------------
    # proprioceptive update (EmbodiedSlamFilter.cpp:353-369)
    # ------------------------------------------------------------------

    def update_contact(self, body2odometry, contact_state: BodyContactState,
                       terrain_classifications=None):
        """``body2odometry`` = (orientation quat [4], position [3]) in the
        odometry frame.  Always advances odometry + propagation; runs the
        measurement update when the motion gate fires or terrain labels
        are present.  Returns True when the measurement update ran."""
        q_np, t_np = body2odometry
        q = jnp.asarray(q_np, jnp.float32)
        self.state = self._project_fn()(self.state, contact_state, q)

        pose = _affine(q_np, t_np)
        dist, angle = _motion(np.linalg.inv(self.ud_pose) @ pose)
        ltc = terrain_classifications
        # non-empty terrain labels force the update
        # (ltc.size() > 0, EmbodiedSlamFilter.cpp:360)
        if ltc is None:
            has_ltc = False
        elif hasattr(ltc, "__len__"):
            has_ltc = len(ltc) > 0
        else:
            has_ltc = True
        gate = bool(
            dist > self.config.measurement_threshold.distance
            or angle > self.config.measurement_threshold.angle
            or has_ltc
        )
        if not gate:
            return False

        # terrain labels -> dense per-wheel class tables
        # (terrain_estimator capability, ContactModel.cpp:226-260):
        # accepts [(wheel_idx, class_probs), ...] or a prebuilt
        # (wheel_probs [W, K], wheel_valid [W]) pair
        from slam_eslam_tpu.models import terrain as terr
        from slam_eslam_tpu.models.asguard import NUM_WHEELS

        wheel_probs = np.full(
            (NUM_WHEELS, terr.NUM_CLASSES), 1.0 / terr.NUM_CLASSES,
            np.float32,
        )
        wheel_valid = np.zeros((NUM_WHEELS,), bool)
        if has_ltc:
            if isinstance(ltc, tuple) and len(ltc) == 2:
                wheel_probs = np.asarray(ltc[0], np.float32)
                wheel_valid = np.asarray(ltc[1], bool)
            else:
                for wheel_idx, probs in ltc:
                    wheel_probs[int(wheel_idx)] = np.asarray(
                        probs, np.float32
                    )
                    wheel_valid[int(wheel_idx)] = True

        map_state = self.shared_grid if self.use_shared_map else self.pool
        state, resampled, idx, ess = self._update_fn()(
            self.state, contact_state, q, map_state,
            jnp.asarray(wheel_probs), jnp.asarray(wheel_valid),
        )
        self.state = state
        if not self.use_shared_map and bool(resampled):
            # chains follow the particles; weights/maps stay consistent
            # (replaces cloneMaps-on-resample, PoseEstimator.cpp:249-253)
            self.pool = self.pool.resample(np.asarray(idx))
            self.state = dataclasses.replace(
                self.state,
                particles=dataclasses.replace(
                    self.state.particles,
                    map_id=jnp.arange(
                        self.config.particle_count, dtype=jnp.int32
                    ),
                ),
            )
        if self.hash is not None:
            self._maybe_hash_reinjection(contact_state, q)
        self.ud_pose = pose
        return True

    def _maybe_hash_reinjection(self, contact_state, q):
        hcfg = self.hash.config
        step = int(self.state.step)
        if step % max(1, hcfg.period) == 0:
            self.state = self.hash.reinject(
                self.state, contact_state, q, self.config
            )

    # ------------------------------------------------------------------
    # exteroceptive updates (EmbodiedSlamFilter.cpp:239-351)
    # ------------------------------------------------------------------

    def update_scan(self, body2odometry, scan: projection.LaserScan,
                    laser2body):
        """Laser mapping update (``EmbodiedSlamFilter.cpp:311-351``).
        ``laser2body`` = (rot [3,3], trans [3]).  Returns True when the
        mapping gate fired."""
        q_np, t_np = body2odometry
        pose = _affine(q_np, t_np) @ np.vstack(
            [np.hstack([np.asarray(laser2body[0]),
                        np.asarray(laser2body[1])[:, None]]),
             [0, 0, 0, 1]]
        )
        dist, angle = _motion(np.linalg.inv(self.map_pose) @ pose)
        if not (dist > self.config.mapping_threshold.distance
                or angle > self.config.mapping_threshold.angle):
            return False

        q = jnp.asarray(q_np, jnp.float32)
        l_rot = jnp.asarray(laser2body[0], jnp.float32)
        l_trans = jnp.asarray(laser2body[1], jnp.float32)
        pts, valid = projection.scan_to_points(
            scan, self.config.max_sensor_range
        )
        cloud = projection.project_points(pts, valid, l_rot, l_trans, q)
        update = not self.use_shared_map
        free = None
        if update and self.config.grid_use_negative_information:
            # the reference's only negative-information site is the
            # laser MLSProjection (EmbodiedSlamFilter.cpp:160); it only
            # has effect where the scan map is merged (per-particle mode)
            free = projection.free_space_points(
                pts, valid, l_rot, l_trans, q
            )
        self.process_map(
            cloud,
            match=self.config.use_visual_update,
            update=update,
            free=free,
        )
        self.map_pose = pose
        return True

    def update_distance_image(self, body2odometry,
                              dimage: projection.DistanceImage,
                              camera2body, texture=None):
        """Camera mapping update (``EmbodiedSlamFilter.cpp:239-309``).
        Note the reference always merges here regardless of shared-map
        mode (``:301``) — replicated."""
        q_np, t_np = body2odometry
        pose = _affine(q_np, t_np) @ np.vstack(
            [np.hstack([np.asarray(camera2body[0]),
                        np.asarray(camera2body[1])[:, None]]),
             [0, 0, 0, 1]]
        )
        dist, angle = _motion(np.linalg.inv(self.stereo_pose) @ pose)
        if not (dist > self.config.mapping_camera_threshold.distance
                or angle > self.config.mapping_camera_threshold.angle):
            return False

        q = jnp.asarray(q_np, jnp.float32)
        pts, valid = projection.distance_image_to_points(
            dimage, self.config.max_sensor_range
        )
        color = (
            projection.texture_colors(dimage, texture)
            if texture is not None else None
        )
        cam_rot = jnp.asarray(camera2body[0], jnp.float32)
        cam_trans = jnp.asarray(camera2body[1], jnp.float32)
        cloud = projection.project_points(
            pts, valid, cam_rot, cam_trans, q, color=color,
        )
        # NOTE: no negative information here — the reference's camera
        # MLSProjection (distMlsOp) does NOT enable it
        # (EmbodiedSlamFilter.cpp:172-176); only the laser path does
        # (:160, see update_scan)
        if self.use_shared_map:
            # no per-particle pool exists; merging into the shared grid
            # is a single merge under the centroid pose
            pos, quat = self.get_centroid()
            r2 = np.asarray(
                geometry.rot2d(jnp.asarray(geometry.yaw_from_quat(quat)))
            )
            self.shared_grid = mls_grid.merge_cloud(
                self.shared_grid, cloud, jnp.asarray(r2),
                jnp.asarray(pos[:2]), jnp.asarray(pos[2]),
                jnp.asarray(0.0), self.update_idx,
                patch_thickness=self.config.grid_patch_thickness,
                gap_size=self.config.grid_gap_size,
            )
            self.update_idx += 1
        else:
            self.process_map(cloud, match=False, update=True)
        self.stereo_pose = pose
        return True

    def run_stream(self, frames, laser2body=None, mesh=None,
                   camera2body=None, camera_intrinsics=None,
                   camera_texture=False, donate=False):
        """Device-resident execution of a whole frame stream
        (``filter.streaming``): every per-frame update this class would
        dispatch individually runs inside ONE ``lax.scan`` dispatch —
        the deployment/benchmark shape.

        ``frames``: stacked pytree from ``streaming.stack_frames`` or
        ``streaming.frames_from_log``.  Requires per-particle-map mode.
        Consumes and updates this filter's state (incl. motion-gate
        anchors and ``update_idx``).  Returns the per-frame ``aux``
        (centroids, gate booleans) plus ``alloc_failed_total`` — the
        cumulative count of map-pool exhaustion events (silently
        degraded merges) over the stream.
        """
        from slam_eslam_tpu.filter import streaming

        if self.use_shared_map:
            raise ValueError(
                "run_stream requires per-particle-map mode "
                "(use_shared_map=False); shared-map tracking streams "
                "via filter.step.make_scan_runner"
            )
        # cache key: extrinsics by CONTENT (a runner closes over the
        # laser2body values — keying on identity would silently reuse a
        # runner compiled with different extrinsics); the mesh entry
        # keeps a strong reference so its id cannot be recycled
        def _extr(e):
            return (
                None if e is None
                else (np.asarray(e[0], np.float32).tobytes()
                      + np.asarray(e[1], np.float32).tobytes())
            )

        key = ("stream", _extr(laser2body), _extr(camera2body),
               camera_intrinsics, camera_texture, self.odometry_config,
               donate, None if mesh is None else id(mesh))
        if key not in self._jit_cache:
            self._jit_cache[key] = (
                streaming.make_slam_scan_runner(
                    self.config, laser2body=laser2body, hash_=self.hash,
                    mesh=mesh, camera2body=camera2body,
                    camera_intrinsics=camera_intrinsics,
                    camera_texture=camera_texture,
                    odometry_config=self.odometry_config,
                    donate=donate,
                ),
                mesh,  # strong ref: pins id(mesh) for the cache lifetime
            )
        carry = streaming.StreamingState.create(self.state, self.pool)
        # resume the motion-gate anchors from the host-side state
        carry = dataclasses.replace(
            carry,
            ud_pos=jnp.asarray(self.ud_pose[:3, 3], jnp.float32),
            ud_q=geometry.quat_from_matrix(
                jnp.asarray(self.ud_pose[:3, :3], jnp.float32)
            ),
            map_pos=jnp.asarray(self.map_pose[:3, 3], jnp.float32),
            map_q=geometry.quat_from_matrix(
                jnp.asarray(self.map_pose[:3, :3], jnp.float32)
            ),
            cam_pos=jnp.asarray(self.stereo_pose[:3, 3], jnp.float32),
            cam_q=geometry.quat_from_matrix(
                jnp.asarray(self.stereo_pose[:3, :3], jnp.float32)
            ),
            update_idx=jnp.asarray(self.update_idx, jnp.int32),
        )
        runner, _ = self._jit_cache[key]
        carry, aux = runner(carry, frames)
        if donate:
            # the carry aliased self.state/self.pool buffers; donation
            # invalidated them — halves peak pool HBM across chunked
            # streams.  Reassignment from the outputs below keeps the
            # donation contract (the caller never reuses the donated
            # buffers); nulling BEFORE the call would brick the filter
            # if the runner raised (advisor round 4).
            self.state = self.pool = None
        self.state = carry.filter
        self.pool = carry.pool
        self.update_idx = int(carry.update_idx)
        self.ud_pose = _affine(np.asarray(carry.ud_q),
                               np.asarray(carry.ud_pos))
        self.map_pose = _affine(np.asarray(carry.map_q),
                                np.asarray(carry.map_pos))
        self.stereo_pose = _affine(np.asarray(carry.cam_q),
                                   np.asarray(carry.cam_pos))
        # surface pool exhaustion (silently dropped merges) to callers
        aux["alloc_failed_total"] = carry.alloc_failed
        nf = int(carry.alloc_failed)
        if nf:
            import sys

            print(
                f"slam_eslam_tpu: map pool exhausted {nf} times during "
                "the stream (merges degraded; raise map_pool_blocks)",
                file=sys.stderr,
            )
        return aux

    def update_featurecloud(self, *_args, **_kw):
        """Stereo feature clouds are unsupported, as in the reference
        (stub returning false, ``EmbodiedSlamFilter.cpp:234-237``)."""
        return False

    def process_map(self, cloud: mls_grid.PatchCloud, match, update,
                    free=None):
        """Per-particle scan match / map merge
        (``EmbodiedSlamFilter::processMap``,
        ``EmbodiedSlamFilter.cpp:179-232``).  ``free``: optional
        ``(points [F, 3], mask [F])`` free-space samples for the
        laser path's negative information (applied before the merge)."""
        if self.pool is None:
            if match:
                # shared map: match against the shared grid
                cfg = self.config
                p = self.state.particles
                w = jax.jit(
                    lambda g, c, pp: jax.vmap(
                        lambda x, th, zo, os_: mls_grid.match_cloud(
                            g, c, geometry.rot2d(th), x, zo, os_,
                            sampling=10, sigma=0.2,
                            z_window=cfg.mls_z_window,
                        )
                    )(pp.xy, pp.yaw, pp.z, pp.z_sigma)
                )(self.shared_grid, cloud, p)
                weight = p.weight * jnp.power(jnp.maximum(w, 1e-30), 0.1)
                self.state = dataclasses.replace(
                    self.state,
                    particles=dataclasses.replace(p, weight=weight),
                )
            return
        fn = self._process_map_fn(match, update)
        free_pts, free_mask = free if free is not None else (None, None)
        state, pool, n_failed = fn(
            self.state, self.pool, cloud, self.update_idx,
            free_pts, free_mask,
        )
        self.state, self.pool = state, pool
        if update:
            self.update_idx += 1
            nf = int(n_failed)
            if nf:
                import sys

                print(
                    f"slam_eslam_tpu: map pool exhausted for {nf} particles",
                    file=sys.stderr,
                )

    # ------------------------------------------------------------------
    # outputs (EmbodiedSlamFilter.cpp:371-384)
    # ------------------------------------------------------------------

    def get_particles(self):
        return self.state.particles

    def get_best_particle_index(self):
        return int(pf.best_particle_index(self.state.particles.weight))

    def get_centroid(self):
        """(position [3], orientation quat [4])."""
        q = self.state.odometry.prev_orientation
        return pe.centroid(self.state.particles, q,
                           wrap_safe=self.config.wrap_safe_centroid)

    def get_distribution(self, body_state=None, n_components=3):
        """Export the observable ``PoseDistribution`` (particles + 2-D
        GMM + orientation + contact state; ``PoseParticle.hpp:88-114``)."""
        from slam_eslam_tpu.core.distribution import export_distribution

        if body_state is None:
            body_state = BodyContactState.create(
                np.zeros((1, 3), np.float32)
            )
        key = jax.random.fold_in(self.state.key, 17)
        return export_distribution(
            key, self.state.particles,
            self.state.odometry.prev_orientation, body_state,
            n_components=n_components,
        )

    def maybe_log_distribution(self, body_state=None):
        """Period-gated distribution export (``logParticlePeriod``,
        ``Configuration.hpp:207-212``): returns a ``PoseDistribution``
        every Nth step, else None; period 0 disables."""
        period = self.config.log_particle_period
        if not period:
            return None
        if int(self.state.step) % period != 0:
            return None
        return self.get_distribution(body_state)
