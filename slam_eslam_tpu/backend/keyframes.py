"""Keyframe manager: ties the pose-graph backend into the SLAM loop.

Usage pattern (see ``examples/loop_closure_demo.py`` / tests): during a
traverse, call ``maybe_add_keyframe`` with the current centroid pose +
scan cloud; the manager

1. stores a keyframe (pose + cloud) every ``keyframe_distance`` metres,
2. chains consecutive keyframes with odometry edges,
3. when the robot re-enters the neighbourhood of an old keyframe
   (candidate gating by distance + minimum index separation), aligns
   the current cloud against an MLS grid built from the old keyframe's
   cloud (``backend.pose_graph.scan_align``) and, if the match score
   passes, adds a loop-closure edge,
4. ``optimize()`` runs Gauss-Newton over the whole graph and returns
   the corrected trajectory.

Host-side orchestration; all heavy steps (alignment sweeps, GN) are
jitted device code.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp

from slam_eslam_tpu.backend import pose_graph as pgr
from slam_eslam_tpu.mapping import mls_grid


@dataclasses.dataclass
class Keyframe:
    index: int
    node_id: int
    pose: np.ndarray       # (x, y, yaw) at insertion
    cloud: object          # PatchCloud in body frame
    z: float


class KeyframeManager:
    def __init__(self, keyframe_distance=0.5, closure_radius=1.0,
                 min_separation=5, min_score=0.35, min_ratio=1.25,
                 grid_resolution=0.2, grid_cells=48,
                 max_nodes=256, max_edges=1024,
                 odom_info=100.0, odom_info_yaw=1e4,
                 closure_info=300.0, closure_info_yaw_scale=0.1,
                 yaw_prior_info=0.0,
                 align_search_xy=0.5, align_search_yaw=0.3,
                 align_steps_xy=9, align_steps_yaw=7,
                 align_sigma=0.2, align_search_z=0.0, align_steps_z=1,
                 align_coarse=None):
        # NOTE: the alignment score averages over ALL sampled cloud
        # points (misses count 0), so keyframe grids must be coarse
        # enough that the stored cloud covers most cells — hence the
        # 0.2 m default resolution.
        self.kf_dist = keyframe_distance
        self.closure_radius = closure_radius
        self.min_separation = min_separation
        self.min_score = min_score
        # peak-distinctiveness gate: best score vs best far-field score
        # (``scan_align(return_ratio=True)``).  On self-similar terrain
        # false closures ride a FLAT score surface — their absolute
        # score matches true revisits but their peak barely beats the
        # far field.  1.0 disables (ratio >= 1 by construction).
        # Default 1.25 is measured, not guessed: on the round-5 100 m
        # stretch dump all 12 ground-truth-false closures had ratio
        # <= 1.22 while 13/17 true ones exceeded 1.25 — the gate keeps
        # 14 closures with 0 false (tools/closure_lab.py,
        # docs/closure_lab_r05.txt).
        self.min_ratio = min_ratio
        self.grid_resolution = grid_resolution
        self.grid_cells = grid_cells
        self.odom_info = odom_info
        # relative yaw between keyframes rides the IMU (the filter's
        # orientation input is absolute attitude), so odometry edges
        # are yaw-STIFF: with yaw as loose as xy the optimiser bends
        # accumulated closure misfit into trajectory rotation — metres
        # of position error for centiradians of residual (round-5
        # stretch find: kf ATE 2.3 -> 13 m through yaw bending)
        self.odom_info_yaw = odom_info_yaw
        self.closure_info = closure_info
        # scan-align yaw comes from a coarse sweep (~0.075 rad steps):
        # closure yaw constraints carry proportionally less weight
        self.closure_info_yaw_scale = closure_info_yaw_scale
        # ABSOLUTE heading prior per node (yaw-only edges to node 0):
        # the platform's orientation input is absolute IMU attitude,
        # so each keyframe's heading is directly observed — without
        # this the optimiser trades centiradians of trajectory bend
        # for metres of closure residual (round-5 stretch find).
        # Callers pass the IMU yaw via ``maybe_add_keyframe(abs_yaw=)``
        self.yaw_prior_info = yaw_prior_info
        self._yaw0 = None
        # alignment sweep extent: must cover the expected odometry
        # drift between revisits or closures silently miss
        self.align_search_xy = align_search_xy
        self.align_search_yaw = align_search_yaw
        self.align_steps_xy = align_steps_xy
        self.align_steps_yaw = align_steps_yaw
        # score kernel width: must resolve the terrain's height
        # variation or the score surface flattens and the sweep
        # settles on maximum overlap instead of the true offset
        self.align_sigma = align_sigma
        self.align_search_z = align_search_z
        self.align_steps_z = align_steps_z
        # coarse-to-fine: ``(search_xy, steps_xy, sigma)`` for a wide
        # stage-A sweep whose peak seeds the fine sweep above.  Long
        # routes accumulate drift far beyond a fine sweep's extent
        # (round-4 stretch: ~6 m over a 100 m traverse vs a ±1.5 m
        # sweep) — a blurred coarse correlation localises the revisit
        # to within the fine sweep's range first.
        self.align_coarse = align_coarse
        self.builder = pgr.PoseGraphBuilder(max_nodes, max_edges)
        # jitted alignment/merge seams: keyframe clouds arrive at one
        # fixed padded shape (``OnlineSlam._local_map_cloud``), so each
        # (steps, shape) combination compiles once — the eager sweeps
        # recompiled per keyframe at stretch scale
        import jax as _jax

        self._align_jit = _jax.jit(
            pgr.scan_align,
            static_argnames=("steps_xy", "steps_yaw", "steps_z",
                             "return_ratio"),
        )
        self._merge_jit = _jax.jit(mls_grid.merge_cloud)
        self.keyframes: list[Keyframe] = []
        self.closures: list[tuple] = []
        # per-closure diagnostics (aligned pose, score, ratio) for
        # closure-quality reporting — parallel to ``closures``
        self.closure_details: list[dict] = []
        self._optimized_edges = 0  # edges present at the last optimize

    def _rel_pose(self, a, b):
        """Pose of b in a's frame."""
        c, s = np.cos(a[2]), np.sin(a[2])
        dt = b[:2] - a[:2]
        return np.array(
            [c * dt[0] + s * dt[1], -s * dt[0] + c * dt[1],
             pgr.wrap_angle(jnp.asarray(b[2] - a[2]))]
        , dtype=float)

    def _kf_grid(self, kf: Keyframe):
        """Local MLS grid of a keyframe's cloud, in world frame."""
        half = self.grid_cells * self.grid_resolution / 2.0
        g = mls_grid.MLSGrid.create(
            self.grid_cells, self.grid_cells, self.grid_resolution,
            (kf.pose[0] - half, kf.pose[1] - half), k=2,
        )
        th = kf.pose[2]
        r = jnp.array(
            [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
            jnp.float32,
        )
        return self._merge_jit(
            g, kf.cloud, r, jnp.asarray(kf.pose[:2], jnp.float32),
            jnp.asarray(kf.z, jnp.float32), jnp.asarray(0.0), 0,
        )

    def maybe_add_keyframe(self, pose_xyyaw, cloud, z=0.0,
                           probe_cloud=None, abs_yaw=None):
        """Returns (added, closure_or_None).

        ``cloud`` is STORED (what later revisits align against — give
        it areal coverage, e.g. a local-map extract); ``probe_cloud``
        is what aligns against OLD keyframes now (default ``cloud``) —
        the current raw scan is the unbiased choice: it is tied to the
        true pose, while an accumulated local map inherits the belief's
        drift."""
        pose = np.asarray(pose_xyyaw, float)
        if self.keyframes and np.linalg.norm(
            pose[:2] - self.keyframes[-1].pose[:2]
        ) < self.kf_dist:
            return False, None

        node = self.builder.add_node(pose)
        kf = Keyframe(len(self.keyframes), node, pose, cloud, float(z))
        if self.keyframes:
            prev = self.keyframes[-1]
            self.builder.add_edge(
                prev.node_id, node, self._rel_pose(prev.pose, pose),
                info=jnp.diag(jnp.asarray([
                    self.odom_info, self.odom_info,
                    self.odom_info_yaw,
                ], jnp.float32)),
            )
        if self.yaw_prior_info > 0 and abs_yaw is not None:
            if self._yaw0 is None:
                self._yaw0 = (float(abs_yaw), float(pose[2]))
            else:
                y0_imu, y0_node = self._yaw0
                self.builder.add_edge(
                    self.keyframes[0].node_id if self.keyframes
                    else 0, node,
                    np.array([0.0, 0.0, float(pgr.wrap_angle(
                        jnp.asarray(abs_yaw - y0_imu)))]),
                    info=jnp.diag(jnp.asarray(
                        [0.0, 0.0, self.yaw_prior_info], jnp.float32)),
                )
        self.keyframes.append(kf)

        closure = self._try_closure(
            kf, probe_cloud=probe_cloud if probe_cloud is not None
            else kf.cloud,
        )
        return True, closure

    def _try_closure(self, kf: Keyframe, top_k=3, probe_cloud=None):
        if probe_cloud is None:
            probe_cloud = kf.cloud
        cands = []
        for old in self.keyframes[: max(0, kf.index - self.min_separation)]:
            d = np.linalg.norm(kf.pose[:2] - old.pose[:2])
            if d < self.closure_radius:
                cands.append((d, old))
        if not cands:
            return None
        cands.sort(key=lambda t: t[0])

        # align against the closest few candidates and keep the best
        # score: with accumulated drift the nearest BELIEVED keyframe is
        # often the wrong physical place, and a single failed alignment
        # would silently drop the revisit
        best = None
        for _, old in cands[:top_k]:
            grid = self._kf_grid(old)
            xy0 = jnp.asarray(kf.pose[:2], jnp.float32)
            yaw0 = jnp.asarray(kf.pose[2], jnp.float32)
            if self.align_coarse is not None:
                csearch, csteps, csigma = self.align_coarse
                xy0, yaw0, _ = self._align_jit(
                    grid, probe_cloud, xy0, yaw0,
                    jnp.asarray(kf.z, jnp.float32),
                    search_xy=csearch,
                    search_yaw=self.align_search_yaw,
                    steps_xy=csteps,
                    steps_yaw=self.align_steps_yaw,
                    sigma=csigma,
                    search_z=self.align_search_z,
                    steps_z=self.align_steps_z,
                )
            xy, yaw, score, ratio = self._align_jit(
                grid, probe_cloud, xy0, yaw0,
                jnp.asarray(kf.z, jnp.float32),
                search_xy=self.align_search_xy,
                search_yaw=self.align_search_yaw,
                steps_xy=self.align_steps_xy,
                steps_yaw=self.align_steps_yaw,
                sigma=self.align_sigma,
                search_z=self.align_search_z,
                steps_z=self.align_steps_z,
                return_ratio=True,
            )
            if best is None or float(score) > best[0]:
                best = (float(score), old, xy, yaw, float(ratio))
        score, old, xy, yaw, ratio = best
        if score < self.min_score or ratio < self.min_ratio:
            return None
        corrected = np.array([float(xy[0]), float(xy[1]), float(yaw)])
        import os
        if os.environ.get("SLAM_DEBUG_CLOSURES"):
            print(f"closure kf{old.index}<-kf{kf.index}: believed "
                  f"{kf.pose.round(3)} aligned {corrected.round(3)} "
                  f"score {score:.3f} ratio {ratio:.2f}")
        z_rel = self._rel_pose(old.pose, corrected)
        ci = self.closure_info * float(score)
        self.builder.add_edge(
            old.node_id, kf.node_id, z_rel,
            info=jnp.diag(jnp.asarray(
                [ci, ci, ci * self.closure_info_yaw_scale], jnp.float32
            )),
        )
        self.closures.append((old.index, kf.index, float(score)))
        self.closure_details.append(dict(
            old=old.index, new=kf.index, score=float(score),
            ratio=float(ratio), corrected=corrected,
            believed=kf.pose.copy(),
            edge=self.builder.n_edges - 1,
        ))
        return (old.index, kf.index, float(score))

    def prune_closures(self, consist=1.0, window=2):
        """Median-consistency gate over accepted closures: each
        closure's implied world correction (aligned − believed at the
        NEW keyframe) should agree with its neighbours' — drift
        changes slowly, so an inconsistent correction is an
        along-track mis-lock even when its score is high (round-5
        stretch find).  Invalidates the pruned closures' edges in the
        graph and returns the number removed.  Call once before
        ``optimize``."""
        det = self.closure_details
        if len(det) < 3:
            return 0
        deltas = np.stack([
            d["corrected"][:2] - d["believed"][:2] for d in det
        ])
        med = np.stack([
            np.median(deltas[max(0, i - window):i + window + 1], axis=0)
            for i in range(len(det))
        ])
        bad = np.linalg.norm(deltas - med, axis=1) > consist
        g = self.builder.graph
        ev = g.edge_valid
        for d, b in zip(det, bad):
            if b:
                ev = ev.at[d["edge"]].set(False)
                d["pruned"] = True
        self.builder.graph = dataclasses.replace(g, edge_valid=ev)
        return int(bad.sum())

    def optimize(self, iters=10, incremental=False, margin=3,
                 solver="dense", mesh=None, cg_iters=32, robust=None,
                 robust_delta=1.0):
        """Re-solve the graph.

        ``incremental=True`` re-solves only the *affected* subgraph: it
        freezes every node older than (earliest node touched by an edge
        added since the last optimize) − ``margin`` via the solver's
        ``fix_mask`` — the warm-started trajectory prefix is already
        consistent, so only the suffix reachable from new constraints
        needs iteration.  A no-op (returns the cached trajectory) when
        nothing new arrived.  ``solver``/``mesh`` forward to
        ``PoseGraphBuilder.optimize`` (dense Cholesky vs
        matrix-free, optionally mesh-distributed, PCG).
        """
        import numpy as _np
        import os as _os

        if _os.environ.get("SLAM_DEBUG_EDGES"):
            g = self.builder.graph
            r = _np.asarray(pgr.edge_residuals(g)[0])
            n_e = self.builder.n_edges
            chi = (r[:n_e] ** 2 * _np.asarray(
                jnp.diagonal(g.edge_info[:n_e], axis1=1, axis2=2)
            )).sum(-1)
            worst = _np.argsort(-chi)[:10]
            for e in worst:
                print(f"edge {int(g.edge_i[e])}->{int(g.edge_j[e])} "
                      f"chi2 {chi[e]:.1f} resid {r[e].round(3)} "
                      f"z {_np.asarray(g.edge_z[e]).round(3)}")

        fix_mask = None
        if incremental:
            b = self.builder
            if b.n_edges == self._optimized_edges:
                return self.trajectory(), jnp.zeros((0,))
            new_sl = slice(self._optimized_edges, b.n_edges)
            touched = int(
                min(
                    _np.asarray(b.graph.edge_i[new_sl]).min(),
                    _np.asarray(b.graph.edge_j[new_sl]).min(),
                )
            )
            cut = max(0, touched - margin)
            fix_mask = jnp.arange(b.graph.nodes.shape[0]) < cut
        hist = self.builder.optimize(
            iters, fix_mask=fix_mask, solver=solver, mesh=mesh,
            cg_iters=cg_iters, robust=robust, robust_delta=robust_delta,
        )
        self._optimized_edges = self.builder.n_edges
        return self.trajectory(), hist

    def trajectory(self):
        n = len(self.keyframes)
        return np.asarray(self.builder.graph.nodes[:n])
