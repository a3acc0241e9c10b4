"""Pose-graph backend tests: GN convergence, loop closure, scan alignment."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from slam_eslam_tpu.backend import pose_graph as pgr
from slam_eslam_tpu.mapping.mls_grid import PatchCloud
from slam_eslam_tpu.models import sim as simlib


def terrain(x, y):
    return 0.3 * np.sin(0.8 * np.asarray(x)) + 0.2 * np.cos(
        0.6 * np.asarray(y)
    )


class TestGaussNewton:
    def test_chain_converges_to_odometry(self):
        # 4 nodes along x with unit odometry edges; start from noisy guesses
        b = pgr.PoseGraphBuilder(max_nodes=8, max_edges=8)
        truth = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0)]
        rng = np.random.default_rng(0)
        for i, t in enumerate(truth):
            noisy = np.asarray(t) + (
                0 if i == 0 else rng.normal(0, 0.2, 3)
            )
            b.add_node(noisy)
        for i in range(3):
            b.add_edge(i, i + 1, (1.0, 0.0, 0.0))
        hist = b.optimize(iters=10)
        nodes = np.asarray(b.graph.nodes)[:4]
        np.testing.assert_allclose(nodes, truth, atol=1e-3)
        assert float(hist[-1]) < float(hist[0]) + 1e-9

    def test_loop_closure_corrects_drift(self):
        # square loop with accumulated odometry drift; the closure edge
        # pulls the end node back onto the start
        b = pgr.PoseGraphBuilder(max_nodes=32, max_edges=32)
        n_side = 4
        # odometry measurements: forward 1 m then turn 90 deg
        poses = [(0.0, 0.0, 0.0)]
        drift = 0.08
        cur = np.zeros(3)
        meas = []
        for k in range(n_side * 4):
            z = (1.0, 0.0, np.pi / 2 if (k % n_side) == n_side - 1 else 0.0)
            meas.append(z)
            # integrate DRIFTED odometry for initial guesses
            zd = (z[0] + drift, z[1], z[2] + drift * 0.2)
            c, s = np.cos(cur[2]), np.sin(cur[2])
            cur = np.array(
                [cur[0] + c * zd[0] - s * zd[1],
                 cur[1] + s * zd[0] + c * zd[1],
                 cur[2] + zd[2]]
            )
            poses.append(cur.copy())
        for p in poses:
            b.add_node(p)
        for k, z in enumerate(meas):
            b.add_edge(k, k + 1, z)
        end_err_before = np.linalg.norm(poses[-1][:2])
        assert end_err_before > 0.3  # drift accumulated
        # loop closure: last node == first node
        b.add_edge(len(poses) - 1, 0, (0.0, 0.0, 0.0),
                   info=jnp.eye(3) * 1000.0)
        b.optimize(iters=15)
        nodes = np.asarray(b.graph.nodes)
        end_err_after = np.linalg.norm(nodes[len(poses) - 1][:2])
        assert end_err_after < 0.05, f"closure failed: {end_err_after}"
        # interior nodes get distributed correction, staying near a square
        assert abs(nodes[n_side][0] - n_side) < 0.5

    def test_invalid_edges_ignored(self):
        b = pgr.PoseGraphBuilder(max_nodes=4, max_edges=4)
        b.add_node((0, 0, 0))
        b.add_node((2.0, 0, 0))
        b.add_edge(0, 1, (1.0, 0, 0))
        # padding edges (invalid) must not perturb anything
        hist = b.optimize(iters=5)
        np.testing.assert_allclose(
            np.asarray(b.graph.nodes)[1], [1.0, 0, 0], atol=1e-3
        )


def _circle_graph(dim, m=16, seed=0):
    """Noisy circle trajectory with odometry + 3 closure edges."""
    import dataclasses

    rng = np.random.default_rng(seed)
    g = pgr.PoseGraph.empty(m, max(64, m + 8), dim=dim)
    th = np.linspace(0, 2 * np.pi, m, endpoint=False)
    cols = [np.cos(th), np.sin(th)]
    if dim == 4:
        cols.append(0.1 * np.sin(2 * th))
    cols.append(th + np.pi / 2)
    gt = np.stack(cols, -1)
    n0 = gt + rng.normal(0, 0.1, gt.shape)
    n0[0] = gt[0]

    def rel(a, b):
        yaw = a[-1]
        c, s = np.cos(yaw), np.sin(yaw)
        d = b[:2] - a[:2]
        out = [c * d[0] + s * d[1], -s * d[0] + c * d[1]]
        if dim == 4:
            out.append(b[2] - a[2])
        out.append(np.arctan2(np.sin(b[-1] - a[-1]),
                              np.cos(b[-1] - a[-1])))
        return np.array(out)

    pairs = [(k, k + 1) for k in range(m - 1)]
    pairs += [(0, m - 1), (2, m - 2), (1, m // 2)]
    ne = len(pairs)
    ei = np.array([p[0] for p in pairs], np.int32)
    ej = np.array([p[1] for p in pairs], np.int32)
    ez = np.stack([rel(gt[a], gt[b]) for a, b in pairs])
    g = dataclasses.replace(
        g,
        nodes=jnp.asarray(n0, jnp.float32),
        node_valid=jnp.ones((m,), bool),
        edge_i=g.edge_i.at[:ne].set(ei),
        edge_j=g.edge_j.at[:ne].set(ej),
        edge_z=g.edge_z.at[:ne].set(jnp.asarray(ez, jnp.float32)),
        edge_info=g.edge_info.at[:ne].set(jnp.eye(dim) * 100.0),
        edge_valid=g.edge_valid.at[:ne].set(True),
    )
    return g, jnp.asarray(gt, jnp.float32)


def _pose_err(a, b):
    d = a - b
    d = d.at[:, -1].set(pgr.wrap_angle(d[:, -1]))
    return float(jnp.abs(d).max())


class TestSolverVariants:
    """4-DoF graphs, the matrix-free PCG solver (local + mesh-sharded)
    and fix-mask freezing must all agree with the dense solve."""

    @pytest.mark.parametrize("dim", [3, 4])
    def test_dense_and_cg_converge(self, dim):
        g, gt = _circle_graph(dim)
        gd, hist = jax.jit(lambda g: pgr.optimize(g, 15))(g)
        assert _pose_err(gd.nodes, gt) < 1e-3
        assert float(hist[-1]) < 1e-6
        gc, _ = jax.jit(lambda g: pgr.optimize_cg(g, 15, cg_iters=64))(g)
        assert _pose_err(gc.nodes, gt) < 1e-3
        assert _pose_err(gc.nodes, gd.nodes) < 1e-3

    @pytest.mark.skipif(len(jax.devices()) < 8,
                        reason="needs 8 (virtual) devices")
    @pytest.mark.parametrize("dim", [3, 4])
    def test_sharded_cg_matches_local(self, dim):
        from slam_eslam_tpu.parallel import sharding as shd

        g, gt = _circle_graph(dim)
        mesh = shd.make_mesh(8)
        gc, _ = jax.jit(lambda g: pgr.optimize_cg(g, 15, cg_iters=64))(g)
        gs, _ = jax.jit(
            lambda g: pgr.optimize_cg(g, 15, cg_iters=64, mesh=mesh)
        )(g)
        assert _pose_err(gs.nodes, gt) < 1e-3
        assert _pose_err(gs.nodes, gc.nodes) < 1e-5

    @pytest.mark.parametrize("dim", [3, 4])
    def test_schur_matches_dense(self, dim):
        """Schur trajectory partitioning (4 segments, boundary
        elimination) must reproduce the dense solve on a loopy graph."""
        g, gt = _circle_graph(dim)
        gd, _ = jax.jit(lambda g: pgr.optimize(g, 15))(g)
        gs, hist = jax.jit(
            lambda g: pgr.optimize_schur(
                g, 15, segments=4, boundary_cap=16
            )
        )(g)
        assert _pose_err(gs.nodes, gt) < 1e-3
        assert _pose_err(gs.nodes, gd.nodes) < 1e-3
        assert float(hist[-1]) < 1e-5

    def test_schur_1k_nodes_matches_dense(self):
        """BASELINE stretch shape: a 1024-node trajectory with loop
        closures, 8-way node-axis partition; the partitioned solve must
        match the dense solution."""
        g, gt = _circle_graph(3, m=1024, seed=2)
        gd, _ = jax.jit(lambda g: pgr.optimize(g, 10))(g)
        gs, _ = jax.jit(
            lambda g: pgr.optimize_schur(
                g, 10, segments=8, boundary_cap=32
            )
        )(g)
        assert _pose_err(gs.nodes, gt) < 5e-3
        assert _pose_err(gs.nodes, gd.nodes) < 1e-3

    @pytest.mark.skipif(len(jax.devices()) < 8,
                        reason="needs 8 (virtual) devices")
    def test_schur_sharded_matches_local(self):
        """Node-axis mesh distribution: segments shard over 'dp',
        boundary system psum-reduced — equal to the local Schur solve."""
        from slam_eslam_tpu.parallel import sharding as shd

        g, gt = _circle_graph(3, m=256, seed=3)
        mesh = shd.make_mesh(8)
        gl, _ = jax.jit(
            lambda g: pgr.optimize_schur(
                g, 12, segments=8, boundary_cap=32
            )
        )(g)
        gs, _ = jax.jit(
            lambda g: pgr.optimize_schur(
                g, 12, segments=8, boundary_cap=32, mesh=mesh
            )
        )(g)
        assert _pose_err(gs.nodes, gt) < 2e-3
        assert _pose_err(gs.nodes, gl.nodes) < 1e-5

    @pytest.mark.parametrize("kind", ["huber", "dcs"])
    def test_robust_kernel_rejects_outlier_closure(self, kind):
        """A wildly wrong closure edge must not wreck the solution when
        a robust kernel is on (and does without one)."""
        import dataclasses

        g, gt = _circle_graph(3)
        # poison: a high-information closure claiming node 8 sits at
        # node 0's pose + (5, 5)
        e = 16 + 3  # after the odometry + 3 good closures
        g = dataclasses.replace(
            g,
            edge_i=g.edge_i.at[e].set(0),
            edge_j=g.edge_j.at[e].set(8),
            edge_z=g.edge_z.at[e].set(jnp.array([5.0, 5.0, 0.0])),
            edge_info=g.edge_info.at[e].set(jnp.eye(3) * 100.0),
            edge_valid=g.edge_valid.at[e].set(True),
        )
        g_naive, _ = jax.jit(lambda g: pgr.optimize(g, 15))(g)
        err_naive = _pose_err(g_naive.nodes, gt)
        assert err_naive > 0.5  # wrecked

        # Huber's linear tail bounds but does not nullify a strong
        # outlier's influence; DCS saturates it to ~zero.
        tol = 0.05 if kind == "dcs" else err_naive * 0.6
        g_rob, _ = jax.jit(
            lambda g: pgr.optimize(g, 20, robust=kind, robust_delta=1.0)
        )(g)
        assert _pose_err(g_rob.nodes, gt) < tol
        # the CG solver applies the same reweighting
        g_rob2, _ = jax.jit(
            lambda g: pgr.optimize_cg(
                g, 20, cg_iters=64, robust=kind, robust_delta=1.0
            )
        )(g)
        assert _pose_err(g_rob2.nodes, gt) < tol

    def test_fix_mask_freezes_prefix(self):
        g, _ = _circle_graph(3)
        fm = jnp.arange(16) < 8
        gf, _ = jax.jit(lambda g: pgr.optimize(g, 10, fix_mask=fm))(g)
        d = gf.nodes[:8] - g.nodes[:8]
        d = d.at[:, -1].set(pgr.wrap_angle(d[:, -1]))
        assert float(jnp.abs(d).max()) < 1e-6
        assert not bool(jnp.allclose(gf.nodes[8:], g.nodes[8:]))


class TestScanAlign:
    def test_recovers_offset(self):
        grid = simlib.terrain_grid(
            terrain, nx=80, ny=80, resolution=0.1, origin=(-4.0, -4.0)
        )
        # cloud sampled from the terrain under a true pose offset
        key = jax.random.PRNGKey(0)
        pts = jax.random.uniform(key, (128, 2), minval=-1.5, maxval=1.5)
        true_dx = jnp.array([0.25, -0.125])
        world = pts + true_dx
        z = jnp.asarray(
            terrain(np.asarray(world[:, 0]), np.asarray(world[:, 1])),
            jnp.float32,
        )
        cloud = PatchCloud.create(
            xy=pts, z=z, stdev=jnp.full((128,), 0.05),
            valid=jnp.ones((128,), bool),
        )
        xy, yaw, score = pgr.scan_align(
            grid, cloud, jnp.zeros(2), jnp.asarray(0.0), jnp.asarray(0.0),
            search_xy=0.5, steps_xy=9, search_yaw=0.1, steps_yaw=3,
        )
        np.testing.assert_allclose(
            np.asarray(xy), np.asarray(true_dx), atol=0.13
        )
        assert float(score) > 0.5
