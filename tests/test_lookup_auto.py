"""Production lookup seam + parity switches.

Covers the exact packed gather behind ``make_lookup`` (a compact
tracking cloud and a hash-reinjected, globally spread cloud must both
get exact measurements), the config-selectable Chitta weighting
(``ContactModel.hpp:168-173``), the wrap-safe centroid yaw option, and
slip-point debug capture (``PoseParticle.hpp:45-50``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu.filter import pose_estimator as pe
from slam_eslam_tpu.mapping import mls_grid
from slam_eslam_tpu.mapping.lookup import make_lookup, shared_grid_lookup
from slam_eslam_tpu.models import contact_model as cm
from slam_eslam_tpu.models import sim as simlib


def terrain(x, y):
    return 0.3 * np.sin(np.asarray(x)) + 0.2 * np.cos(0.7 * np.asarray(y))


@pytest.fixture(scope="module")
def grid():
    return simlib.terrain_grid(
        terrain, nx=128, ny=128, resolution=0.1, origin=(-6.4, -6.4)
    )


def _query_points(key, n, c, spread):
    """[N, C, 3] query cloud with matching terrain z values."""
    xy = jax.random.uniform(key, (n, c, 2), minval=-spread, maxval=spread)
    z = jnp.asarray(
        terrain(np.asarray(xy[..., 0]), np.asarray(xy[..., 1])),
        jnp.float32,
    )
    return jnp.concatenate([xy, z[..., None] + 0.05], axis=-1)


def _oracle(grid, pts, z_window=3.0):
    """NumPy reference of ``MLSGrid`` patch lookup: per query, the
    valid slot of its cell nearest to z within ``z_window``."""
    mean = np.asarray(grid.mean)
    stdev = np.asarray(grid.stdev)
    valid = np.asarray(grid.valid)
    origin = np.asarray(grid.origin)
    flat = np.asarray(pts).reshape(-1, 3)
    found = np.zeros(len(flat), bool)
    m_out = np.zeros(len(flat), np.float32)
    s_out = np.zeros(len(flat), np.float32)
    for q, (x, y, z) in enumerate(flat):
        ix = int(np.floor((np.float32(x) - origin[0]) / grid.resolution))
        iy = int(np.floor((np.float32(y) - origin[1]) / grid.resolution))
        if not (0 <= ix < grid.nx and 0 <= iy < grid.ny):
            continue
        d = np.where(valid[ix, iy], np.abs(mean[ix, iy] - z), np.inf)
        if d.min() <= z_window:
            k = int(np.argmin(d))
            found[q] = True
            m_out[q], s_out[q] = mean[ix, iy, k], stdev[ix, iy, k]
    shape = np.asarray(pts).shape[:-1]
    return (found.reshape(shape), m_out.reshape(shape),
            s_out.reshape(shape))


class TestAutoLookup:
    @pytest.mark.parametrize("spread", [1.0, 6.0])
    def test_compact_and_spread_clouds_match_oracle(self, grid, spread):
        """Tracking (1 m) and relocalising (12 m) clouds take the same
        exact gather: found, mean and stdev equal the NumPy oracle."""
        lk = make_lookup(Config(), grid)
        pts = _query_points(jax.random.PRNGKey(0), 64, 8, spread=spread)
        fa, ma, sa, _ = jax.jit(lambda p: lk(None, p))(pts)
        fo, mo, so = _oracle(grid, pts)
        assert fo.any()
        np.testing.assert_array_equal(np.asarray(fa), fo)
        np.testing.assert_array_equal(np.asarray(ma)[fo], mo[fo])
        np.testing.assert_array_equal(np.asarray(sa)[fo], so[fo])

    def test_out_of_grid_queries_miss(self, grid):
        lk = make_lookup(Config(), grid)
        pts = jnp.array([[[7.0, 0.0, 0.0], [0.0, -7.0, 0.0],
                          [0.0, 0.0, 0.1], [-6.45, 6.35, 0.0]]])
        found, _, _, _ = lk(None, pts)
        np.testing.assert_array_equal(
            np.asarray(found), [[False, False, True, False]]
        )

    def test_slip_update_forces_gather(self, grid):
        cfg = Config(
            contact_model=ContactModelConfig(use_slip_update=True),
        )
        lk = make_lookup(cfg, grid)
        pts = _query_points(jax.random.PRNGKey(2), 4, 8, spread=1.0)
        found, mean, stdev, color = lk(None, pts)
        # the unpacked gather path carries colour
        assert color.shape == pts.shape[:-1] + (3,)
        fo, mo, _ = _oracle(grid, pts)
        np.testing.assert_array_equal(np.asarray(found), fo)
        np.testing.assert_array_equal(np.asarray(mean)[fo], mo[fo])


class TestFilterAutoLookup:
    def test_spread_filter_update_equals_gather(self, grid):
        """A globally spread particle cloud (the post-reinjection
        regime) must produce the same weights through the production
        lookup (packed gather + fold) and the unpacked ``get_patch``
        gather without fold."""
        n, c = 64, 8
        cfg = Config(
            particle_count=n,
            contact_model=ContactModelConfig(
                contact_point_radius=0.0, min_contacts=2
            ),
        )
        key = jax.random.PRNGKey(3)
        xy = jax.random.uniform(key, (n, 2), minval=-6.0, maxval=6.0)
        particles = dataclasses.replace(
            ParticleSet.zeros(n).with_xy(xy),
            z=jnp.asarray(
                terrain(np.asarray(xy[:, 0]), np.asarray(xy[:, 1]))
            ).astype(jnp.float32) + 0.1,
            z_sigma=jnp.full((n,), 0.3, jnp.float32),
        )
        state = pe.PoseEstimatorState.create(cfg, c)
        state = dataclasses.replace(state, particles=particles)
        cs = BodyContactState.create(
            np.array([[0.2, 0.1, -0.1], [-0.2, 0.1, -0.12],
                      [0.2, -0.1, -0.09], [-0.2, -0.1, -0.11],
                      [0.0, 0.2, -0.1], [0.0, -0.2, -0.1],
                      [0.1, 0.0, -0.1], [-0.1, 0.0, -0.1]], np.float32),
            group_id=np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32),
        )
        q = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)

        out = {}
        unfolded = dataclasses.replace(
            cfg, contact_model=dataclasses.replace(
                cfg.contact_model, fold_lookup=False)
        )
        for mode, c2, lk in (
            ("auto", cfg, make_lookup(cfg, grid)),
            ("gather", unfolded, shared_grid_lookup(grid, packed=False)),
        ):
            s2, _ = jax.jit(
                lambda s: pe.update_weights(s, cs, q, lk, c2)
            )(state)
            out[mode] = np.asarray(s2.particles.weight)
        assert np.isfinite(out["gather"]).all()
        np.testing.assert_allclose(out["auto"], out["gather"], rtol=1e-5)


class TestChittaSelectable:
    def test_batch_matches_single(self):
        cfg = ContactModelConfig(weighting="chitta", min_contacts=2)
        n, c = 16, 6
        key = jax.random.PRNGKey(0)
        cs = BodyContactState.create(
            jax.random.normal(key, (c, 3)) * 0.2,
            group_id=jnp.array([0, 0, 1, 1, 2, 2], jnp.int32),
        )

        def fake_lookup(points):
            shape = points.shape[:-1]
            return (jnp.ones(shape, bool),
                    jnp.zeros(shape, jnp.float32),
                    jnp.full(shape, 0.1, jnp.float32),
                    jnp.zeros(shape + (3,), jnp.float32))

        rot = jnp.broadcast_to(jnp.eye(3), (n, 3, 3))
        trans = jax.random.normal(jax.random.PRNGKey(1), (n, 3)) * 0.1
        mv = jnp.full((n,), 0.05, jnp.float32)
        res_b = cm.evaluate_pose_batch(cs, rot, trans, mv, fake_lookup, cfg)
        res_s = jax.vmap(
            lambda r, t, v: cm.evaluate_pose(
                cs, r, t, v,
                lambda p: fake_lookup(p), cfg,
            )
        )(rot, trans, mv)
        np.testing.assert_allclose(
            np.asarray(res_b.weight), np.asarray(res_s.weight), rtol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(res_b.z_delta), np.asarray(res_s.z_delta), rtol=1e-5
        )
        # chitta anchors at the min zdiff: weight <= 1 and z_var = measVar
        np.testing.assert_allclose(np.asarray(res_b.z_var), 0.05, rtol=1e-6)

    def test_differs_from_ratio(self):
        c = 6
        cs = BodyContactState.create(
            np.array([[0.2, 0.0, -0.1], [-0.2, 0.0, -0.15],
                      [0.2, 0.1, -0.05], [-0.2, 0.1, -0.1],
                      [0.0, 0.2, -0.12], [0.0, -0.2, -0.08]], np.float32),
            group_id=np.array([0, 0, 1, 1, 2, 2], np.int32),
        )

        def fake_lookup(points):
            shape = points.shape[:-1]
            return (jnp.ones(shape, bool),
                    jnp.full(shape, -0.3, jnp.float32),
                    jnp.full(shape, 0.1, jnp.float32),
                    jnp.zeros(shape + (3,), jnp.float32))

        rot = jnp.eye(3)[None]
        trans = jnp.zeros((1, 3))
        mv = jnp.full((1,), 0.05, jnp.float32)
        w = {}
        for wt in ("ratio", "chitta"):
            cfg = ContactModelConfig(weighting=wt, min_contacts=2)
            res = cm.evaluate_pose_batch(
                cs, rot, trans, mv, fake_lookup, cfg
            )
            w[wt] = float(res.weight[0])
        assert w["ratio"] != pytest.approx(w["chitta"])


class TestSoAQueryPath:
    def test_soa_matches_aos(self, grid):
        """The contact model's SoA flat-query fast path (taken when the
        lookup advertises ``.soa``) must produce identical results to
        the AoS ``[N, C, 3]`` path — including debug payloads."""
        n, c = 32, 8
        cfg_cm = ContactModelConfig(contact_point_radius=0.01,
                                    min_contacts=2)
        cfg = Config(contact_model=cfg_cm)
        lk = make_lookup(cfg, grid)
        assert getattr(lk, "soa", False)

        def lk_aos(points):  # same lookup, AoS entry (no .soa attr)
            return lk(None, points)

        def lk_soa(q):
            return lk(None, q)

        lk_soa.soa = True

        key = jax.random.PRNGKey(7)
        cs = BodyContactState.create(
            jax.random.normal(key, (c, 3)) * 0.2,
            group_id=jnp.array([0, 0, 1, 1, 2, 2, 3, 3], jnp.int32),
        )
        yaw = jax.random.uniform(
            jax.random.PRNGKey(8), (n,), minval=-1.0, maxval=1.0
        )
        cy, sy = jnp.cos(yaw), jnp.sin(yaw)
        zr = jnp.zeros_like(yaw)
        rot = jnp.stack([
            jnp.stack([cy, -sy, zr], -1),
            jnp.stack([sy, cy, zr], -1),
            jnp.stack([zr, zr, jnp.ones_like(yaw)], -1),
        ], -2)
        xy = jax.random.uniform(
            jax.random.PRNGKey(9), (n, 2), minval=-1.0, maxval=1.0
        )
        z = jnp.asarray(
            terrain(np.asarray(xy[:, 0]), np.asarray(xy[:, 1])),
            jnp.float32,
        ) + 0.1
        trans = jnp.concatenate([xy, z[:, None]], axis=-1)
        mv = jnp.full((n,), 0.05, jnp.float32)

        res_soa = jax.jit(
            lambda: cm.evaluate_pose_batch(
                cs, rot, trans, mv, lk_soa, cfg_cm,
                with_debug_points=True,
            )
        )()
        res_aos = jax.jit(
            lambda: cm.evaluate_pose_batch(
                cs, rot, trans, mv, lk_aos, cfg_cm,
                with_debug_points=True,
            )
        )()
        assert np.asarray(res_soa.measurement_valid).any()
        for field in ("weight", "z_delta", "z_var", "pose_var",
                      "cp_zdiff", "cp_point"):
            a = np.asarray(getattr(res_soa, field))
            b = np.asarray(getattr(res_aos, field))
            np.testing.assert_allclose(
                np.where(np.isfinite(a), a, 0.0),
                np.where(np.isfinite(b), b, 0.0),
                rtol=1e-5, atol=1e-6, err_msg=field,
            )
        np.testing.assert_array_equal(
            np.asarray(res_soa.measurement_valid),
            np.asarray(res_aos.measurement_valid),
        )


class TestWrapSafeCentroid:
    def test_wrap(self):
        n = 2
        p = dataclasses.replace(
            ParticleSet.zeros(n),
            yaw=jnp.array([np.pi - 0.01, -np.pi + 0.01], jnp.float32),
        )
        q = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
        _, quat_lin = pe.centroid(p, q, wrap_safe=False)
        _, quat_safe = pe.centroid(p, q, wrap_safe=True)
        # linear mean lands near yaw 0; circular mean near +-pi
        from slam_eslam_tpu.utils import geometry

        yaw_lin = float(geometry.yaw_from_quat(quat_lin))
        yaw_safe = float(geometry.yaw_from_quat(quat_safe))
        assert abs(yaw_lin) < 0.1                     # the wrap bug
        assert abs(abs(yaw_safe) - np.pi) < 0.1       # fixed


class TestSlipPointCapture:
    def test_spoints_captured(self):
        from slam_eslam_tpu.models import terrain as terr

        c = 4
        cs = BodyContactState.create(
            np.array([[0.2, 0.0, -0.1], [-0.2, 0.0, -0.1],
                      [0.2, 0.1, -0.1], [-0.2, 0.1, -0.1]], np.float32),
            group_id=np.array([0, 0, 1, 1], np.int32),
        )
        wheel_probs = jnp.array(
            [[0.8, 0.1, 0.1], [0.2, 0.6, 0.2]], jnp.float32
        )
        wheel_valid = jnp.array([True, False])

        def tp(gid, color):
            return terr.per_point_probability(
                gid, color, wheel_probs, wheel_valid, with_mask=True
            )

        def fake_lookup(points):
            shape = points.shape[:-1]
            color = jnp.zeros(shape + (3,), jnp.float32)
            color = color.at[..., 0].set(1.0)  # class-0 terrain
            return (jnp.ones(shape, bool),
                    jnp.full(shape, -0.1, jnp.float32),
                    jnp.full(shape, 0.1, jnp.float32), color)

        cfg = ContactModelConfig(
            use_slip_update=True, min_contacts=1
        )
        res = cm.evaluate_pose_batch(
            cs, jnp.eye(3)[None], jnp.zeros((1, 3)),
            jnp.full((1,), 0.05, jnp.float32), fake_lookup, cfg,
            terrain_prob=tp, with_debug_points=True,
        )
        sp_ok = np.asarray(res.sp_ok[0])
        # only wheel 0 (groups 0) has a classification
        np.testing.assert_array_equal(sp_ok, [True, True, False, False])
        assert np.asarray(res.sp_point[0]).shape == (c, 3)
        # class-0 visual vs [0.8, .1, .1] proprioceptive: high joint prob
        assert (np.asarray(res.sp_prob[0])[:2] > 0.5).all()
