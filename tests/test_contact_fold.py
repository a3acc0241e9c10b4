"""Contact fold: the packed lookup's ``.fold`` computes the likelihood
ratio + group reductions together with the gather and returns ``[8, N]``
per-particle rows instead of per-query rows.

Parity target: ``evaluate_pose_batch`` with ``fold_lookup=True`` must
match the unfolded path (same exact gather) to the accuracy of the
fold's Mills-ratio approximation (~5e-5 rel on the ratio; see
``_mills_ratio``), for compact and globally spread particle clouds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_eslam_tpu.config import Config, ContactModelConfig
from slam_eslam_tpu.core.state import BodyContactState, ParticleSet
from slam_eslam_tpu.filter import pose_estimator as pe
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


CONTACTS = np.array(
    [[0.2, 0.1, -0.1], [-0.2, 0.1, -0.12],
     [0.2, -0.1, -0.09], [-0.2, -0.1, -0.11],
     [0.0, 0.2, -0.1], [0.0, -0.2, -0.1],
     [0.1, 0.0, -0.1], [-0.1, 0.0, -0.1]], np.float32)
GROUPS = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)


def _contact_state():
    return BodyContactState.create(CONTACTS, group_id=GROUPS)


def _batch_inputs(key, n, spread):
    xy = jax.random.uniform(key, (n, 2), minval=-spread, maxval=spread)
    z = jnp.asarray(
        terrain(np.asarray(xy[:, 0]), np.asarray(xy[:, 1])), jnp.float32
    )
    rot = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))
    trans = jnp.concatenate([xy, (z + 0.1)[:, None]], axis=-1)
    meas_var = jnp.full((n,), 0.09, jnp.float32)
    return rot, trans, meas_var


def _eval(grid, n, spread, fold, key=0):
    cmc = ContactModelConfig(
        contact_point_radius=0.0, min_contacts=2, fold_lookup=fold
    )
    cfg = Config(contact_model=cmc)
    lookup = make_lookup(cfg, grid)
    state = _contact_state()
    rot, trans, meas_var = _batch_inputs(jax.random.PRNGKey(key), n,
                                         spread)

    bound = pe.bind_lookup(lookup, None)
    if fold:
        # the attribute-forwarding seam itself is part of the contract
        assert callable(getattr(bound, "fold", None))

    def run(rot, trans, meas_var):
        return cm.evaluate_pose_batch(
            state, rot, trans, meas_var, bound, cmc,
        )

    return jax.jit(run)(rot, trans, meas_var)


def _assert_results_close(a, b, rtol=2e-3):
    """``a`` = folded result (per-particle stats only; cp_* are
    documented placeholders), ``b`` = unfolded oracle."""
    np.testing.assert_array_equal(
        np.asarray(a.measurement_valid), np.asarray(b.measurement_valid)
    )
    np.testing.assert_array_equal(
        np.asarray(a.n_contacts), np.asarray(b.n_contacts)
    )
    for name in ("weight", "z_delta", "pose_var"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
            rtol=rtol, atol=1e-5, err_msg=name,
        )
    fin = np.isfinite(np.asarray(b.z_var))
    np.testing.assert_array_equal(fin, np.isfinite(np.asarray(a.z_var)))
    np.testing.assert_allclose(
        np.asarray(a.z_var)[fin], np.asarray(b.z_var)[fin], rtol=rtol
    )


class TestMillsRatio:
    def test_accuracy_vs_scipy(self):
        scipy_stats = pytest.importorskip("scipy.stats")
        u = np.linspace(-30, 12, 50001).astype(np.float32)
        ref = np.exp(
            scipy_stats.norm.logpdf(u) - scipy_stats.norm.logcdf(u)
        )
        got = np.asarray(cm._mills_ratio(jnp.asarray(u)))
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)
        assert rel.max() < 1e-4, rel.max()

    def test_matches_likelihood_ratio(self):
        # mills(z/s)/s == pdf(z;0,s)/cdf(z;0,s) (the reference formula,
        # ContactModel.cpp:104-115)
        z = jnp.linspace(-2.0, 2.0, 101)
        s = jnp.float32(0.3)
        ref = cm.contact_likelihood_ratio(z, s / 0.33, 0.33)
        got = cm._mills_ratio(z / s) / s
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-4
        )


class TestFoldParity:
    def test_lookup_advertises_fold(self, grid):
        lk = make_lookup(Config(), grid)
        assert callable(getattr(lk, "fold", None))
        # the unpacked (colour-carrying) gather of the slip update does not
        lk2 = make_lookup(
            Config(contact_model=ContactModelConfig(use_slip_update=True)),
            grid,
        )
        assert getattr(lk2, "fold", None) is None

    def test_compact_cloud(self, grid):
        a = _eval(grid, 64, spread=1.0, fold=True)
        b = _eval(grid, 64, spread=1.0, fold=False)
        assert np.asarray(b.measurement_valid).any()
        _assert_results_close(a, b)

    def test_spread_fallback_branch(self, grid):
        # a globally spread cloud (12 m, the post-relocalisation regime)
        # folds through the same exact gather as a compact one
        a = _eval(grid, 64, spread=6.0, fold=True)
        b = _eval(grid, 64, spread=6.0, fold=False)
        assert np.asarray(b.measurement_valid).any()
        _assert_results_close(a, b)

    def test_ragged_particle_count(self, grid):
        # a particle count that is no power of two
        a = _eval(grid, 37, spread=1.0, fold=True, key=5)
        b = _eval(grid, 37, spread=1.0, fold=False, key=5)
        _assert_results_close(a, b)

    def test_update_weights_end_to_end(self, grid):
        n, c = 64, 8
        key = jax.random.PRNGKey(7)
        xy = jax.random.uniform(key, (n, 2), minval=-1.5, maxval=1.5)
        particles = dataclasses.replace(
            ParticleSet.zeros(n).with_xy(xy),
            z=jnp.asarray(
                terrain(np.asarray(xy[:, 0]), np.asarray(xy[:, 1]))
            ).astype(jnp.float32) + 0.1,
            z_sigma=jnp.full((n,), 0.3, jnp.float32),
        )
        cs = _contact_state()
        q = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
        out = {}
        for fold in (True, False):
            cfg = Config(
                particle_count=n,
                contact_model=ContactModelConfig(
                    contact_point_radius=0.0, min_contacts=2,
                    fold_lookup=fold,
                ),
            )
            state = pe.PoseEstimatorState.create(cfg, c)
            state = dataclasses.replace(state, particles=particles)
            lookup = make_lookup(cfg, grid)
            new_state, _ = jax.jit(
                lambda s, cs: pe.update_weights(s, cs, q, lookup, cfg)
            )(state, cs)
            out[fold] = new_state.particles
        np.testing.assert_allclose(
            np.asarray(out[True].weight), np.asarray(out[False].weight),
            rtol=2e-3, atol=1e-7,
        )
        np.testing.assert_array_equal(
            np.asarray(out[True].floating), np.asarray(out[False].floating)
        )
        np.testing.assert_allclose(
            np.asarray(out[True].z), np.asarray(out[False].z), rtol=1e-3,
            atol=1e-5,
        )

    def test_skewed_cloud_tier_coverage(self, grid):
        """A skewed cloud (y-span 30 cells, mass at the bottom, 4
        particles 2.5 m up) must keep every far-tail contact: the fold
        matches the unfolded gather, and the unpacked ``get_patch``
        lookup is the independent oracle of the contact counts."""
        n, n_tail = 64, 4
        y = np.full((n,), -1.3, np.float32)
        y[: n - n_tail] += np.linspace(-0.05, 0.05, n - n_tail)
        y[n - n_tail:] = 1.25  # tail: world y-span 3.0 m = 30 cells
        x = np.linspace(-0.3, 0.3, n).astype(np.float32)
        z = terrain(x, y).astype(np.float32)
        rot = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))
        trans = jnp.asarray(np.stack([x, y, z + 0.1], -1))
        meas_var = jnp.full((n,), 0.09, jnp.float32)
        state = _contact_state()

        def run(cfg, fold):
            cmc = dataclasses.replace(
                cfg.contact_model, contact_point_radius=0.0,
                min_contacts=2, fold_lookup=fold,
            )
            cfg = dataclasses.replace(cfg, contact_model=cmc)
            lookup = make_lookup(cfg, grid)
            return jax.jit(
                lambda r, t, mv: cm.evaluate_pose_batch(
                    state, r, t, mv, pe.bind_lookup(lookup, None), cmc
                )
            )(rot, trans, meas_var)

        a = run(Config(), fold=True)
        b = run(Config(), fold=False)
        # every particle (incl. the tail) must keep all its contacts
        np.testing.assert_array_equal(
            np.asarray(a.n_contacts), np.asarray(b.n_contacts)
        )
        assert np.asarray(b.measurement_valid).all()
        _assert_results_close(a, b)
        # the unpacked gather (no fold, no SoA queries) agrees too
        cmc = ContactModelConfig(contact_point_radius=0.0, min_contacts=2,
                                 fold_lookup=False)
        unpacked = pe.bind_lookup(shared_grid_lookup(grid, packed=False),
                                  None)
        c = jax.jit(
            lambda r, t, mv: cm.evaluate_pose_batch(
                state, r, t, mv, unpacked, cmc
            )
        )(rot, trans, meas_var)
        _assert_results_close(c, b, rtol=1e-5)

    def test_debug_points_disable_fold(self, grid):
        # with_debug_points needs per-query data — the fold must bow out
        cmc = ContactModelConfig(
            contact_point_radius=0.0, min_contacts=2, fold_lookup=True
        )
        cfg = Config(contact_model=cmc)
        lookup = make_lookup(cfg, grid)
        state = _contact_state()
        rot, trans, meas_var = _batch_inputs(jax.random.PRNGKey(2), 16,
                                             1.0)
        res = cm.evaluate_pose_batch(
            state, rot, trans, meas_var, pe.bind_lookup(lookup, None),
            cmc, with_debug_points=True,
        )
        # debug payload is populated (not the fold's zero placeholder)
        assert np.asarray(res.cp_point)[np.asarray(res.cp_ok)].any()
