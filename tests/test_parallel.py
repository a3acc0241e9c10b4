"""Multi-device tests on the virtual 8-device CPU mesh.

The pattern SURVEY §4 prescribes: distributed resampling / sharded
filter steps validated via ``--xla_force_host_platform_device_count``
without a pod.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_eslam_tpu.core import filter as pf
from slam_eslam_tpu.parallel import resample as dres
from slam_eslam_tpu.parallel import sharding as shd

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(scope="module")
def mesh():
    return shd.make_mesh(8)


class TestDistributedResample:
    def test_matches_single_device(self, mesh):
        # identical key + weights => shard_map result == single-device
        key = jax.random.PRNGKey(5)
        w = jax.random.uniform(jax.random.PRNGKey(1), (64,)) + 0.01
        wn, ess_ref = pf.normalize_weights(w)
        idx_ref = pf.resample_systematic(key, wn, 64)

        w_sharded = jax.device_put(
            w, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("dp")
            )
        )
        idx, ess = jax.jit(
            lambda k, ww: dres.resample_shard_map(k, ww, mesh)
        )(key, w_sharded)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_ref))
        np.testing.assert_allclose(float(ess), float(ess_ref), rtol=1e-5)

    def test_jit_path_matches(self, mesh):
        key = jax.random.PRNGKey(7)
        w = jax.random.uniform(jax.random.PRNGKey(2), (64,)) + 0.01
        idx_a, ess_a = jax.jit(
            lambda k, ww: dres.resample_sharded(k, ww, mesh)
        )(key, w)
        wn, _ = pf.normalize_weights(w)
        idx_ref = pf.resample_systematic(key, wn, 64)
        np.testing.assert_array_equal(np.asarray(idx_a), np.asarray(idx_ref))

    @pytest.mark.parametrize("n", [64, 1000])
    def test_gather_resampler_matches_default(self, mesh, n):
        """The mesh default of the filter step: the single-device
        stratified resample + packed gather, indices sharded."""
        from slam_eslam_tpu.core.state import ParticleSet

        key = jax.random.PRNGKey(3)
        w = jax.random.uniform(jax.random.PRNGKey(4), (n,)) + 0.01
        wn, _ = pf.normalize_weights(w)
        p = dataclasses.replace(ParticleSet.zeros(n), weight=wn,
                                yaw=jnp.arange(n, dtype=jnp.float32))
        sh = shd.particle_sharding(mesh)
        out, idx = jax.jit(dres.make_gather_resampler(mesh))(
            key, jax.device_put(wn, sh), shd.constrain_particles(p, mesh)
        )
        idx_ref = pf.resample_stratified(key, wn, n)
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(idx_ref))
        np.testing.assert_array_equal(np.asarray(out.yaw),
                                      np.asarray(idx_ref, np.float32))
        assert idx.sharding.spec == jax.sharding.PartitionSpec("dp")

    def test_degenerate_weights_uniform_reset(self, mesh):
        key = jax.random.PRNGKey(0)
        w = jnp.zeros((64,))
        w_sharded = jax.device_put(
            w, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("dp")
            )
        )
        idx, ess = jax.jit(
            lambda k, ww: dres.resample_shard_map(k, ww, mesh)
        )(key, w_sharded)
        np.testing.assert_allclose(float(ess), 64.0, rtol=1e-4)
        # uniform weights + systematic scheme -> identity permutation
        assert sorted(np.asarray(idx).tolist()) == list(range(64))


class TestPpermuteResample:
    """Ring-hop payload exchange must equal the all-gather formulation
    (and the single-device oracle) for every weight-imbalance regime."""

    CASES = {
        "random": lambda: jax.random.uniform(
            jax.random.PRNGKey(1), (64,)) + 0.01,
        "collapse_high": lambda: jnp.concatenate(
            [jnp.full((56,), 1e-6), jnp.ones((8,))]),
        "collapse_low": lambda: jnp.concatenate(
            [jnp.ones((8,)), jnp.full((56,), 1e-6)]),
        "degenerate": lambda: jnp.zeros((64,)),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_matches_single_device(self, mesh, case):
        key = jax.random.PRNGKey(5)
        w = self.CASES[case]()
        payload = {
            "xy": jnp.arange(64.0)[:, None] * jnp.ones((1, 2)),
            "map_id": jnp.arange(64, dtype=jnp.int32),
        }
        wn, ess_ref = pf.normalize_weights(w)
        idx_ref = pf.resample_systematic(key, wn, 64)

        sh = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("dp")
        )
        w_s = jax.device_put(w, sh)
        pay_s = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, sh), payload
        )
        out, idxg, ess = jax.jit(
            lambda k, ww, pp: dres.resample_ppermute(k, ww, pp, mesh)
        )(key, w_s, pay_s)

        np.testing.assert_array_equal(np.asarray(idxg), np.asarray(idx_ref))
        # the moved payload is exactly the gather by the global indices
        np.testing.assert_array_equal(
            np.asarray(out["map_id"]), np.asarray(idxg)
        )
        np.testing.assert_allclose(
            np.asarray(out["xy"])[:, 0], np.asarray(idxg)
        )
        np.testing.assert_allclose(float(ess), float(ess_ref), rtol=1e-5)

    def test_stratified_scheme_matches_reference_statistics(self, mesh):
        """scheme='stratified' reproduces the single-device stratified
        resample (the reference's scheme) bit-for-bit on indices."""
        key = jax.random.PRNGKey(5)
        w = jax.random.uniform(jax.random.PRNGKey(1), (64,)) + 0.01
        wn, _ = pf.normalize_weights(w)
        idx_ref = pf.resample_stratified(key, wn, 64)
        sh = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("dp")
        )
        payload = {"i": jnp.arange(64, dtype=jnp.int32)}
        out, idxg, _ = jax.jit(
            lambda k, ww, pp: dres.resample_ppermute(
                k, ww, pp, mesh, scheme="stratified"
            )
        )(
            key, jax.device_put(w, sh),
            jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), payload),
        )
        np.testing.assert_array_equal(np.asarray(idxg), np.asarray(idx_ref))
        np.testing.assert_array_equal(np.asarray(out["i"]), np.asarray(idxg))

    def test_full_step_with_ppermute_resampler(self, mesh):
        """The ring-hop resampler must drop into the jitted, lax.cond-
        gated filter step on a mesh and match the gather formulation."""
        import __graft_entry__ as g
        from slam_eslam_tpu.filter import step as steplib

        cfg, lookup, state, cs, q = g._build(64, nx=32, ny=32)
        cfg = dataclasses.replace(cfg, min_effective=64)  # force resample
        gate = (np.float32(1.0), np.float32(0.0))

        state_sh = shd.shard_state(state, mesh)
        f_plain = steplib.make_filter_step(cfg, lookup, mesh=mesh)
        f_pp = steplib.make_filter_step(
            cfg, lookup, mesh=mesh,
            resampler=dres.make_ppermute_resampler(mesh),
        )
        out_a, _ = f_plain(state_sh, cs, q, gate)
        out_b, _ = f_pp(state_sh, cs, q, gate)
        np.testing.assert_allclose(
            np.asarray(out_a.particles.weight),
            np.asarray(out_b.particles.weight),
        )
        np.testing.assert_allclose(
            np.asarray(out_a.particles.xy), np.asarray(out_b.particles.xy)
        )


class TestShardedFilterStep:
    def test_fold_lookup_on_mesh(self, mesh):
        """The production lookup's contact fold built for the mesh runs
        shard-locally over particle-sharded ``[C, N]`` queries (the map
        replicated) and must match the single-device result."""
        import numpy as _np

        from slam_eslam_tpu.config import Config
        from slam_eslam_tpu.mapping.lookup import make_lookup
        from slam_eslam_tpu.models import sim as simlib

        terrain = lambda x, y: 0.25 * _np.sin(1.3 * _np.asarray(x))
        grid = simlib.terrain_grid(
            terrain, nx=64, ny=64, resolution=0.1, origin=(-3.2, -3.2)
        )
        lk = make_lookup(Config(), grid)
        lk_mesh = make_lookup(Config(), grid, mesh=mesh)
        c, n = 4, 64
        xy = jax.random.uniform(jax.random.PRNGKey(0), (2, c, n),
                                minval=-0.8, maxval=0.8)
        z = jnp.asarray(terrain(_np.asarray(xy[0]), 0.0) + 0.05,
                        jnp.float32)
        queries = (xy[0], xy[1], z)
        act = jnp.ones((c, 1), jnp.float32)
        mv = jnp.full((1, n), 0.01, jnp.float32)
        onehot = jnp.asarray(_np.eye(c, 2, k=0, dtype=_np.float32)
                             + _np.eye(c, 2, k=-2, dtype=_np.float32))

        def fold(lookup):
            return jax.jit(lambda q, m: lookup.fold(
                q, act, m, onehot=onehot, correction=0.33))

        a = fold(lk)(queries, mv)
        cols = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, "dp")
        )
        b = fold(lk_mesh)(jax.device_put(queries, cols),
                          jax.device_put(mv, cols))
        assert not b.sharding.is_fully_replicated
        assert float(jnp.sum(a[4])) > 0
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6)

    def test_full_step_on_mesh(self, mesh):
        # the dryrun path: full filter step sharded dp over 8 devices
        import __graft_entry__ as g

        g.dryrun_multichip(8)

    def test_sharded_matches_replicated(self, mesh):
        """The sharded update must produce the same weights as the
        unsharded one (determinism across layouts at f32 tolerance)."""
        import __graft_entry__ as g
        from slam_eslam_tpu.filter import step as steplib

        cfg, lookup, state, cs, q = g._build(64, nx=32, ny=32)
        gate = (np.float32(1.0), np.float32(0.0))

        f_single = steplib.make_filter_step(cfg, lookup)
        out_single, _ = f_single(state, cs, q, gate)

        state_sh = shd.shard_state(state, mesh)
        mesh_lookup = g._build(64, nx=32, ny=32, mesh=mesh)[1]
        f_mesh = steplib.make_filter_step(cfg, mesh_lookup, mesh=mesh)
        out_mesh, _ = f_mesh(state_sh, cs, q, gate)

        np.testing.assert_allclose(
            np.asarray(out_single.particles.weight),
            np.asarray(out_mesh.particles.weight),
            rtol=2e-4, atol=1e-6,
        )
        np.testing.assert_allclose(
            np.asarray(out_single.particles.xy),
            np.asarray(out_mesh.particles.xy),
            rtol=2e-4, atol=1e-5,
        )
