"""Map-pool tests: copy-on-write, chains, rollover, fused match/merge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from slam_eslam_tpu.mapping import map_pool as mp
from slam_eslam_tpu.mapping import mls_grid
from slam_eslam_tpu.mapping.mls_grid import MLSGrid, PatchCloud


def make_pool(n=4, b=10, nx=20, ny=20, res=0.5, chain_len=3,
              with_color=True):
    template = MLSGrid.create(nx, ny, res, (-5.0, -5.0), k=2)
    return mp.MapPool.from_template(template, n, b, chain_len,
                                    with_color=with_color)


def write_cell(pool, block, x, y, z):
    """Directly poke one patch into a block (test helper)."""
    ix = int((x - float(pool.origin[block, 0])) / pool.resolution)
    iy = int((y - float(pool.origin[block, 1])) / pool.resolution)
    lane = iy * pool.k  # slot 0 of the cell in the [nx, ny*K] image
    return dataclasses.replace(
        pool,
        mean=pool.mean.at[block, ix, lane].set(z),
        stdev=pool.stdev.at[block, ix, lane].set(0.1),
        # set valid bit, keep the template's horizontal bit
        meta=pool.meta.at[block, ix, lane].set(
            pool.meta[block, ix, lane] | 1
        ),
    )


class TestPoolBasics:
    def test_from_template(self):
        pool = make_pool()
        assert pool.n == 4 and pool.b == 10
        np.testing.assert_array_equal(np.asarray(pool.active()), [0, 1, 2, 3])
        np.testing.assert_array_equal(
            np.asarray(pool.refcounts()), [1, 1, 1, 1, 0, 0, 0, 0, 0, 0]
        )

    def test_resample_shares_blocks(self):
        pool = make_pool()
        pool = pool.resample(jnp.array([0, 0, 0, 3]))
        np.testing.assert_array_equal(np.asarray(pool.active()), [0, 0, 0, 3])
        ref = np.asarray(pool.refcounts())
        assert ref[0] == 3 and ref[3] == 1 and ref[1] == 0

    def test_ensure_unique_active(self):
        pool = make_pool()
        pool = write_cell(pool, 0, 0.0, 0.0, 7.0)
        pool = pool.resample(jnp.array([0, 0, 0, 3]))
        pool, n_failed = mp.ensure_unique_active(pool)
        assert int(n_failed) == 0
        active = np.asarray(pool.active())
        assert len(set(active.tolist())) == 4, f"actives not unique: {active}"
        # copies carry the content
        lookup = mp.chain_lookup(pool)
        for i in range(3):
            f, m, s, _ = lookup(jnp.asarray(i), jnp.array([[0.0, 0.0, 7.0]]))
            assert bool(f[0]), f"particle {i} lost its map content"
            np.testing.assert_allclose(m[0], 7.0)

    def test_resample_frees_unreferenced_blocks(self):
        # collapsing onto particle 0 releases blocks 1-3, so COW can
        # still hand every duplicate a private block
        pool = make_pool(n=4, b=4)
        pool = pool.resample(jnp.array([0, 0, 0, 0]))
        pool, n_failed = mp.ensure_unique_active(pool)
        assert int(n_failed) == 0
        assert len(set(np.asarray(pool.active()).tolist())) == 4

    def test_pool_exhaustion_degrades(self):
        # pin every block through chain tails: no free blocks left
        pool = make_pool(n=4, b=4)
        pool = pool.resample(jnp.array([0, 0, 0, 0]))
        chain = pool.chain.at[:, 1].set(jnp.array([1, 2, 3, 1], jnp.int32))
        pool = dataclasses.replace(pool, chain=chain)
        pool, n_failed = mp.ensure_unique_active(pool)
        assert int(n_failed) == 3  # three dups could not get blocks


class TestRollover:
    def test_no_rollover_when_inside(self):
        pool = make_pool()
        xy = jnp.zeros((4, 2))
        pool2, nf = mp.rollover(pool, xy, threshold=3.0)
        np.testing.assert_array_equal(
            np.asarray(pool2.chain), np.asarray(pool.chain)
        )

    def test_rollover_allocates_and_chains(self):
        pool = make_pool()
        pool = write_cell(pool, 1, 0.0, 0.0, 2.5)
        xy = jnp.array([[0.0, 0.0], [8.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
        pool2, nf = mp.rollover(pool, xy, threshold=3.0)
        assert int(nf) == 0
        chain1 = np.asarray(pool2.chain[1])
        assert chain1[1] == 1, "old grid should move down the chain"
        assert chain1[0] >= 4, "fresh block expected"
        # new block centred on the particle
        org = np.asarray(pool2.origin[chain1[0]])
        np.testing.assert_allclose(org, [8.0 - 5.0, -5.0], atol=1e-5)
        # old content still reachable through the chain
        lookup = mp.chain_lookup(pool2)
        f, m, s, _ = lookup(jnp.asarray(1), jnp.array([[0.0, 0.0, 2.5]]))
        assert bool(f[0])
        np.testing.assert_allclose(m[0], 2.5)

    def test_chain_head_priority(self):
        # head (newer) grid wins over older chain entries
        pool = make_pool()
        pool = write_cell(pool, 1, 0.0, 0.0, 2.5)
        xy = jnp.array([[0.0, 0.0], [8.0, 0.0], [0.0, 0.0], [0.0, 0.0]])
        pool, _ = mp.rollover(pool, xy, threshold=3.0)
        head = int(pool.chain[1, 0])
        # overlapping area: write different z into the head block
        pool = write_cell(pool, head, 4.0, 0.0, 9.0)
        pool = write_cell(pool, 1, 4.0, 0.0, 1.0)
        lookup = mp.chain_lookup(pool, z_window=20.0)
        f, m, _, _ = lookup(jnp.asarray(1), jnp.array([[4.0, 0.0, 5.0]]))
        assert bool(f[0])
        np.testing.assert_allclose(m[0], 9.0)


class TestFusedMergeMatch:
    def _cloud(self, n=32, z=1.0):
        key = jax.random.PRNGKey(3)
        xy = jax.random.uniform(key, (n, 2), minval=-2.0, maxval=2.0)
        return PatchCloud.create(
            xy=xy, z=jnp.full((n,), z), stdev=jnp.full((n,), 0.1),
            valid=jnp.ones((n,), bool),
        )

    def test_merge_cloud_all_isolated_per_particle(self):
        pool = make_pool()
        cloud = self._cloud()
        xy = jnp.zeros((4, 2))
        yaw = jnp.zeros((4,))
        z_off = jnp.array([0.0, 10.0, 0.0, 0.0])
        pool = mp.merge_cloud_all(
            pool, xy, yaw, z_off, jnp.zeros((4,)), cloud, 5
        )
        lookup = mp.chain_lookup(pool, z_window=3.0)
        # particle 1's map has patches at z=11, particle 0 at z=1
        pt = np.asarray(cloud.xy[0])
        f0, m0, _, _ = lookup(
            jnp.asarray(0), jnp.array([[pt[0], pt[1], 1.0]])
        )
        f1, m1, _, _ = lookup(
            jnp.asarray(1), jnp.array([[pt[0], pt[1], 11.0]])
        )
        assert bool(f0[0]) and bool(f1[0])
        np.testing.assert_allclose(m0[0], 1.0, atol=1e-5)
        np.testing.assert_allclose(m1[0], 11.0, atol=1e-5)
        # particle 0's map must NOT see z=11
        f0b, _, _, _ = lookup(
            jnp.asarray(0), jnp.array([[pt[0], pt[1], 11.0]])
        )
        assert not bool(f0b[0])

    def test_match_cloud_all_discriminates(self):
        pool = make_pool()
        cloud = self._cloud(z=0.5)
        xy = jnp.zeros((4, 2))
        yaw = jnp.zeros((4,))
        pool = mp.merge_cloud_all(
            pool, xy, yaw, jnp.zeros(4), jnp.zeros(4), cloud, 0
        )
        # particle 0 matches at its build pose; particle 1 offset 2 m up
        scores = mp.match_cloud_all(
            pool, xy, yaw, jnp.array([0.0, 2.0, 0.0, 0.0]), jnp.zeros(4),
            cloud, sampling=1,
        )
        s = np.asarray(scores)
        assert s[0] > 0.9
        assert s[1] < 0.1

    def test_update_idx_stamped(self):
        pool = make_pool()
        cloud = self._cloud()
        pool = mp.merge_cloud_all(
            pool, jnp.zeros((4, 2)), jnp.zeros(4), jnp.zeros(4),
            jnp.zeros(4), cloud, 42,
        )
        assert int(jnp.max(pool.update_idx)) == 42

    def test_jit_merge(self):
        pool = make_pool()
        cloud = self._cloud()
        f = jax.jit(
            lambda p, c: mp.merge_cloud_all(
                p, jnp.zeros((4, 2)), jnp.zeros(4), jnp.zeros(4),
                jnp.zeros(4), c, 0,
            )
        )
        out = f(pool, cloud)
        assert int(jnp.sum(out.valid)) > 0

class TestNegativeInformation:
    """Laser-path negative information on per-particle active grids
    (``EmbodiedSlamFilter.cpp:160``; config doc
    ``src/Configuration.hpp:190-193``)."""

    def test_contradicted_patch_removed_per_particle(self):
        pool = make_pool(n=2, with_color=False)
        # stale patches: particle 0 at world (1, 1, z=2); particle 1 at
        # world (-2, 0, z=0.5)
        pool = write_cell(pool, 0, 1.0, 1.0, 2.0)
        pool = write_cell(pool, 1, -2.0, 0.0, 0.5)

        # free-space samples in the body frame; particle poses differ
        xy = jnp.array([[0.0, 0.0], [-3.0, 0.0]])
        yaw = jnp.zeros(2)
        z = jnp.array([0.0, 0.5])
        # body-frame point (1, 1, 2.0) -> p0 world (1, 1, 2.0) HIT;
        #                              -> p1 world (-2, 1, 2.5) miss
        # body-frame point (1, 0, 0.0) -> p0 world (1, 0, 0.0) no patch;
        #                              -> p1 world (-2, 0, 0.5) HIT
        pts = jnp.array([[1.0, 1.0, 2.0], [1.0, 0.0, 0.0]])
        mask = jnp.ones(2, bool)
        out = mp.apply_negative_cloud_all(pool, xy, yaw, z, pts, mask)

        lookup = mp.chain_lookup(out)
        f0, _, _, _ = lookup(0, jnp.array([[1.0, 1.0, 2.0]]))
        f1, _, _, _ = lookup(1, jnp.array([[-2.0, 0.0, 0.5]]))
        assert not bool(f0[0]), "particle 0's contradicted patch survives"
        assert not bool(f1[0]), "particle 1's contradicted patch survives"

    def test_z_margin_and_mask_respected(self):
        pool = make_pool(n=1, with_color=False)
        pool = write_cell(pool, 0, 1.0, 1.0, 2.0)
        xy, yaw, z = jnp.zeros((1, 2)), jnp.zeros(1), jnp.zeros(1)

        # sample 0.5 m below the patch: outside the 0.15 m margin
        out = mp.apply_negative_cloud_all(
            pool, xy, yaw, z, jnp.array([[1.0, 1.0, 1.5]]),
            jnp.ones(1, bool),
        )
        f, _, _, _ = mp.chain_lookup(out)(0, jnp.array([[1.0, 1.0, 2.0]]))
        assert bool(f[0]), "sample outside z_margin must not erase"

        # masked-off sample never erases
        out = mp.apply_negative_cloud_all(
            pool, xy, yaw, z, jnp.array([[1.0, 1.0, 2.0]]),
            jnp.zeros(1, bool),
        )
        f, _, _, _ = mp.chain_lookup(out)(0, jnp.array([[1.0, 1.0, 2.0]]))
        assert bool(f[0]), "masked sample must not erase"

    def test_only_active_block_touched(self):
        # a patch in a chain TAIL block (not head) must survive: merges
        # only write the active grid, so only it can hold stale patches
        pool = make_pool(n=1, b=10, with_color=False)
        pool = write_cell(pool, 5, 1.0, 1.0, 2.0)
        pool = dataclasses.replace(
            pool, chain=jnp.array([[0, 5, -1]], jnp.int32)
        )
        out = mp.apply_negative_cloud_all(
            pool, jnp.zeros((1, 2)), jnp.zeros(1), jnp.zeros(1),
            jnp.array([[1.0, 1.0, 2.0]]), jnp.ones(1, bool),
        )
        f, _, _, _ = mp.chain_lookup(out)(0, jnp.array([[1.0, 1.0, 2.0]]))
        assert bool(f[0]), "tail-block patch must survive negative info"


class TestCompactStorage:
    """Packed meta word + optional bf16 float fields (the 100k-particle
    HBM configuration)."""

    def test_meta_roundtrip(self):
        v = jnp.array([1, 0, 1], jnp.int32)
        h = jnp.array([0, 1, 1], jnp.int32)
        u = jnp.array([0, 7, 123456], jnp.int32)
        meta = mp.pack_meta(v, h, u)
        np.testing.assert_array_equal(np.asarray(meta & 1), np.asarray(v))
        np.testing.assert_array_equal(
            np.asarray((meta >> 1) & 1), np.asarray(h)
        )
        np.testing.assert_array_equal(np.asarray(meta >> 2), np.asarray(u))

    def test_bf16_pool_merge_and_lookup(self):
        template = MLSGrid.create(20, 20, 0.5, (-5.0, -5.0), k=2)
        mk = lambda dt: mp.MapPool.from_template(
            template, 4, 10, 3, with_color=False, dtype=dt
        )
        key = jax.random.PRNGKey(3)
        n = 32
        xy = jax.random.uniform(key, (n, 2), minval=-2.0, maxval=2.0)
        cloud = PatchCloud.create(
            xy=xy, z=jnp.full((n,), 1.0), stdev=jnp.full((n,), 0.1),
            valid=jnp.ones((n,), bool),
        )
        args = (jnp.zeros((4, 2)), jnp.zeros(4),
                jnp.array([0.0, 10.0, 0.0, 0.0]), jnp.zeros(4), cloud, 5)
        outs = {}
        for dt in (jnp.float32, jnp.bfloat16):
            pool = mp.merge_cloud_all(mk(dt), *args)
            assert pool.mean.dtype == dt
            lookup = mp.chain_lookup(pool, z_window=3.0)
            pt = np.asarray(cloud.xy[0])
            f, m, s, _ = lookup(jnp.asarray(0),
                                jnp.array([[pt[0], pt[1], 1.0]]))
            assert bool(f[0])
            assert m.dtype == jnp.float32  # lookups always return f32
            outs[str(dt)] = (float(m[0]), float(s[0]))
        # bf16 storage rounds once: ~3 decimal digits
        a, b = outs["<class 'jax.numpy.float32'>"], outs[
            "<class 'jax.numpy.bfloat16'>"
        ]
        np.testing.assert_allclose(b[0], a[0], rtol=1e-2, atol=1e-2)
