"""Parity of the compiled GPU paths with the CPU device (needs a card).

Every test is marked ``chip`` and takes the ``gpu`` fixture, which skips
it without a GPU.  ``chip_smoke.py`` runs them in its own process on the
card (``pytest -m chip tests/test_chip.py``); the same program then runs
on the GPU and on ``jax.devices("cpu")[0]`` and the results are
compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_eslam_tpu.mapping import map_pool as mp
from slam_eslam_tpu.mapping.mls_grid import PatchCloud

pytestmark = pytest.mark.chip


def _on(device, fn, *args):
    """``fn(*args)`` jitted, with every input placed on ``device``."""
    return jax.jit(fn)(*jax.device_put(args, device))


def _pool(n=256, nx=40, ny=40, k=4, chain_len=3, seed=0):
    b = n + 16
    rng = np.random.default_rng(seed)
    shape = (b, nx, ny * k)
    return mp.MapPool(
        mean=jnp.asarray(rng.normal(size=shape).astype(np.float32)),
        stdev=jnp.asarray((0.01 + 0.2 * rng.random(shape)).astype(np.float32)),
        height=jnp.zeros(shape, jnp.float32),
        meta=jnp.asarray(((rng.random(shape) < 0.5).astype(np.int32)) | 2),
        color=None,
        origin=jnp.asarray((rng.normal(size=(b, 2)) * 2).astype(np.float32)),
        allocated=jnp.ones((b,), bool),
        chain=jnp.asarray(np.where(
            rng.random((n, chain_len)) < 0.8,
            rng.integers(0, b, size=(n, chain_len)), -1,
        ).astype(np.int32)),
        resolution=0.25, nx=nx, ny=ny, k=k,
    )


def test_chain_lookup_matches_cpu(gpu):
    """The per-particle chain gather (``PoseEstimator.hpp:97-105``
    equivalent) returns the same patches on the card as on the CPU."""
    pool = _pool()
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.normal(size=(pool.n, 8, 3)).astype(np.float32) * 3)

    def lookup(pool, pts):
        lk = mp.chain_lookup(pool)
        return jax.vmap(lk)(jnp.arange(pool.n), pts)[:3]

    g = _on(gpu, lookup, pool, pts)
    c = _on(jax.devices("cpu")[0], lookup, pool, pts)
    f = np.asarray(c[0])
    assert f.sum() > 0, "fixture produced no hits"
    np.testing.assert_array_equal(np.asarray(g[0]), f)
    np.testing.assert_array_equal(np.asarray(g[1])[f], np.asarray(c[1])[f])
    np.testing.assert_array_equal(np.asarray(g[2])[f], np.asarray(c[2])[f])


def _merge(pool, cloud):
    n = pool.n
    pool = dataclasses.replace(
        pool, chain=pool.chain.at[:, 0].set(jnp.arange(n, dtype=jnp.int32))
    )
    return mp.merge_cloud_all(pool, jnp.zeros((n, 2)), jnp.zeros(n),
                              jnp.zeros(n), jnp.full((n,), 0.01), cloud, 7)


def test_merge_single_point_cells_exact(gpu):
    """One point per cell leaves no accumulation-order freedom: flags
    bitwise equal, values to f32 round-off.  The fused z (sum w*z / sum
    w) can still round one ulp apart on the two backends, and a gap
    patch's height (top - bottom) carries that ulp as an absolute error,
    hence the absolute tolerance of a few ulps at these magnitudes."""
    pool = _pool(n=64)
    rng = np.random.default_rng(2)
    p = 64
    cells = rng.choice(40 * 40, size=p, replace=False)
    cx, cy = cells // 40, cells % 40
    xy = np.stack([(cx + 0.5) * 0.25, (cy + 0.5) * 0.25], 1)
    xy += np.asarray(pool.origin[0])
    cloud = PatchCloud.create(
        xy=jnp.asarray(xy.astype(np.float32)),
        z=jnp.asarray(rng.normal(size=(p,)).astype(np.float32)),
        stdev=jnp.full((p,), 0.05), valid=jnp.ones((p,), bool),
    )
    g = _on(gpu, _merge, pool, cloud)
    c = _on(jax.devices("cpu")[0], _merge, pool, cloud)
    np.testing.assert_array_equal(np.asarray(g.meta), np.asarray(c.meta))
    v = np.asarray(c.valid) != 0
    for fld in ("mean", "stdev", "height"):
        np.testing.assert_allclose(
            np.asarray(getattr(g, fld))[v], np.asarray(getattr(c, fld))[v],
            rtol=1e-6, atol=1e-6, err_msg=fld,
        )


def test_merge_multi_point_cells_statistical(gpu):
    """Multi-point cells accumulate in another order on each device;
    f32 associativity can flip a fuse/gap/insert branch that sits on a
    threshold (the ``chip_smoke.check_merge_statistical`` criterion)."""
    import chip_smoke

    pool = _pool(n=64)
    rng = np.random.default_rng(3)
    p = 256
    cloud = PatchCloud.create(
        xy=jnp.asarray(rng.normal(size=(p, 2)).astype(np.float32) * 3),
        z=jnp.asarray(rng.normal(size=(p,)).astype(np.float32)),
        stdev=jnp.full((p,), 0.05), valid=jnp.ones((p,), bool),
    )
    g = _on(gpu, _merge, pool, cloud)
    c = _on(jax.devices("cpu")[0], _merge, pool, cloud)
    chip_smoke.check_merge_statistical(g, c)


def test_contact_fold_matches_cpu(gpu):
    """The fused gather + contact fold (the default weighting path)
    on the card against the same program on the CPU."""
    from slam_eslam_tpu.config import Config, ContactModelConfig
    from slam_eslam_tpu.core.state import BodyContactState
    from slam_eslam_tpu.filter import pose_estimator as pe
    from slam_eslam_tpu.mapping import mls_grid
    from slam_eslam_tpu.mapping.lookup import make_lookup
    from slam_eslam_tpu.models import contact_model as cm
    from slam_eslam_tpu.models import sim as simlib

    import chip_smoke

    grid = simlib.terrain_grid(chip_smoke.terrain, nx=128, ny=128,
                               resolution=0.1, origin=(-6.4, -6.4))
    packed = mls_grid.PackedLookup.from_grid(grid)
    n = 512
    cs = BodyContactState.create(
        np.array([[0.2, 0.1, -0.1], [-0.2, 0.1, -0.12],
                  [0.2, -0.1, -0.09], [-0.2, -0.1, -0.11],
                  [0.0, 0.2, -0.1], [0.0, -0.2, -0.1],
                  [0.1, 0.0, -0.1], [-0.1, 0.0, -0.1]], np.float32),
        group_id=np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32),
    )
    xy = jax.random.uniform(jax.random.PRNGKey(3), (n, 2), minval=-1.5,
                            maxval=1.5)
    z = jnp.asarray(chip_smoke.terrain(np.asarray(xy[:, 0]),
                                       np.asarray(xy[:, 1])), jnp.float32)
    rot = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))
    trans = jnp.concatenate([xy, (z + 0.1)[:, None]], axis=-1)
    meas_var = jnp.full((n,), 0.09, jnp.float32)
    cmc = ContactModelConfig(contact_point_radius=0.0, min_contacts=2)
    cfg = Config(contact_model=cmc)

    def evaluate(packed, rot, trans, meas_var):
        bound = pe.bind_lookup(make_lookup(cfg, packed), None)
        r = cm.evaluate_pose_batch(cs, rot, trans, meas_var, bound, cmc)
        return r.measurement_valid, r.weight, r.z_delta, r.pose_var

    args = (packed, rot, trans, meas_var)
    g = _on(gpu, evaluate, *args)
    c = _on(jax.devices("cpu")[0], evaluate, *args)
    assert np.asarray(c[0]).any()
    np.testing.assert_array_equal(np.asarray(g[0]), np.asarray(c[0]))
    for a, b in zip(g[1:], c[1:]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=chip_smoke.UPDATE_RTOL,
            atol=chip_smoke.UPDATE_ATOL,
        )


def test_fold_kernel_matches_xla_fold(gpu):
    """The production fold (the Triton kernel where the program is
    lowered for CUDA) against the plain-XLA fold, both on the card, at
    100k particles x 8 contact points on the 400x400 map."""
    from slam_eslam_tpu.config import Config
    from slam_eslam_tpu.mapping import mls_grid
    from slam_eslam_tpu.mapping.lookup import gather_fold, make_lookup
    from slam_eslam_tpu.models import sim as simlib

    import chip_smoke

    grid = simlib.terrain_grid(chip_smoke.terrain, nx=400, ny=400,
                               resolution=0.05, origin=(-10.0, -10.0))
    packed = mls_grid.PackedLookup.from_grid(grid)
    c, n = 8, 100_000
    rng = np.random.default_rng(0)
    xy = rng.normal(0.0, 3.0, (2, c, n)).astype(np.float32)
    z = (chip_smoke.terrain(xy[0], xy[1])
         + rng.normal(0.0, 0.05, (c, n))).astype(np.float32)
    queries = (jnp.asarray(xy[0]), jnp.asarray(xy[1]), jnp.asarray(z))
    act = jnp.asarray(rng.random((c, 1)) < 0.8, jnp.float32)
    onehot = jnp.asarray(np.eye(4, dtype=np.float32)[np.arange(c) // 2])
    mv = jnp.full((1, n), 0.01, jnp.float32)
    outs = []
    for fold in (make_lookup(Config(), packed).fold, gather_fold(packed)):
        outs.append(jax.jit(
            lambda q, m, fold=fold: fold(q, act, m, onehot=onehot,
                                         correction=0.33)
        )(jax.device_put(queries, gpu), jax.device_put(mv, gpu)))
    hlo = jax.jit(lambda q, m: make_lookup(Config(), packed).fold(
        q, act, m, onehot=onehot, correction=0.33)).lower(
            queries, mv).as_text()
    assert "triton" in hlo, "the kernel is not in the CUDA program"
    assert float(jnp.sum(outs[1][4])) > 0
    np.testing.assert_allclose(np.asarray(outs[0]), np.asarray(outs[1]),
                               rtol=1e-4, atol=1e-5)
