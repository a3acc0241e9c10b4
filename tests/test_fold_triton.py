"""The Triton contact-fold kernel in the Pallas interpreter, against the
plain-XLA fold (``lookup.gather_fold``), plus the platform choice of the
production lookup (XLA on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_eslam_tpu.config import Config
from slam_eslam_tpu.mapping import mls_grid
from slam_eslam_tpu.mapping.fold_triton import _tile, kernel_wins, triton_fold
from slam_eslam_tpu.mapping.lookup import gather_fold, make_lookup


def _packed(nx, ny, k, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 0.2, (nx, ny, k)).astype(np.float32)
    stdevs = rng.uniform(0.01, 0.1, (nx, ny, k)).astype(np.float32)
    valid = rng.random((nx, ny, k)) < 0.7
    data = np.concatenate(
        [np.where(valid, means, 0.0), np.where(valid, stdevs, -1.0)], -1
    ).astype(np.float32)
    return mls_grid.PackedLookup(
        data=jnp.asarray(data), origin=jnp.asarray([-1.1, -0.9], jnp.float32),
        resolution=0.05,
    )


def _inputs(packed, c, n, n_seg, seed=1):
    rng = np.random.default_rng(seed)
    nx, ny = packed.data.shape[:2]
    ox, oy = np.asarray(packed.origin)
    # a cloud over the grid and a little beyond it (misses)
    x = ox + rng.uniform(-0.1, nx * 0.05 + 0.1, (c, n))
    y = oy + rng.uniform(-0.1, ny * 0.05 + 0.1, (c, n))
    z = rng.normal(0.0, 0.3, (c, n))
    queries = tuple(jnp.asarray(a, jnp.float32) for a in (x, y, z))
    act = jnp.asarray(rng.random((c, 1)) < 0.8, jnp.float32)
    seg = np.arange(c) * n_seg // c
    onehot = jnp.asarray(np.eye(n_seg, dtype=np.float32)[seg])
    mv = jnp.asarray(rng.uniform(0.005, 0.02, (1, n)), jnp.float32)
    return queries, act, mv, onehot


@pytest.mark.parametrize("c,n,n_seg,k", [
    (8, 700, 4, 4),     # the contact-cap shape, ragged particle tile
    (6, 128, 3, 2),     # C padded to 8
    (20, 300, 5, 1),    # the full Asguard state, C padded to 32
    (8, 1, 8, 4),       # one particle, one point per segment
])
def test_kernel_matches_xla_fold(c, n, n_seg, k):
    packed = _packed(30, 23, k, seed=c + k)
    queries, act, mv, onehot = _inputs(packed, c, n, n_seg)
    ref = gather_fold(packed)(queries, act, mv, onehot=onehot,
                              correction=0.33)
    got = triton_fold(packed, interpret=True)(
        queries, act, mv, onehot=onehot, correction=0.33)
    assert got.shape == (8, n)
    assert float(jnp.sum(ref[4])) > 0
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_kernel_takes_a_traced_map():
    """The map may travel as a jit argument (EmbodiedSlamFilter)."""
    packed = _packed(16, 16, 4)
    queries, act, mv, onehot = _inputs(packed, 8, 64, 4)

    @jax.jit
    def run(packed, queries, mv):
        return triton_fold(packed, interpret=True)(
            queries, act, mv, onehot=onehot, correction=0.33)

    ref = gather_fold(packed)(queries, act, mv, onehot=onehot,
                              correction=0.33)
    np.testing.assert_allclose(np.asarray(run(packed, queries, mv)),
                               np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_production_fold_is_xla_on_cpu():
    """``make_lookup(...).fold`` picks the plain-XLA fold when lowered
    for the CPU: no kernel in the compiled program, identical rows."""
    packed = _packed(20, 20, 4)
    queries, act, mv, onehot = _inputs(packed, 8, 100, 4)
    fold = make_lookup(Config(), packed).fold

    def run(q, m):
        return fold(q, act, m, onehot=onehot, correction=0.33)

    hlo = jax.jit(run).lower(queries, mv).as_text()
    assert "triton" not in hlo and "custom_call" not in hlo
    xla = gather_fold(packed)
    ref = jax.jit(lambda q, m: xla(q, act, m, onehot=onehot,
                                   correction=0.33))(queries, mv)
    np.testing.assert_array_equal(np.asarray(jax.jit(run)(queries, mv)),
                                  np.asarray(ref))


@pytest.mark.parametrize("cp,n,tile", [
    (8, 100_000, 512),   # the contact-cap shape
    (32, 100_000, 128),  # the full Asguard state (C = 20)
    (128, 100_000, 64),  # floor
    (8, 300, 512),       # small N: one program
    (8, 1, 1),
])
def test_tile_holds_the_elements_per_program(cp, n, tile):
    assert _tile(cp, n) == tile


@pytest.mark.parametrize("c,kernel", [(8, True), (6, True), (20, False),
                                      (4, False)])
def test_cuda_lowering_uses_the_kernel_where_it_wins(c, kernel):
    """Lowered for CUDA, the production fold holds the kernel's custom
    call at one 8-row block and the plain-XLA fold at other counts."""
    packed = _packed(20, 20, 4)
    queries, act, mv, onehot = _inputs(packed, c, 1000, 4)
    fold = make_lookup(Config(), packed).fold

    def run(q, m):
        return fold(q, act, m, onehot=onehot, correction=0.33)

    hlo = jax.jit(run).trace(queries, mv).lower(
        lowering_platforms=("cuda",)).as_text()
    assert kernel_wins(c) == kernel
    assert ("contact_fold" in hlo) == kernel
