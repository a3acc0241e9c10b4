"""Device-mesh sharding of the filter.

The reference's only parallelism is an (unsafe, default-off) OpenMP loop
over particles (``/root/reference/src/PoseEstimator.cpp:272-276``,
``src/CMakeLists.txt:22-29``).  The scale-out here is
**particle-dimension data parallelism**: every per-particle array shards
along its leading axis over a 1-D ``('dp',)`` mesh; maps are replicated
(shared-map mode) or block-sharded (map pool).  The filter step is pure,
so a single ``jit`` with sharding constraints makes XLA insert the
collectives:

* weight normalisation / ESS / max-weight  -> ``psum``-style reductions,
* stratified/systematic resampling         -> all-gather of the [N]
  weight vector (4 B/particle) + a cross-shard particle gather; the
  cumsum+searchsorted formulation is *exactly* the distributed
  systematic resample — every shard computes identical stratum
  positions from the shared key, and the index gather migrates
  particles (and their map ids) between shards.

``constrain`` is idempotent and a no-op without a mesh, so single-chip
and multi-host code paths are the same function.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices=None, devices=None):
    """1-D data-parallel mesh over the particle axis."""
    devs = devices if devices is not None else jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), ("dp",))


def particle_sharding(mesh):
    return NamedSharding(mesh, P("dp"))


def replicated(mesh):
    return NamedSharding(mesh, P())


def constrain_particles(particles, mesh):
    """Pin every per-particle leaf to the 'dp' axis."""
    if mesh is None:
        return particles
    s = particle_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda a: jax.lax.with_sharding_constraint(a, s), particles
    )


def shard_state(state, mesh):
    """Place a PoseEstimatorState: particles sharded, the rest replicated."""
    if mesh is None:
        return state
    import dataclasses

    ps = particle_sharding(mesh)
    rep = replicated(mesh)
    particles = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, ps), state.particles
    )
    rest = {
        f.name: jax.tree_util.tree_map(
            lambda a: jax.device_put(a, rep), getattr(state, f.name)
        )
        for f in dataclasses.fields(state)
        if f.name != "particles"
    }
    return dataclasses.replace(state, particles=particles, **rest)


# pool fields whose leading axis is the BLOCK axis (sharded over 'dp';
# with Config.map_pool_shards == mesh size, allocation keeps each
# particle's blocks on its own device)
_POOL_BLOCK_FIELDS = (
    "mean", "stdev", "height", "meta", "color", "origin", "allocated",
)


def _pool_placements(pool, mesh, put):
    import dataclasses as dc

    s = particle_sharding(mesh)  # P('dp') on the leading axis
    new = {"chain": put(pool.chain, s)}
    for f in _POOL_BLOCK_FIELDS:
        a = getattr(pool, f)
        if a is not None:
            new[f] = put(a, s)
    return dc.replace(pool, **new)


def shard_pool(pool, mesh):
    """Place a MapPool on the mesh: chain rows follow their particles,
    block arrays shard along the block axis (map memory per device
    scales down with the mesh)."""
    if mesh is None:
        return pool
    return _pool_placements(pool, mesh, jax.device_put)


def constrain_pool(pool, mesh):
    """In-jit sharding constraints matching :func:`shard_pool`."""
    if mesh is None:
        return pool
    return _pool_placements(
        pool, mesh, jax.lax.with_sharding_constraint
    )
