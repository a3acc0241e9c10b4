"""Multi-host runtime wiring (the DCN path).

The reference is a single-process library — its only parallelism is an
optional OpenMP loop (``/root/reference/src/PoseEstimator.cpp:272-276``;
no MPI/NCCL anywhere, SURVEY §2c).  The multi-host deployment spans
hosts with ONE program: ``jax.distributed`` builds the cross-process
runtime, the global device mesh covers every device of every host, and
XLA routes collectives over the intra-host links and the network.

This module is the thin, testable wiring layer:

* :func:`initialize` — idempotent ``jax.distributed.initialize`` driven
  by explicit args or ``ESLAM_*`` environment variables (on clusters
  that JAX auto-detects they may all be omitted);
* :func:`global_mesh` — the 1-D ``('dp',)`` particle mesh over ALL
  processes' devices;
* :func:`shard_host_batch` — lift each process's local particle shard
  into one global ``jax.Array``.

CI proof without a pod: ``tests/test_multihost.py`` launches two local
CPU processes through this module's ``__main__`` worker; the 2-process
global resample/ESS must match the single-process oracle exactly.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Initialise the multi-host runtime (idempotent).

    Argument resolution order: explicit args, then ``ESLAM_COORDINATOR``
    / ``ESLAM_NUM_PROCESSES`` / ``ESLAM_PROCESS_ID`` env vars, then the
    cluster auto-detection built into ``jax.distributed.initialize``.
    Returns True when a multi-process runtime is active
    after the call, False when the configuration says single-process
    (no coordinator and no pod auto-detection requested).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "ESLAM_COORDINATOR"
    )
    if num_processes is None and "ESLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ESLAM_NUM_PROCESSES"])
    if process_id is None and "ESLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ESLAM_PROCESS_ID"])

    # NOTE: jax.process_count() would initialise the XLA backend, after
    # which jax.distributed.initialize refuses to run — only touch the
    # distributed-state flag here.
    if jax.distributed.is_initialized():
        return jax.process_count() > 1
    if coordinator_address is None and num_processes is None:
        return False  # single-process configuration; nothing to do

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count() > 1


def global_mesh(axis="dp"):
    """1-D mesh over every device of every process (global view)."""
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_host_batch(local_arrays, mesh, axis="dp"):
    """Per-process local particle shards -> global ``jax.Array`` pytree.

    ``local_arrays``: pytree of host arrays holding THIS process's
    particles (leading axis = local particle count).  The global array
    concatenates the processes in process order along the axis.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    s = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(s, np.asarray(a)),
        local_arrays,
    )


def _worker_main():
    """2-process CPU test worker (driven by tests/test_multihost.py).

    Builds a deterministic weight vector, shards it over the global
    mesh, and runs the jitted normalize + ESS + systematic resample.
    Prints ``ess`` and the local shard of the resampled payload so the
    test can compare every process against the single-process oracle.
    """
    import jax.numpy as jnp

    # CPU backend with several virtual devices per process (set before
    # any backend initialises).
    jax.config.update("jax_platforms", "cpu")
    ok = initialize()
    assert ok, "worker expects a multi-process configuration"

    n_global = int(os.environ.get("ESLAM_TEST_N", "64"))
    pc, pid = jax.process_count(), jax.process_index()
    assert n_global % pc == 0
    n_local = n_global // pc

    mesh = global_mesh()
    # deterministic global weights, identical on every process
    rng = np.random.default_rng(7)
    w_global = rng.uniform(0.1, 1.0, n_global).astype(np.float32)
    payload_global = np.arange(n_global, dtype=np.int32)
    lo = pid * n_local
    w = shard_host_batch(w_global[lo:lo + n_local], mesh)
    payload = shard_host_batch(payload_global[lo:lo + n_local], mesh)

    from jax.sharding import NamedSharding, PartitionSpec as P

    from slam_eslam_tpu.core import filter as pf

    @jax.jit
    def step(w, payload):
        w, _ = pf.normalize_weights(w)
        ess = pf.effective_sample_size(w)
        idx = pf.resample_systematic(
            jax.random.PRNGKey(3), w, w.shape[0]
        )
        out = jax.lax.with_sharding_constraint(
            payload[idx], NamedSharding(mesh, P("dp"))
        )
        return ess, out

    ess, out = step(w, payload)
    # every process prints ITS shard (addressable data only)
    local = np.concatenate([
        np.asarray(s.data).reshape(-1)
        for s in sorted(out.addressable_shards, key=lambda s: s.index)
    ])
    print(f"RESULT pid={pid} ess={float(ess):.6f} "
          f"local={','.join(map(str, local.tolist()))}", flush=True)


if __name__ == "__main__":
    _worker_main()
