"""Map-lookup adapters: the seam between the contact model and maps.

The reference injects the map as a callback
(``boost::function<bool(Vector3d, SurfacePatch&)>`` —
``/root/reference/src/ContactModel.hpp:115-118``, bound to
``GridAccess::get`` at ``src/PoseEstimator.cpp:291``).  Here the seam is
a batched function ``lookup(map_id, points [C, 3]) -> (found, mean,
stdev, color)`` vmapped over particles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from slam_eslam_tpu.mapping import fold_triton, mls_grid
from slam_eslam_tpu.models import contact_model as cm


def _cells(packed, x, y):
    """World xy -> (unclamped) int32 cell indices of ``packed``."""
    ix = jnp.floor((x - packed.origin[0]) / packed.resolution)
    iy = jnp.floor((y - packed.origin[1]) / packed.resolution)
    return ix.astype(jnp.int32), iy.astype(jnp.int32)


def gather_fold(packed, z_window=3.0):
    """The contact fold in plain XLA: exact packed gather +
    ``contact_fold_sums``.  ``fold(queries, act_col, mv, *, onehot,
    correction)`` takes contact-grid ``[C, N]`` SoA world queries,
    ``act_col [C, 1]`` active mask, ``mv [1, N]`` measurement variance
    and returns ``[8, N]`` per-particle rows (d1, d2, sq, pose_var,
    n_contacts, 0, 0, 0)."""

    def fold(queries, act_col, mv, *, onehot, correction):
        x, y, z = queries
        ix, iy = _cells(packed, x, y)
        found, mean, stdev = mls_grid.get_patch_packed_cells(
            packed, ix, iy, z, z_window
        )
        return cm.contact_fold_sums(
            found, mean, stdev, z, jnp.broadcast_to(act_col, x.shape), mv,
            act_col, onehot, correction,
        )

    return fold


def shared_grid_lookup(grid, z_window=3.0, packed=True, mesh=None):
    """All particles query one shared grid (useSharedMap mode,
    ``EmbodiedSlamFilter.cpp:73-101``); ``map_id`` is ignored.

    With ``packed`` (default) the grid is repacked into the
    single-gather ``PackedLookup`` layout — XLA hoists the (loop-
    invariant) packing out of scans.  The packed lookup also takes SoA
    flat queries ``(x, y, z)`` (``.soa``) and offers the fused contact
    fold (``.fold``, see ``evaluate_pose_batch``).  Colour is not
    available on this path, so pass ``packed=False`` when the
    slip/terrain update needs patch colours.

    ``mesh``: the ``('dp',)`` mesh the particle axis is sharded over;
    the fold then runs shard-locally under ``shard_map`` (each device
    folds its own particles against the replicated map), because XLA
    cannot partition the kernel's custom call.
    """
    if not (isinstance(grid, mls_grid.PackedLookup) or packed):
        def lookup(map_id, points):
            del map_id
            return mls_grid.get_patch(grid, points, z_window)

        lookup.batched = True
        return lookup

    pl = (
        grid
        if isinstance(grid, mls_grid.PackedLookup)
        else mls_grid.PackedLookup.from_grid(grid)
    )

    def lookup(map_id, points):
        del map_id
        if isinstance(points, tuple):
            x, y, z = points
            ix, iy = _cells(pl, x, y)
            return mls_grid.get_patch_packed_cells(pl, ix, iy, z, z_window)
        return mls_grid.get_patch_packed(pl, points, z_window)

    xla_fold = gather_fold(pl, z_window)
    kernel_fold = fold_triton.triton_fold(pl, z_window)

    def fold(queries, act_col, mv, *, onehot, correction):
        """``gather_fold``'s contract: the fused Triton kernel where the
        program is lowered for CUDA and the kernel wins at this contact
        count (``fold_triton.kernel_wins``), plain XLA otherwise."""
        def branch(f):
            return lambda q, a, m, oh: f(q, a, m, onehot=oh,
                                         correction=correction)

        def local(q, a, m, oh):
            if not fold_triton.kernel_wins(q[0].shape[0]):
                return branch(xla_fold)(q, a, m, oh)
            return jax.lax.platform_dependent(
                q, a, m, oh,
                cuda=branch(kernel_fold), default=branch(xla_fold),
            )

        if mesh is None:
            return local(queries, act_col, mv, onehot)
        cols, rep_ = P(None, "dp"), P()
        return jax.shard_map(
            local, mesh=mesh,
            in_specs=((cols, cols, cols), rep_, cols, rep_),
            out_specs=cols, check_vma=False,
        )(queries, act_col, mv, onehot)

    lookup.batched = True  # shape-polymorphic over [N, C, 3]
    lookup.soa = True
    lookup.fold = fold
    return lookup


def make_lookup(cfg, grid, mesh=None):
    """Config-driven shared-map lookup factory — THE production seam.

    The exact packed gather (``shared_grid_lookup``) with its contact
    fold (a fused Triton kernel on CUDA where it wins, plain XLA
    elsewhere).  The
    slip/terrain update needs patch colours, which only the unpacked
    gather carries — ``use_slip_update`` selects that path.  ``grid``
    may be an ``MLSGrid`` or a prebuilt ``PackedLookup``; it may be a
    traced value (map state travelling as a jit argument).  ``mesh``:
    see ``shared_grid_lookup``.
    """
    use_slip = cfg.contact_model.use_slip_update
    return shared_grid_lookup(grid, cfg.mls_z_window, packed=not use_slip,
                              mesh=mesh)
