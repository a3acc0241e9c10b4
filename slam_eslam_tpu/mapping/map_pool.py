"""Per-particle MLS maps: a copy-on-write block pool.

The reference gives every particle its own mutable ``MLSMap`` (a chain
of MLSGrids with an active grid) via ``shared_ptr`` + deep clone on
resample (``/root/reference/src/PoseEstimator.hpp:28-106``,
``PoseEstimator.cpp:31-45``) and rolls to a fresh active grid when the
particle leaves the current one (``EmbodiedSlamFilter.cpp:195-207``).
Naively that is O(N x map) memory traffic per resample.

Design: one dense **block pool** ``[B, nx, ny, K]``; a
particle map is a fixed-length chain of block indices (most recent
first).  Invariants:

* merges only ever write a particle's *active* (chain head) block, so
  non-head blocks are immutable and can be shared freely — resampling
  duplicates chains by index copy (O(N) ints, no map copies);
* before any write, ``ensure_unique_active`` gives each particle an
  exclusively-owned head block, copying only the blocks that are
  actually shared (true copy-on-write; the reference's ``cloneMaps``
  deep-copies whole maps eagerly);
* all heads unique  =>  the merge of N particles x P cloud points is a
  single collision-free ``scatter_fuse_cells`` over the pool flattened
  to ``[B*nx, ny, K]`` — one kernel for the widest fan-out in the
  mapping path (``EmbodiedSlamFilter.cpp:179-232``).

Pool exhaustion degrades gracefully: particles that cannot get a
private block keep sharing (their concurrent cell writes then resolve
in unspecified order — bounded corruption of one scan merge, flagged in
the returned ``alloc_failed`` count).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from slam_eslam_tpu.mapping import mls_grid
from slam_eslam_tpu.mapping.mls_grid import MLSGrid, PatchCloud

_FIELDS = ["mean", "stdev", "height", "meta"]

# meta bit layout (one int32 per patch slot, replacing three separate
# int32 fields — 24 -> 16 bytes/slot at f32, 10 at bf16)
META_VALID = 1          # bit 0
META_HORIZONTAL = 2     # bit 1
META_UIDX_SHIFT = 2     # bits 2.. = update_idx (30 bits)


def pack_meta(valid, horizontal, update_idx):
    """Encode (valid, horizontal, update_idx) into one int32 word."""
    v = valid.astype(jnp.int32) & 1
    h = horizontal.astype(jnp.int32) & 1
    return v | (h << 1) | (update_idx.astype(jnp.int32) << META_UIDX_SHIFT)


def _data_fields(pool):
    """Per-slot SoA fields of this pool (``color`` is optional — None
    when the pool was built without colour to save 1.5x patch memory)."""
    return _FIELDS + (["color"] if pool.color is not None else [])


@partial(
    jax.tree_util.register_dataclass,
    data_fields=_FIELDS + ["color", "origin", "allocated", "chain"],
    meta_fields=["resolution", "nx", "ny", "k"],
)
@dataclasses.dataclass
class MapPool:
    """Patch fields are stored as 2-D block images ``[B, nx, ny*K]``
    (colour ``[B, nx, ny*K*3]``): cell ``(ix, iy)`` slot ``s`` sits at
    ``[b, ix, iy*K + s]``, so a cell's K slots are contiguous.

    * the three flag/bookkeeping fields (valid, horizontal,
      update_idx) pack into ONE int32 ``meta`` word per slot (bit 0 =
      valid, bit 1 = horizontal, bits 2.. = update_idx) — 16 bytes per
      patch slot instead of 24;
    * float fields may be bfloat16 (``from_template(dtype=...)``,
      ``Config.map_pool_dtype``): 10 bytes/slot.  All fusion arithmetic
      stays f32 (values are cast on load, rounded once on store).
    """

    mean: jax.Array        # [B, nx, ny*K] float32 or bfloat16
    stdev: jax.Array
    height: jax.Array
    meta: jax.Array        # [B, nx, ny*K] int32 packed (see pack_meta)
    color: jax.Array | None  # [B, nx, ny*K*3] float32, or None
    origin: jax.Array      # [B, 2] float32 — world xy of block cell (0,0)
    allocated: jax.Array   # [B] bool
    chain: jax.Array       # [N, L] int32 block ids, head = active; -1 empty
    resolution: float
    nx: int
    ny: int
    k: int

    # decoded views of the packed meta word (int32 0/1 masks; writers
    # must re-pack — see pack_meta)
    @property
    def valid(self):
        return self.meta & 1

    @property
    def horizontal(self):
        return (self.meta >> 1) & 1

    @property
    def update_idx(self):
        return self.meta >> META_UIDX_SHIFT

    @property
    def b(self):
        return self.mean.shape[0]

    @property
    def s(self):
        """Flat patch-slot count per block (nx*ny*K)."""
        return self.mean.shape[1] * self.mean.shape[2]

    @property
    def n(self):
        return self.chain.shape[0]

    @property
    def chain_len(self):
        return self.chain.shape[1]

    def active(self):
        return self.chain[:, 0]

    def field_grid(self, name):
        """Host/viz convenience: field as ``[B, nx, ny, K(, 3)]``."""
        a = getattr(self, name)
        trail = (3,) if name == "color" else ()
        return a.reshape(self.b, self.nx, self.ny, self.k, *trail)

    @staticmethod
    def from_template(template: MLSGrid, n_particles, num_blocks,
                      chain_len=4, with_color=True, shards=1,
                      dtype=None):
        """Every particle starts with its own copy of the template grid
        (per-particle mode ``setEnvironment`` + immediate ``cloneMaps``,
        ``PoseEstimator.cpp:47-62``; seeding from a prebuilt environment
        grid = the clone-from-env path).

        ``with_color=False`` drops patch colours (1.5x less patch
        memory/merge traffic; slip/terrain fusion and textures then only
        work in shared-map mode).  ``shards``: particle i's initial
        block lives in block range ``i * shards // N`` so a
        block-sharded pool starts fully co-located
        (``Config.map_pool_shards``).  ``dtype``: storage dtype of the
        float patch fields (None = the template's, ``jnp.bfloat16``
        halves patch-field memory; fusion math stays f32)."""
        b = num_blocks
        dtype = dtype or template.mean.dtype
        assert b >= n_particles, "pool must hold one block per particle"
        if shards <= 1:
            assign = jnp.arange(n_particles, dtype=jnp.int32)
        else:
            assert n_particles % shards == 0 and b % shards == 0, (
                f"shards={shards} must divide particles ({n_particles}) "
                f"and blocks ({b})"
            )
            nl, bl = n_particles // shards, b // shards
            i = jnp.arange(n_particles, dtype=jnp.int32)
            assign = (i // nl) * bl + (i % nl)

        nx, ny, k = template.nx, template.ny, template.k

        def tile(x, fill=0):
            x = x.reshape(nx, -1)
            out = jnp.full((b,) + x.shape, fill, x.dtype)
            return out.at[assign].set(
                jnp.broadcast_to(x, (n_particles,) + x.shape)
            )

        chain = jnp.full((n_particles, chain_len), -1, jnp.int32)
        chain = chain.at[:, 0].set(assign)
        meta = pack_meta(
            template.valid, template.horizontal, template.update_idx
        )
        return MapPool(
            mean=tile(template.mean.astype(dtype)),
            stdev=tile(template.stdev.astype(dtype)),
            height=tile(template.height.astype(dtype)),
            meta=tile(meta),
            color=tile(template.color.astype(dtype)) if with_color
            else None,
            origin=jnp.broadcast_to(template.origin, (b, 2)).copy(),
            allocated=jnp.zeros((b,), bool).at[assign].set(True),
            chain=chain,
            resolution=template.resolution,
            nx=template.nx, ny=template.ny, k=template.k,
        )

    def refcounts(self):
        """References per block over all chain entries."""
        flat = self.chain.reshape(-1)
        return jax.ops.segment_sum(
            (flat >= 0).astype(jnp.int32),
            jnp.where(flat >= 0, flat, 0),
            num_segments=self.b,
        )

    def resample(self, idx):
        """Duplicate chains along a resampling index map — O(N) ints,
        replaces the reference's deep ``cloneMaps`` copies."""
        return dataclasses.replace(self, chain=self.chain[idx])


def _free_mask(pool: MapPool):
    """Blocks with zero chain references (safe to reclaim)."""
    return pool.refcounts() == 0


def _copy_blocks(pool: MapPool, dst, src, mask):
    """pool[dst[i]] <- pool[src[i]] where mask[i] (unique dst).

    The whole gather+scatter (2 x pool-sized HBM traffic in the worst
    case) runs under ``lax.cond``: frames where no block actually needs
    copying — every mapping frame between resamples, once heads are
    unique — cost nothing.  (Measured: at 4096 particles the
    unconditional copy dominated the streaming SLAM step.)
    """

    def do_copy(pool):
        d = jnp.where(mask, dst, pool.b)  # out-of-bounds -> dropped

        def cp(a):
            return a.at[d].set(a[jnp.where(mask, src, 0)], mode="drop")

        return dataclasses.replace(
            pool,
            **{f: cp(getattr(pool, f)) for f in _data_fields(pool)},
            origin=pool.origin.at[d].set(
                pool.origin[jnp.where(mask, src, 0)], mode="drop"
            ),
        )

    return jax.lax.cond(jnp.any(mask), do_copy, lambda p: p, pool)


def _allocate(pool: MapPool, want_mask, shards=1):
    """Assign a distinct free block to each particle with ``want_mask``.

    ``shards`` splits both the particle and block axes into equal
    ranges; particle range ``s`` only takes blocks from block range
    ``s`` (particle/block co-location on a 'dp' mesh — see
    ``Config.map_pool_shards``).  The result depends only on ``shards``,
    not on any device topology.  Returns
    ``(new_block [N] int32 or -1, n_failed)``.
    """
    free = _free_mask(pool)
    n, b = pool.n, pool.b
    if shards <= 1:
        # rank free blocks: free_ids[j] = index of j-th free block
        order = jnp.argsort(~free)  # frees first, stable
        n_free = jnp.sum(free)
        rank = jnp.cumsum(want_mask.astype(jnp.int32)) - 1
        ok = want_mask & (rank < n_free)
        new_block = jnp.where(
            ok, order[jnp.clip(rank, 0, b - 1)], -1
        ).astype(jnp.int32)
        n_failed = jnp.sum(want_mask) - jnp.sum(ok)
        return new_block, n_failed
    assert n % shards == 0 and b % shards == 0, (
        f"map_pool_shards={shards} must divide particles ({n}) "
        f"and blocks ({b})"
    )
    nl, bl = n // shards, b // shards
    free_r = free.reshape(shards, bl)
    want_r = want_mask.reshape(shards, nl)
    order = jnp.argsort(~free_r, axis=1)          # per-range free list
    n_free = jnp.sum(free_r, axis=1)              # [S]
    rank = jnp.cumsum(want_r.astype(jnp.int32), axis=1) - 1
    ok = want_r & (rank < n_free[:, None])
    base = (jnp.arange(shards, dtype=jnp.int32) * bl)[:, None]
    picked = jnp.take_along_axis(
        order, jnp.clip(rank, 0, bl - 1), axis=1
    ).astype(jnp.int32) + base
    new_block = jnp.where(ok, picked, -1).reshape(n)
    n_failed = jnp.sum(want_mask) - jnp.sum(ok)
    return new_block, n_failed


def ensure_unique_active(pool: MapPool, shards=1):
    """Copy-on-write: give every particle an exclusively-owned head block.

    With ``shards > 1`` a head living outside the particle's block
    range (a resample migrated the particle across ranges) is also
    re-homed into the local range — the write-side co-location
    invariant that keeps meshed merges shard-local (every particle's
    active block on its own device).

    Returns ``(pool, n_failed)`` — ``n_failed`` particles stayed on a
    shared block because the pool was exhausted.
    """
    active = pool.active()
    n = pool.n
    idx = jnp.arange(n, dtype=jnp.int32)
    owner = jax.ops.segment_min(idx, active, num_segments=pool.b)
    is_dup = idx != owner[active]
    if shards > 1:
        foreign = (idx // (n // shards)) != (active // (pool.b // shards))
        is_dup = is_dup | foreign

    new_block, n_failed = _allocate(pool, is_dup, shards=shards)
    do = new_block >= 0
    pool = _copy_blocks(pool, new_block, active, do)
    chain = pool.chain.at[:, 0].set(
        jnp.where(do, new_block, pool.chain[:, 0])
    )
    allocated = pool.allocated.at[
        jnp.where(do, new_block, pool.b)
    ].set(True, mode="drop")
    return dataclasses.replace(pool, chain=chain, allocated=allocated), n_failed


def rollover(pool: MapPool, xy, threshold, shards=1):
    """Select a fresh active grid for particles that left their current
    one (``MLSMap::selectActiveGrid``; trigger condition
    ``EmbodiedSlamFilter.cpp:195-207``: |offset| beyond
    ``gridSize/2 * gridThreshold`` from the active grid centre).

    ``xy``: [N, 2] particle positions.  New blocks are empty grids
    centred on the particle; the chain shifts (oldest dropped — its
    block frees itself once unreferenced).  Returns ``(pool, n_failed)``.
    """
    size_x = pool.nx * pool.resolution
    size_y = pool.ny * pool.resolution
    center = pool.origin[pool.active()] + jnp.array(
        [size_x / 2.0, size_y / 2.0], xy.dtype
    )
    off = jnp.abs(xy - center)
    need = (off[:, 0] > threshold) | (off[:, 1] > threshold)

    new_block, n_failed = _allocate(pool, need, shards=shards)
    do = new_block >= 0

    def do_roll(pool):
        # clear the new blocks and position them on the particle
        d = jnp.where(do, new_block, pool.b)
        pool = dataclasses.replace(
            pool,
            meta=pool.meta.at[d].set(0, mode="drop"),
            origin=pool.origin.at[d].set(
                xy - jnp.array([size_x / 2.0, size_y / 2.0], xy.dtype),
                mode="drop",
            ),
            allocated=pool.allocated.at[d].set(True, mode="drop"),
        )
        shifted = jnp.concatenate(
            [new_block[:, None], pool.chain[:, :-1]], axis=1
        )
        chain = jnp.where(do[:, None], shifted, pool.chain)
        return dataclasses.replace(pool, chain=chain)

    # rollovers are rare (a particle crossing its grid border) — skip
    # the pool-wide scatters entirely on frames with none
    pool = jax.lax.cond(jnp.any(do), do_roll, lambda p: p, pool)
    return pool, n_failed


def chain_lookup(pool: MapPool, z_window=3.0):
    """Build the per-particle map-lookup callback over grid chains.

    ``lookup(particle_idx, points [C, 3])`` searches the particle's
    chain head-first and returns the first hit per point
    (``MLSMap::getPatch`` searches its grid list the same way).
    Vmapped by the pose estimator over particles: a gather that reads
    only the N x C x K slots the queries hit.
    """

    def lookup(particle_idx, points):
        chain = pool.chain[particle_idx]          # [L]
        found = jnp.zeros(points.shape[:-1], bool)
        mean = jnp.zeros(points.shape[:-1], jnp.float32)
        stdev = jnp.zeros(points.shape[:-1], jnp.float32)
        color = jnp.zeros(points.shape[:-1] + (3,), jnp.float32)
        with_color = pool.color is not None
        for l in range(pool.chain_len):
            b = chain[l]
            ok = b >= 0
            bi = jnp.where(ok, b, 0)
            f, m, s, c = _block_get_patch(
                pool, bi, points, z_window, with_color=with_color
            )
            use = ok & f & ~found
            mean = jnp.where(use, m, mean)
            stdev = jnp.where(use, s, stdev)
            if with_color:
                color = jnp.where(use[..., None], c, color)
            found = found | use
        return found, mean, stdev, color

    return lookup


def _block_get_patch(pool: MapPool, b, points, z_window, with_color=False):
    origin = pool.origin[b]
    rel = (points[..., :2] - origin) / pool.resolution
    ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
    inb = (ix >= 0) & (ix < pool.nx) & (iy >= 0) & (iy < pool.ny)
    cix = jnp.where(inb, ix, 0)
    ciy = jnp.where(inb, iy, 0)
    # column indices of the cell's K patch slots in the [nx, ny*K] image
    idx = ciy[..., None] * pool.k + jnp.arange(pool.k, dtype=jnp.int32)
    cx = cix[..., None]
    means = pool.mean[b][cx, idx].astype(jnp.float32)    # [..., K]
    stdevs = pool.stdev[b][cx, idx].astype(jnp.float32)
    valids = (pool.meta[b][cx, idx] & 1) != 0
    z = points[..., 2:3]
    dist = jnp.abs(means - z)
    cand = valids & (dist <= z_window)
    dist = jnp.where(cand, dist, jnp.inf)
    best = jnp.argmin(dist, axis=-1)
    found = inb & jnp.any(cand, axis=-1)
    take = partial(jnp.take_along_axis, indices=best[..., None], axis=-1)
    color = None
    if with_color and pool.color is not None:
        idx3 = idx[..., None] * 3 + jnp.arange(3, dtype=jnp.int32)
        colors = pool.color[b][cx[..., None], idx3]  # [..., K, 3]
        color = jnp.take_along_axis(
            colors, best[..., None, None], axis=-2
        )[..., 0, :]
    return found, take(means)[..., 0], take(stdevs)[..., 0], color


def merge_cloud_all(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                    cloud: PatchCloud, update_idx,
                    patch_thickness=0.1, gap_size=1.5):
    """Merge one scan cloud into every particle's active grid at once.

    The fused equivalent of the reference's per-particle
    ``pgrid->merge(scanMap, C_s2p, offsetPatch)`` loop
    (``EmbodiedSlamFilter.cpp:222-227``): transforms the cloud by each
    particle pose, offsets by its (zPos, zSigma), and fuses all N x P
    patches into the pool in one pass.  Requires unique active blocks
    (call ``ensure_unique_active`` first).  Same-cell points are fused
    row-wise, then each surviving entry gathers its cell's K slot rows,
    fuses, and scatters back: N x P cells touched, not whole blocks.
    """
    n, p = pool.n, cloud.p
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    # [N, P, 2] world xy of cloud points under each particle
    px, py = cloud.xy[:, 0], cloud.xy[:, 1]
    wx = c[:, None] * px[None, :] - s[:, None] * py[None, :] + xy[:, 0:1]
    wy = s[:, None] * px[None, :] + c[:, None] * py[None, :] + xy[:, 1:2]
    wz = cloud.z[None, :] + z_offset[:, None]
    var = (cloud.stdev**2)[None, :] + (offset_stdev**2)[:, None]

    active = pool.active()                      # [N]
    origin = pool.origin[active]                # [N, 2]
    ix = jnp.floor((wx - origin[:, 0:1]) / pool.resolution).astype(jnp.int32)
    iy = jnp.floor((wy - origin[:, 1:2]) / pool.resolution).astype(jnp.int32)
    inb = (ix >= 0) & (ix < pool.nx) & (iy >= 0) & (iy < pool.ny)
    mask = inb & cloud.valid[None, :]

    # fuse same-cell points row-wise: each particle merges into its own
    # (unique) active block, so cross-particle collisions are impossible
    # and the dedup runs as N independent row sorts + one-hot segment
    # sums instead of one global N*P sort (see _dedup_fuse_rows)
    ncells = pool.nx * pool.ny
    lin = (active[:, None] * pool.nx + ix) * pool.ny + iy      # [N, P]
    cf = (
        jnp.broadcast_to(cloud.color[None], (n, p, 3))
        if pool.color is not None else None
    )
    lin_s, z2r, v2r, keepr, fcolor = mls_grid._dedup_fuse_rows(
        lin, wz, var, mask, sentinel=pool.b * ncells, color=cf
    )
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    lin2 = flat(lin_s)                                          # [N*P]
    z2, v2, keep = flat(z2r), flat(v2r), flat(keepr)
    fcolor = None if fcolor is None else flat(fcolor)

    # gather each surviving entry's K slot rows from the block images,
    # fuse, and scatter back (block OOB drops the dedup losers)
    blk = lin2 // ncells
    cell = lin2 - blk * ncells
    cx = (cell // pool.ny)[:, None]                             # [M, 1]
    idx = (cell % pool.ny)[:, None] * pool.k + jnp.arange(
        pool.k, dtype=jnp.int32
    )                                                           # [M, K]
    gblk = jnp.where(keep, blk, 0)[:, None]
    g = lambda a: a[gblk, cx, idx]                              # [M, K]
    gmeta = g(pool.meta)
    means, stdevs, heights, valids, horiz, uidx, upd = (
        mls_grid.fuse_slot_rows(
            g(pool.mean).astype(jnp.float32),
            g(pool.stdev).astype(jnp.float32),
            g(pool.height).astype(jnp.float32),
            (gmeta & 1) != 0, (gmeta & 2) != 0,
            gmeta >> META_UIDX_SHIFT,
            z2, v2, keep, update_idx,
            patch_thickness=patch_thickness, gap_size=gap_size,
        )
    )
    sblk = jnp.where(keep, blk, pool.b)[:, None]               # OOB -> drop
    scat = lambda a, val: a.at[sblk, cx, idx].set(
        val.astype(a.dtype), mode="drop"
    )
    new = {
        "mean": scat(pool.mean, means),
        "stdev": scat(pool.stdev, stdevs),
        "height": scat(pool.height, heights),
        "meta": scat(pool.meta, pack_meta(valids, horiz, uidx)),
    }
    if pool.color is not None:
        idx3 = idx[..., None] * 3 + jnp.arange(3, dtype=jnp.int32)
        cell_colors = pool.color[
            gblk[..., None], cx[..., None], idx3
        ]                                                       # [M, K, 3]
        cell_colors = jnp.where(
            upd[..., None], fcolor[:, None, :], cell_colors
        )
        new["color"] = pool.color.at[
            sblk[..., None], cx[..., None], idx3
        ].set(cell_colors, mode="drop")
    return dataclasses.replace(pool, **new)


def apply_negative_cloud_all(pool: MapPool, xy, yaw, z_offset, points,
                             mask, z_margin=0.15):
    """Negative information on every particle's active grid at once.

    The reference enables ``useNegativeInformation`` on the LASER
    MLSProjection only (``EmbodiedSlamFilter.cpp:160``; the camera
    ``distMlsOp`` does not, ``:172-176``): free space observed along
    scan rays invalidates contradicted map patches when the scan merges
    into the per-particle grids.  This is the fused per-particle
    equivalent — ``points [F, 3]`` free-space samples in the
    yaw-compensated body frame (``projection.free_space_points``) are
    transformed by each particle pose and any ACTIVE-block patch whose
    mean lies within ``z_margin`` of a sample is removed (merges only
    ever write the active grid, so only it accumulates stale patches).

    Call after ``ensure_unique_active`` (shared heads would erase
    patches for sibling particles) and before ``merge_cloud_all`` (the
    fresh scan's own patches must survive; free samples stop short of
    the hit surface, but erase-then-write is the safe order).
    """
    n, f = pool.n, points.shape[0]
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    px, py = points[:, 0], points[:, 1]
    wx = c[:, None] * px[None, :] - s[:, None] * py[None, :] + xy[:, 0:1]
    wy = s[:, None] * px[None, :] + c[:, None] * py[None, :] + xy[:, 1:2]
    wz = points[None, :, 2] + z_offset[:, None]          # [N, F]

    active = pool.active()                               # [N]
    origin = pool.origin[active]
    ix = jnp.floor((wx - origin[:, 0:1]) / pool.resolution).astype(jnp.int32)
    iy = jnp.floor((wy - origin[:, 1:2]) / pool.resolution).astype(jnp.int32)
    inb = (ix >= 0) & (ix < pool.nx) & (iy >= 0) & (iy < pool.ny)
    m = inb & mask[None, :]                              # [N, F]

    cx = jnp.where(m, ix, 0)
    idx = jnp.where(m, iy, 0)[..., None] * pool.k + jnp.arange(
        pool.k, dtype=jnp.int32
    )                                                    # [N, F, K]
    gblk = active[:, None, None]
    means = pool.mean[gblk, cx[..., None], idx].astype(jnp.float32)
    valids = (pool.meta[gblk, cx[..., None], idx] & 1) != 0
    hit = (
        valids
        & (jnp.abs(means - wz[..., None]) <= z_margin)
        & m[..., None]
    )
    sblk = jnp.where(m, active[:, None], pool.b)[..., None]  # OOB -> drop
    hits = jnp.zeros_like(pool.meta).at[
        sblk, cx[..., None], idx
    ].max(hit.astype(jnp.int32), mode="drop")
    # clear the valid bit of hit slots, preserve the rest of the word
    return dataclasses.replace(
        pool, meta=jnp.where(hits > 0, pool.meta & ~1, pool.meta)
    )


def match_cloud_all(pool: MapPool, xy, yaw, z_offset, offset_stdev,
                    cloud: PatchCloud, sampling=10, sigma=0.2,
                    z_window=3.0):
    """Per-particle scan-to-map consistency scores [N] (fused equivalent
    of the ``pgrid->match`` loop, ``EmbodiedSlamFilter.cpp:214-221``;
    matches query the particle's active grid).  Only every
    ``sampling``-th VALID cloud patch contributes, normalised by the
    sampled count.
    """
    p = cloud.p
    sample_mask = (jnp.arange(p) % sampling) == 0
    m = cloud.valid & sample_mask

    def one(i, x, th, zo, os_):
        c_, s_ = jnp.cos(th), jnp.sin(th)
        wx = c_ * cloud.xy[:, 0] - s_ * cloud.xy[:, 1] + x[0]
        wy = s_ * cloud.xy[:, 0] + c_ * cloud.xy[:, 1] + x[1]
        wz = cloud.z + zo
        pts = jnp.stack([wx, wy, wz], axis=-1)
        b = pool.chain[i, 0]
        f, mean, stdev, _ = _block_get_patch(pool, b, pts, z_window)
        var = sigma**2 + stdev**2 + cloud.stdev**2 + os_**2
        score = jnp.exp(-0.5 * (wz - mean) ** 2 / var)
        score = jnp.where(m & f, score, 0.0)
        return jnp.sum(score) / jnp.maximum(jnp.sum(m), 1)

    return jax.vmap(one)(
        jnp.arange(pool.n), xy, yaw, z_offset, offset_stdev
    )
