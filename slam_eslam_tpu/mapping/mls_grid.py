"""Multi-Level Surface (MLS) grids as dense structure-of-arrays.

Array-program rebuild of the capability of envire's ``MLSGrid`` /
``MLSMap`` (external to the reference repo but load-bearing: per-cell
patch lists with ``{mean, stdev, height, horizontal, update_idx, color}``,
``toGrid/fromGrid``, ``get(pos, patch)``, ``updateCell``, ``match``,
``merge`` — consumed at ``/root/reference/src/PoseEstimator.hpp:97-105``,
``src/EmbodiedSlamFilter.cpp:25-39,212-227``,
``test/testMap.cpp:236-257,304-317``).

Design (fixed-shape arrays, not a translation):

* A grid is a fixed-shape SoA pytree ``[nx, ny, K]`` with ``K`` patch
  slots per cell and a validity mask — no linked patch lists, no dynamic
  allocation.  Lookups are batched gathers; updates are batched scatters
  over *deduplicated* cell indices (points falling into the same cell are
  Gaussian-fused by a segmented reduction first, so the scatter is
  collision-free and deterministic).

* Scan maps are not merged grid-to-grid.  The sensor pipeline produces a
  ``PatchCloud`` (fixed-size list of fused surface patches); per-particle
  ``match``/``merge`` operate directly on the cloud under the particle's
  transform.  This keeps the widest fan-out (per-particle map updates,
  ``EmbodiedSlamFilter.cpp:179-232``) a pure gather/scatter kernel.

Patch-fusion semantics follow envire's update rules: a new measurement
either (a) Kalman-fuses with a horizontal patch whose mean lies within
``patch_thickness``, (b) extends a patch vertically when within
``gap_size``, or (c) occupies a free slot (evicting the least-certain
patch when the cell is full — the fixed-K overflow policy).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

# Value-carrying contractions must not round f32 operands (TF32 or bf16
# passes are the GPU default): map CONTENT flows through these dots, and
# the drift flips borderline slot-rule compares.
_EXACT = jax.lax.Precision.HIGHEST


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "mean", "stdev", "height", "valid", "horizontal", "update_idx",
        "color", "origin",
    ],
    meta_fields=["resolution"],
)
@dataclasses.dataclass
class MLSGrid:
    """One MLS grid: ``[nx, ny, K]`` patch slots.

    ``origin`` is the world xy of the cell (0, 0) corner (envire's
    ``offset``; the reference builds grids with offset ``-size/2``,
    ``EmbodiedSlamFilter.cpp:29-30``).  ``resolution`` is metres per cell
    (static).  ``height`` is the downward thickness of a patch from its
    ``mean`` (vertical patches); horizontal patches have height 0.
    """

    mean: jax.Array        # [nx, ny, K] float32
    stdev: jax.Array       # [nx, ny, K] float32
    height: jax.Array      # [nx, ny, K] float32
    valid: jax.Array       # [nx, ny, K] bool
    horizontal: jax.Array  # [nx, ny, K] bool
    update_idx: jax.Array  # [nx, ny, K] int32
    color: jax.Array       # [nx, ny, K, 3] float32
    origin: jax.Array      # [2] float32 — world xy of cell (0,0) corner
    resolution: float      # static

    @property
    def nx(self):
        return self.mean.shape[0]

    @property
    def ny(self):
        return self.mean.shape[1]

    @property
    def k(self):
        return self.mean.shape[2]

    @staticmethod
    def create(nx, ny, resolution, origin=(0.0, 0.0), k=4, dtype=jnp.float32):
        shape = (nx, ny, k)
        return MLSGrid(
            mean=jnp.zeros(shape, dtype),
            stdev=jnp.zeros(shape, dtype),
            height=jnp.zeros(shape, dtype),
            valid=jnp.zeros(shape, bool),
            horizontal=jnp.ones(shape, bool),
            update_idx=jnp.zeros(shape, jnp.int32),
            color=jnp.zeros(shape + (3,), dtype),
            origin=jnp.asarray(origin, dtype),
            resolution=float(resolution),
        )

    # ---- coordinate transforms (envire toGrid/fromGrid) ----

    def to_grid(self, xy):
        """World xy [..., 2] -> (ix, iy, in_bounds). Cells are floor-indexed."""
        rel = (xy - self.origin) / self.resolution
        ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
        iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
        inb = (ix >= 0) & (ix < self.nx) & (iy >= 0) & (iy < self.ny)
        return ix, iy, inb

    def from_grid(self, ix, iy):
        """Cell index -> world xy of the cell centre."""
        return (
            jnp.stack([ix, iy], axis=-1).astype(self.mean.dtype) + 0.5
        ) * self.resolution + self.origin

    def clear(self):
        return dataclasses.replace(
            self,
            valid=jnp.zeros_like(self.valid),
            update_idx=jnp.zeros_like(self.update_idx),
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["xy", "z", "stdev", "valid", "color"],
    meta_fields=[],
)
@dataclasses.dataclass
class PatchCloud:
    """Fixed-size list of fused surface patches (local frame).

    The fixed-shape stand-in for the reference's intermediate ``scanMap``
    MLS grid (``EmbodiedSlamFilter.cpp:137-160``): the projection
    pipeline fuses sensor points per cell and emits one patch per
    occupied cell.  ``match``/``merge`` consume it directly.
    ``color`` carries texture/terrain-class RGB (the ImageRGB24 path,
    ``EmbodiedSlamFilter.cpp:259-275``); zeros when untextured.
    """

    xy: jax.Array     # [P, 2] float32
    z: jax.Array      # [P]    float32
    stdev: jax.Array  # [P]    float32
    valid: jax.Array  # [P]    bool
    color: jax.Array  # [P, 3] float32

    @property
    def p(self):
        return self.xy.shape[0]

    @staticmethod
    def create(xy, z, stdev, valid, color=None):
        if color is None:
            color = jnp.zeros(xy.shape[:-1] + (3,), xy.dtype)
        return PatchCloud(xy=xy, z=z, stdev=stdev, valid=valid,
                          color=color)


# --------------------------------------------------------------------------
# Patch lookup (the contact-model map callback seam,
# ContactModel.hpp:115-118 / GridAccess::get, PoseEstimator.hpp:97-105)
# --------------------------------------------------------------------------

def get_patch(grid: MLSGrid, points, z_window=3.0):
    """Batched patch lookup.

    ``points``: [..., 3] world/grid-local positions.  For each point:
    find the valid patch in its cell whose mean is nearest to the query z
    within ``z_window`` (the reference passes 3.0 through
    ``MLSMap::getPatch``, ``src/PoseEstimator.hpp:101``).

    Returns ``(found [...], mean [...], stdev [...], color [..., 3])``.
    """
    ix, iy, inb = grid.to_grid(points[..., :2])
    cix = jnp.where(inb, ix, 0)
    ciy = jnp.where(inb, iy, 0)
    means = grid.mean[cix, ciy]            # [..., K]
    stdevs = grid.stdev[cix, ciy]
    valids = grid.valid[cix, ciy]
    colors = grid.color[cix, ciy]          # [..., K, 3]

    z = points[..., 2:3]
    dist = jnp.abs(means - z)
    cand = valids & (dist <= z_window)
    dist = jnp.where(cand, dist, jnp.inf)
    best = jnp.argmin(dist, axis=-1)       # [...]
    found = inb & jnp.any(cand, axis=-1)

    take = partial(jnp.take_along_axis, indices=best[..., None], axis=-1)
    mean = take(means)[..., 0]
    stdev = take(stdevs)[..., 0]
    color = jnp.take_along_axis(colors, best[..., None, None], axis=-2)[..., 0, :]
    return found, mean, stdev, color


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "origin"],
    meta_fields=["resolution"],
)
@dataclasses.dataclass
class PackedLookup:
    """Gather-optimised read-only view of a grid: ``[nx, ny, 2K]`` with
    means in the first K slots and stdevs (negative = invalid slot) in
    the last K.  One query then costs a single contiguous 2K-row gather
    instead of 3 separate gathers over mean/stdev/valid."""

    data: jax.Array    # [nx, ny, 2K] float32
    origin: jax.Array  # [2]
    resolution: float

    @property
    def k(self):
        return self.data.shape[2] // 2

    @staticmethod
    def from_grid(grid: MLSGrid):
        mean = jnp.where(grid.valid, grid.mean, 0.0)
        stdev = jnp.where(grid.valid, grid.stdev, -1.0)
        data = jnp.concatenate([mean, stdev], axis=-1)
        return PackedLookup(
            data=data, origin=grid.origin, resolution=grid.resolution,
        )


def get_patch_packed_cells(packed: PackedLookup, ix, iy, z,
                           z_window=3.0):
    """``get_patch_packed`` on precomputed cell queries: ``ix, iy``
    int32 (unclamped, any shape), ``z`` of the same shape.  Returns
    ``(found, mean, stdev)`` of that shape."""
    k = packed.k
    nx, ny = packed.data.shape[0], packed.data.shape[1]
    inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    cell = packed.data[jnp.where(inb, ix, 0), jnp.where(inb, iy, 0)]
    means = cell[..., :k]
    stdevs = cell[..., k:]
    valids = stdevs >= 0.0

    dist = jnp.abs(means - z[..., None])
    cand = valids & (dist <= z_window)
    dist = jnp.where(cand, dist, jnp.inf)
    best = jnp.argmin(dist, axis=-1)
    found = inb & jnp.any(cand, axis=-1)
    take = partial(jnp.take_along_axis, indices=best[..., None], axis=-1)
    mean = take(means)[..., 0]
    stdev = jnp.abs(take(stdevs)[..., 0])
    return found, mean, stdev


def get_patch_packed(packed: PackedLookup, points, z_window=3.0):
    """Batched lookup against a ``PackedLookup`` (same semantics as
    ``get_patch``; no colour — the slip path uses the unpacked grid)."""
    rel = (points[..., :2] - packed.origin) / packed.resolution
    ix = jnp.floor(rel[..., 0]).astype(jnp.int32)
    iy = jnp.floor(rel[..., 1]).astype(jnp.int32)
    found, mean, stdev = get_patch_packed_cells(
        packed, ix, iy, points[..., 2], z_window
    )
    color = jnp.zeros(points.shape[:-1] + (3,), mean.dtype)
    return found, mean, stdev, color


# --------------------------------------------------------------------------
# Patch insertion / fusion
# --------------------------------------------------------------------------

def _dedup_fuse(ix, iy, z, var, mask, nx, ny, color=None):
    """Gaussian-fuse points that land in the same cell.

    Sorts by linear cell id and segment-reduces inverse-variance-weighted
    sums, leaving exactly one surviving (masked-in) entry per occupied
    cell.  Fixed shape [P]; fully on-device.  ``color`` [P, 3], when
    given, fuses by the same weights.
    """
    p = ix.shape[0]
    lin = jnp.where(mask, ix * ny + iy, nx * ny)  # invalid -> sentinel
    order = jnp.argsort(lin)
    lin_s = lin[order]
    z_s = z[order]
    var_s = var[order]
    mask_s = mask[order]

    # segment ids over runs of equal cell
    first = jnp.concatenate(
        [jnp.ones((1,), bool), lin_s[1:] != lin_s[:-1]]
    )
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1  # [P] in [0, P)

    w = jnp.where(mask_s, 1.0 / jnp.maximum(var_s, 1e-12), 0.0)
    wsum = jax.ops.segment_sum(w, seg, num_segments=p)
    zsum = jax.ops.segment_sum(w * z_s, seg, num_segments=p)
    fused_z = zsum / jnp.maximum(wsum, 1e-30)
    fused_var = 1.0 / jnp.maximum(wsum, 1e-30)

    fused_color = None
    if color is not None:
        csum = jax.ops.segment_sum(
            w[:, None] * color[order], seg, num_segments=p
        )
        fused_color = (csum / jnp.maximum(wsum, 1e-30)[:, None])[seg]

    keep = first & mask_s
    return (
        ix[order], iy[order],
        fused_z[seg], fused_var[seg],
        keep, order, fused_color,
    )


def _dedup_fuse_rows(lin, z, var, mask, sentinel, color=None):
    """Row-independent ``_dedup_fuse``: fuse same-cell entries within
    each row (rows = particles in the per-particle merge — cells of
    different particles can never collide because the linear id embeds
    the particle's block).

    Instead of one global ``argsort`` over N*P elements + 1-D segment
    ops, sort WITHIN rows (a batched short-axis sort) and run the
    per-run inverse-variance sums as one-hot ``[N, P, P]`` batched
    matmuls (P is the small cloud size, so the one-hots are tiny).

    Returns ``(lin_sorted [N, P], fused_z, fused_var, keep, fused_color)``
    — entries reordered within rows; ``keep`` marks one survivor per
    occupied cell.
    """
    n, p = lin.shape
    lin_m = jnp.where(mask, lin, sentinel)
    order = jnp.argsort(lin_m, axis=1)
    take = lambda a: jnp.take_along_axis(a, order, axis=1)
    lin_s, z_s, var_s, mask_s = take(lin_m), take(z), take(var), take(mask)

    first = jnp.concatenate(
        [jnp.ones((n, 1), bool), lin_s[:, 1:] != lin_s[:, :-1]], axis=1
    )
    seg = jnp.cumsum(first.astype(jnp.int32), axis=1) - 1      # [N, P)
    onehot = (
        seg[..., None] == jnp.arange(p, dtype=seg.dtype)
    ).astype(z.dtype)                                          # [N, P, P]

    w = jnp.where(mask_s, 1.0 / jnp.maximum(var_s, 1e-12), 0.0)
    wsum = jnp.einsum("nps,np->ns", onehot, w, precision=_EXACT)
    zsum = jnp.einsum("nps,np->ns", onehot, w * z_s, precision=_EXACT)
    back = lambda a: jnp.take_along_axis(a, seg, axis=1)
    fused_z = back(zsum / jnp.maximum(wsum, 1e-30))
    fused_var = back(1.0 / jnp.maximum(wsum, 1e-30))

    fused_color = None
    if color is not None:
        color_s = jnp.take_along_axis(color, order[..., None], axis=1)
        csum = jnp.einsum("nps,npc->nsc", onehot, w[..., None] * color_s,
                          precision=_EXACT)
        fused_color = jnp.take_along_axis(
            csum / jnp.maximum(wsum, 1e-30)[..., None],
            seg[..., None], axis=1,
        )

    keep = first & mask_s
    return lin_s, fused_z, fused_var, keep, fused_color


def fuse_slot_rows(means, stdevs, heights, valids, horiz, uidx,
                   z, var, keep, update_idx,
                   patch_thickness=0.1, gap_size=1.5):
    """Pure MLS patch-slot fusion math: one measurement ``(z, var)``
    against its cell's ``[P, K]`` slot rows.

    Implements the envire ``MLSGrid::updateCell`` patch rules the
    reference relies on (``EmbodiedSlamFilter.cpp:35-36`` thickness/gap
    semantics): (a) Kalman-fuse with the nearest horizontal patch within
    ``patch_thickness``; (b) extend the nearest patch vertically within
    ``gap_size``; (c) insert into a free slot, else evict the
    highest-uncertainty patch.  Returns the updated slot rows plus the
    written-slot mask ``upd`` (shared by the rank-3 grid scatter and
    the flat map-pool scatter).
    """
    k = means.shape[-1]
    zc = z[:, None]
    dist = jnp.abs(means - zc)

    # (a) Kalman fusion with nearest horizontal patch within thickness
    fuse_cand = valids & horiz & (dist <= patch_thickness)
    fuse_dist = jnp.where(fuse_cand, dist, jnp.inf)
    fuse_slot = jnp.argmin(fuse_dist, axis=-1)
    can_fuse = jnp.any(fuse_cand, axis=-1)

    # (b) vertical extension within gap
    gap_cand = valids & (dist <= gap_size)
    gap_dist = jnp.where(gap_cand, dist, jnp.inf)
    gap_slot = jnp.argmin(gap_dist, axis=-1)
    can_gap = jnp.any(gap_cand, axis=-1) & ~can_fuse

    # (c) insertion: free slot, else evict max-stdev patch
    free_slot = jnp.argmax(~valids, axis=-1)
    has_free = jnp.any(~valids, axis=-1)
    evict_slot = jnp.argmax(jnp.where(valids, stdevs, -jnp.inf), axis=-1)
    ins_slot = jnp.where(has_free, free_slot, evict_slot)
    do_insert = ~can_fuse & ~can_gap

    slot = jnp.where(can_fuse, fuse_slot, jnp.where(can_gap, gap_slot, ins_slot))
    onehot = jax.nn.one_hot(slot, k, dtype=bool)               # [P, K]

    sel = lambda a: jnp.take_along_axis(a, slot[:, None], axis=-1)[:, 0]
    m0, s0, h0 = sel(means), sel(stdevs), sel(heights)

    # fused values per branch
    w1 = 1.0 / jnp.maximum(s0 * s0, 1e-12)
    w2 = 1.0 / jnp.maximum(var, 1e-12)
    fuse_mean = (m0 * w1 + z * w2) / (w1 + w2)
    fuse_stdev = jnp.sqrt(1.0 / (w1 + w2))

    top = jnp.maximum(m0, z)
    bottom = jnp.minimum(m0 - h0, z)
    gap_mean = top
    gap_height = top - bottom
    gap_stdev = jnp.minimum(s0, jnp.sqrt(var))

    new_mean = jnp.where(can_fuse, fuse_mean, jnp.where(can_gap, gap_mean, z))
    new_stdev = jnp.where(
        can_fuse, fuse_stdev, jnp.where(can_gap, gap_stdev, jnp.sqrt(var))
    )
    new_height = jnp.where(can_fuse, h0, jnp.where(can_gap, gap_height, 0.0))
    new_horiz = jnp.where(can_fuse, True, jnp.where(can_gap, False, True))

    upd = onehot & keep[:, None]
    means = jnp.where(upd, new_mean[:, None], means)
    stdevs = jnp.where(upd, new_stdev[:, None], stdevs)
    heights = jnp.where(upd, new_height[:, None], heights)
    valids = valids | upd
    horiz = jnp.where(upd, new_horiz[:, None], horiz)
    uidx = jnp.where(upd, jnp.int32(update_idx), uidx)
    return means, stdevs, heights, valids, horiz, uidx, upd


def scatter_fuse_cells(
    arrays, ix, iy, z, var, keep, update_idx,
    patch_thickness=0.1, gap_size=1.5, x_oob=None, color=None,
):
    """Fuse one measurement per (unique) cell into K patch slots.

    ``arrays`` is the dict of grid SoA fields shaped ``[X, ny, K]``.
    ``(ix, iy)`` must be unique among ``keep`` entries (use
    ``_dedup_fuse``); dropped entries scatter out-of-bounds (``x_oob``)
    and are discarded.
    """
    if x_oob is None:
        x_oob = arrays["mean"].shape[0]

    gix = jnp.where(keep, ix, 0)
    giy = jnp.where(keep, iy, 0)
    means, stdevs, heights, valids, horiz, uidx, upd = fuse_slot_rows(
        arrays["mean"][gix, giy], arrays["stdev"][gix, giy],
        arrays["height"][gix, giy], arrays["valid"][gix, giy],
        arrays["horizontal"][gix, giy], arrays["update_idx"][gix, giy],
        z, var, keep, update_idx,
        patch_thickness=patch_thickness, gap_size=gap_size,
    )

    # collision-free scatter: surviving entries have unique cells; dropped
    # entries write out-of-bounds and are discarded.
    six = jnp.where(keep, ix, x_oob)
    scat = lambda dst, val: dst.at[six, giy].set(val, mode="drop")
    out = {
        "mean": scat(arrays["mean"], means),
        "stdev": scat(arrays["stdev"], stdevs),
        "height": scat(arrays["height"], heights),
        "valid": scat(arrays["valid"], valids),
        "horizontal": scat(arrays["horizontal"], horiz),
        "update_idx": scat(arrays["update_idx"], uidx),
    }
    if color is not None and "color" in arrays:
        # written slots take the (fused) measurement colour
        # (terrain-class RGB riding on patches, ContactModel.cpp:238-240)
        cell_colors = arrays["color"][gix, giy]           # [P, K, 3]
        cell_colors = jnp.where(
            upd[..., None], color[:, None, :], cell_colors
        )
        out["color"] = scat(arrays["color"], cell_colors)
    return out


def merge_points(grid: MLSGrid, xy, z, stdev, mask, update_idx,
                 patch_thickness=0.1, gap_size=1.5, color=None):
    """Scatter-fuse a batch of surface measurements into the grid.

    The batched equivalent of looping ``MLSGrid::updateCell`` over projected
    points (``test/testMap.cpp:304-317``, envire ``MLSProjection``):

    1. points are bucketed by cell and Gaussian-fused per cell,
    2. each occupied cell resolves against its K patch slots:
       Kalman-fuse into a horizontal patch within ``patch_thickness``,
       else vertically extend a patch within ``gap_size``,
       else claim a free slot (evicting the least-certain patch if full).

    ``update_idx`` is stamped on touched patches (scan-merge bookkeeping,
    ``EmbodiedSlamFilter.cpp:212-213``).  Returns the updated grid.
    """
    ix, iy, inb = grid.to_grid(xy)
    mask = mask & inb
    var = stdev * stdev
    ix, iy, z, var, keep, order, fcolor = _dedup_fuse(
        ix, iy, z, var, mask, grid.nx, grid.ny, color=color
    )
    arrays = {
        "mean": grid.mean, "stdev": grid.stdev, "height": grid.height,
        "valid": grid.valid, "horizontal": grid.horizontal,
        "update_idx": grid.update_idx,
    }
    if color is not None:
        arrays["color"] = grid.color
    out = scatter_fuse_cells(
        arrays, ix, iy, z, var, keep, update_idx,
        patch_thickness=patch_thickness, gap_size=gap_size, color=fcolor,
    )
    return dataclasses.replace(grid, **out)


def apply_negative_points(grid: MLSGrid, points, mask, z_margin=0.15):
    """Negative information: invalidate patches contradicted by
    observed free space.

    The capability behind ``useNegativeInformation`` in envire's
    ``MLSProjection`` (enabled by ``gridUseNegativeInformation``,
    ``EmbodiedSlamFilter.cpp:160``): a sensor ray passing through a
    cell at height z is evidence there is no surface there; existing
    patches whose mean lies within ``z_margin`` of a free-space sample
    are removed.  ``points`` [P, 3] free-space samples (see
    ``projection.free_space_points``); collisions resolve via
    scatter-max of hit flags (deterministic).
    """
    ix, iy, inb = grid.to_grid(points[..., :2])
    m = mask & inb
    cix = jnp.where(m, ix, grid.nx)  # out-of-bounds -> dropped
    ciy = jnp.where(m, iy, 0)
    gix = jnp.where(m, ix, 0)
    means = grid.mean[gix, ciy]                     # [P, K]
    hit = (
        grid.valid[gix, ciy]
        & (jnp.abs(means - points[..., 2:3]) <= z_margin)
        & m[..., None]
    )
    hits = jnp.zeros_like(grid.valid).at[cix, ciy].max(hit, mode="drop")
    return dataclasses.replace(grid, valid=grid.valid & ~hits)


# --------------------------------------------------------------------------
# Scan-cloud match / merge (per-particle map operations,
# EmbodiedSlamFilter::processMap, EmbodiedSlamFilter.cpp:179-232)
# --------------------------------------------------------------------------

def match_cloud(grid: MLSGrid, cloud: PatchCloud, rot2d, trans, z_offset,
                offset_stdev, sampling=10, sigma=0.2, z_window=3.0):
    """Scan-to-map consistency score in [0, 1].

    Re-derivation of envire ``MLSGrid::match(other, T, offset, sampling,
    sigma)`` (consumed at ``EmbodiedSlamFilter.cpp:214-221``): every
    ``sampling``-th cloud patch is transformed into the grid frame
    (rotated by ``rot2d``, translated by ``trans``, lifted by
    ``z_offset`` = the particle's zPos), looked up, and scored with a
    Gaussian on the height residual; the score is the mean over sampled
    patches (missing patches score 0).  ``offset_stdev`` (the particle's
    zSigma) widens the residual variance.
    """
    p = cloud.p
    sample_mask = (jnp.arange(p) % sampling) == 0
    m = cloud.valid & sample_mask

    xy_g = jnp.dot(cloud.xy, rot2d.T, precision=_EXACT) + trans
    z_g = cloud.z + z_offset
    pts = jnp.concatenate([xy_g, z_g[:, None]], axis=-1)
    found, mean, stdev, _ = get_patch(grid, pts, z_window)

    var = sigma * sigma + stdev * stdev + cloud.stdev**2 + offset_stdev**2
    resid = z_g - mean
    score = jnp.exp(-0.5 * resid * resid / var)
    score = jnp.where(m & found, score, 0.0)
    n = jnp.maximum(jnp.sum(m), 1)
    return jnp.sum(score) / n


def merge_cloud(grid: MLSGrid, cloud: PatchCloud, rot2d, trans, z_offset,
                offset_stdev, update_idx, patch_thickness=0.1, gap_size=1.5):
    """Merge a scan cloud into the grid under a particle transform.

    Equivalent of ``MLSGrid::merge(scanMap, C_s2p, offsetPatch)``
    (``EmbodiedSlamFilter.cpp:222-227``): patches are shifted by the
    particle's z estimate and their uncertainty widened by its zSigma
    before fusion.
    """
    xy_g = jnp.dot(cloud.xy, rot2d.T, precision=_EXACT) + trans
    z_g = cloud.z + z_offset
    stdev = jnp.sqrt(cloud.stdev**2 + offset_stdev**2)
    return merge_points(
        grid, xy_g, z_g, stdev, cloud.valid, update_idx,
        patch_thickness=patch_thickness, gap_size=gap_size,
        color=cloud.color,
    )
