"""Terrain-signature hashing for global (re)localisation.

Array-program rebuild of ``eslam::SurfaceHash`` + ``SurfaceParam`` +
``Buckets`` (``/root/reference/src/SurfaceHash.hpp``): precompute, for
every map cell x every of ``angular_steps`` headings, the least-squares
plane slope of a 4-point robot footprint, bucket candidate poses by
``(slope_x, slope_y)``, and sample relocalisation candidates conditioned
on the robot's currently-sensed footprint signature.

The reference's triple loop with per-cell MLS iterator lookups
(``SurfaceHash.hpp:178-229``) becomes one vmapped sweep: a [A*W*H]
batch of 4-point gathers + closed-form 3x3 solves.  Variable-length
buckets become a sort-by-bucket index: ``sorted_idx`` + per-bucket
``start/count`` — uniform in-bucket sampling is then two gathers.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import jax
import jax.numpy as jnp

from slam_eslam_tpu.config import SurfaceHashConfig
from slam_eslam_tpu.core.state import ParticleSet
from slam_eslam_tpu.models import contact_model as cm

# footprint base length in metres (SurfaceHash.hpp:162)
FOOT_BASE = 0.5
# body height added to candidate z (SurfaceHash.hpp:218)
BODY_HEIGHT = 0.18


def fit_plane(points, mask):
    """Masked least-squares plane fit, ``z = a x + b y + c``.

    Closed-form 3x3 normal-equation solve
    (``SurfaceParam::fromPoints``, ``SurfaceHash.hpp:60-110``).
    Returns ``(slope_x, slope_y)`` = (a, b).
    """
    w = mask.astype(points.dtype)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    sx = jnp.sum(w * x, -1)
    sy = jnp.sum(w * y, -1)
    sz = jnp.sum(w * z, -1)
    sxx = jnp.sum(w * x * x, -1)
    syy = jnp.sum(w * y * y, -1)
    sxy = jnp.sum(w * x * y, -1)
    sxz = jnp.sum(w * x * z, -1)
    syz = jnp.sum(w * y * z, -1)
    n = jnp.sum(w, -1)
    a_mat = jnp.stack(
        [
            jnp.stack([sxx, sxy, sx], -1),
            jnp.stack([sxy, syy, sy], -1),
            jnp.stack([sx, sy, n], -1),
        ],
        -2,
    )
    b_vec = jnp.stack([sxz, syz, sz], -1)
    # regularise: degenerate fits (n < 3) produce garbage that callers
    # must mask out themselves
    eye = jnp.eye(3, dtype=points.dtype) * 1e-6
    sol = jnp.linalg.solve(a_mat + eye, b_vec[..., None])[..., 0]
    return sol[..., 0], sol[..., 1]


def _bucket_index(slope, bins):
    """Bucket in [-1, 1] (``Buckets::bucketIndex``, ``SurfaceHash.hpp:25-29``)."""
    idx = ((slope + 1.0) / 2.0 * bins).astype(jnp.int32)
    return jnp.clip(idx, 0, bins - 1)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "cand_xy", "cand_yaw", "cand_z", "cand_valid", "bucket_id",
        "sorted_idx", "bucket_start", "bucket_count", "n_valid",
    ],
    meta_fields=["config"],
)
@dataclasses.dataclass
class SurfaceHash:
    cand_xy: jax.Array       # [M, 2]
    cand_yaw: jax.Array      # [M]
    cand_z: jax.Array        # [M]
    cand_valid: jax.Array    # [M] bool
    bucket_id: jax.Array     # [M] int32 (bx * bins + by)
    sorted_idx: jax.Array    # [M] candidate ids sorted by bucket
    bucket_start: jax.Array  # [bins^2] int32
    bucket_count: jax.Array  # [bins^2] int32
    n_valid: jax.Array       # [] int32
    config: SurfaceHashConfig

    @staticmethod
    def create(config: SurfaceHashConfig, grid):
        """Precompute the hash over an MLS grid (``SurfaceHash::create``,
        ``SurfaceHash.hpp:155-231``) as one jitted sweep."""
        bins = config.slope_bins
        steps = config.angular_steps
        nx, ny = grid.nx, grid.ny

        base = FOOT_BASE
        opoints = jnp.array(
            [
                [base / 2.0, 0.0],
                [-base / 2.0, 0.0],
                [base / 2.0, -base],
                [-base / 2.0, -base],
            ],
            jnp.float32,
        )
        angles = (
            jnp.arange(1, steps + 1, dtype=jnp.float32) * 2.0 * math.pi / steps
        )  # the reference rotates before the first use (SurfaceHash.hpp:182-184)

        @jax.jit
        def sweep(grid):
            xs, ys = jnp.meshgrid(
                jnp.arange(nx), jnp.arange(ny), indexing="ij"
            )
            centers = grid.from_grid(xs.ravel(), ys.ravel())  # [C, 2]

            def per_angle(angle):
                c, s = jnp.cos(angle), jnp.sin(angle)
                rot = jnp.array([[c, -s], [s, c]], jnp.float32)
                offs = jnp.dot(opoints, rot.T,              # [4, 2]
                               precision=jax.lax.Precision.HIGHEST)
                pts = centers[:, None, :] + offs[None]      # [C, 4, 2]
                ix = jnp.floor(
                    (pts[..., 0] - grid.origin[0]) / grid.resolution
                ).astype(jnp.int32)
                iy = jnp.floor(
                    (pts[..., 1] - grid.origin[1]) / grid.resolution
                ).astype(jnp.int32)
                inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                cix = jnp.where(inb, ix, 0)
                ciy = jnp.where(inb, iy, 0)
                # first stored patch per cell (MLSGrid::beginCell use,
                # SurfaceHash.hpp:201-206)
                cell_valid = grid.valid[cix, ciy]           # [C, 4, K]
                first = jnp.argmax(cell_valid, axis=-1)
                zval = jnp.take_along_axis(
                    grid.mean[cix, ciy], first[..., None], axis=-1
                )[..., 0]
                found = inb & jnp.any(cell_valid, axis=-1)  # [C, 4]

                n_found = jnp.sum(found, -1)
                mean_z = jnp.sum(jnp.where(found, zval, 0.0), -1) / jnp.maximum(
                    n_found, 1
                )
                fit_pts = jnp.concatenate(
                    [
                        jnp.broadcast_to(opoints, pts.shape[:-1] + (2,)),
                        zval[..., None],
                    ],
                    -1,
                )
                slope_x, slope_y = fit_plane(fit_pts, found)
                valid = n_found >= 3
                return (
                    centers,
                    jnp.full((centers.shape[0],), angle),
                    mean_z + BODY_HEIGHT,
                    valid,
                    _bucket_index(slope_x, bins) * bins
                    + _bucket_index(slope_y, bins),
                )

            xy, yaw, z, valid, bid = jax.vmap(per_angle)(angles)
            flat = lambda a: a.reshape((-1,) + a.shape[2:])
            xy, yaw, z, valid, bid = map(flat, (xy, yaw, z, valid, bid))

            bid = jnp.where(valid, bid, bins * bins)  # invalid -> sentinel
            order = jnp.argsort(bid).astype(jnp.int32)
            bid_sorted = bid[order]
            starts = jnp.searchsorted(
                bid_sorted, jnp.arange(bins * bins)
            ).astype(jnp.int32)
            ends = jnp.searchsorted(
                bid_sorted, jnp.arange(1, bins * bins + 1)
            ).astype(jnp.int32)
            return xy, yaw, z, valid, bid, order, starts, ends - starts

        xy, yaw, z, valid, bid, order, starts, counts = sweep(grid)
        return SurfaceHash(
            cand_xy=xy, cand_yaw=yaw, cand_z=z, cand_valid=valid,
            bucket_id=bid, sorted_idx=order, bucket_start=starts,
            bucket_count=counts, n_valid=jnp.sum(valid).astype(jnp.int32),
            config=config,
        )

    # ------------------------------------------------------------------

    def signature(self, contact_state, orientation):
        """Footprint slope signature of the current contact state
        (lowest point per wheel -> plane fit; ``PoseEstimator.cpp:136-143``)."""
        cstate = cm.set_contact_points(contact_state, orientation)
        pts, mask, _ = cm.lowest_point_per_group(cstate)
        return fit_plane(pts, mask)

    def relevance(self, slope_x, slope_y):
        """1 - |bucket| / |all| (``SurfaceHash::getRelevance``,
        ``SurfaceHash.hpp:134-139``)."""
        bins = self.config.slope_bins
        b = _bucket_index(slope_x, bins) * bins + _bucket_index(slope_y, bins)
        return 1.0 - self.bucket_count[b] / jnp.maximum(self.n_valid, 1)

    def sample_particles(self, key, n):
        """Uniform global sampling (``SurfaceHash::sample()``,
        ``SurfaceHash.hpp:128-132``; consumed by ``PoseEstimator::init``).

        Sampling is over valid candidates via the sorted index (valid
        entries occupy the first ``n_valid`` slots).
        """
        u = jax.random.randint(
            key, (n,), 0, jnp.maximum(self.n_valid, 1)
        )
        ids = self.sorted_idx[u]
        p = ParticleSet.zeros(n)
        return dataclasses.replace(
            p.with_xy(self.cand_xy[ids]),
            yaw=self.cand_yaw[ids],
            z=self.cand_z[ids],
            z_sigma=jnp.zeros((n,), jnp.float32),
        )

    def sample_bucket(self, key, slope_x, slope_y, n):
        """Signature-conditioned sampling (``SurfaceHash::sample(param)``,
        ``SurfaceHash.hpp:141-153``).  Returns ``(ids [n], ok)`` — ``ok``
        False when the bucket is empty (reference returns NULL)."""
        bins = self.config.slope_bins
        b = _bucket_index(slope_x, bins) * bins + _bucket_index(slope_y, bins)
        count = self.bucket_count[b]
        u = jax.random.randint(key, (n,), 0, jnp.maximum(count, 1))
        ids = self.sorted_idx[self.bucket_start[b] + u]
        return ids, count > 0

    # ------------------------------------------------------------------

    def reinject(self, state, contact_state, orientation, cfg):
        """Replace the lowest-weight particles with hash candidates
        (``PoseEstimator::sampleFromHash``, ``PoseEstimator.cpp:130-182``):
        replace ``percentage * relevance^3`` of the particles when the
        terrain signature is distinctive (relevance^3 >= 0.8), at weight
        ``avg * avgFactor * relevance^3``."""
        return _reinject_jit(self, state, contact_state, orientation, cfg)


@partial(jax.jit, static_argnames=("cfg",))
def _reinject_jit(hash_, state, contact_state, orientation, cfg):
    import slam_eslam_tpu.filter.pose_estimator as pe
    from slam_eslam_tpu.core import filter as pf

    p = state.particles
    n = p.n
    key, k_s = jax.random.split(state.key)

    sx, sy = hash_.signature(contact_state, orientation)
    rel = hash_.relevance(sx, sy) ** 3
    # health gate (see SurfaceHashConfig.lost_threshold): scale the
    # injected count by how far the decayed max weight has collapsed —
    # the reference's recovery-spread trigger (PoseEstimator.cpp:224-236)
    # repurposed as the reinjection gate; 1.0 when lost_threshold == 0
    # (reference-faithful unconditional injection)
    lost = 1.0
    if hash_.config.lost_threshold > 0.0:
        lost = pe.weighting_function(
            state.max_weight, 0.0, hash_.config.lost_threshold, 0.0
        )
    replace_count = jnp.where(
        rel < 0.8,
        0,
        (n * hash_.config.percentage * rel * lost).astype(jnp.int32),
    )

    ids, ok = hash_.sample_bucket(k_s, sx, sy, n)
    replace_count = jnp.where(ok, replace_count, 0)

    # lowest-weight particles first (the reference sorts weight asc)
    order = jnp.argsort(p.weight)
    rank = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32)
    )
    replace = rank < replace_count

    new_weight = pf.weights_avg(p.weight) * hash_.config.avg_factor * rel
    particles = dataclasses.replace(
        p,
        x=jnp.where(replace, hash_.cand_xy[ids, 0], p.x),
        y=jnp.where(replace, hash_.cand_xy[ids, 1], p.y),
        yaw=jnp.where(replace, hash_.cand_yaw[ids], p.yaw),
        z=jnp.where(replace, hash_.cand_z[ids], p.z),
        z_sigma=jnp.where(replace, 0.5, p.z_sigma),
        floating=jnp.where(replace, True, p.floating),
        weight=jnp.where(replace, new_weight, p.weight),
    )
    return dataclasses.replace(state, particles=particles, key=key)
