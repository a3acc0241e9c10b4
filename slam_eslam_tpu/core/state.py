"""State pytrees: particle sets and body contact states.

Structure-of-arrays rebuilds of the reference state types:

* ``ParticleSet``    <- ``eslam::PoseParticle`` / ``PoseParticleGA``
  (``/root/reference/src/PoseParticle.hpp:52-86``,
  ``src/PoseEstimator.hpp:108-117``).  A particle is (x, y) position, yaw,
  z height + z sigma, weight, plus bookkeeping (measurement probability,
  floating flag, contact count for the group-count discount) and an index
  into the map pool replacing the per-particle ``MLSMap`` shared pointer.

* ``BodyContactState`` <- ``odometry::BodyContactState`` with
  ``BodyContactPoint{position, contact, slip, groupId}`` (consumed at
  ``src/ContactModel.cpp:21-41``).  Fixed point count ``C`` with a
  validity mask instead of a variable-length vector.

All fields are float32/int32/bool arrays — everything lives on device and
shards along the leading (particle) axis.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from slam_eslam_tpu.utils import geometry


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleSet:
    """SoA particle state; all arrays share leading dim N (particle count).

    World x/y are stored as SEPARATE [N] arrays, so every per-particle
    field is a dense vector and the ``lax.scan`` carry needs no
    transposing copies.  The ``xy`` property materialises
    the classic ``[N, 2]`` view for read sites (XLA fuses the stack
    into consumers; only loop carries must materialise a layout).
    """

    x: jax.Array           # [N]    float32 — world x
    y: jax.Array           # [N]    float32 — world y
    yaw: jax.Array         # [N]    float32 — heading
    z: jax.Array           # [N]    float32 — zPos
    z_sigma: jax.Array     # [N]    float32 — zSigma
    weight: jax.Array      # [N]    float32
    mprob: jax.Array       # [N]    float32 — last measurement probability
    floating: jax.Array    # [N]    bool    — no valid contact measurement
    n_contacts: jax.Array  # [N]    int32   — |cpoints| (discount exponent)
    map_id: jax.Array      # [N]    int32   — map-pool index (per-particle maps)

    @property
    def n(self):
        return self.x.shape[0]

    @property
    def xy(self):
        """[N, 2] read view (do NOT put this in loop carries)."""
        return jnp.stack([self.x, self.y], axis=-1)

    def with_xy(self, xy):
        """Functional update from a [N, 2] (or [..., 2]) array."""
        return dataclasses.replace(
            self, x=xy[..., 0], y=xy[..., 1]
        )

    @staticmethod
    def zeros(n, dtype=jnp.float32):
        return ParticleSet(
            x=jnp.zeros((n,), dtype),
            y=jnp.zeros((n,), dtype),
            yaw=jnp.zeros((n,), dtype),
            z=jnp.zeros((n,), dtype),
            z_sigma=jnp.zeros((n,), dtype),
            weight=jnp.full((n,), 1.0 / n, dtype),
            mprob=jnp.ones((n,), dtype),
            floating=jnp.ones((n,), bool),
            n_contacts=jnp.zeros((n,), jnp.int32),
            map_id=jnp.zeros((n,), jnp.int32),
        )

    def pose_matrix(self):
        """(R, t) per particle for the weighting loop
        (``src/PoseEstimator.cpp:279-282``)."""
        return geometry.pose_matrix_2p5d(self.xy, self.yaw, self.z)

    def full_pose(self, orientation_quat):
        """6-DoF pose quaternion+translation per particle:
        translation * yaw * removeYaw(imu) (``src/PoseParticle.hpp:58-67``)."""
        q = geometry.quat_mul(
            geometry.quat_from_yaw(self.yaw),
            jnp.broadcast_to(
                geometry.remove_yaw(orientation_quat), self.yaw.shape + (4,)
            ),
        )
        t = jnp.stack([self.x, self.y, self.z], axis=-1)
        return q, t


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BodyContactState:
    """Fixed-size contact-point set (leading dim C = contact candidates)."""

    position: jax.Array  # [C, 3] float32 — body-frame (or rotated) positions
    contact: jax.Array   # [C]    float32 — contact probability (NaN = unknown)
    slip: jax.Array      # [C]    float32
    group_id: jax.Array  # [C]    int32   — -1 = ungrouped
    valid: jax.Array     # [C]    bool    — padding mask

    @property
    def c(self):
        return self.position.shape[0]

    @staticmethod
    def create(position, contact=None, slip=None, group_id=None, valid=None):
        position = jnp.asarray(position, jnp.float32)
        c = position.shape[0]
        return BodyContactState(
            position=position,
            contact=(jnp.full((c,), jnp.nan, jnp.float32)
                     if contact is None else jnp.asarray(contact, jnp.float32)),
            slip=(jnp.zeros((c,), jnp.float32)
                  if slip is None else jnp.asarray(slip, jnp.float32)),
            group_id=(jnp.full((c,), -1, jnp.int32)
                      if group_id is None else jnp.asarray(group_id, jnp.int32)),
            valid=(jnp.ones((c,), bool)
                   if valid is None else jnp.asarray(valid, bool)),
        )

    def compact(self, cap):
        """Host-side compaction to the active candidate set.

        Points with contact probability below the model's threshold are
        never queried and contribute nothing to ``evaluate_pose``
        (``ContactModel.cpp:136,154``), so a frame whose active set is
        small can be compacted to ``cap`` slots before entering the
        device step — a 20->8 compaction cuts the map-gather and
        likelihood work by 2.5x at identical results.  Stable order
        (group runs preserved).  Active points beyond ``cap`` are kept
        by dropping inactive ones first; if actives alone exceed
        ``cap``, the tail actives are dropped (choose ``cap`` >= the
        worst-case active count to avoid this).

        MEASUREMENT-ONLY: the stance-foot odometry
        (``models.odometry.update``) differences contact points BY SLOT
        across frames; when the active set changes between frames (a
        rolling wheel hands contact to the next foot), per-frame
        compaction re-selects the slots and silently mispairs feet —
        the integrated odometry then reads ~zero motion.  Feed the
        odometry the FULL contact stream (e.g.
        ``filter.streaming.precompute_odometry``) and compact only the
        measurement frames.
        """
        import numpy as np

        from slam_eslam_tpu.models.contact_model import CONTACT_THRESHOLD

        contact = np.asarray(self.contact)
        valid = np.asarray(self.valid)
        active = valid & ~(contact < CONTACT_THRESHOLD)
        order = np.argsort(~active, kind="stable")  # actives first
        keep = np.sort(order[:cap])                 # restore original order
        return BodyContactState(
            position=self.position[keep],
            contact=self.contact[keep],
            slip=self.slip[keep],
            group_id=self.group_id[keep],
            valid=self.valid[keep],
        )

    def segments(self):
        """Group segmentation of the contact points.

        The reference iterates contact points sequentially and closes a
        group when the ``groupId`` changes or equals -1
        (``src/ContactModel.cpp:193-214``); i.e. groups are *consecutive
        runs* of equal non-negative groupId, and every groupId == -1 point
        is its own group.  Returns ``(seg_id [C] int32, num_segments C)``
        — padded/invalid points keep a segment id but are masked out by
        callers via ``self.valid``.
        """
        gid = self.group_id
        prev = jnp.concatenate([jnp.array([-2], jnp.int32), gid[:-1]])
        boundary = (gid != prev) | (gid < 0)
        seg = jnp.cumsum(boundary.astype(jnp.int32)) - 1
        return seg, self.c
