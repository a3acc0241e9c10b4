"""Legged-wheel (Asguard-like) kinematic model and simulation fixture.

Rebuild of the capability of the external ``asguard`` package that the
reference uses as its test/benchmark fixture
(``/root/reference/test/testMap.cpp:65-104``): a four-wheel robot where
each wheel is a five-spoke star of feet; rotating the wheels rolls the
robot from foot to foot, producing the contact states + odometry stream
that drive the filter.

Geometry: wheels rotate about the body x-axis (lateral), so the robot
drives in +y (the reference's statistical harness plots distance along y,
``testMap.cpp:284,405``).  Foot j of a wheel at angle ``a`` sits at
``center + r * (0, -sin(a + j*2pi/5), -cos(a + j*2pi/5))``.

The simulator supports an arbitrary terrain height function so E2E
localisation tests can run over synthetic relief.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from slam_eslam_tpu.core.state import BodyContactState
from slam_eslam_tpu.utils import geometry

NUM_WHEELS = 4
FEET_PER_WHEEL = 5
NUM_FEET = NUM_WHEELS * FEET_PER_WHEEL


@dataclasses.dataclass
class AsguardConfig:
    wheel_radius: float = 0.16
    # wheel centre offsets (x lateral, y longitudinal)
    track_width: float = 0.5
    wheel_base: float = 0.6

    def wheel_centers(self):
        hx, hy = self.track_width / 2.0, self.wheel_base / 2.0
        return np.array(
            [[-hx, -hy, 0.0], [hx, -hy, 0.0], [-hx, hy, 0.0], [hx, hy, 0.0]]
        )

    def foot_positions(self, wheel_pos):
        """Body-frame positions of all feet.  ``wheel_pos``: [4] wheel
        angles.  Returns [NUM_FEET, 3] ordered wheel-major (groupId =
        wheel index, matching the grouped contact layout the contact
        model expects)."""
        centers = self.wheel_centers()
        j = np.arange(FEET_PER_WHEEL)
        angles = wheel_pos[:, None] + j[None, :] * (2 * np.pi / FEET_PER_WHEEL)
        offs = np.stack(
            [
                np.zeros_like(angles),
                -np.sin(angles),
                -np.cos(angles),
            ],
            axis=-1,
        ) * self.wheel_radius
        return (centers[:, None, :] + offs).reshape(NUM_FEET, 3)

    def lowest_foot_position(self, wheel_pos):
        feet = self.foot_positions(wheel_pos)
        return feet[np.argmin(feet[:, 2])]

    def contact_state(self, wheel_pos, contact_sharpness=None):
        """Build a ``BodyContactState``: one contact candidate per foot,
        grouped by wheel; the lowest foot of each wheel is marked in
        contact (the lowest-point heuristic the reference applies,
        ``ContactModel.cpp:48-92``)."""
        feet = self.foot_positions(wheel_pos)
        group = np.repeat(np.arange(NUM_WHEELS), FEET_PER_WHEEL)
        z = feet[:, 2].reshape(NUM_WHEELS, FEET_PER_WHEEL)
        lowest = np.zeros_like(z)
        lowest[np.arange(NUM_WHEELS), np.argmin(z, axis=1)] = 1.0
        # plain-numpy fields: ``create``'s jnp.asarray would round-trip
        # every simulated frame through the device; consumers stack
        # whole frame lists at once
        c = feet.shape[0]
        return BodyContactState(
            position=feet.astype(np.float32),
            contact=lowest.reshape(-1).astype(np.float32),
            slip=np.zeros((c,), np.float32),
            group_id=group.astype(np.int32),
            valid=np.ones((c,), bool),
        )


class AsguardSim:
    """Kinematic ground-truth simulator (``testMap.cpp:65-104``).

    Flat or functional terrain; the body z rides so the lowest foot
    touches the terrain under it (the reference pins z the same way,
    ``testMap.cpp:81-83,101-102``).  Runs in NumPy — it is a host-side
    fixture feeding device-side filters.
    """

    def __init__(self, config: AsguardConfig = None, terrain=None,
                 heading=np.pi / 2):
        # heading pi/2: the robot drives toward +y in the world while the
        # body frame keeps +y as its rolling direction => world yaw = 0
        # with our convention that rolling is along body +y. Identity.
        self.config = config or AsguardConfig()
        self.terrain = terrain or (lambda x, y: 0.0)
        self.wheel_pos = np.zeros(NUM_WHEELS)
        self.position = np.zeros(3)
        self.yaw = 0.0
        self._settle()

    def _settle(self):
        feet = self.config.foot_positions(self.wheel_pos)
        world_feet = self._to_world(feet)
        clearance = world_feet[:, 2] - np.array(
            [self.terrain(p[0], p[1]) for p in world_feet]
        )
        self.position[2] -= clearance.min()

    def _to_world(self, pts):
        r = np.array(
            [
                [np.cos(self.yaw), -np.sin(self.yaw), 0],
                [np.sin(self.yaw), np.cos(self.yaw), 0],
                [0, 0, 1],
            ]
        )
        return pts @ r.T + self.position

    @property
    def orientation(self):
        # pure numpy: a jnp quat helper would dispatch one device op
        # per frame of a host-side fixture
        half = 0.5 * float(self.yaw)
        return np.array([np.cos(half), 0.0, 0.0, np.sin(half)],
                        np.float32)

    def contact_state(self):
        return self.config.contact_state(self.wheel_pos)

    def step(self, wheel_delta=0.1, yaw_rate=0.0, substeps=10,
             on_substep=None):
        """Advance one filter step = ``substeps`` kinematic substeps
        (mirrors the 10x0.01 rad inner loop, ``testMap.cpp:86-97``;
        ``on_substep(sim)`` is called after each substep so callers can
        run odometry at the reference's substep rate, ``:94-95``).
        Returns the new ground-truth body pose."""
        d = wheel_delta / substeps
        for _ in range(substeps):
            prev_feet = self._to_world(
                self.config.foot_positions(self.wheel_pos)
            )
            # stance foot = lowest BEFORE the substep; the same foot is
            # tracked across the substep (comparing the argmin of both
            # frames would mix different feet at stance transitions)
            stance = int(np.argmin(prev_feet[:, 2]))
            self.wheel_pos += d
            self.yaw += yaw_rate / substeps
            cur_feet = self._to_world(
                self.config.foot_positions(self.wheel_pos)
            )
            self.position[:2] += (prev_feet[stance] - cur_feet[stance])[:2]
            self._settle()
            if on_substep is not None:
                on_substep(self)
        return self.position.copy(), self.yaw
