"""slam_eslam_tpu — an embodied-SLAM engine in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the
``eslam`` embodied-SLAM particle filter (reference:
``liyangSKD/slam-eslam``): contact-odometry particle propagation,
terrain-contact likelihood weighting against Multi-Level Surface (MLS)
elevation maps, ESS-gated resampling, terrain-signature hashing for
global relocalisation, and per-particle map building — re-designed as
pure, fixed-shape, structure-of-arrays functional transforms that shard
over device meshes.  (The ``_tpu`` in the package name is historical.)

Layout:
  config        static configuration dataclasses
  core          particle-set state + generic SIR filter primitives
  models        contact measurement model, contact odometry, terrain
                classification, robot kinematics fixtures
  mapping       MLS grids/maps, sensor projection pipelines, map pool
  filter        pose estimator + embodied-SLAM orchestrator + surface hash
  parallel      device-mesh sharding, distributed resampling & map merge
  utils         geometry, PRNG policy, profiling
  viz           offline visualisation (matplotlib)
"""

__version__ = "0.1.0"

from slam_eslam_tpu.config import (  # noqa: F401
    Config,
    ContactModelConfig,
    OdometryConfig,
    SurfaceHashConfig,
    UpdateThreshold,
)
