"""Checkpoint / resume of the full filter state.

The reference has no checkpointing (SURVEY §5; map persistence exists
only through envire serialization in a viz test).  This build makes
the whole system resumable: the filter state (particles, odometry,
PRNG key, counters), the map (shared grid or block pool), and the
orchestrator's host-side gate poses are one pytree, saved with Orbax.
"""

from __future__ import annotations

import os

import numpy as np


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def save_filter(path, eslam_filter):
    """Persist an ``EmbodiedSlamFilter``'s complete state."""
    path = os.path.abspath(path)
    tree = {
        "state": eslam_filter.state,
        "map": (
            eslam_filter.shared_grid
            if eslam_filter.use_shared_map
            else eslam_filter.pool
        ),
        "host": {
            "ud_pose": np.asarray(eslam_filter.ud_pose),
            "map_pose": np.asarray(eslam_filter.map_pose),
            "stereo_pose": np.asarray(eslam_filter.stereo_pose),
            "update_idx": np.asarray(eslam_filter.update_idx),
        },
    }
    c = _checkpointer()
    c.save(path, tree, force=True)
    c.wait_until_finished()


def restore_filter(path, eslam_filter):
    """Restore in place (the filter must be ``init``-ed with matching
    shapes/config first).  Returns the filter."""
    path = os.path.abspath(path)
    template = {
        "state": eslam_filter.state,
        "map": (
            eslam_filter.shared_grid
            if eslam_filter.use_shared_map
            else eslam_filter.pool
        ),
        "host": {
            "ud_pose": np.asarray(eslam_filter.ud_pose),
            "map_pose": np.asarray(eslam_filter.map_pose),
            "stereo_pose": np.asarray(eslam_filter.stereo_pose),
            "update_idx": np.asarray(eslam_filter.update_idx),
        },
    }
    tree = _checkpointer().restore(path, template)
    eslam_filter.state = tree["state"]
    if eslam_filter.use_shared_map:
        eslam_filter.shared_grid = tree["map"]
    else:
        eslam_filter.pool = tree["map"]
    host = tree["host"]
    eslam_filter.ud_pose = np.asarray(host["ud_pose"])
    eslam_filter.map_pose = np.asarray(host["map_pose"])
    eslam_filter.stereo_pose = np.asarray(host["stereo_pose"])
    eslam_filter.update_idx = int(np.asarray(host["update_idx"]))
    return eslam_filter


def save_state(path, pytree):
    """Generic pytree save (filter-core states, map pools, hashes)."""
    c = _checkpointer()
    c.save(os.path.abspath(path), pytree, force=True)
    c.wait_until_finished()


def restore_state(path, template):
    return _checkpointer().restore(os.path.abspath(path), template)
