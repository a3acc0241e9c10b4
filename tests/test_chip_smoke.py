"""``chip_smoke.py`` on the CPU: it must refuse to run without a GPU or
outside a checkout, and its phases must pass at tiny sizes (here the
"card" is the CPU device, so every card-vs-CPU comparison runs)."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(out):
    return any(line.startswith("{") for line in out.splitlines())


def test_exits_nonzero_without_gpu():
    r = _run(ROOT, "chip_smoke.py")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not _printed_result(r.stdout)


def test_exits_nonzero_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, "chip_smoke.py")
    assert r.returncode != 0
    assert "checkout" in r.stderr
    assert not _printed_result(r.stdout)


def test_phase_localisation_tiny():
    out = chip_smoke.phase_localisation(
        particles=1024, steps=60, cells=400, queries=256, repeats=1,
        log=lambda m: None,
    )
    assert out["ate_m"] < chip_smoke.ATE_BOUND_M
    assert out["updates_per_s"] > 0


def test_phase_slam_tiny():
    out = chip_smoke.phase_slam(particles=32, steps=2, grid_size=4.0,
                                grid_res=0.5, n_rays=16, repeats=1,
                                log=lambda m: None)
    assert out["frames_per_s"] > 0


def test_phase_host_api_tiny():
    out = chip_smoke.phase_host_api(particles=16, steps=2,
                                    log=lambda m: None)
    assert out["wall_s"] > 0


def test_lookup_oracle_and_query_sampler():
    """The smoke's NumPy oracle on a hand-made 2x2 table: nearest valid
    slot within the z window, misses out of bounds and beyond it."""
    data = np.full((2, 2, 4), -1.0, np.float32)
    data[1, 0, :2] = [0.0, 2.0]        # means
    data[1, 0, 2:] = [0.1, 0.2]        # stdevs (valid)
    pts = np.array([[1.5, 0.5, 1.9], [1.5, 0.5, 0.4], [1.5, 0.5, 9.0],
                    [2.5, 0.5, 0.0], [0.5, 0.5, 0.0]], np.float32)
    f, m, s = chip_smoke.lookup_oracle(data, np.zeros(2, np.float32), 1.0,
                                       pts, 3.0)
    np.testing.assert_array_equal(f, [True, True, False, False, False])
    np.testing.assert_array_equal(m[:2], [2.0, 0.0])
    np.testing.assert_array_equal(s[:2], np.float32([0.2, 0.1]))
    q = chip_smoke.sample_queries(np.random.default_rng(0), 10, 10,
                                  np.zeros(2), 0.5, 200, chip_smoke.terrain)
    frac = np.mod(q[:, :2] / 0.5, 1.0)
    assert ((frac > 0.05) & (frac < 0.95)).all()


def test_merge_check_rejects_disagreement():
    from slam_eslam_tpu.mapping import map_pool as mp
    from slam_eslam_tpu.mapping.mls_grid import MLSGrid

    pool = mp.MapPool.from_template(
        MLSGrid.create(8, 8, 0.5, (0.0, 0.0), k=2), 2, 4, 2,
        with_color=False,
    )
    chip_smoke.check_merge_statistical(pool, pool)
    flipped = pool.__class__(**{
        **pool.__dict__, "meta": jnp.ones_like(pool.meta)
    })
    with pytest.raises(AssertionError):
        chip_smoke.check_merge_statistical(pool, flipped)
