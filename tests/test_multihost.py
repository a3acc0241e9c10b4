"""Multi-host (multi-process) runtime wiring.

The reference has no distributed code at all (SURVEY §2c); this build
adds a ``jax.distributed`` runtime layer.  Real DCN hardware is
not available in CI, so this launches a genuine 2-process local CPU
cluster (coordinator + worker over localhost) and checks the global
normalize/ESS/systematic-resample against the single-process oracle —
the wiring, global-mesh construction, and cross-process collectives all
execute for real.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


N = 64


def _launch(pid, port, n_local_devices=2):
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", ""
    )
    env.update({
        "ESLAM_COORDINATOR": f"127.0.0.1:{port}",
        "ESLAM_NUM_PROCESSES": "2",
        "ESLAM_PROCESS_ID": str(pid),
        "ESLAM_TEST_N": str(N),
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": (
            flags + f" --xla_force_host_platform_device_count"
            f"={n_local_devices}"
        ).strip(),
    })
    return subprocess.Popen(
        [sys.executable, "-m", "slam_eslam_tpu.parallel.distributed"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=os.path.dirname(os.path.dirname(__file__)),
    )


def test_two_process_resample_matches_oracle():
    port = _free_port()
    procs = [_launch(0, port), _launch(1, port)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    results = {}
    for out in outs:
        m = re.search(
            r"RESULT pid=(\d+) ess=([0-9.]+) local=([0-9,]+)", out
        )
        assert m, f"no RESULT line in: {out}"
        results[int(m.group(1))] = (
            float(m.group(2)),
            np.array([int(v) for v in m.group(3).split(",")]),
        )
    assert set(results) == {0, 1}

    # single-process oracle (same math, same key)
    import jax

    jax.config.update("jax_platforms", "cpu")

    from slam_eslam_tpu.core import filter as pf

    rng = np.random.default_rng(7)
    w = rng.uniform(0.1, 1.0, N).astype(np.float32)
    wn, _ = pf.normalize_weights(w)
    ess = float(pf.effective_sample_size(wn))
    idx = np.asarray(pf.resample_systematic(jax.random.PRNGKey(3), wn, N))
    payload = np.arange(N, dtype=np.int32)[idx]

    np.testing.assert_allclose(results[0][0], ess, rtol=1e-5)
    np.testing.assert_allclose(results[1][0], ess, rtol=1e-5)
    got = np.concatenate([results[0][1], results[1][1]])
    np.testing.assert_array_equal(got, payload)
