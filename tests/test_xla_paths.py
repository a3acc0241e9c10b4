"""The XLA map paths against plain NumPy oracles.

* the packed shared-map gather (``make_lookup``) — grid widths that are
  no multiple of 128, K in {1, 2, 4}, z windows, out-of-grid queries,
  SoA and AoS queries;
* the per-particle chain lookup (``map_pool.chain_lookup``) — chain
  lengths 1-4, empty (-1) levels, f32 and bf16 pools, a particle count
  that is no multiple of 8;
* the per-particle merge (``map_pool.merge_cloud_all``) — single- and
  multi-point cells, colour, bf16, dense pools, ``update_idx`` stamping;
* the scan-to-map score (``map_pool.match_cloud_all``).

Each oracle is a straightforward loop over queries or cells that
follows the reference semantics (``MLSGrid::get``, envire
``updateCell``) and shares no code with the package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_eslam_tpu.config import Config
from slam_eslam_tpu.mapping import map_pool as mp
from slam_eslam_tpu.mapping import mls_grid
from slam_eslam_tpu.mapping.lookup import make_lookup
from slam_eslam_tpu.mapping.mls_grid import PatchCloud


def nearest_slot(means, stdevs, valid, z, z_window):
    """Index of the valid slot nearest to ``z`` within ``z_window``
    (first on ties), or None."""
    best, best_d = None, None
    for s in range(len(means)):
        d = abs(float(means[s]) - float(z))
        if valid[s] and d <= z_window and (best is None or d < best_d):
            best, best_d = s, d
    return best


def cell_of(x, y, origin, res):
    """Cell index as the package computes it (float32 arithmetic)."""
    ix = np.floor((np.float32(x) - np.float32(origin[0])) / np.float32(res))
    iy = np.floor((np.float32(y) - np.float32(origin[1])) / np.float32(res))
    return int(ix), int(iy)


# --------------------------------------------------------------------------
# packed shared-map gather
# --------------------------------------------------------------------------

def _packed(nx, ny, k, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 1.0, (nx, ny, k)).astype(np.float32)
    stdevs = rng.uniform(0.01, 0.3, (nx, ny, k)).astype(np.float32)
    valid = rng.random((nx, ny, k)) < 0.6
    data = np.concatenate(
        [np.where(valid, means, 0.0), np.where(valid, stdevs, -1.0)], -1
    ).astype(np.float32)
    return mls_grid.PackedLookup(
        data=jnp.asarray(data), origin=jnp.asarray([-1.3, 0.7], jnp.float32),
        resolution=0.1,
    )


def _queries(rng, nx, ny, origin, res, n):
    ix = rng.integers(-3, nx + 3, n)
    iy = rng.integers(-3, ny + 3, n)
    frac = rng.uniform(0.05, 0.95, (n, 2))
    x = origin[0] + (ix + frac[:, 0]) * res
    y = origin[1] + (iy + frac[:, 1]) * res
    z = rng.normal(0.0, 1.5, n)
    return np.stack([x, y, z], 1).astype(np.float32)


def packed_oracle(packed, pts, z_window):
    data = np.asarray(packed.data)
    nx, ny, c2 = data.shape
    k = c2 // 2
    origin = np.asarray(packed.origin)
    found = np.zeros(len(pts), bool)
    mean = np.zeros(len(pts), np.float32)
    stdev = np.zeros(len(pts), np.float32)
    for q, (x, y, z) in enumerate(pts):
        ix, iy = cell_of(x, y, origin, packed.resolution)
        if not (0 <= ix < nx and 0 <= iy < ny):
            continue
        cell = data[ix, iy]
        s = nearest_slot(cell[:k], cell[k:], cell[k:] >= 0, z, z_window)
        if s is not None:
            found[q], mean[q], stdev[q] = True, cell[s], cell[k + s]
    return found, mean, stdev


@pytest.mark.parametrize("z_window", [0.5, 3.0])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("nx,ny", [(37, 53), (130, 70)])
def test_packed_gather_matches_oracle(nx, ny, k, z_window):
    packed = _packed(nx, ny, k, seed=nx + k)
    pts = _queries(np.random.default_rng(k), nx, ny,
                   np.asarray(packed.origin), packed.resolution, 600)
    cfg = dataclasses.replace(Config(), mls_z_window=z_window)
    lk = make_lookup(cfg, packed)
    f, m, s, color = jax.jit(lambda p: lk(None, p))(
        jnp.asarray(pts).reshape(100, 6, 3))
    assert color.shape == (100, 6, 3)
    fo, mo, so = packed_oracle(packed, pts, z_window)
    assert fo.any() and not fo.all()
    f, m, s = (np.asarray(a).reshape(-1) for a in (f, m, s))
    np.testing.assert_array_equal(f, fo)
    np.testing.assert_array_equal(m[fo], mo[fo])
    np.testing.assert_array_equal(s[fo], so[fo])


@pytest.mark.parametrize("k", [1, 4])
def test_packed_gather_soa_equals_aos(k):
    packed = _packed(45, 33, k)
    pts = _queries(np.random.default_rng(9), 45, 33,
                   np.asarray(packed.origin), packed.resolution, 257)
    lk = make_lookup(Config(), packed)
    aos = lk(None, jnp.asarray(pts))
    soa = lk(None, tuple(jnp.asarray(pts[:, i]) for i in range(3)))
    for a, b in zip(aos[:3], soa):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------
# per-particle chain lookup
# --------------------------------------------------------------------------

def _random_pool(n, b, nx, ny, k, chain_len, dtype=jnp.float32, seed=0,
                 fill=0.5):
    rng = np.random.default_rng(seed)
    shape = (b, nx, ny * k)
    chain = rng.integers(0, b, size=(n, chain_len)).astype(np.int32)
    chain[rng.random((n, chain_len)) < 0.25] = -1
    chain[0] = -1                      # a particle with no map at all
    return mp.MapPool(
        mean=jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype),
        stdev=jnp.asarray((0.01 + 0.2 * rng.random(shape)).astype(np.float32),
                          dtype),
        height=jnp.asarray((0.1 * rng.random(shape)).astype(np.float32),
                           dtype),
        meta=jnp.asarray(
            (rng.random(shape) < fill).astype(np.int32)
            | (rng.integers(0, 2, shape) << 1).astype(np.int32)
            | (rng.integers(0, 50, shape) << 2).astype(np.int32)
        ),
        color=None,
        origin=jnp.asarray(rng.uniform(-2.0, 2.0, (b, 2)).astype(np.float32)),
        allocated=jnp.ones((b,), bool),
        chain=jnp.asarray(chain),
        resolution=0.25, nx=nx, ny=ny, k=k,
    )


def _np_pool(pool):
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    return dict(mean=f32(pool.mean), stdev=f32(pool.stdev),
                height=f32(pool.height), meta=np.asarray(pool.meta),
                origin=np.asarray(pool.origin), chain=np.asarray(pool.chain),
                color=None if pool.color is None else f32(pool.color))


def block_lookup(P, pool, b, x, y, z, z_window):
    """(found, mean, stdev) of one query in block ``b``."""
    ix, iy = cell_of(x, y, P["origin"][b], pool.resolution)
    if not (0 <= ix < pool.nx and 0 <= iy < pool.ny):
        return False, 0.0, 0.0
    cols = slice(iy * pool.k, (iy + 1) * pool.k)
    means = P["mean"][b, ix, cols]
    stdevs = P["stdev"][b, ix, cols]
    valid = (P["meta"][b, ix, cols] & 1) != 0
    s = nearest_slot(means, stdevs, valid, z, z_window)
    if s is None:
        return False, 0.0, 0.0
    return True, means[s], stdevs[s]


def chain_oracle(pool, pts, z_window):
    P = _np_pool(pool)
    n, c, _ = pts.shape
    found = np.zeros((n, c), bool)
    mean = np.zeros((n, c), np.float32)
    stdev = np.zeros((n, c), np.float32)
    for i in range(n):
        for q in range(c):
            for b in P["chain"][i]:
                if b < 0:
                    continue
                hit = block_lookup(P, pool, b, *pts[i, q], z_window)
                if hit[0]:
                    found[i, q], mean[i, q], stdev[i, q] = hit
                    break
    return found, mean, stdev


def _chain_queries(pool, rng, c):
    """Per particle: half the queries on a cell of one of its blocks
    (z near a slot mean), half anywhere."""
    P = _np_pool(pool)
    n = pool.n
    pts = np.zeros((n, c, 3), np.float32)
    for i in range(n):
        for q in range(c):
            blocks = [b for b in P["chain"][i] if b >= 0]
            if blocks and q % 2 == 0:
                b = blocks[rng.integers(len(blocks))]
                ix, iy = rng.integers(0, pool.nx), rng.integers(0, pool.ny)
                fx, fy = rng.uniform(0.05, 0.95, 2)
                pts[i, q, 0] = P["origin"][b, 0] + (ix + fx) * pool.resolution
                pts[i, q, 1] = P["origin"][b, 1] + (iy + fy) * pool.resolution
                pts[i, q, 2] = (P["mean"][b, ix, iy * pool.k]
                                + rng.normal(0.0, 0.3))
            else:
                pts[i, q] = [rng.uniform(-3, 8), rng.uniform(-3, 8),
                             rng.normal(0.0, 2.0)]
    return pts


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("chain_len", [1, 2, 3, 4])
def test_chain_lookup_matches_oracle(chain_len, dtype):
    pool = _random_pool(n=13, b=20, nx=12, ny=9, k=4, chain_len=chain_len,
                        dtype=dtype, seed=chain_len)
    pts = _chain_queries(pool, np.random.default_rng(chain_len), 6)
    lk = mp.chain_lookup(pool, z_window=1.0)
    f, m, s, _ = jax.jit(jax.vmap(lk))(jnp.arange(pool.n), jnp.asarray(pts))
    assert m.dtype == jnp.float32
    fo, mo, so = chain_oracle(pool, pts, 1.0)
    assert fo.any() and not fo[0].any()
    np.testing.assert_array_equal(np.asarray(f), fo)
    np.testing.assert_array_equal(np.asarray(m)[fo], mo[fo])
    np.testing.assert_array_equal(np.asarray(s)[fo], so[fo])


# --------------------------------------------------------------------------
# per-particle merge
# --------------------------------------------------------------------------

def fuse_cell(means, stdevs, heights, valid, horiz, z, var, thick, gap):
    """envire ``updateCell`` on one cell's K slots (float64): returns
    (slot, mean, stdev, height, horizontal)."""
    k = len(means)
    dist = np.abs(means - z)
    fuse = [s for s in range(k) if valid[s] and horiz[s] and dist[s] <= thick]
    near = [s for s in range(k) if valid[s] and dist[s] <= gap]
    if fuse:
        s = min(fuse, key=lambda t: (dist[t], t))
        w1 = 1.0 / max(stdevs[s] ** 2, 1e-12)
        w2 = 1.0 / max(var, 1e-12)
        return (s, (means[s] * w1 + z * w2) / (w1 + w2),
                np.sqrt(1.0 / (w1 + w2)), heights[s], True)
    if near:
        s = min(near, key=lambda t: (dist[t], t))
        top = max(means[s], z)
        bottom = min(means[s] - heights[s], z)
        return s, top, min(stdevs[s], np.sqrt(var)), top - bottom, False
    free = [s for s in range(k) if not valid[s]]
    if free:
        s = free[0]
    else:
        s = int(np.argmax(np.where(valid, stdevs, -np.inf)))
    return s, z, np.sqrt(var), 0.0, True


def merge_oracle(pool, xy, yaw, z_off, off_std, cloud, update_idx,
                 thick=0.1, gap=1.5):
    P = {k: (None if v is None else np.array(v, np.float64))
         for k, v in _np_pool(pool).items()}
    meta = np.asarray(pool.meta).copy()
    cxy = np.asarray(cloud.xy)
    cz, cs, cv = (np.asarray(a) for a in (cloud.z, cloud.stdev, cloud.valid))
    ccol = np.asarray(cloud.color, np.float64)
    yaw32 = np.asarray(yaw, np.float32)
    for i in range(pool.n):
        b = int(P["chain"][i, 0])
        c, s = np.cos(yaw32[i]), np.sin(yaw32[i])
        cells = {}
        for p in range(cloud.p):
            if not cv[p]:
                continue
            wx = c * cxy[p, 0] - s * cxy[p, 1] + np.float32(xy[i][0])
            wy = s * cxy[p, 0] + c * cxy[p, 1] + np.float32(xy[i][1])
            ix, iy = cell_of(wx, wy, P["origin"][b], pool.resolution)
            if not (0 <= ix < pool.nx and 0 <= iy < pool.ny):
                continue
            var = float(cs[p]) ** 2 + float(off_std[i]) ** 2
            w = 1.0 / max(var, 1e-12)
            acc = cells.setdefault((ix, iy), [0.0, 0.0, np.zeros(3)])
            acc[0] += w
            acc[1] += w * (float(cz[p]) + float(z_off[i]))
            acc[2] += w * ccol[p]
        for (ix, iy), (wsum, zsum, csum) in cells.items():
            cols = slice(iy * pool.k, (iy + 1) * pool.k)
            m = meta[b, ix, cols]
            slot, mean, std, height, horiz = fuse_cell(
                P["mean"][b, ix, cols], P["stdev"][b, ix, cols],
                P["height"][b, ix, cols], (m & 1) != 0, (m & 2) != 0,
                zsum / wsum, 1.0 / wsum, thick, gap,
            )
            col = iy * pool.k + slot
            P["mean"][b, ix, col] = mean
            P["stdev"][b, ix, col] = std
            P["height"][b, ix, col] = height
            meta[b, ix, col] = 1 | (int(horiz) << 1) | (update_idx << 2)
            if P["color"] is not None:
                P["color"][b, ix, 3 * col:3 * col + 3] = csum / wsum
    P["meta"] = meta
    return P


def _merge_case(case):
    rng = np.random.default_rng(len(case))
    k = {"k1": 1, "dense": 4}.get(case, 2)
    n, nx, ny = 6, 20, 15
    dtype = jnp.bfloat16 if case == "bf16" else jnp.float32
    template = mls_grid.MLSGrid.create(nx, ny, 0.5, (-5.0, -3.5), k=k)
    pool = mp.MapPool.from_template(template, n, 3 * n, 3,
                                    with_color=(case == "colour"),
                                    dtype=dtype)
    if case in ("dense", "k1", "update_idx"):
        shape = pool.mean.shape
        pool = dataclasses.replace(
            pool,
            mean=jnp.asarray(rng.uniform(0.5, 1.5, shape), dtype),
            stdev=jnp.asarray(rng.uniform(0.01, 0.3, shape), dtype),
            height=jnp.asarray(rng.uniform(0.0, 0.2, shape), dtype),
            meta=jnp.asarray(
                (rng.random(shape) < 0.6).astype(np.int32)
                | (rng.integers(0, 2, shape) << 1).astype(np.int32)
                | (rng.integers(0, 9, shape) << 2).astype(np.int32)),
        )
    p = 96
    if case == "single":
        cells = rng.choice(nx * ny, size=p, replace=False)
        frac = rng.uniform(0.1, 0.9, (p, 2))
        cxy = np.stack([(cells // ny + frac[:, 0]) * 0.5 - 5.0,
                        (cells % ny + frac[:, 1]) * 0.5 - 3.5], 1)
    else:
        # 32 cells hit three times each
        base = rng.uniform(-4.0, 4.0, (32, 2))
        cxy = np.repeat(base, 3, axis=0) + rng.normal(0.0, 0.05, (p, 2))
    cloud = PatchCloud.create(
        xy=jnp.asarray(cxy, jnp.float32),
        z=jnp.asarray(rng.uniform(0.6, 1.4, p), jnp.float32),
        stdev=jnp.asarray(rng.uniform(0.02, 0.2, p), jnp.float32),
        valid=jnp.asarray(np.arange(p) % 7 != 3),
        color=jnp.asarray(rng.random((p, 3)), jnp.float32),
    )
    single = case == "single"
    xy = jnp.asarray(np.zeros((n, 2)) if single
                     else rng.uniform(-0.5, 0.5, (n, 2)), jnp.float32)
    yaw = jnp.asarray(np.zeros(n) if single else rng.uniform(-0.5, 0.5, n),
                      jnp.float32)
    z_off = jnp.asarray(rng.normal(0.0, 0.05, n), jnp.float32)
    off_std = jnp.asarray(rng.uniform(0.0, 0.1, n), jnp.float32)
    uidx = 12345 if case == "update_idx" else 7
    return pool, (xy, yaw, z_off, off_std, cloud, uidx)


@pytest.mark.parametrize(
    "case", ["single", "multi", "colour", "bf16", "dense", "k1",
             "update_idx"])
def test_merge_matches_oracle(case):
    pool, args = _merge_case(case)
    out = jax.jit(mp.merge_cloud_all, static_argnums=(6,))(pool, *args)
    ref = merge_oracle(pool, *args)
    got_meta = np.asarray(out.meta)
    np.testing.assert_array_equal(got_meta, ref["meta"])
    written = got_meta != np.asarray(pool.meta)
    assert written.sum() > 20
    assert ((got_meta[written] >> 2) == args[-1]).all()
    tol = (dict(rtol=1e-2, atol=1e-2) if case == "bf16"
           else dict(rtol=1e-5, atol=1e-6))
    v = (got_meta & 1) != 0
    for fld in ("mean", "stdev", "height"):
        np.testing.assert_allclose(
            np.asarray(jnp.asarray(getattr(out, fld), jnp.float32))[v],
            ref[fld][v], err_msg=fld, **tol)
    if out.color is not None:
        np.testing.assert_allclose(np.asarray(out.color), ref["color"],
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# scan-to-map score
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", [1, 3, 10])
def test_match_matches_oracle(sampling):
    pool, (xy, yaw, z_off, off_std, cloud, _) = _merge_case("dense")
    P = _np_pool(pool)
    scores = mp.match_cloud_all(pool, xy, yaw, z_off, off_std, cloud,
                                sampling=sampling, sigma=0.2, z_window=3.0)
    cxy, cz = np.asarray(cloud.xy), np.asarray(cloud.z)
    cs, cv = np.asarray(cloud.stdev), np.asarray(cloud.valid)
    yaw32 = np.asarray(yaw)
    ref = np.zeros(pool.n)
    sampled = cv & (np.arange(cloud.p) % sampling == 0)
    for i in range(pool.n):
        b = int(P["chain"][i, 0])
        c, s = np.cos(yaw32[i]), np.sin(yaw32[i])
        total = 0.0
        for p in np.flatnonzero(sampled):
            wx = c * cxy[p, 0] - s * cxy[p, 1] + np.asarray(xy)[i, 0]
            wy = s * cxy[p, 0] + c * cxy[p, 1] + np.asarray(xy)[i, 1]
            wz = cz[p] + float(z_off[i])
            f, m, sd = block_lookup(P, pool, b, wx, wy, wz, 3.0)
            if f:
                var = 0.04 + sd ** 2 + cs[p] ** 2 + float(off_std[i]) ** 2
                total += np.exp(-0.5 * (wz - m) ** 2 / var)
        ref[i] = total / max(sampled.sum(), 1)
    assert (ref > 0).all()
    np.testing.assert_allclose(np.asarray(scores), ref, rtol=1e-5,
                               atol=1e-7)
