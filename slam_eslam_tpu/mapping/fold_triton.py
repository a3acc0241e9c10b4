"""Fused exact gather + contact fold as one Pallas kernel (Triton route).

Each program takes a tile of particles and all their contact points
(``[C, T]``), gathers the 2K packed slots of every query's cell with
direct loads from the flat ``PackedLookup`` table, selects the slot
nearest to the query z, and runs the contact fold
(``models.contact_model.contact_fold_sums``) in registers, so only the
``[8, T]`` per-particle rows are written.  The XLA version
(``mapping.lookup.shared_grid_lookup(...).fold``) is its reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from slam_eslam_tpu.models.contact_model import _mills_ratio


def _fold_kernel(x_ref, y_ref, z_ref, act_ref, seg_ref, mv_ref, origin_ref,
                 table_ref, out_ref, *, nx, ny, k, resolution, z_window,
                 correction, n_seg):
    x, y, z = x_ref[...], y_ref[...], z_ref[...]          # [C, T]
    ix = jnp.floor((x - origin_ref[0]) / resolution).astype(jnp.int32)
    iy = jnp.floor((y - origin_ref[1]) / resolution).astype(jnp.int32)
    inb = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    base = jnp.where(inb, (ix * ny + iy) * (2 * k), 0)
    best_d = jnp.full(x.shape, jnp.inf, jnp.float32)
    mean = jnp.zeros(x.shape, jnp.float32)
    stdev = jnp.zeros(x.shape, jnp.float32)
    for s in range(k):
        m = table_ref[base + s]
        sd = table_ref[base + k + s]
        d = jnp.abs(m - z)
        take = (sd >= 0.0) & (d <= z_window) & (d < best_d)
        best_d = jnp.where(take, d, best_d)
        mean = jnp.where(take, m, mean)
        stdev = jnp.where(take, sd, stdev)
    found = inb & (best_d < jnp.inf)

    act = act_ref[...]                                    # [C]
    mv = mv_ref[...]                                      # [T]
    zdiff = z - mean
    pose_var = stdev * stdev
    zvar = pose_var + mv[None, :]
    sig = jnp.sqrt(zvar) * correction
    ratio = _mills_ratio(zdiff / sig) / sig
    contrib = act[:, None] * found.astype(jnp.float32)
    rm = jnp.where(contrib > 0.5, ratio, 0.0)

    seg = seg_ref[...]                                    # [C]
    zero = jnp.zeros(mv.shape, jnp.float32)
    d1, d2, sq, pv, nc = zero, zero, zero, zero, zero
    for s in range(n_seg):
        mcol = (seg == s).astype(jnp.float32)             # [C]
        mm = mcol[:, None]
        rsum = jnp.sum(rm * mm, axis=0)                   # [T]
        zds = jnp.sum(rm * zdiff * mm, axis=0)
        zvs = jnp.sum(rm * zvar * mm, axis=0)
        pvs = jnp.sum(rm * pose_var * mm, axis=0)
        ncb = jnp.sum(contrib * mm, axis=0)
        act_s = jnp.sum(act * mcol)
        ok = (ncb >= act_s - 0.5) & (ncb > 0.5) & (rsum > 1e-9)
        okf = ok.astype(jnp.float32)
        safe = jnp.where(ok, rsum, 1.0)
        czd = jnp.where(ok, zds / safe, 0.0)
        inv = okf * safe / jnp.where(ok, zvs, 1.0)
        d1 = d1 + czd * inv
        d2 = d2 + inv
        sq = sq + czd * czd * inv
        pv = pv + okf * pvs / safe
        nc = nc + okf
    for r, row in enumerate((d1, d2, sq, pv, nc, zero, zero, zero)):
        out_ref[r, :] = row


# Particles per program hold C x T = 4096 fold elements (512 particles
# at C = 8), the load that timed fastest on an H100 at 100k particles
# (PERF.md): at 4 warps, twice that load ran ~1.4x slower than the XLA
# fold and a quarter of it only level with it.
_ELEMS_PER_PROGRAM = 4096
_NUM_WARPS = 4


def _tile(cp, n):
    """Particles per program for ``cp`` (padded) contact rows and ``n``
    particles: ``_ELEMS_PER_PROGRAM / cp``, at least 64, at most
    ``n`` rounded up to a power of two."""
    return min(max(64, _ELEMS_PER_PROGRAM // cp), pl.next_power_of_2(n))


def kernel_wins(c):
    """Whether the kernel beats the XLA fold at ``c`` contact points per
    particle.  On an H100 at 100k particles (PERF.md) it does in one
    8-row block (C = 8: 0.188 vs 0.235 ms per filter step) and loses at
    the full Asguard state (C = 20: 0.699 vs 0.404)."""
    return pl.next_power_of_2(c) == 8


def triton_fold(packed, z_window=3.0, interpret=False):
    """``lookup.gather_fold``'s contract, computed by ``_fold_kernel``.

    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests
    only)."""
    nx, ny, c2 = packed.data.shape
    k = c2 // 2

    def fold(queries, act_col, mv, *, onehot, correction):
        x, y, z = queries
        c, n = x.shape
        cp = pl.next_power_of_2(c)
        tile = _tile(cp, n)
        npad = -(-n // tile) * tile

        def pad(a, fill=0.0):
            return jnp.pad(a, ((0, cp - c), (0, npad - n)),
                           constant_values=fill)

        seg = jnp.where(jnp.any(onehot > 0.5, axis=1),
                        jnp.argmax(onehot, axis=1), -1).astype(jnp.int32)
        seg = jnp.pad(seg, (0, cp - c), constant_values=-1)
        act = jnp.pad(act_col[:, 0].astype(jnp.float32), (0, cp - c))
        mvp = jnp.pad(jnp.broadcast_to(mv, (1, n))[0], (0, npad - n),
                      constant_values=1.0)
        kernel = functools.partial(
            _fold_kernel, nx=nx, ny=ny, k=k,
            resolution=float(packed.resolution), z_window=float(z_window),
            correction=float(correction), n_seg=int(onehot.shape[1]),
        )
        qspec = pl.BlockSpec((cp, tile), lambda i: (0, i))
        table = packed.data.reshape(-1)
        out = pl.pallas_call(
            kernel,
            grid=(npad // tile,),
            in_specs=[
                qspec, qspec, qspec,
                pl.BlockSpec((cp,), lambda i: (0,)),
                pl.BlockSpec((cp,), lambda i: (0,)),
                pl.BlockSpec((tile,), lambda i: (i,)),
                pl.BlockSpec((2,), lambda i: (0,)),
                pl.BlockSpec(table.shape, lambda i: (0,)),
            ],
            out_specs=pl.BlockSpec((8, tile), lambda i: (0, i)),
            out_shape=jax.ShapeDtypeStruct((8, npad), jnp.float32),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name="contact_fold",
        )(pad(x), pad(y), pad(z, 1e9), act, seg, mvp,
          packed.origin.astype(jnp.float32), table)
        return out[:, :n]

    return fold
