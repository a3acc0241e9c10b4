"""Pose-graph backend: loop closures + batched Gauss-Newton.

NEW capability beyond the reference (SURVEY §5 "long-context" /
BASELINE stretch config #5): the reference's only loop-closure
mechanism is map re-entry via per-particle maps + hash relocalisation.
Here, a planar pose graph over trajectory keyframes fuses odometry
constraints with loop-closure constraints detected by scan-to-map
alignment, optimised by Gauss-Newton.

Fixed-shape formulation: the graph is SoA (``M`` nodes, ``E`` edges
with validity masks); each GN iteration builds the normal equations
**densely** — scatter-adding 3x3 edge blocks into ``H [3M, 3M]`` and
solving with a dense Cholesky — which keeps trajectory graphs up to
thousands of keyframes one fixed-shape device program instead of a
serial sparse elimination.  For larger graphs a
matrix-free conjugate-gradient path does H-matvecs as segment
reductions (no H materialisation).  Residuals/Jacobians are closed
form and fully vectorised over edges.

Edge model (SE(2)): measurement ``z_ij = (dx, dy, dyaw)`` of node j in
node i's frame; residual ``r = (R_i^T (t_j - t_i) - z_t,
wrap(yaw_j - yaw_i - z_yaw))``, weighted by a 3x3 information matrix.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

# solver-grade contractions: a reduced-precision default (TF32/bf16
# passes) degrades GN/PCG convergence — pin exact f32 (the per-edge
# einsums are tiny; cost is negligible)
_einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def wrap_angle(a):
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["nodes", "node_valid", "edge_i", "edge_j", "edge_z",
                 "edge_info", "edge_valid"],
    meta_fields=[],
)
@dataclasses.dataclass
class PoseGraph:
    nodes: jax.Array       # [M, 3] (x, y, yaw)
    node_valid: jax.Array  # [M] bool
    edge_i: jax.Array      # [E] int32
    edge_j: jax.Array      # [E] int32
    edge_z: jax.Array      # [E, 3] relative measurement
    edge_info: jax.Array   # [E, 3, 3] information matrices
    edge_valid: jax.Array  # [E] bool

    @staticmethod
    def empty(max_nodes, max_edges, dim=3):
        """``dim=3``: planar SE(2) nodes (x, y, yaw).  ``dim=4``: the
        filter's full state manifold SE(2) x R — (x, y, z, yaw), matching
        the reference particle (``PoseParticle.hpp:52-86``); z enters as
        a frame-independent offset (yaw-only rotations)."""
        return PoseGraph(
            nodes=jnp.zeros((max_nodes, dim)),
            node_valid=jnp.zeros((max_nodes,), bool),
            edge_i=jnp.zeros((max_edges,), jnp.int32),
            edge_j=jnp.zeros((max_edges,), jnp.int32),
            edge_z=jnp.zeros((max_edges, dim)),
            edge_info=jnp.zeros((max_edges, dim, dim)),
            edge_valid=jnp.zeros((max_edges,), bool),
        )

    @property
    def dim(self):
        return self.nodes.shape[1]


def edge_residuals(graph: PoseGraph, edge_sl=slice(None)):
    """Residuals [E, D] and Jacobians ([E, D, D] wrt i, [E, D, D] wrt j)
    for D = 3 (x, y, yaw) or 4 (x, y, z, yaw).  ``edge_sl`` restricts to
    an edge subset (the shard-local slice in distributed solves)."""
    d = graph.dim
    ei = graph.edge_i[edge_sl]
    ej = graph.edge_j[edge_sl]
    ez = graph.edge_z[edge_sl]
    pi = graph.nodes[ei]
    pj = graph.nodes[ej]
    yaw_c = d - 1  # yaw is always the last component
    ci, si = jnp.cos(pi[:, yaw_c]), jnp.sin(pi[:, yaw_c])
    dt = pj[:, :2] - pi[:, :2]
    # R_i^T dt
    lx = ci * dt[:, 0] + si * dt[:, 1]
    ly = -si * dt[:, 0] + ci * dt[:, 1]
    r_yaw = wrap_angle(pj[:, yaw_c] - pi[:, yaw_c] - ez[:, yaw_c])
    zeros = jnp.zeros_like(ci)
    ones = jnp.ones_like(ci)

    rows = [lx - ez[:, 0], ly - ez[:, 1]]
    # d r / d (xi, yi, [zi,] yawi) — row-major per residual row
    ji_rows = [
        [-ci, -si] + ([zeros] if d == 4 else []) + [-si * dt[:, 0] + ci * dt[:, 1]],
        [si, -ci] + ([zeros] if d == 4 else []) + [-ci * dt[:, 0] - si * dt[:, 1]],
    ]
    jj_rows = [
        [ci, si] + ([zeros] if d == 4 else []) + [zeros],
        [-si, ci] + ([zeros] if d == 4 else []) + [zeros],
    ]
    if d == 4:
        rows.append(pj[:, 2] - pi[:, 2] - ez[:, 2])
        ji_rows.append([zeros, zeros, -ones, zeros])
        jj_rows.append([zeros, zeros, ones, zeros])
    rows.append(r_yaw)
    ji_rows.append([zeros] * (d - 1) + [-ones])
    jj_rows.append([zeros] * (d - 1) + [ones])

    r = jnp.stack(rows, axis=-1)
    ji = jnp.stack([jnp.stack(row, -1) for row in ji_rows], axis=-2)
    jj = jnp.stack([jnp.stack(row, -1) for row in jj_rows], axis=-2)
    return r, ji, jj


def robust_edge_weights(graph: PoseGraph, kind="huber", delta=1.0):
    """Per-edge robust reweighting factors (iteratively-reweighted GN).

    ``kind='huber'``: w = min(1, delta / sqrt(chi2_e)) — linear tail.
    ``kind='dcs'``: Dynamic Covariance Scaling, w = min(1,
    (2*delta / (delta + chi2_e))^2) — saturates spurious closures to
    ~zero influence instead of a linear tail (Agarwal et al. 2013).
    Applied by both solvers when ``robust=`` is set: each GN iteration
    rescales the edge information matrices by these factors.
    """
    r, _, _ = edge_residuals(graph)
    chi2_e = _einsum("ei,eij,ej->e", r, graph.edge_info, r)
    if kind == "huber":
        w = jnp.minimum(1.0, delta / jnp.sqrt(jnp.maximum(chi2_e, 1e-12)))
    elif kind == "dcs":
        w = jnp.minimum(1.0, (2.0 * delta / (delta + chi2_e)) ** 2)
    else:
        raise ValueError(f"unknown robust kernel {kind!r}")
    return jnp.where(graph.edge_valid, w, 1.0)


def _apply_delta(graph: PoseGraph, delta, fix_mask):
    d = graph.dim
    free = graph.node_valid
    if fix_mask is not None:
        free = free & ~fix_mask
    delta = jnp.where(free[:, None], delta, 0.0)
    nodes = graph.nodes + delta
    nodes = nodes.at[:, d - 1].set(wrap_angle(nodes[:, d - 1]))
    return dataclasses.replace(graph, nodes=nodes)


def _pin_diag(graph: PoseGraph, fix_first, fix_mask):
    """Gauge/constraint pinning weights [M]: large values freeze a node
    (gauge anchor, invalid slots, and the incremental-solve fixed set)."""
    m = graph.nodes.shape[0]
    diag_pin = jnp.zeros((m,), graph.nodes.dtype)
    if fix_first:
        diag_pin = diag_pin.at[0].set(1e9)
    diag_pin = jnp.where(graph.node_valid, diag_pin, 1e9)
    if fix_mask is not None:
        diag_pin = jnp.where(fix_mask, 1e9, diag_pin)
    return diag_pin


def _robustified(graph: PoseGraph, robust, delta):
    if robust is None:
        return graph
    w = robust_edge_weights(graph, robust, delta)
    return dataclasses.replace(
        graph, edge_info=graph.edge_info * w[:, None, None]
    )


def gauss_newton_step(graph: PoseGraph, damping=1e-6, fix_first=True,
                      fix_mask=None, robust=None, robust_delta=1.0):
    """One dense GN step (Cholesky over the [D*M, D*M] normal
    matrix).  ``fix_mask [M]`` freezes nodes (incremental re-solves
    touch only the affected suffix of the trajectory).  ``robust``:
    'huber' / 'dcs' iteratively-reweighted edge information (outlier
    closures lose influence).  Returns ``(graph', chi2_before)``."""
    out_graph = graph
    graph = _robustified(graph, robust, robust_delta)
    m = graph.nodes.shape[0]
    d = graph.dim
    r, ji, jj = edge_residuals(graph)
    w = graph.edge_valid[:, None, None].astype(r.dtype)
    info = graph.edge_info * w

    chi2 = jnp.sum(
        _einsum("ei,eij,ej->e", r, graph.edge_info, r)
        * graph.edge_valid
    )

    # block contributions
    hii = _einsum("eki,ekl,elj->eij", ji, info, ji)
    hij = _einsum("eki,ekl,elj->eij", ji, info, jj)
    hjj = _einsum("eki,ekl,elj->eij", jj, info, jj)
    bi = _einsum("eki,ekl,el->ei", ji, info, r)
    bj = _einsum("eki,ekl,el->ei", jj, info, r)

    h = jnp.zeros((m, m, d, d), r.dtype)
    h = h.at[graph.edge_i, graph.edge_i].add(hii)
    h = h.at[graph.edge_i, graph.edge_j].add(hij)
    h = h.at[graph.edge_j, graph.edge_i].add(
        jnp.swapaxes(hij, -1, -2)
    )
    h = h.at[graph.edge_j, graph.edge_j].add(hjj)
    b = jnp.zeros((m, d), r.dtype)
    b = b.at[graph.edge_i].add(bi)
    b = b.at[graph.edge_j].add(bj)

    hd = jnp.transpose(h, (0, 2, 1, 3)).reshape(d * m, d * m)
    bd = b.reshape(d * m)

    pin = jnp.repeat(_pin_diag(graph, fix_first, fix_mask), d)
    hd = hd + jnp.diag(pin + damping)

    delta = jax.scipy.linalg.solve(hd, -bd, assume_a="pos")
    return _apply_delta(out_graph, delta.reshape(m, d), fix_mask), chi2


def optimize(graph: PoseGraph, iters=10, damping=1e-6, fix_mask=None,
             robust=None, robust_delta=1.0):
    """Run ``iters`` GN steps inside ``lax.scan``; returns
    ``(graph, chi2_history [iters])``."""

    def step(g, _):
        g2, chi2 = gauss_newton_step(
            g, damping, fix_mask=fix_mask, robust=robust,
            robust_delta=robust_delta,
        )
        return g2, chi2

    graph, hist = jax.lax.scan(step, graph, None, length=iters)
    return graph, hist


# --------------------------------------------------------------------------
# Matrix-free distributed solver (edge-parallel block-Jacobi PCG)
# --------------------------------------------------------------------------

def _edge_terms(graph: PoseGraph, edge_sl=slice(None)):
    """Per-edge residuals/Jacobians/weighted info for a (shard-local)
    edge slice."""
    r, ji, jj = edge_residuals(graph, edge_sl)
    w = graph.edge_valid[edge_sl][:, None, None].astype(r.dtype)
    info = graph.edge_info[edge_sl] * w
    return r, ji, jj, info


def _scatter_nodes(m, d, ei, ej, vi, vj, dtype):
    out = jnp.zeros((m, d), dtype)
    out = out.at[ei].add(vi)
    out = out.at[ej].add(vj)
    return out


def gauss_newton_step_cg(graph: PoseGraph, damping=1e-6, fix_first=True,
                         fix_mask=None, cg_iters=32, mesh=None,
                         robust=None, robust_delta=1.0):
    """One GN step with a **matrix-free block-Jacobi PCG** inner solve —
    H is never materialised; each H-matvec is an edge-parallel pass
    (gather node values at edge endpoints -> per-edge D x D block
    products -> scatter-add).  With ``mesh`` the edges shard over the
    ``('dp',)`` axis inside ``shard_map``: every device computes the
    matvec partial for its edges and a ``psum`` completes it —
    the trajectory-dimension distributed solve SURVEY §5 calls for
    (scales past the dense Cholesky's [D*M]^2 memory at large M).

    Requires the edge capacity to divide the mesh size.  Returns
    ``(graph', chi2_before)``; identical math to ``gauss_newton_step``
    up to CG tolerance.
    """
    out_graph = graph
    graph = _robustified(graph, robust, robust_delta)
    m = graph.nodes.shape[0]
    d = graph.dim
    pin = _pin_diag(graph, fix_first, fix_mask) + damping

    def solve_local(graph, edge_sl=slice(None), psum=lambda x: x):
        r, ji, jj, info = _edge_terms(graph, edge_sl)
        ei = graph.edge_i[edge_sl]
        ej = graph.edge_j[edge_sl]
        chi2 = psum(jnp.sum(
            _einsum("ei,eij,ej->e", r, info, r)
        ))

        # b = J^T W r
        bi = _einsum("eki,ekl,el->ei", ji, info, r)
        bj = _einsum("eki,ekl,el->ei", jj, info, r)
        b = psum(_scatter_nodes(m, d, ei, ej, bi, bj, r.dtype))

        # block-diagonal of H for the preconditioner
        hii = _einsum("eki,ekl,elj->eij", ji, info, ji)
        hjj = _einsum("eki,ekl,elj->eij", jj, info, jj)
        diag = jnp.zeros((m, d, d), r.dtype)
        diag = diag.at[ei].add(hii)
        diag = diag.at[ej].add(hjj)
        diag = psum(diag)
        diag = diag + (pin[:, None, None]
                       * jnp.eye(d, dtype=r.dtype)[None])
        pre = jnp.linalg.inv(diag)                      # [M, D, D]

        def matvec(x):
            xi = x[ei]
            xj = x[ej]
            # y_e = W (Ji xi + Jj xj); scatter Ji^T y, Jj^T y
            ye = _einsum(
                "ekl,el->ek", info,
                _einsum("ekj,ej->ek", ji, xi)
                + _einsum("ekj,ej->ek", jj, xj),
            )
            vi = _einsum("eki,ek->ei", ji, ye)
            vj = _einsum("eki,ek->ei", jj, ye)
            out = psum(_scatter_nodes(m, d, ei, ej, vi, vj, x.dtype))
            return out + pin[:, None] * x

        apply_pre = lambda v: _einsum("mij,mj->mi", pre, v)

        # PCG for H delta = -b
        x0 = jnp.zeros((m, d), r.dtype)
        r0 = -b
        z0 = apply_pre(r0)
        p0 = z0

        def body(carry, _):
            x, rr, z, p = carry
            hp = matvec(p)
            rz = jnp.sum(rr * z)
            alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-30)
            x = x + alpha * p
            r_new = rr - alpha * hp
            z_new = apply_pre(r_new)
            beta = jnp.sum(r_new * z_new) / jnp.maximum(rz, 1e-30)
            p_new = z_new + beta * p
            return (x, r_new, z_new, p_new), ()

        (delta, *_), _ = jax.lax.scan(
            body, (x0, r0, z0, p0), None, length=cg_iters
        )
        return delta, chi2

    if mesh is None:
        delta, chi2 = solve_local(graph)
    else:
        from jax.sharding import PartitionSpec as P

        def local(ei, ej, ez, einfo, evalid):
            g = dataclasses.replace(
                graph, edge_i=ei, edge_j=ej, edge_z=ez,
                edge_info=einfo, edge_valid=evalid,
            )
            axis = "dp"
            psum = lambda x: jax.lax.psum(x, axis)
            delta, chi2 = solve_local(g, psum=psum)
            return delta, chi2[None]

        delta, chi2 = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
            out_specs=(P(), P("dp")),
        )(graph.edge_i, graph.edge_j, graph.edge_z, graph.edge_info,
          graph.edge_valid)
        chi2 = chi2[0]

    return _apply_delta(out_graph, delta, fix_mask), chi2


def optimize_cg(graph: PoseGraph, iters=10, damping=1e-6, fix_mask=None,
                cg_iters=32, mesh=None, robust=None, robust_delta=1.0):
    """``optimize`` with the matrix-free (optionally mesh-distributed)
    PCG inner solver."""

    def step(g, _):
        g2, chi2 = gauss_newton_step_cg(
            g, damping, fix_mask=fix_mask, cg_iters=cg_iters, mesh=mesh,
            robust=robust, robust_delta=robust_delta,
        )
        return g2, chi2

    graph, hist = jax.lax.scan(step, graph, None, length=iters)
    return graph, hist


# --------------------------------------------------------------------------
# Schur-complement trajectory partitioning (node-axis distributed GN)
# --------------------------------------------------------------------------

def _schur_structure(graph: PoseGraph, segments, boundary_cap):
    """Classify nodes for a ``segments``-way contiguous trajectory
    partition.

    A node is **boundary** iff some valid edge crosses segments at it
    (for a trajectory chain these are the segment seams; every loop
    closure promotes its two endpoints).  All other coupling stays
    interior to one segment, so the interior-interior normal-equation
    block is block-diagonal over segments — the classic domain
    decomposition that makes the node axis shardable.

    Returns ``(seg [M], boundary [M] bool, gb [M] int32 boundary slot
    or OOB, n_boundary [])``.
    """
    m = graph.nodes.shape[0]
    assert m % segments == 0, "segments must divide the node capacity"
    nl = m // segments
    seg = jnp.arange(m, dtype=jnp.int32) // nl
    cross = (seg[graph.edge_i] != seg[graph.edge_j]) & graph.edge_valid
    boundary = jnp.zeros((m,), bool)
    boundary = boundary.at[graph.edge_i].max(cross)
    boundary = boundary.at[graph.edge_j].max(cross)
    # stable global boundary slots (cumsum order); overflow -> OOB slot
    rank = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    n_boundary = jnp.sum(boundary)
    gb = jnp.where(boundary & (rank < boundary_cap), rank, boundary_cap)
    gb = gb.astype(jnp.int32)
    return seg, boundary, gb, n_boundary


def gauss_newton_step_schur(graph: PoseGraph, segments=4,
                            boundary_cap=64, damping=1e-6,
                            fix_first=True, fix_mask=None, mesh=None,
                            robust=None, robust_delta=1.0):
    """One GN step via **Schur-complement trajectory partitioning**.

    The trajectory's node axis splits into ``segments`` contiguous
    blocks; boundary nodes (segment seams + loop-closure endpoints, at
    most ``boundary_cap``) are eliminated last:

    1. per-segment dense interior systems ``A_II^s`` factor
       independently (batched Cholesky — [S, NL*D, NL*D], never a
       global [M*D, M*D] matrix),
    2. the small boundary system ``S_BB = A_BB - sum_s A_BI (A_II)^-1
       A_IB`` reduces across segments (``psum`` when ``mesh``
       shards the segment axis),
    3. back-substitution recovers interior deltas segment-locally.

    This is the node-axis distributed solve (SURVEY §5 long-context
    analog / BASELINE stretch): memory and factor work scale as
    ``M^2 / S^2`` per device instead of the dense solver's ``M^2``.
    Exact (up to roundoff) — matches ``gauss_newton_step``.
    Returns ``(graph', chi2_before)``.
    """
    out_graph = graph
    graph = _robustified(graph, robust, robust_delta)
    m = graph.nodes.shape[0]
    d = graph.dim
    s_n = segments
    nl = m // s_n
    nb = boundary_cap
    seg, boundary, gb, _ = _schur_structure(graph, s_n, nb)
    li = jnp.arange(m, dtype=jnp.int32) % nl   # slot within segment
    pin = _pin_diag(graph, fix_first, fix_mask) + damping

    r, ji, jj, info = _edge_terms(graph)
    ei, ej = graph.edge_i, graph.edge_j
    chi2 = jnp.sum(_einsum("ei,eij,ej->e", r, info, r))

    hii = _einsum("eki,ekl,elj->eij", ji, info, ji)
    hij = _einsum("eki,ekl,elj->eij", ji, info, jj)
    hjj = _einsum("eki,ekl,elj->eij", jj, info, jj)
    bi = _einsum("eki,ekl,el->ei", ji, info, r)
    bj = _einsum("eki,ekl,el->ei", jj, info, r)

    bnd_i, bnd_j = boundary[ei], boundary[ej]
    seg_i, seg_j = seg[ei], seg[ej]
    li_i, li_j = li[ei], li[ej]

    def route(node_bnd, s_idx, l_idx, g_idx, drop):
        """(segment, interior-slot) or boundary-slot targets; entries
        with ``drop`` scatter out of bounds."""
        ii = jnp.where(drop | node_bnd, s_n, s_idx)     # OOB segment
        il = jnp.where(drop | node_bnd, nl, l_idx)
        ib = jnp.where(drop | ~node_bnd, nb, g_idx)
        return ii, il, ib

    drop = ~graph.edge_valid
    si_seg, si_li, si_gb = route(bnd_i, seg_i, li_i, gb[ei], drop)
    sj_seg, sj_li, sj_gb = route(bnd_j, seg_j, li_j, gb[ej], drop)

    # ---- assemble the partitioned blocks (all scatters mode='drop')
    a_ii = jnp.zeros((s_n, nl, nl, d, d), r.dtype)
    a_ii = a_ii.at[si_seg, si_li, si_li].add(hii, mode="drop")
    a_ii = a_ii.at[sj_seg, sj_li, sj_li].add(hjj, mode="drop")
    # intra-segment interior-interior coupling
    a_ii = a_ii.at[si_seg, si_li, sj_li].add(
        jnp.where((si_seg == sj_seg)[:, None, None], hij, 0.0),
        mode="drop",
    )
    a_ii = a_ii.at[sj_seg, sj_li, si_li].add(
        jnp.where((si_seg == sj_seg)[:, None, None],
                  jnp.swapaxes(hij, -1, -2), 0.0),
        mode="drop",
    )

    a_bb = jnp.zeros((nb, nb, d, d), r.dtype)
    a_bb = a_bb.at[si_gb, si_gb].add(hii, mode="drop")
    a_bb = a_bb.at[sj_gb, sj_gb].add(hjj, mode="drop")
    a_bb = a_bb.at[si_gb, sj_gb].add(hij, mode="drop")
    a_bb = a_bb.at[sj_gb, si_gb].add(
        jnp.swapaxes(hij, -1, -2), mode="drop"
    )

    # interior x boundary coupling [S, NL, NB, D, D]
    a_ib = jnp.zeros((s_n, nl, nb, d, d), r.dtype)
    a_ib = a_ib.at[si_seg, si_li, sj_gb].add(hij, mode="drop")
    a_ib = a_ib.at[sj_seg, sj_li, si_gb].add(
        jnp.swapaxes(hij, -1, -2), mode="drop"
    )

    b_int = jnp.zeros((s_n, nl, d), r.dtype)
    b_int = b_int.at[si_seg, si_li].add(bi, mode="drop")
    b_int = b_int.at[sj_seg, sj_li].add(bj, mode="drop")
    b_bnd = jnp.zeros((nb, d), r.dtype)
    b_bnd = b_bnd.at[si_gb].add(bi, mode="drop")
    b_bnd = b_bnd.at[sj_gb].add(bj, mode="drop")

    # pinning (added on the dense diagonals below): interior slots get
    # their node pin; slots occupied by a boundary node (whose mass
    # lives in A_BB) and padding slots get a unit diagonal so the
    # segment factor stays SPD and their interior delta solves to zero
    pin_ii = jnp.where(boundary, 1.0, pin).reshape(s_n, nl)
    pin_b = jnp.zeros((nb + 1,), r.dtype).at[gb].add(
        jnp.where(boundary, pin, 0.0)
    )[:nb]
    occupied = jnp.zeros((nb + 1,), bool).at[gb].set(True)[:nb]
    pin_b = pin_b + jnp.where(occupied, 0.0, 1.0)

    def dense(a, rows, cols):
        return jnp.transpose(a, (0, 2, 1, 3)).reshape(rows * d, cols * d)

    a_bb_d = dense(a_bb, nb, nb) + jnp.diag(jnp.repeat(pin_b, d))
    b_bnd_d = b_bnd.reshape(nb * d)

    def seg_solve(a_ii_s, a_ib_s, b_s, pin_s):
        """Per-segment: factor A_II, return (Y = A_II^-1 A_IB,
        w = A_II^-1 b_I, and the Schur contributions)."""
        a = jnp.transpose(a_ii_s, (0, 2, 1, 3)).reshape(nl * d, nl * d)
        a = a + jnp.diag(jnp.repeat(pin_s, d))
        c = jnp.transpose(a_ib_s, (0, 2, 1, 3)).reshape(nl * d, nb * d)
        bsd = b_s.reshape(nl * d)
        cf = jax.scipy.linalg.cho_factor(a)
        y = jax.scipy.linalg.cho_solve(cf, c)        # [NL*D, NB*D]
        w = jax.scipy.linalg.cho_solve(cf, bsd)      # [NL*D]
        s_contrib = _einsum("ki,kj->ij", c, y)      # [NB*D, NB*D]
        r_contrib = _einsum("ki,k->i", c, w)        # [NB*D]
        return y, w, s_contrib, r_contrib

    if mesh is None:
        y, w, s_c, r_c = jax.vmap(seg_solve)(a_ii, a_ib, b_int, pin_ii)
        s_bb = a_bb_d - jnp.sum(s_c, axis=0)
        rhs_b = b_bnd_d - jnp.sum(r_c, axis=0)
        delta_b = jax.scipy.linalg.solve(s_bb, -rhs_b, assume_a="pos")
        # back-substitute: delta_I = -w - Y delta_b  (H delta = -b)
        delta_i = -w - _einsum("sij,j->si", y, delta_b)
    else:
        from jax.sharding import PartitionSpec as P

        def local(a_ii_l, a_ib_l, b_l, pin_l):
            y, w, s_c, r_c = jax.vmap(seg_solve)(
                a_ii_l, a_ib_l, b_l, pin_l
            )
            s_bb = a_bb_d - jax.lax.psum(jnp.sum(s_c, 0), "dp")
            rhs_b = b_bnd_d - jax.lax.psum(jnp.sum(r_c, 0), "dp")
            delta_b = jax.scipy.linalg.solve(
                s_bb, -rhs_b, assume_a="pos"
            )
            delta_i = -w - _einsum("sij,j->si", y, delta_b)
            return delta_i, delta_b[None]

        delta_i, delta_b = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
            out_specs=(P("dp"), P()),
        )(a_ii, a_ib, b_int, pin_ii)
        delta_b = delta_b[0]

    # gather the per-node delta: boundary nodes read their slot,
    # interior nodes their segment solution
    delta_i_nodes = delta_i.reshape(s_n, nl, d).reshape(m, d)
    delta_b_nodes = delta_b.reshape(nb, d)[jnp.clip(gb, 0, nb - 1)]
    delta = jnp.where(boundary[:, None], delta_b_nodes, delta_i_nodes)
    return _apply_delta(out_graph, delta, fix_mask), chi2


def optimize_schur(graph: PoseGraph, iters=10, segments=4,
                   boundary_cap=64, damping=1e-6, fix_mask=None,
                   mesh=None, robust=None, robust_delta=1.0):
    """``optimize`` with the Schur-partitioned (optionally node-axis
    mesh-distributed) solver."""

    def step(g, _):
        g2, chi2 = gauss_newton_step_schur(
            g, segments=segments, boundary_cap=boundary_cap,
            damping=damping, fix_mask=fix_mask, mesh=mesh,
            robust=robust, robust_delta=robust_delta,
        )
        return g2, chi2

    graph, hist = jax.lax.scan(step, graph, None, length=iters)
    return graph, hist


# --------------------------------------------------------------------------
# Loop-closure detection by scan-to-map alignment
# --------------------------------------------------------------------------

def scan_align(grid, cloud, xy0, yaw0, z0,
               search_xy=0.5, search_yaw=0.3, steps_xy=9, steps_yaw=7,
               z_window=3.0, sigma=0.2, search_z=0.0, steps_z=1,
               return_ratio=False, ratio_exclusion=0.75):
    """Grid-search alignment of a scan cloud against an MLS grid around
    an initial pose guess — the loop-closure front-end.  Evaluates the
    ``match_cloud`` consistency score over a (dx, dy, dyaw[, dz]) grid
    in one batched sweep (exhaustive correlation instead of
    iterative ICP) and returns ``(best_xy, best_yaw, best_score)``.

    ``search_z``: half-range of a vertical offset sweep.  The believed
    z drifts like everything else; with a sharp ``sigma`` a constant z
    error suppresses the TRUE xy peak and the sweep latches onto false
    overlap maxima — searching dz decouples the vertical drift from
    the lateral alignment (the dz itself is discarded: pose-graph
    edges here are planar).
    """
    from slam_eslam_tpu.mapping import mls_grid

    dxs = jnp.linspace(-search_xy, search_xy, steps_xy)
    dyaws = jnp.linspace(-search_yaw, search_yaw, steps_yaw)
    dzs = (jnp.linspace(-search_z, search_z, steps_z)
           if steps_z > 1 else jnp.zeros((1,)))

    def eval_one(dx, dy, dyaw, dz):
        th = yaw0 + dyaw
        r = jnp.array(
            [[jnp.cos(th), -jnp.sin(th)], [jnp.sin(th), jnp.cos(th)]]
        )
        return mls_grid.match_cloud(
            grid, cloud, r, xy0 + jnp.array([dx, dy]), z0 + dz, 0.0,
            sampling=1, sigma=sigma, z_window=z_window,
        )

    # outer (dz, dyaw) axes stream via lax.map: a full 4-axis vmap
    # materialises steps_z*steps_yaw*steps_xy^2 x |cloud| gather
    # intermediates at once — several GB for a 31x31x5x7 sweep over a
    # keyframe submap, which OOMs next to a stretch-scale resident map
    # pool (round-4 50k composition).  Memory now peaks at one
    # (dx, dy) sheet per (dz, dyaw) pair; same values.
    zz, yy = jnp.meshgrid(dzs, dyaws, indexing="ij")

    def sheet(args):
        dz, dyaw = args
        return jax.vmap(
            lambda dx: jax.vmap(
                lambda dy: eval_one(dx, dy, dyaw, dz)
            )(dxs)
        )(dxs)

    scores = jax.lax.map(
        sheet, (zz.reshape(-1), yy.reshape(-1))
    ).reshape(len(dzs), len(dyaws), steps_xy, steps_xy)  # [z, yaw, x, y]
    flat = scores.reshape(-1)
    best = jnp.argmax(flat)
    iy = best % steps_xy
    ixx = (best // steps_xy) % steps_xy
    iyaw = (best // (steps_xy * steps_xy)) % steps_yaw
    out = (
        xy0 + jnp.array([dxs[ixx], dxs[iy]]),
        yaw0 + dyaws[iyaw],
        flat[best],
    )
    if not return_ratio:
        return out
    # peak distinctiveness: best vs the best score at an xy offset more
    # than ``ratio_exclusion`` metres from the peak.  On self-similar
    # terrain partial-overlap false peaks score close to the true
    # match's absolute score (round-4 stretch: false closures at
    # ~5 m offsets scored ~0.3 == true revisits) — a flat score surface
    # is the tell, the absolute value is not.
    k = jnp.arange(flat.shape[0])
    ox = dxs[(k // steps_xy) % steps_xy]
    oy = dxs[k % steps_xy]
    far = ((ox - dxs[ixx]) ** 2 + (oy - dxs[iy]) ** 2
           > ratio_exclusion ** 2)
    second = jnp.max(jnp.where(far, flat, -jnp.inf))
    ratio = flat[best] / jnp.maximum(second, 1e-6)
    return out + (ratio,)


class PoseGraphBuilder:
    """Host-side helper accumulating keyframes + constraints."""

    def __init__(self, max_nodes=256, max_edges=1024, dim=3):
        self.graph = PoseGraph.empty(max_nodes, max_edges, dim=dim)
        self.dim = dim
        self.n_nodes = 0
        self.n_edges = 0

    def add_node(self, pose):
        i = self.n_nodes
        g = self.graph
        self.graph = dataclasses.replace(
            g,
            nodes=g.nodes.at[i].set(jnp.asarray(pose, jnp.float32)),
            node_valid=g.node_valid.at[i].set(True),
        )
        self.n_nodes += 1
        return i

    def add_edge(self, i, j, z, info=None):
        e = self.n_edges
        g = self.graph
        if info is None:
            info = jnp.eye(self.dim) * 100.0
        self.graph = dataclasses.replace(
            g,
            edge_i=g.edge_i.at[e].set(i),
            edge_j=g.edge_j.at[e].set(j),
            edge_z=g.edge_z.at[e].set(jnp.asarray(z, jnp.float32)),
            edge_info=g.edge_info.at[e].set(jnp.asarray(info, jnp.float32)),
            edge_valid=g.edge_valid.at[e].set(True),
        )
        self.n_edges += 1
        return e

    def optimize(self, iters=10, fix_mask=None, solver="dense",
                 cg_iters=32, mesh=None, robust=None, robust_delta=1.0):
        """``solver='dense'``: dense Cholesky; ``'cg'``: matrix-free
        block-Jacobi PCG, optionally mesh-distributed over the edge
        axis.  ``robust``: 'huber'/'dcs' edge reweighting."""
        if solver == "cg":
            fn = jax.jit(
                lambda g, fm: optimize_cg(
                    g, iters, fix_mask=fm, cg_iters=cg_iters, mesh=mesh,
                    robust=robust, robust_delta=robust_delta,
                )
            )
        else:
            fn = jax.jit(
                lambda g, fm: optimize(
                    g, iters, fix_mask=fm, robust=robust,
                    robust_delta=robust_delta,
                )
            )
        self.graph, hist = fn(
            self.graph,
            (jnp.zeros((self.graph.nodes.shape[0],), bool)
             if fix_mask is None else fix_mask),
        )
        return hist
