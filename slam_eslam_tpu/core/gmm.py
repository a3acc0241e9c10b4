"""Weighted 2-D Gaussian-mixture fitting (EM).

Rebuilds the capability of envire's ``GaussianMixture`` used for the
exported pose distribution (``/root/reference/src/PoseParticle.hpp:
88-114``: a 2-D GMM over the particle cloud, rendered as uncertainty
ellipses by the viz layer).  Fixed component count + fixed iteration
count so the whole fit is one jittable ``lax.scan``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from functools import partial as _partial

# exact f32 statistics (no TF32/bf16 rounding of the operands)
_einsum = _partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def fit_gmm(key, xy, weights, n_components=3, n_iters=25, min_var=1e-6):
    """Weighted EM fit of ``n_components`` Gaussians to 2-D points.

    Returns ``(means [K, 2], covs [K, 2, 2], mix [K], resp [N, K])``.
    Degenerate inputs (all weight on one point) collapse components onto
    it with ``min_var`` floors.
    """
    n = xy.shape[0]
    w = weights / jnp.maximum(jnp.sum(weights), 1e-30)

    # init: farthest-point (k-means++-style) means — random init can
    # drop every seed into one mode and EM then collapses onto the
    # global mean; covariances start at a fraction of the global spread
    first = jax.random.choice(key, n, (), p=w)
    means0 = jnp.zeros((n_components, 2), xy.dtype).at[0].set(xy[first])

    def pick(k, means):
        # distance to the nearest already-chosen mean (unset slots
        # masked with +inf)
        d2 = jnp.sum((xy[:, None, :] - means[None, :, :]) ** 2, axis=-1)
        d2 = d2 + jnp.where(
            jnp.arange(n_components)[None, :] < k, 0.0, jnp.inf
        )
        nxt = jnp.argmax(w * jnp.min(d2, axis=1))
        return means.at[k].set(xy[nxt])

    for k in range(1, n_components):
        means0 = pick(k, means0)

    mu = jnp.sum(xy * w[:, None], axis=0)
    d = xy - mu
    glob_cov = _einsum("n,ni,nj->ij", w, d, d) + jnp.eye(2) * min_var
    covs0 = jnp.broadcast_to(
        glob_cov / (n_components**2), (n_components, 2, 2)
    )
    mix0 = jnp.full((n_components,), 1.0 / n_components)

    def log_gauss(x, mean, cov):
        diff = x - mean
        inv = jnp.linalg.inv(cov)
        logdet = jnp.log(jnp.maximum(jnp.linalg.det(cov), 1e-30))
        return -0.5 * (
            _einsum("ni,ij,nj->n", diff, inv, diff)
            + logdet + 2.0 * jnp.log(2.0 * jnp.pi)
        )

    def em_step(carry, _):
        means, covs, mix = carry
        # E: responsibilities
        logp = jax.vmap(
            lambda m, c, px: log_gauss(xy, m, c) + jnp.log(
                jnp.maximum(px, 1e-30)
            ),
            in_axes=(0, 0, 0),
        )(means, covs, mix)                         # [K, N]
        logp = logp - jax.scipy.special.logsumexp(logp, axis=0)
        resp = jnp.exp(logp) * w[None, :]           # [K, N] weighted
        nk = jnp.sum(resp, axis=1)                  # [K]
        safe_nk = jnp.maximum(nk, 1e-30)
        # M: update
        means = jnp.dot(resp, xy,
                        precision=jax.lax.Precision.HIGHEST) / safe_nk[:, None]
        diff = xy[None, :, :] - means[:, None, :]   # [K, N, 2]
        covs = _einsum("kn,kni,knj->kij", resp, diff, diff) / safe_nk[
            :, None, None
        ] + jnp.eye(2) * min_var
        mix = nk / jnp.maximum(jnp.sum(nk), 1e-30)
        return (means, covs, mix), None

    (means, covs, mix), _ = jax.lax.scan(
        em_step, (means0, covs0, mix0), None, length=n_iters
    )

    logp = jax.vmap(
        lambda m, c, px: log_gauss(xy, m, c) + jnp.log(jnp.maximum(px, 1e-30)),
        in_axes=(0, 0, 0),
    )(means, covs, mix)
    logp = logp - jax.scipy.special.logsumexp(logp, axis=0)
    return means, covs, mix, jnp.exp(logp).T
