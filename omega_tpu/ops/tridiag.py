"""Batched tridiagonal solvers for implicit vertical mixing.

Rewrite of base/TriDiagSolvers.h: the reference picks Thomas
(sequential, CPU) or PCR (parallel cyclic reduction, GPU) at compile time
(TriDiagSolvers.h:28-35) with team-scratch batching over VecLength columns.
Here both are whole-array algorithms over (..., K) batches with K the
contiguous last axis:

  * `thomas`   — lax.scan along K (two sweeps); minimal flops, serial in K
  * `pcr`      — ceil(log2 K) fused elementwise sweeps, no K-serial
                 dependency (each sweep is a shift + FMA over the
                 whole (batch, K) block)

plus the diffusion-specialized form of the reference
(ThomasDiffusionSolver / PCRDiffusionSolver, TriDiagSolvers.h:262,363):
systems  (H_k + G_k + G_{k-1}) x_k - G_{k-1} x_{k-1} - G_k x_{k+1} = b_k
parameterized by coupling G >= 0 and diagonal mass H > 0, which arise from
implicit vertical diffusion and are solved without cancellation.

All solvers treat the K axis as the LAST axis and batch over any leading
axes.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def thomas(dl, d, du, b):
    """Thomas algorithm, batched over leading axes; K is the last axis.

    dl[..., 0] and du[..., K-1] are ignored. Returns x with d*x = b in the
    tridiagonal sense. (ThomasSolver::solve, TriDiagSolvers.h:79-104.)
    """
    dl, d, du, b = jnp.broadcast_arrays(dl, d, du, b)
    K = d.shape[-1]
    # move K to the front for scan
    dlT = jnp.moveaxis(dl, -1, 0)
    dT = jnp.moveaxis(d, -1, 0)
    duT = jnp.moveaxis(du, -1, 0)
    bT = jnp.moveaxis(b, -1, 0)

    def fwd(carry, inp):
        d_prev, b_prev = carry
        dl_k, d_k, du_km1, b_k = inp
        w = dl_k / d_prev
        d_new = d_k - w * du_km1
        b_new = b_k - w * b_prev
        return (d_new, b_new), (d_new, b_new)

    (_, _), (d_mod, b_mod) = jax.lax.scan(
        fwd, (dT[0], bT[0]),
        (dlT[1:], dT[1:], duT[:-1], bT[1:]))
    d_all = jnp.concatenate([dT[:1], d_mod], axis=0)
    b_all = jnp.concatenate([bT[:1], b_mod], axis=0)

    def back(x_next, inp):
        d_k, b_k, du_k = inp
        x = (b_k - du_k * x_next) / d_k
        return x, x

    x_last = b_all[-1] / d_all[-1]
    _, xs = jax.lax.scan(back, x_last,
                         (d_all[:-1], b_all[:-1], duT[:-1]), reverse=True)
    x = jnp.concatenate([xs, x_last[None]], axis=0)
    return jnp.moveaxis(x, 0, -1)


def _shift(x, offset, fill):
    """x[..., k + offset] with out-of-range entries replaced by fill."""
    K = x.shape[-1]
    if offset == 0:
        return x
    pad = jnp.full_like(x[..., :1], fill)
    if offset > 0:
        return jnp.concatenate(
            [x[..., offset:], jnp.repeat(pad, offset, axis=-1)], axis=-1)
    return jnp.concatenate(
        [jnp.repeat(pad, -offset, axis=-1), x[..., :offset]], axis=-1)


def pcr(dl, d, du, b):
    """Parallel cyclic reduction: log2(K) whole-array sweeps.

    Out-of-range neighbor rows act as identity equations (a=c=0, b=1, d=0),
    so no power-of-two padding is needed. (PCRSolver, TriDiagSolvers.h:138.)
    """
    a, bb, c, x = jnp.broadcast_arrays(dl, d, du, b)
    K = x.shape[-1]
    # normalize ignored corners so out-of-range refs are true identities
    a = a.at[..., 0].set(0.0)
    c = c.at[..., K - 1].set(0.0)
    levels = math.ceil(math.log2(K)) if K > 1 else 0
    s = 1
    for _ in range(levels):
        alpha = -a / _shift(bb, -s, 1.0)
        beta = -c / _shift(bb, +s, 1.0)
        a_new = alpha * _shift(a, -s, 0.0)
        c_new = beta * _shift(c, +s, 0.0)
        b_new = bb + alpha * _shift(c, -s, 0.0) + beta * _shift(a, +s, 0.0)
        x_new = x + alpha * _shift(x, -s, 0.0) + beta * _shift(x, +s, 0.0)
        a, bb, c, x = a_new, b_new, c_new, x_new
        s *= 2
    return x / bb


def implicit_diffusion_matrix(g, h):
    """Map the diffusion form (G, H) to (dl, d, du):
    row k: -G_{k-1} x_{k-1} + (H_k + G_k + G_{k-1}) x_k - G_k x_{k+1}."""
    g_km1 = _shift(g, -1, 0.0)
    dl = -g_km1
    d = h + g + g_km1
    du = -g
    return dl, d, du


def diffusion_solve(g, h, b, method: str = "pcr"):
    """Solve the diffusion-form system (ThomasDiffusionSolver /
    PCRDiffusionSolver). g[..., K-1] must be 0 (no flux through bottom)."""
    dl, d, du = implicit_diffusion_matrix(g, h)
    if method == "thomas":
        return thomas(dl, d, du, b)
    return pcr(dl, d, du, b)
