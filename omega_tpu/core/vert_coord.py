"""Vertical coordinate (p-star) computations.

Rewrite of ocn/VertCoord.h/.cpp: per-column pressure (top-down
mass sum), z-height (bottom-up specific-volume sum), geopotential (with
tidal-potential and self-attraction/loading hooks), and the p-star target
layer thickness redistribution.

The reference uses hierarchical Kokkos team scans per column
(VertCoord.cpp:654-735); here each becomes one `jnp.cumsum` along the
contiguous K axis — the natural vectorization (SURVEY.md section 2.6: team
scans -> lax cumsum along K).

Variable active-layer bounds (MinLayerCell/MaxLayerCell, VertCoord.h:85-106)
are handled by masking instead of ragged loops: inactive (cell, layer)
entries contribute zero thickness to the scans, and derived edge/vertex
bounds follow the reference's min/max rules (VertCoord.cpp:486-527).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from omega_tpu import constants

GRAVITY = 9.80616   # the reference's hard-wired value (VertCoord.cpp:659)


@dataclasses.dataclass(frozen=True)
class VertCoordConfig:
    """``VertCoord:`` config group."""
    nvertlayers: int = 1
    movement_weight_type: str = "uniform"   # uniform | fixed
    rho0: float = constants.RHO0_SEAWATER

    @classmethod
    def from_yaml(cls, cfg, nvertlayers: int) -> "VertCoordConfig":
        if not cfg.exists("VertCoord"):
            return cls(nvertlayers=nvertlayers)
        v = cfg.get_group("VertCoord")
        return cls(
            nvertlayers=nvertlayers,
            movement_weight_type=v.get_str("MovementWeightType",
                                           "Uniform").lower(),
        )


class LayerBounds(NamedTuple):
    """Active-layer index bounds per element (VertCoord.h:85-106).
    max == -1 marks a fully inactive column."""
    min_cell: jax.Array        # (C,)
    max_cell: jax.Array        # (C,)
    min_edge_top: jax.Array    # (E,)
    max_edge_top: jax.Array
    min_edge_bot: jax.Array
    max_edge_bot: jax.Array
    min_vertex_top: jax.Array  # (V,)
    max_vertex_top: jax.Array
    min_vertex_bot: jax.Array
    max_vertex_bot: jax.Array

    def cell_mask(self, nvert: int) -> jax.Array:
        """(C, K) 1.0 where the layer is active."""
        k = jnp.arange(nvert)
        return ((k[None, :] >= self.min_cell[:, None])
                & (k[None, :] <= self.max_cell[:, None])).astype(jnp.float64)


def layer_bounds(mesh, min_cell, max_cell, nvert: int) -> LayerBounds:
    """Derive edge/vertex bounds from cell bounds (minMaxLayerEdge /
    minMaxLayerVertex, VertCoord.cpp:486-560).

    Top variants span layers where ANY/ALL adjacent columns are active:
    EdgeTop = [min over cells of min, min over cells of max] (both active),
    EdgeBot = [max of min, max of max] (any active). Inactive columns
    (max == -1) are excluded from Top mins and treated as empty.
    """
    nvp1 = nvert + 1
    coe = mesh.cells_on_edge
    cov = mesh.cells_on_vertex

    def pick(bound, idx, inactive_val):
        v = bound[idx]
        dead = max_cell[idx] == -1
        return jnp.where(dead, inactive_val, v)

    min_e = min_cell[coe]                       # (E, 2)
    max_e = max_cell[coe]
    min_edge_top = jnp.min(pick(min_cell, coe, nvp1), axis=1)
    min_edge_bot = jnp.max(pick(min_cell, coe, 0), axis=1)
    max_edge_top = jnp.min(max_e, axis=1)
    max_edge_bot = jnp.max(max_e, axis=1)

    min_vertex_top = jnp.min(pick(min_cell, cov, nvp1), axis=1)
    min_vertex_bot = jnp.max(pick(min_cell, cov, 0), axis=1)
    max_vertex_top = jnp.min(max_cell[cov], axis=1)
    max_vertex_bot = jnp.max(max_cell[cov], axis=1)

    return LayerBounds(min_cell, max_cell, min_edge_top, max_edge_top,
                       min_edge_bot, max_edge_bot, min_vertex_top,
                       max_vertex_top, min_vertex_bot, max_vertex_bot)


def full_depth_bounds(mesh, nvert: int) -> LayerBounds:
    """All layers active everywhere (the all-ocean default)."""
    zmin = jnp.zeros(mesh.ncells, jnp.int32)
    zmax = jnp.full(mesh.ncells, nvert - 1, jnp.int32)
    return layer_bounds(mesh, zmin, zmax, nvert)


# ----------------------------------------------------------------------
def compute_pressure(h, surface_pressure, rho0: float,
                     active_mask=None):
    """Interface + mid pressures by a top-down mass sum
    (VertCoord::computePressure, VertCoord.cpp:654-692).

    h: (C, K) pseudo thickness; surface_pressure: (C,).
    Returns (p_interface (C, K+1), p_mid (C, K)).
    """
    dp = GRAVITY * rho0 * h
    if active_mask is not None:
        dp = dp * active_mask
    cum = jnp.cumsum(dp, axis=-1)
    p_int = surface_pressure[:, None] + jnp.concatenate(
        [jnp.zeros_like(cum[:, :1]), cum], axis=-1)
    p_mid = surface_pressure[:, None] + cum - 0.5 * dp
    return p_int, p_mid


def compute_z_height(h, spec_vol, bottom_depth, rho0: float,
                     active_mask=None):
    """Interface + mid z by a bottom-up sum of rho0 * specvol * h
    (VertCoord::computeZHeight, VertCoord.cpp:700-735).

    Returns (z_interface (C, K+1), z_mid (C, K)); z = -bottom_depth at the
    sea floor.
    """
    dz = rho0 * spec_vol * h
    if active_mask is not None:
        dz = dz * active_mask
    # bottom-up cumulative: reverse, cumsum, reverse
    rev = jnp.flip(dz, axis=-1)
    cum_up = jnp.flip(jnp.cumsum(rev, axis=-1), axis=-1)   # sum k..K-1
    z_int = -bottom_depth[:, None] + jnp.concatenate(
        [cum_up, jnp.zeros_like(cum_up[:, :1])], axis=-1)
    z_mid = -bottom_depth[:, None] + cum_up - 0.5 * dz
    return z_int, z_mid


def compute_geopotential(z_mid, tidal_potential=None,
                         self_attraction=None):
    """Geopotential at layer midpoints (VertCoord::computeGeopotential,
    VertCoord.cpp:743-782). Tidal potential and SAL are default-off hooks."""
    phi = GRAVITY * z_mid
    if tidal_potential is not None:
        phi = phi + tidal_potential[:, None]
    if self_attraction is not None:
        phi = phi + self_attraction[:, None]
    return phi


def compute_target_thickness(p_int, ref_thickness, movement_weights,
                             active_mask, rho0: float = constants.RHO0_SEAWATER):
    """p-star target layer thickness (VertCoord::computeTargetThickness,
    VertCoord.cpp:790-840): redistribute the column's total pseudo
    thickness over layers proportionally to movement weights.

        target_k = ref_k * (1 + coeff * w_k / sum(w_j ref_j))
        coeff    = (p_bot - p_top)/(g rho0) - sum(ref_j)

    movement_weights: (K,) per-layer weights (uniform by default).
    """
    ref = ref_thickness * active_mask
    w = movement_weights[None, :] * active_mask
    col_mass = (p_int[:, -1] - p_int[:, 0]) / (GRAVITY * rho0)
    sum_ref = jnp.sum(ref, axis=-1)
    sum_wh = jnp.sum(w * ref_thickness, axis=-1)
    coeff = col_mass - sum_ref
    target = ref_thickness * (1.0 + coeff[:, None] * movement_weights[None, :]
                              / jnp.where(sum_wh > 0, sum_wh, 1.0)[:, None])
    return target * active_mask


def remap_piecewise_constant(h_old, h_new, q):
    """Conservative donor-cell vertical remap of a layer-mean quantity.

    q (..., K) are layer means on thicknesses h_old; returns layer means
    on h_new (same column totals). The cumulative content function
    F(z) = integral of q dz' is piecewise linear for piecewise-constant
    q, so new-layer contents are exact interval integrals:
    F interpolated at the new interfaces, differenced, divided by h_new.
    This is the vertical-remap building block of the p-star
    redistribution (VertCoord.cpp:785-840 computes the targets; the
    remap itself is roadmap in the reference)."""
    zero = jnp.zeros_like(h_old[..., :1])
    zo = jnp.concatenate([zero, jnp.cumsum(h_old, axis=-1)], axis=-1)
    zn = jnp.concatenate([zero, jnp.cumsum(h_new, axis=-1)], axis=-1)
    F = jnp.concatenate([zero, jnp.cumsum(q * h_old, axis=-1)], axis=-1)

    def col(znc, zoc, Fc):
        return jnp.interp(znc, zoc, Fc)

    for _ in range(q.ndim - 1):
        col = jax.vmap(col)
    Fn = col(zn, zo, F)
    dF = Fn[..., 1:] - Fn[..., :-1]
    return jnp.where(h_new > 0, dF / jnp.where(h_new > 0, h_new, 1.0),
                     q)


def make_pstar_phase(mesh, ref_thickness, weights, active_mask=None,
                     rho0: float = constants.RHO0_SEAWATER):
    """Per-step p-star redistribution phase (config VertCoord.PStarEnable).

    Returns state -> state: recompute interface pressure from the
    current thickness, redistribute the column mass onto the target
    layers (computeTargetThickness, VertCoord.cpp:785-840), and
    conservatively remap tracers (cell columns) and normal velocity
    (edge columns, with 2-cell-mean edge thickness) onto the new
    layers. Volume and tracer content per column are conserved exactly
    (the remap is an exact interval integral)."""
    from omega_tpu.ops import trisk

    ref = jnp.asarray(ref_thickness)
    w = jnp.asarray(weights)
    mask = (jnp.ones_like(ref) if active_mask is None
            else jnp.asarray(active_mask))

    def phase(state):
        h = state.h
        p_int, _ = compute_pressure(h, jnp.zeros(h.shape[0], h.dtype),
                                    rho0, mask)
        target = compute_target_thickness(p_int, ref, w, mask, rho0)
        tr_new = jax.vmap(lambda q: remap_piecewise_constant(h, target, q)
                          )(state.tracers)
        # 2-cell edge mean via the streaming stencil path (row gathers
        # of (N, K) fields are 10-15x slower; steppers._mix uses the
        # same helper for the same quantity)
        he_old = trisk.cell_mean_on_edge(mesh, h)
        he_new = trisk.cell_mean_on_edge(mesh, target)
        u_new = remap_piecewise_constant(he_old, he_new, state.u)
        return type(state)(h=target, u=u_new, tracers=tr_new)

    return phase


def movement_weights(cfg: VertCoordConfig) -> np.ndarray:
    """VertCoordMovementWeights from config (initMovementWeights,
    VertCoord.cpp:620-646): 'uniform' weights every layer equally; 'fixed'
    puts all movement in the top layer."""
    K = cfg.nvertlayers
    if cfg.movement_weight_type == "uniform":
        return np.ones(K)
    if cfg.movement_weight_type == "fixed":
        w = np.zeros(K)
        w[0] = 1.0
        return w
    raise ValueError(f"unknown MovementWeightType "
                     f"{cfg.movement_weight_type!r}")
