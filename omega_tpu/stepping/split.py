"""Split-explicit barotropic/baroclinic time stepping.

The reference roadmap defers this to Omega-2.0 (doc/design/
OmegaV1GoverningEqns.md:29; doc/design/TimeStepping.md only sketches the
extensible-stepper design), so this follows established MPAS-Ocean
practice (Ringler et al. 2013, Ocean Modelling 69): the fast external
gravity wave — speed sqrt(g H), which sets the explicit CFL of the
unsplit steppers — is integrated with many cheap barotropic (depth-
averaged) subcycles per baroclinic step, while the full 3D tendencies
advance once with the long step.

Per step of length dt with M subcycles:
  1. split u = ubar + u' (thickness-weighted depth average on edges)
  2. full velocity tendency G at the current state; its depth average
     minus the SSH-gradient part is the slow barotropic forcing, held
     fixed through the subcycles
  3. M forward-backward barotropic subcycles of (ubar, ssh) with
     d(ubar)/dt = -g grad(ssh) + Gbar_slow,
     d(ssh)/dt  = -div(H_edge ubar)                    [lax.scan]
     accumulating the time-averaged <ubar>
  4. baroclinic update u' += dt (G - depth_avg(G))
  5. recombine u = u' + ubar_final; thickness and tracers advect with
     the transport velocity u' + <ubar> so the layer-sum of thickness
     fluxes is consistent with the subcycled free surface

The subcycle loop is a lax.scan over cheap (C/E, 1)-depth barotropic
fields, so it costs O(M * 2D traffic) beside the 3D work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from omega_tpu.core import aux as auxmod
from omega_tpu.core import tendencies as tend_mod
from omega_tpu.core.config import ModelConfig
from omega_tpu.core.state import ModelState
from omega_tpu.mesh.horz_mesh import HorzMesh
from omega_tpu.ops import trisk
from omega_tpu.stepping.steppers import Halo, _identity, _mix


def _depth_avg_edge(h_edge, x):
    """Thickness-weighted depth average of an edge field: (E, K) -> (E, 1)."""
    ht = jnp.sum(h_edge, axis=-1, keepdims=True)
    return jnp.sum(h_edge * x, axis=-1, keepdims=True) / ht


def split_forward_backward_step(mesh: HorzMesh, cfg: ModelConfig,
                                state: ModelState, t, dt,
                                halo: Halo = _identity, wind_stress=None,
                                n_subcycles: int = 10,
                                bt_drag: float = 0.0) -> ModelState:
    """One split-explicit step (barotropic FB subcycling inside).

    The fast system re-evaluates the SSH gradient AND the barotropic
    Coriolis term (+f u_perp via the tangential reconstruction) every
    subcycle — freezing Coriolis at the step start destabilizes long
    steps on f-plane inertia-gravity waves. `bt_drag` adds an optional
    linear drag -r*ubar to the fast system (MPAS-O practice for
    barotropic stabilization); it is subtracted consistently from the
    slow forcing so the scheme stays an exact rearrangement at t0.
    The remaining frozen slow forcing (advection, viscosity, baroclinic
    pressure) carries an O(dt) splitting error, the same order as the
    baroclinic FB update itself."""
    if cfg.ssh_formulation != "column":
        raise ValueError(
            "the split-explicit stepper integrates the true free surface; "
            "set ModelConfig.ssh_formulation='column' (SshFormulation: "
            "Column) — the default 'stacked' per-layer ssh has no shared "
            "barotropic mode")
    h, u, tr = state
    g = cfg.gravity

    # --- mode split (thickness-weighted)
    thick_aux = auxmod.thickness_aux_edge(mesh, cfg, h, u)
    h_edge = thick_aux.mean_h_edge                        # (E, K)
    h_edge_tot = jnp.sum(h_edge, axis=-1, keepdims=True)  # (E, 1)
    ubar = _depth_avg_edge(h_edge, u)                     # (E, 1)
    uprime = u - ubar

    # --- full 3D tendency at the current state
    du_full, _ = tend_mod.compute_velocity_tendency(mesh, cfg, h, u, t,
                                                    wind_stress)
    du_bar = _depth_avg_edge(h_edge, du_full)             # (E, 1)

    # fast operator, re-evaluated every subcycle: SSH gradient +
    # barotropic Coriolis + optional linear drag
    f_e = trisk.col(mesh, "f_edge")
    mask = trisk.col(mesh, "edge_mask")

    def fast(ub, ssh_s):
        out = (-g * trisk.grad_edge(mesh, ssh_s)
               + f_e * trisk.tangential_edge(mesh, ub))
        if bt_drag:
            out = out - bt_drag * ub
        return mask * out

    ssh = jnp.sum(h, axis=-1, keepdims=True) - trisk.col(mesh, "bottom_depth")
    du_fast0 = fast(ubar, ssh)                            # (E, 1)
    g_slow = du_bar - du_fast0                            # held fixed

    # --- barotropic FB subcycles (lax.scan over 2D fields)
    dt_bt = dt / n_subcycles

    # Under sharding the subcycles advance (ubar, ssh) many radius-1 FB
    # stages between full-state exchanges — far beyond the halo width —
    # so each subcycle refreshes its own 2D fields through the per-array
    # exchange the sharded halo exposes (identity on a single device).
    # The barotropic fields are (E,1)/(C,1): two tiny ppermute rounds.
    edge_ex = getattr(halo, "edge", None) or (lambda x: x)
    cell_ex = getattr(halo, "cell", None) or (lambda x: x)

    def subcycle(carry, _):
        ub, ssh_s, acc = carry
        ub = ub + dt_bt * (fast(ub, ssh_s) + g_slow)
        ub = edge_ex(ub)
        ssh_s = ssh_s - dt_bt * trisk.div_cell(mesh, h_edge_tot * ub)
        ssh_s = cell_ex(ssh_s)
        return (ub, ssh_s, acc + ub), None

    (ub_final, _, acc), _ = jax.lax.scan(
        subcycle, (ubar, ssh, jnp.zeros_like(ubar)), None,
        length=n_subcycles)
    ubar_avg = acc / n_subcycles

    # --- baroclinic velocity update (slow modes only)
    uprime_new = uprime + dt * (du_full - du_bar)
    u_new = uprime_new + ub_final

    # --- thickness + tracers with the averaged transport velocity
    u_trans = uprime + ubar_avg
    dh = -trisk.div_cell(mesh, thick_aux.flux_h_edge * u_trans)
    h_new = h + dt * dh

    dtr, _ = tend_mod.compute_tracer_tendency(
        mesh, cfg, h, u_trans, tr, h_edge, t, h_new=h_new, dt=dt,
        flux_h_edge=thick_aux.flux_h_edge)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]

    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


def make_split_stepper(n_subcycles: int = 10, bt_drag: float = 0.0):
    """Stepper factory with a fixed subcycle count and optional linear
    barotropic drag (config `TimeIntegration: BarotropicSubcycles` /
    `BarotropicLinearDrag`)."""
    def step(mesh, cfg, state, t, dt, halo=_identity, wind_stress=None):
        return split_forward_backward_step(mesh, cfg, state, t, dt, halo,
                                           wind_stress, n_subcycles,
                                           bt_drag)
    return step
