"""Time steppers — pure functional state -> state maps.

Rewrite of src/timeStepping/: ForwardBackwardStepper.cpp:27-82,
RungeKutta2Stepper.cpp:25-75, RungeKutta4Stepper.cpp:68-137. The reference
mutates circular time-level buffers and triggers MPI halo exchanges inside
updateTimeLevels; here each stepper is a pure function and the halo
exchange is an injectable `halo` callback (identity on a single device, a
shard_map collective in distributed runs). RK4 applies `halo` to the
provisional state at stage 2, matching the reference's width-3-halo
amortization (RungeKutta4Stepper.cpp:107-114).

Tracer updates are thickness-weighted exactly as TimeStepper.h:205-237:
    tr^{n+1} = (tr^n h^n + sum_s b_s dt R_s) / h^{n+1}
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from omega_tpu.core import tendencies as tend_mod
from omega_tpu.core.config import ModelConfig
from omega_tpu.core.state import ModelState
from omega_tpu.mesh.horz_mesh import HorzMesh

Halo = Callable[[ModelState], ModelState]
_identity: Halo = lambda s: s


def _halo_overlap_enabled() -> bool:
    """OMEGA_HALO_OVERLAP=0 restores the trailing full-state exchange
    (A/B knob; overlap is bit-identical and the default)."""
    import os
    return os.environ.get("OMEGA_HALO_OVERLAP", "1") != "0"


def _mix(mesh, cfg, state, dt):
    """Operator-split backward-Euler vertical mixing applied after the
    horizontal update (the implicit stage the reference's tridiagonal
    solvers exist for, base/TriDiagSolvers.h:28-35). Unconditionally
    stable; conserves h-weighted tracer columns exactly."""
    vm = cfg.vert_mix
    if not vm.enabled or cfg.nvertlayers < 2:
        return state
    from omega_tpu.core import vmix
    from omega_tpu.ops import trisk
    h, u, tr = state
    h_edge = trisk.cell_mean_on_edge(mesh, h)
    if vm.scheme == "pp81":
        kt, km = vmix.pp81_coefficients(mesh, vm, cfg.gravity, h, u, tr)
    else:
        kt = vm.kappa_tracer * jnp.ones_like(h[..., :-1])
        km = vm.kappa_momentum * jnp.ones_like(h_edge[..., :-1])
    tr_new = vmix.implicit_vmix(h[None], kt[None], dt, tr, method=vm.method)
    u_new = vmix.implicit_vmix(h_edge, km, dt, u, method=vm.method)
    return ModelState(h=h, u=u_new, tracers=tr_new)


def forward_backward_step(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
                          t, dt, halo: Halo = _identity,
                          wind_stress=None) -> ModelState:
    """Forward h/tracer update, backward u update (uses new h)."""
    h, u, tr = state
    dh, thick_aux = tend_mod.compute_thickness_tendency(mesh, cfg, h, u, t)
    h_new = h + dt * dh

    dtr, _ = tend_mod.compute_tracer_tendency(
        mesh, cfg, h, u, tr, thick_aux.mean_h_edge, t, h_new=h_new, dt=dt,
        flux_h_edge=thick_aux.flux_h_edge)
    tr_new = (tr * h[None] + dt * dtr) / h_new[None]

    # Compute/comm overlap (the analogue of the reference's
    # MPI_Test poll-and-unpack loop, base/Halo.h:849-881): once h and
    # the tracers are updated, their owned boundary rows are final, so
    # the cell-space ppermute rounds are ISSUED here and their results
    # consumed only after the velocity stage — XLA's latency-hiding
    # scheduler runs the collective behind the computeMomAux sweep (the
    # step's largest block). The velocity tendency reads the LOCAL
    # pre-exchange h_new (identical values on the rings it touches:
    # width-3 halos keep rings 1-2 of h_new exact after a radius-1
    # update), so results are bit-identical to the trailing exchange.
    # Implicit vertical mixing modifies u/tracers after this point, so
    # with vmix enabled the step keeps the single trailing exchange.
    cell_ex = getattr(halo, "cell", None)
    overlap = (cell_ex is not None and _halo_overlap_enabled()
               and not (cfg.vert_mix.enabled and cfg.nvertlayers >= 2))
    if overlap:
        bundle = cell_ex(jnp.concatenate([h_new[None], tr_new], axis=0))

    du, _ = tend_mod.compute_velocity_tendency(
        mesh, cfg, h_new, u, t + dt, wind_stress)
    u_new = u + dt * du

    if overlap:
        return ModelState(h=bundle[0], u=halo.edge(u_new),
                          tracers=bundle[1:])
    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


def rk2_step(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
             t, dt, halo: Halo = _identity, wind_stress=None) -> ModelState:
    """Midpoint method (RungeKutta2Stepper.cpp:25-75)."""
    h, u, tr = state

    k1 = tend_mod.compute_all_tendencies(mesh, cfg, h, u, tr, t, wind_stress)
    h_mid = h + 0.5 * dt * k1.dh
    u_mid = u + 0.5 * dt * k1.du
    tr_mid = (tr * h[None] + 0.5 * dt * k1.dtr) / h_mid[None]

    k2 = tend_mod.compute_all_tendencies(mesh, cfg, h_mid, u_mid, tr_mid,
                                         t + 0.5 * dt, wind_stress)
    h_new = h + dt * k2.dh
    u_new = u + dt * k2.du
    tr_new = (tr * h[None] + dt * k2.dtr) / h_new[None]

    out = _mix(mesh, cfg, ModelState(h=h_new, u=u_new, tracers=tr_new), dt)
    return halo(out)


_RKA = (0.0, 0.5, 0.5, 1.0)
_RKB = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_RKC = (0.0, 0.5, 0.5, 1.0)


def rk4_step(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
             t, dt, halo: Halo = _identity, wind_stress=None) -> ModelState:
    """Classic RK4 with thickness-weighted tracer accumulation
    (RungeKutta4Stepper.cpp:68-137), including the stage-2 halo refresh of
    the provisional state."""
    h, u, tr = state

    k = tend_mod.compute_all_tendencies(mesh, cfg, h, u, tr, t, wind_stress)
    h_acc = h + _RKB[0] * dt * k.dh
    u_acc = u + _RKB[0] * dt * k.du
    tr_acc = tr * h[None] + _RKB[0] * dt * k.dtr

    for stage in range(1, 4):
        h_prov = h + _RKA[stage] * dt * k.dh
        u_prov = u + _RKA[stage] * dt * k.du
        tr_prov = (tr * h[None] + _RKA[stage] * dt * k.dtr) / h_prov[None]
        if stage == 2:
            # width-3 halo supports 2 stages between exchanges
            prov = halo(ModelState(h=h_prov, u=u_prov, tracers=tr_prov))
            h_prov, u_prov, tr_prov = prov
        k = tend_mod.compute_all_tendencies(
            mesh, cfg, h_prov, u_prov, tr_prov, t + _RKC[stage] * dt, wind_stress)
        h_acc = h_acc + _RKB[stage] * dt * k.dh
        u_acc = u_acc + _RKB[stage] * dt * k.du
        tr_acc = tr_acc + _RKB[stage] * dt * k.dtr

    tr_new = tr_acc / h_acc[None]
    out = _mix(mesh, cfg, ModelState(h=h_acc, u=u_acc, tracers=tr_new), dt)
    return halo(out)


_STEPPERS = {
    "forward-backward": forward_backward_step,
    "rungekutta2": rk2_step,
    "rungekutta4": rk4_step,
}


def _split_stepper(*args, **kw):
    from omega_tpu.stepping.split import split_forward_backward_step
    return split_forward_backward_step(*args, **kw)


_STEPPERS["splitexplicit"] = _split_stepper


def make_stepper(name: str):
    key = name.lower().replace(" ", "").replace("_", "").replace("-", "")
    for k, fn in _STEPPERS.items():
        if k.replace("-", "") == key:
            return fn
    raise ValueError(f"unknown time stepper: {name!r} "
                     f"(expected one of {sorted(_STEPPERS)})")


def run_steps(mesh: HorzMesh, cfg: ModelConfig, state: ModelState,
              t0, dt, nsteps: int, stepper=forward_backward_step,
              halo: Halo = _identity, wind_stress=None) -> ModelState:
    """Advance `nsteps` with a compiled lax.scan (the ocnRun loop,
    ocn/OceanRun.cpp:16-70, minus host-side IO which is handled by the
    driver between scan segments)."""
    def body(carry, i):
        st, t = carry
        st = stepper(mesh, cfg, st, t, dt, halo, wind_stress)
        return (st, t + dt), None

    (state, _), _ = jax.lax.scan(body, (state, jnp.asarray(t0, state.h.dtype)),
                                 None, length=nsteps)
    return state
