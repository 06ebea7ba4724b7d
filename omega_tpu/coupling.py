"""Coupled-mode component interface (the E3SM coupler analogue).

The reference is designed to run as an E3SM component — `MachEnv::init`
accepts a coupler-supplied communicator (base/MachEnv.h:136-142) and the
Omega-2 roadmap is the coupled configuration — but its own MCT/MOAB
wiring does not exist yet (SURVEY.md section 2.5).  This module is the
JAX equivalent of that component contract: a host "coupler"
(atmosphere model, test harness, ESM driver) constructs an
`OmegaComponent`, then alternates

    exports = comp.run(coupling_interval_seconds, imports)

calls with its own physics.  Imports/exports are plain global cell
arrays (the attribute-vector analogue); the component advances its own
exact-rational clock, fires its IO streams, and keeps the jitted run
segment cached across intervals (driver._run_ctx), so per-interval cost
is one segment execution, not a re-compile.

Import fields (all optional, (ncells,) float):
  zonal_wind_stress / merid_wind_stress   [N m-2] surface stress
    (requires Tendencies.WindForcingTendencyEnable in the config)

Export fields ((ncells,) float unless noted):
  ssh            sea surface height = sum_k h_k - bottom_depth  [m]
  sst / sss      surface Temperature / Salinity (when in the catalog)
  u_zonal, v_merid   surface velocity reconstructed at cell centers
  frazil/melt fluxes etc. have no analogue in the layered SW core.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional

import numpy as np

from omega_tpu.infra.time_manager import Alarm, TimeInterval


def reconstruct_cell_velocity(mesh, u):
    """Edge-normal velocity -> (zonal, meridional) vectors at cells.

    Each edge's full vector is rebuilt from its normal component and the
    TRiSK tangential reconstruction (ocn/HorzOperators.h:104-133), then
    averaged to cells with dc*dv/4 edge-area weights.  Exact for uniform
    flow (both projections are exact there and the weights normalize).
    Returns (u_zonal, v_merid), each (C, K) for (E, K) input.
    """
    import jax.numpy as jnp

    from omega_tpu.ops import trisk

    ut = trisk.tangential_edge(mesh, u)
    ang = jnp.asarray(mesh.angle_edge)[:, None]
    # n-hat = (cos a, sin a), t-hat = (-sin a, cos a) in (east, north)
    ve = u * jnp.cos(ang) - ut * jnp.sin(ang)
    vn = u * jnp.sin(ang) + ut * jnp.cos(ang)

    w, idx_np = _cell_edge_avg_weights(mesh)
    wj = jnp.asarray(w)[:, :, None]                       # (C, M, 1)
    idx = jnp.asarray(idx_np)
    wsum = jnp.sum(wj, axis=1)

    def avg(x):
        return jnp.sum(wj * x[idx], axis=1) / wsum

    return avg(ve), avg(vn)


def _cell_edge_avg_weights(mesh_l):
    """Host-side dc*dv/4 edge-area weights of one local mesh (the
    reconstruct_cell_velocity averaging), as (w (C, M), idx (C, M))."""
    from omega_tpu.mesh.horz_mesh import unclamped_connectivity

    eoc = np.asarray(unclamped_connectivity(mesh_l)["edges_on_cell"])
    dc = np.asarray(mesh_l.dc_edge)
    dv = np.asarray(mesh_l.dv_edge)
    w = np.where(eoc >= 0, (dc * dv / 4.0)[np.maximum(eoc, 0)], 0.0)
    return w, np.maximum(eoc, 0)


def _local_exports(mesh_l, st, w, idx, temp_idx, salt_idx):
    """Per-shard export fields on a (possibly traced) local mesh —
    identical arithmetic to the gathered `OmegaComponent.exports` so
    owned rows match bitwise."""
    import jax.numpy as jnp

    from omega_tpu.ops import trisk

    h, u = st.h, st.u
    out = {"ssh": jnp.sum(h, axis=1) - jnp.ravel(
        jnp.broadcast_to(trisk.col(mesh_l, "bottom_depth"),
                         (h.shape[0], 1)))}
    if temp_idx is not None:
        out["sst"] = st.tracers[temp_idx][:, 0]
    if salt_idx is not None:
        out["sss"] = st.tracers[salt_idx][:, 0]
    ut = trisk.tangential_edge(mesh_l, u)
    ang = jnp.asarray(mesh_l.angle_edge)[:, None]
    ve = u * jnp.cos(ang) - ut * jnp.sin(ang)
    vn = u * jnp.sin(ang) + ut * jnp.cos(ang)
    wj = w[:, :, None]
    wsum = jnp.sum(wj, axis=1)
    out["u_zonal"] = (jnp.sum(wj * ve[idx], axis=1) / wsum)[:, 0]
    out["v_merid"] = (jnp.sum(wj * vn[idx], axis=1) / wsum)[:, 0]
    return out


def make_sharded_exports(model):
    """Shard_map'd coupler exports: each shard computes its owned surface
    rows on its local mesh and only the assembled (C,) export fields
    leave the devices — no global-state gather at coupling intervals
    (the r4 analysis treatment applied to the export path). Returns
    exports(sharded_state) -> dict of global numpy arrays, or None when
    the decomposition keeps global state (patch path)."""
    import dataclasses as _dc

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    kind, dec, dmesh = model._decomp
    if kind == "patch":
        return None                      # state already global
    mesh_g = model.mesh
    temp_idx = None
    salt_idx = None
    try:
        names = list(model.tracers.names)
        temp_idx = (names.index("Temperature")
                    if "Temperature" in names else None)
        salt_idx = names.index("Salinity") if "Salinity" in names else None
    except AttributeError:
        pass
    pspec = P("x")
    state_specs = None

    if kind == "sfc":
        sm = dec
        S = sm.nshards
        c_l2g = np.asarray(sm.cell_local_to_global)
        c_own = np.asarray(sm.owned_cell_mask) > 0
        # host-precomputed per-shard averaging weights
        ws, idxs = [], []
        for s in range(S):
            mesh_s = jax.tree.map(lambda a: np.asarray(a)[s], sm.mesh)
            w_s, i_s = _cell_edge_avg_weights(mesh_s)
            ws.append(w_s)
            idxs.append(i_s)
        w_st = jnp.asarray(np.stack(ws))
        i_st = jnp.asarray(np.stack(idxs))
        smesh_specs = jax.tree.map(lambda _: pspec, sm)

        def local(sm_st, st_st, w_, i_):
            sml = jax.tree.map(lambda a: a[0], sm_st)
            st = jax.tree.map(lambda a: a[0], st_st)
            out = _local_exports(sml.mesh, st, w_[0], i_[0],
                                 temp_idx, salt_idx)
            return tuple(out[k][None] for k in sorted(out))

        keys = None

        def exports(state):
            nonlocal keys, state_specs
            if state_specs is None:
                from omega_tpu.core.state import ModelState
                state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)
            vals = jax.jit(jax.shard_map(
                local, mesh=dmesh,
                in_specs=(smesh_specs, state_specs, pspec, pspec),
                out_specs=tuple(pspec for _ in range(
                    3 + (temp_idx is not None) + (salt_idx is not None))),
                check_vma=False))(sm, state, w_st, i_st)
            if keys is None:
                keys = sorted(["ssh", "u_zonal", "v_merid"]
                              + (["sst"] if temp_idx is not None else [])
                              + (["sss"] if salt_idx is not None else []))
            out = {}
            for k, v in zip(keys, vals):
                g = np.zeros(mesh_g.ncells, np.asarray(v).dtype)
                v = np.asarray(v)
                for s in range(S):
                    m = c_own[s]
                    g[c_l2g[s, m]] = v[s, m]
                out[k] = g
            return out

        return exports

    # structured: shared local mesh + per-shard overrides
    from omega_tpu.parallel import structured_shard as sshard
    ss = dec
    S = ss.nshards
    c_l2g, c_own = sshard.element_maps(ss, "cell")
    w_np, i_np = _cell_edge_avg_weights(ss.local_mesh)
    w_l = jnp.asarray(w_np)
    i_l = jnp.asarray(i_np)
    ov_names = tuple(a for a, _ in ss.mesh_overrides)
    ov_data = tuple(jnp.asarray(v) for _, v in ss.mesh_overrides)
    ovspecs = tuple(pspec for _ in ov_data)

    def local_st(ov_st, st_st):
        m = ss.local_mesh
        if ov_names:
            m = _dc.replace(m, **{a: v[0] for a, v in
                                  zip(ov_names, ov_st)})
        st = jax.tree.map(lambda a: a[0], st_st)
        out = _local_exports(m, st, w_l, i_l, temp_idx, salt_idx)
        return tuple(out[k][None] for k in sorted(out))

    def exports(state):
        nonlocal state_specs
        if state_specs is None:
            from omega_tpu.core.state import ModelState
            state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)
        nout = 3 + (temp_idx is not None) + (salt_idx is not None)
        vals = jax.jit(jax.shard_map(
            local_st, mesh=dmesh, in_specs=(ovspecs, state_specs),
            out_specs=tuple(pspec for _ in range(nout)),
            check_vma=False))(ov_data, state)
        keys = sorted(["ssh", "u_zonal", "v_merid"]
                      + (["sst"] if temp_idx is not None else [])
                      + (["sss"] if salt_idx is not None else []))
        out = {}
        for k, v in zip(keys, vals):
            g = np.zeros(mesh_g.ncells, np.asarray(v).dtype)
            v = np.asarray(v)
            for s in range(S):
                m = c_own[s]
                g[c_l2g[s][m]] = v[s][m]
            out[k] = g
        return out

    return exports


class OmegaComponent:
    """Omega as a drivable component with import/export states.

    The init/run/finalize triplet of an E3SM component
    (ocn/OceanDriver.h:26-35): `__init__` = ocnInit from a config,
    `run(interval)` = ocnRun until a one-shot coupling alarm,
    `finalize()` = ocnFinalize.  The model's own IO streams (history,
    restart + pointer files) stay active underneath the coupler."""

    def __init__(self, config_file: Optional[str] = None, *,
                 config=None, directory: str = "."):
        from omega_tpu.driver import ocn_init
        self.model = ocn_init(config=config, config_file=config_file,
                              directory=directory)
        self._temp_idx = self._tracer_index("Temperature")
        self._salt_idx = self._tracer_index("Salinity")
        if self.model.nshards > 1:
            # hold the state sharded across coupling intervals; exports
            # are computed shard_map'd from owned rows (no global gather)
            self.model._keep_sharded = True
        self._sharded_exports = None

    def _tracer_index(self, name: str) -> Optional[int]:
        try:
            return self.model.tracers.index_of(name)
        except (KeyError, ValueError, AttributeError):
            names = list(getattr(self.model.tracers, "names", []))
            return names.index(name) if name in names else None

    # ---- component contract ----

    def run(self, interval_seconds: float,
            imports: Optional[Dict[str, np.ndarray]] = None) -> Dict:
        """Advance the ocean by one coupling interval and return exports.

        The interval must be a whole number of time steps (the coupler
        sets the alarm cadence, exactly like an IOStream alarm)."""
        import jax.numpy as jnp

        model = self.model
        if imports:
            wz = imports.get("zonal_wind_stress")
            wm = imports.get("merid_wind_stress")
            if wz is not None or wm is not None:
                if not model.model_cfg.tendencies.wind_forcing:
                    raise ValueError(
                        "wind imports need Tendencies."
                        "WindForcingTendencyEnable: true in the config")
                C = model.mesh.ncells
                z = jnp.asarray(np.broadcast_to(
                    np.asarray(0.0 if wz is None else wz, np.float64), (C,)))
                m = jnp.asarray(np.broadcast_to(
                    np.asarray(0.0 if wm is None else wm, np.float64), (C,)))
                model.wind_stress = (z, m)
            unknown = set(imports) - {"zonal_wind_stress",
                                      "merid_wind_stress"}
            if unknown:
                raise ValueError(f"unknown import fields: {sorted(unknown)}")

        from omega_tpu.driver import ocn_run
        now = model.clock.get_current_time()
        ring = now + TimeInterval(seconds=Fraction(interval_seconds))
        cpl = Alarm("CouplingAlarm", ring_time=ring)
        model.clock.attach_alarm(cpl)
        saved = model.end_alarm
        model.end_alarm = cpl
        try:
            ocn_run(model)
        finally:
            model.end_alarm = saved
            model.clock.alarms.remove(cpl)
        return self.exports()

    def exports(self) -> Dict[str, np.ndarray]:
        model = self.model
        mesh = model.mesh
        if getattr(model, "_state_is_sharded", False):
            if self._sharded_exports is None:
                self._sharded_exports = make_sharded_exports(model)
            if self._sharded_exports is not None:
                return self._sharded_exports(model.state)
            # patch path keeps global state; fall through

        h = np.asarray(model.state.h)
        depth = np.asarray(mesh.bottom_depth)
        out = {"ssh": h.sum(axis=1) - depth}
        tr = np.asarray(model.state.tracers)
        if self._temp_idx is not None:
            out["sst"] = tr[self._temp_idx][:, 0]
        if self._salt_idx is not None:
            out["sss"] = tr[self._salt_idx][:, 0]
        uz, vm = reconstruct_cell_velocity(mesh, model.state.u)
        out["u_zonal"] = np.asarray(uz)[:, 0]
        out["v_merid"] = np.asarray(vm)[:, 0]
        return out

    def finalize(self):
        from omega_tpu.driver import ocn_finalize
        return ocn_finalize(self.model)

    @property
    def clock_time(self) -> str:
        return str(self.model.clock.get_current_time())
