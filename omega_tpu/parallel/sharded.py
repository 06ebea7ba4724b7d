"""SPMD execution of the dycore over a jax device mesh.

Replaces the reference's MPI rank model (base/MachEnv.h:36) with a 1-D
jax.sharding.Mesh over the spatial axis: each device holds one owned+halo
local mesh (see decomp.py) and steppers run unchanged inside shard_map with
the halo callback lowering to XLA collectives (the updateTimeLevels halo
exchange of ocn/OceanState.cpp:333-365 and the RK4 mid-step refresh).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from omega_tpu.core.config import ModelConfig
from omega_tpu.core.state import ModelState
from omega_tpu.parallel import halo as halo_mod
from omega_tpu.parallel.decomp import ShardedMesh


def shard_state(smesh: ShardedMesh, state: ModelState) -> ModelState:
    """Scatter a global state into stacked per-shard local states (host)."""
    c = np.maximum(np.asarray(smesh.cell_local_to_global), 0)
    e = np.maximum(np.asarray(smesh.edge_local_to_global), 0)
    h = np.asarray(state.h)[c]                      # (S, Cl, K)
    u = np.asarray(state.u)[e]                      # (S, El, K)
    tr = np.asarray(state.tracers)                  # (L, C, K)
    tr_l = np.moveaxis(tr[:, c], 1, 0)              # (S, L, Cl, K)
    return ModelState(h=jnp.asarray(h), u=jnp.asarray(u),
                      tracers=jnp.asarray(tr_l))


def gather_state(smesh: ShardedMesh, sstate: ModelState,
                 ncells: int, nedges: int) -> ModelState:
    """Reassemble the global state from owned shard entries (host)."""
    c_l2g = np.asarray(smesh.cell_local_to_global)
    e_l2g = np.asarray(smesh.edge_local_to_global)
    c_own = np.asarray(smesh.owned_cell_mask) > 0
    e_own = np.asarray(smesh.owned_edge_mask) > 0
    h_l = np.asarray(sstate.h)
    u_l = np.asarray(sstate.u)
    tr_l = np.asarray(sstate.tracers)               # (S, L, Cl, K)

    K = h_l.shape[-1]
    L = tr_l.shape[1]
    h = np.zeros((ncells, K), h_l.dtype)
    u = np.zeros((nedges, K), u_l.dtype)
    tr = np.zeros((L, ncells, K), tr_l.dtype)
    for s in range(smesh.nshards):
        cm, em = c_own[s], e_own[s]
        h[c_l2g[s, cm]] = h_l[s, cm]
        u[e_l2g[s, em]] = u_l[s, em]
        tr[:, c_l2g[s, cm]] = tr_l[s][:, cm]
    return ModelState(h=jnp.asarray(h), u=jnp.asarray(u), tracers=jnp.asarray(tr))


def build_permute_lists(smesh: ShardedMesh, kind: str):
    """Per-neighbor-distance exchange lists for ppermute halos (host side;
    the analogue of Halo::generateExchangeLists, base/Halo.cpp:455-600).

    kind: 'cell' | 'edge' | 'vertex'. Returns a list of
      (d, send_idx (S, Nd), recv_dst (S, Nd))
    — for rank distance d, shard s sends rows send_idx[s] to (s+d) % S and
    scatters what it receives from (s-d) % S into recv_dst[s]. The send
    order is exactly the receiver's recv order, so no slot indirection is
    needed on the wire. Padded entries use each shard's dummy row.
    """
    S = smesh.nshards
    pre = {"cell": "cell", "edge": "edge", "vertex": "vertex"}[kind]
    send_glob = np.asarray(getattr(smesh, f"{pre}_send_idx"))
    rsrc = np.asarray(getattr(smesh, f"{pre}_recv_src_shard"))
    rslot = np.asarray(getattr(smesh, f"{pre}_recv_src_slot"))
    rdst = np.asarray(getattr(smesh, f"{pre}_recv_dst"))
    dummy = send_glob.max() if send_glob.size else 0
    n_local = np.asarray(
        getattr(smesh, f"{pre}_local_to_global")).shape[1]
    dummy_row = n_local - 1

    # distance -> per-src (send rows, per-dst recv rows)
    per_d: dict = {}
    for dst in range(S):
        # real (non-dummy-targeting) halo entries of this shard
        real = rdst[dst] != dummy_row
        srcs = rsrc[dst][real]
        slots = rslot[dst][real]
        dsts = rdst[dst][real]
        for src in np.unique(srcs):
            d = int((dst - src) % S)
            if d == 0:
                continue
            sel = srcs == src
            pd = per_d.setdefault(d, {})
            # receiver order defines the wire order
            pd[int(src)] = (send_glob[src][slots[sel]], dsts[sel])
    out = []
    for d in sorted(per_d):
        pd = per_d[d]
        nd = max(len(v[0]) for v in pd.values())
        send = np.full((S, nd), dummy_row, np.int32)
        recv = np.full((S, nd), dummy_row, np.int32)
        for src, (s_rows, _) in pd.items():
            send[src, :len(s_rows)] = s_rows
        for src, (_, r_rows) in pd.items():
            dst = (src + d) % S
            recv[dst, :len(r_rows)] = r_rows
        out.append((d, send, recv))
    return out


def exchange_any(sm: ShardedMesh, x, space: str, axis_name: str = "x",
                 plists=None):
    """General halo refresh of ANY local array on any of the three index
    spaces — the Halo::exchangeFullArrayHalo analogue (base/Halo.h:45,
    769): exchanges (..., N_local, K) arrays on 'cell' | 'edge' |
    'vertex'. Call inside shard_map with per-shard (leading-axis-
    stripped) operands; the step loop never needs the vertex space (aux
    vars recompute locally), but diagnostics that publish vertex fields
    (vorticity snapshots) do. `sm` must be the UNSTACKED per-shard
    pytree (as make_halo_fn receives it inside shard_map)."""
    if plists is not None:
        return halo_mod.exchange_permute(x, plists, axis_name)
    pre = {"cell": "cell", "edge": "edge", "vertex": "vertex"}[space]
    return halo_mod.exchange(
        x, getattr(sm, f"{pre}_send_idx"),
        getattr(sm, f"{pre}_recv_src_shard"),
        getattr(sm, f"{pre}_recv_src_slot"),
        getattr(sm, f"{pre}_recv_dst"), axis_name)


def make_halo_fn(sm: ShardedMesh, axis_name: str = "x",
                 cell_plists=None, edge_plists=None) -> Callable:
    """Per-shard halo exchange for a ModelState (call inside shard_map with
    an *unstacked* ShardedMesh pytree). When per-distance permute lists
    are provided (each entry already unstacked to this shard's row), uses
    neighbor ppermutes; otherwise falls back to all_gather."""
    def cell_ex(x):
        """Halo-refresh one cell array (..., Cl, K)."""
        if cell_plists is not None:
            return halo_mod.exchange_permute(x, cell_plists, axis_name)
        return halo_mod.exchange(x, sm.cell_send_idx, sm.cell_recv_src_shard,
                                 sm.cell_recv_src_slot, sm.cell_recv_dst,
                                 axis_name)

    def edge_ex(x):
        """Halo-refresh one edge array (..., El, K)."""
        if edge_plists is not None:
            return halo_mod.exchange_permute(x, edge_plists, axis_name)
        return halo_mod.exchange(x, sm.edge_send_idx, sm.edge_recv_src_shard,
                                 sm.edge_recv_src_slot, sm.edge_recv_dst,
                                 axis_name)

    def halo_fn(st: ModelState) -> ModelState:
        if cell_plists is not None:
            import jax.numpy as jnp
            # h and tracers share the cell exchange lists: one permute for
            # the stacked (1+L, Cl, K) bundle halves the collective count
            bundle = jnp.concatenate([st.h[None], st.tracers], axis=0)
            bundle = halo_mod.exchange_permute(bundle, cell_plists, axis_name)
            u = halo_mod.exchange_permute(st.u, edge_plists, axis_name)
            return ModelState(h=bundle[0], u=u, tracers=bundle[1:])
        return ModelState(h=cell_ex(st.h), u=edge_ex(st.u),
                          tracers=cell_ex(st.tracers))

    # steppers that advance sub-fields between full-state exchanges (the
    # split-explicit barotropic subcycle) refresh them through these —
    # on a single device the default halo has no such attributes and
    # getattr falls back to identity
    halo_fn.cell = cell_ex
    halo_fn.edge = edge_ex
    return halo_fn


def make_sharded_step(smesh: ShardedMesh, cfg: ModelConfig, stepper,
                      device_mesh: Mesh, axis_name: str = "x",
                      halo_impl: str = "permute", wind_stress=None,
                      post_phase=None):
    """Build a jittable sharded step: (sharded ModelState, t, dt) -> state.

    The same pure stepper used on a single device runs inside shard_map on
    each local mesh; its `halo` callback is the collective exchange
    (halo_impl: 'permute' = per-neighbor ppermute rings, 'allgather').

    post_phase: optional (fn, aux) pair applied per shard AFTER the
    stepper (the driver's p-star redistribution phase): `aux` is a
    pytree whose leaves are stacked (S, ...) local-row arrays, and
    `fn(local_mesh, state, aux_local)` -> state runs inside shard_map.
    The phase is column-local with an edge radius of 1 (the 2-cell-mean
    edge thickness), so halo rows out to width-1-less-than-the-exchange
    stay exact — the driver bumps Decomp.HaloWidth accordingly."""
    pspec = P(axis_name)
    smesh_specs = jax.tree.map(lambda _: pspec, smesh)
    state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)
    phase_fn, phase_aux = post_phase if post_phase is not None \
        else (None, None)
    phase_specs = (P() if phase_aux is None
                   else jax.tree.map(lambda _: pspec, phase_aux))

    S = smesh.nshards
    if halo_impl == "permute":
        cell_pl = build_permute_lists(smesh, "cell")
        edge_pl = build_permute_lists(smesh, "edge")
    else:
        cell_pl = edge_pl = []
    cell_meta = [d for (d, _, _) in cell_pl]
    edge_meta = [d for (d, _, _) in edge_pl]
    cell_data = tuple(jnp.asarray(x) for (_, s, r) in cell_pl for x in (s, r))
    edge_data = tuple(jnp.asarray(x) for (_, s, r) in edge_pl for x in (s, r))

    c_l2g = np.maximum(np.asarray(smesh.cell_local_to_global), 0)

    def scatter_wind(w):
        """(zonal, merid) global (C,) arrays -> stacked (S, Cl) local rows
        (for time-varying forcing updates between segments)."""
        return tuple(jnp.asarray(np.asarray(x)[c_l2g]) for x in w)

    if wind_stress is not None:
        wind_stress = scatter_wind(wind_stress)
    wspecs = (P() if wind_stress is None
              else tuple(pspec for _ in wind_stress))

    def local_step(sm_stacked, cell_d, edge_d, state_stacked, wind_stacked,
                   phase_stacked, t, dt):
        sm = jax.tree.map(lambda a: a[0], sm_stacked)
        st = jax.tree.map(lambda a: a[0], state_stacked)
        if halo_impl == "permute":
            cpl = [(cell_meta[i], S, cell_d[2 * i][0], cell_d[2 * i + 1][0])
                   for i in range(len(cell_meta))]
            epl = [(edge_meta[i], S, edge_d[2 * i][0], edge_d[2 * i + 1][0])
                   for i in range(len(edge_meta))]
            halo_fn = make_halo_fn(sm, axis_name, cpl, epl)
        else:
            halo_fn = make_halo_fn(sm, axis_name)
        wind = (None if wind_stacked is None
                else tuple(w[0] for w in wind_stacked))
        out = stepper(sm.mesh, cfg, st, t, dt, halo_fn, wind_stress=wind)
        if phase_fn is not None:
            out = phase_fn(sm.mesh, out,
                           jax.tree.map(lambda a: a[0], phase_stacked))
        return jax.tree.map(lambda a: a[None], out)

    sharded = jax.shard_map(
        local_step, mesh=device_mesh,
        in_specs=(smesh_specs,
                  tuple(pspec for _ in cell_data),
                  tuple(pspec for _ in edge_data),
                  state_specs, wspecs, phase_specs, P(), P()),
        out_specs=state_specs)

    def step(state, t, dt, wind=None):
        return sharded(smesh, cell_data, edge_data, state,
                       wind_stress if wind is None else wind, phase_aux,
                       t, dt)

    step.scatter_wind = scatter_wind
    return step


def default_device_mesh(nshards: int, axis_name: str = "x") -> Mesh:
    devs = jax.devices()[:nshards]
    if len(devs) < nshards:
        raise ValueError(f"need {nshards} devices, have {len(jax.devices())}")
    return Mesh(np.array(devs), (axis_name,))


def host_major_device_mesh(nshards: int, axis_name: str = "x",
                           devices=None) -> Mesh:
    """1-D device mesh ordered host-major for multi-host runs.

    The model's single distributed axis is the horizontal mesh
    (SURVEY.md section 2.6) and the SFC decomposition gives contiguous
    spatial blocks, so halo ppermutes are dominated by rank distance 1.
    Ordering devices (process, slice, id)-major makes consecutive ranks
    co-located: the distance-1 ring stays on the links inside each host
    and crosses the inter-host network only at the host seams — the
    analogue of the reference's node-aware MPI rank placement.  `devices` overrides the
    device list (tests emulate multi-host orderings with it)."""
    devs = list(jax.devices() if devices is None else devices)
    devs.sort(key=lambda d: (getattr(d, "process_index", 0),
                             getattr(d, "slice_index", 0) or 0, d.id))
    if len(devs) < nshards:
        raise ValueError(f"need {nshards} devices, have {len(devs)}")
    return Mesh(np.array(devs[:nshards]), (axis_name,))


def comm_volume_by_link(smesh: ShardedMesh, host_of) -> dict:
    """Per-step halo traffic split by link type for a host assignment.

    host_of: (nshards,) host index of each shard (rank order).  Returns
    row counts {'intra': n, 'inter': n, 'per_host_pair': {(ha, hb): n}}
    (inside one host, between hosts, per host pair) summed
    over the cell and edge exchange lists (rows = elements, multiply by
    K * itemsize * fields for bytes).  The planner's tool for checking a
    layout keeps the inter-host share small before committing to it."""
    host_of = np.asarray(host_of)
    S = smesh.nshards
    out = {"intra": 0, "inter": 0, "per_host_pair": {}}
    for kind in ("cell", "edge"):
        l2g = np.asarray(smesh.cell_local_to_global if kind == "cell"
                         else smesh.edge_local_to_global)
        dummy_row = l2g.shape[1] - 1   # pad target (build_permute_lists)
        for (d, send, recv) in build_permute_lists(smesh, kind):
            for src in range(S):
                dst = (src + d) % S
                # recv-side padding identifies dead slots exactly (real
                # sends can legitimately name the last local row)
                n = int((recv[dst] != dummy_row).sum())
                if n == 0:
                    continue
                if host_of[src] == host_of[dst]:
                    out["intra"] += n
                else:
                    out["inter"] += n
                    key = (int(min(host_of[src], host_of[dst])),
                           int(max(host_of[src], host_of[dst])))
                    out["per_host_pair"][key] = \
                        out["per_host_pair"].get(key, 0) + n
    return out


def make_sharded_energetics(smesh: ShardedMesh, cfg, device_mesh: Mesh,
                            axis_name: str = "x"):
    """Sharded energetics sampler for the SFC decomposition: each shard
    computes its owned-masked budget terms on its local mesh and the
    double-double psum combines them — no global state gather at sample
    boundaries (analysis.energetics_local). Returns
    sample(state, ssh_ref=None) -> dict of floats; ssh_ref None computes
    the t=0 area-mean ssh (also sharded)."""
    from omega_tpu import analysis as ana
    pspec = P(axis_name)
    smesh_specs = jax.tree.map(lambda _: pspec, smesh)
    state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)
    keys = None

    def local_row(sm_st, state_st, ssh_ref):
        sm = jax.tree.map(lambda a: a[0], sm_st)
        st = jax.tree.map(lambda a: a[0], state_st)
        row = ana.energetics_local(sm.mesh, cfg, st,
                                   sm.owned_cell_mask,
                                   sm.owned_vertex_mask,
                                   ssh_ref, axis_name)
        return tuple(row[k] for k in sorted(row))

    def local_mean(sm_st, state_st):
        sm = jax.tree.map(lambda a: a[0], sm_st)
        st = jax.tree.map(lambda a: a[0], state_st)
        return ana.mean_ssh_local(sm.mesh, cfg, st, sm.owned_cell_mask,
                                  axis_name)

    def sample(state, ssh_ref=None):
        nonlocal keys
        if keys is None:
            # key order from a host-side dry build (ntracers-dependent)
            L = state.tracers.shape[1]
            base = ["volume", "kinetic_energy", "potential_energy",
                    "potential_enstrophy"]
            for l in range(L):
                base += [f"tracer{l}_mass", f"tracer{l}_min",
                         f"tracer{l}_max"]
            keys = sorted(base)
        if ssh_ref is None:
            ssh_ref = float(jax.jit(jax.shard_map(
                local_mean, mesh=device_mesh,
                in_specs=(smesh_specs, state_specs), out_specs=P(),
                check_vma=False))(smesh, state))
        nout = len(keys)
        vals = jax.jit(jax.shard_map(
            local_row, mesh=device_mesh,
            in_specs=(smesh_specs, state_specs, P()),
            out_specs=tuple(P() for _ in range(nout)),
            check_vma=False))(smesh, state, jnp.asarray(ssh_ref))
        row = {k: float(v) for k, v in zip(keys, vals)}
        # host-side add (matches analysis.energetics — keeps the
        # bitwise decomposition-invariance contract out of XLA's FMA)
        row["total_energy"] = (row["kinetic_energy"]
                               + row["potential_energy"])
        return row, ssh_ref

    return sample
