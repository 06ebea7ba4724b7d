"""Structure-preserving decomposition of uniform planar hex meshes.

The general decomposition (decomp.py) renumbers each shard's local mesh,
which drops it off the structured roll path onto the general gather
path precisely where performance matters most.
This module shards the (ny, nx) grid into an (sy, sx) grid of rectangles
instead (sx == 1 gives the round-1 row bands):

  * shard (iy, ix) owns cell rows [iy*band, (iy+1)*band) x columns
    [ix*band_x, (ix+1)*band_x); its local domain adds `hw` halo rows and
    (when sx > 1) `hw` halo columns, so the local mesh IS a
    planar_hex_mesh(band_x + 2*hw, band + 2*hw) — fully structured, roll
    path on
  * the local periodic wrap across the cuts produces garbage only in the
    outermost halo ring, exactly the owned+halo redundancy model of the
    reference (compute over NCellsAll, exchange refreshes halos)
  * halo width hw = 4 (>= the width-3 contract; even so the row parity
    phase of the hex stagger is preserved across row cuts — column cuts
    have no parity constraint since the stagger shifts whole rows)
  * the exchange is two stages of row/column-block ppermutes over ONE
    device axis (shard id s = iy*sx + ix): stage 1 moves row blocks
    between y-neighbors, stage 2 moves column blocks (including the
    just-refreshed y-halo rows) between x-neighbors, which also fills
    the corner regions — no index lists at all; all element classes and
    tracers ride one stacked (1 + 3 + L, nyl, nxl, K) bundle
  * beta-plane (and variable-depth) meshes are supported by overriding
    the local mesh's f / bottom_depth arrays with per-shard windows of
    the global arrays (sliced, not recomputed, so the periodic-wrap
    discontinuity of f matches the global mesh exactly); the local
    mesh's static uniform-scalar table drops those attrs so trisk.col
    falls back to the per-element columns
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from omega_tpu.core.config import ModelConfig
from omega_tpu.core.state import ModelState
from omega_tpu.mesh.horz_mesh import HorzMesh
from omega_tpu.mesh.planar import planar_hex_mesh
from omega_tpu.ops import structured

HW = 4   # halo rows/cols (>= reference HaloWidth 3; even preserves parity)

# per-element mesh fields that may vary spatially on a planar hex mesh
# (everything else — dc, dv, areas, kites, weights — is uniform by
# construction); ordered (attr, element class)
_VARIABLE_ATTRS = (("f_cell", "cell"), ("f_edge", "edge"),
                   ("f_vertex", "vertex"), ("bottom_depth", "cell"))
_NPER = {"cell": 1, "edge": 3, "vertex": 2}


@dataclasses.dataclass(frozen=True)
class StructuredShards:
    nshards: int
    sy: int                      # shard grid rows
    sx: int                      # shard grid cols
    nx: int                      # global grid
    ny: int
    band: int                    # owned rows per shard
    band_x: int                  # owned cols per shard (nx when sx == 1)
    hw: int                      # halo rows
    hwx: int                     # halo cols (0 when sx == 1)
    local_mesh: HorzMesh         # planar hex local mesh, shared
    global_mesh: HorzMesh
    # stacked (S, N_local) per-shard windows of non-uniform mesh fields,
    # ((attr, array), ...); () on fully uniform (f-plane) meshes
    mesh_overrides: tuple = ()

    @property
    def nyl(self):
        return self.band + 2 * self.hw

    @property
    def nxl(self):
        return self.band_x + 2 * self.hwx


def _choose_layout(nx, ny, nshards, hw):
    """(sy, sx) with ny%sy==0, even band>=hw, nx%sx==0, band_x>=hw.
    Prefers row bands (sx=1), then the most-square valid factorization."""
    opts = []
    for sx in range(1, nshards + 1):
        if nshards % sx:
            continue
        sy = nshards // sx
        if ny % sy:
            continue
        band = ny // sy
        if band % 2 or band < hw:
            continue
        if sx > 1:
            if nx % sx:
                continue
            if nx // sx < hw:
                continue
        opts.append((sx != 1, abs(sy - sx), sy, sx))
    if not opts:
        raise ValueError(
            f"no valid (sy, sx) layout for nx={nx}, ny={ny}, "
            f"nshards={nshards} (need ny%sy==0 with even band>=hw={hw}, "
            f"and nx%sx==0 with band_x>=hw)")
    opts.sort()
    _, _, sy, sx = opts[0]
    return sy, sx


def decompose_structured(mesh: HorzMesh, nshards: int, hw: int = HW,
                         layout: Optional[Tuple[int, int]] = None
                         ) -> StructuredShards:
    nx, ny = mesh.structured_nx, mesh.structured_ny
    if nx == 0:
        raise ValueError("mesh is not structured")
    if layout is None:
        sy, sx = _choose_layout(nx, ny, nshards, hw)
    else:
        sy, sx = layout
        if sy * sx != nshards:
            raise ValueError(f"layout {layout} != {nshards} shards")
    band = ny // sy
    band_x = nx // sx
    hwx = hw if sx > 1 else 0
    if ny % sy or band % 2 or band < hw:
        raise ValueError(f"rows: ny={ny} needs sy | ny with even "
                         f"band >= hw, got sy={sy}")
    if sx > 1 and (nx % sx or band_x < hw):
        raise ValueError(f"cols: nx={nx} needs sx | nx with "
                         f"band_x >= hw, got sx={sx}")

    f0 = structured.uniform_scalar(mesh, "f_cell")
    depth = structured.uniform_scalar(mesh, "bottom_depth")
    local = planar_hex_mesh(band_x + 2 * hwx, band + 2 * hw,
                            dc=mesh.structured_dc,
                            f0=f0 if f0 is not None else 0.0,
                            bottom_depth=depth if depth is not None else 1.0)

    ss = StructuredShards(nshards=nshards, sy=sy, sx=sx, nx=nx, ny=ny,
                          band=band, band_x=band_x, hw=hw, hwx=hwx,
                          local_mesh=local, global_mesh=mesh)

    # per-shard windows of any non-uniform field (beta-plane f, variable
    # bathymetry); strip those attrs from the local static scalar table
    overrides = []
    stale = set()
    for attr, cls in _VARIABLE_ATTRS:
        if structured.uniform_scalar(mesh, attr) is None:
            arr = np.asarray(getattr(mesh, attr))
            loc = _split_field(ss, arr[:, None], _NPER[cls])[..., 0]
            overrides.append((attr, jnp.asarray(loc)))
            stale.add(attr)
    if stale:
        keep = tuple((a, v) for a, v in local.structured_scalars
                     if a not in stale)
        local = dataclasses.replace(local, structured_scalars=keep)
        ss = dataclasses.replace(ss, local_mesh=local,
                                 mesh_overrides=tuple(overrides))
    return ss


# ----------------------------------------------------------------------
# state scatter/gather (host side)

def _rows(ss: StructuredShards, iy: int) -> np.ndarray:
    """Global row indices (wrapped) of a shard row's local rows."""
    start = iy * ss.band - ss.hw
    return (start + np.arange(ss.band + 2 * ss.hw)) % ss.ny


def _cols(ss: StructuredShards, ix: int) -> np.ndarray:
    start = ix * ss.band_x - ss.hwx
    return (start + np.arange(ss.band_x + 2 * ss.hwx)) % ss.nx


def _split_field(ss: StructuredShards, f, nper: int):
    """(..., nper*ny*nx, K) -> (S, ..., nper*nyl*nxl, K)."""
    f = np.asarray(f)
    K = f.shape[-1]
    lead = f.shape[:-2]
    g = f.reshape(lead + (nper, ss.ny, ss.nx, K))
    outs = []
    for iy in range(ss.sy):
        rows = _rows(ss, iy)
        gr = np.take(g, rows, axis=len(lead) + 1)
        for ix in range(ss.sx):
            loc = np.take(gr, _cols(ss, ix), axis=len(lead) + 2)
            outs.append(loc.reshape(lead + (nper * ss.nyl * ss.nxl, K)))
    return np.stack(outs)


def shard_state(ss: StructuredShards, state: ModelState) -> ModelState:
    return ModelState(
        h=jnp.asarray(_split_field(ss, state.h, 1)),
        u=jnp.asarray(_split_field(ss, state.u, 3)),
        tracers=jnp.asarray(_split_field(ss, state.tracers, 1)))


def gather_state(ss: StructuredShards, sstate: ModelState) -> ModelState:
    """Owned windows of every shard -> global state."""
    def merge(f, nper):
        f = np.asarray(f)                    # (S, ..., nper*nyl*nxl, K)
        K = f.shape[-1]
        lead = f.shape[1:-2]
        nl = len(lead)
        g = f.reshape((ss.sy, ss.sx) + lead + (nper, ss.nyl, ss.nxl, K))
        own = g[(slice(None), slice(None)) + (slice(None),) * nl +
                (slice(None),
                 slice(ss.hw, ss.hw + ss.band),
                 slice(ss.hwx, ss.hwx + ss.band_x))]
        # (sy, sx, lead..., nper, band, band_x, K) ->
        # (lead..., nper, sy, band, sx, band_x, K) -> global (ny, nx)
        perm = tuple(range(2, 2 + nl)) + (2 + nl, 0, 3 + nl, 1,
                                          4 + nl, 5 + nl)
        own = own.transpose(perm)
        out = own.reshape(lead + (nper, ss.sy * ss.band,
                                  ss.sx * ss.band_x, K))
        return out.reshape(lead + (nper * ss.ny * ss.nx, K))

    return ModelState(h=jnp.asarray(merge(sstate.h, 1)),
                      u=jnp.asarray(merge(sstate.u, 3)),
                      tracers=jnp.asarray(merge(sstate.tracers, 1)))


def element_maps(ss: StructuredShards, cls: str):
    """(l2g, owned) for one element class: (S, nper*nyl*nxl) global ids
    of every local element and the owned-window mask — feeds sharded
    region writes (io.stream.ShardedFieldData)."""
    nper = _NPER[cls]
    S = ss.nshards
    n_loc = nper * ss.nyl * ss.nxl
    l2g = np.zeros((S, n_loc), np.int64)
    owned = np.zeros((S, n_loc), bool)
    oy = (np.arange(ss.nyl) >= ss.hw) & \
        (np.arange(ss.nyl) < ss.hw + ss.band)
    ox = (np.arange(ss.nxl) >= ss.hwx) & \
        (np.arange(ss.nxl) < ss.hwx + ss.band_x)
    own_grid = (oy[None, :, None] & ox[None, None, :]) & \
        np.ones((nper, 1, 1), bool)
    for iy in range(ss.sy):
        rows = _rows(ss, iy)
        for ix in range(ss.sx):
            cols = _cols(ss, ix)
            gid = (np.arange(nper)[:, None, None] * (ss.ny * ss.nx)
                   + rows[None, :, None] * ss.nx + cols[None, None, :])
            s = iy * ss.sx + ix
            l2g[s] = gid.reshape(-1)
            owned[s] = own_grid.reshape(-1)
    return l2g, owned


# ----------------------------------------------------------------------
# device-side halo exchange: two stages of block ppermutes

def _perm_y(ss, d):
    """Pairs (s, neighbor) moving row blocks d shard-rows forward."""
    out = []
    for iy in range(ss.sy):
        for ix in range(ss.sx):
            out.append((iy * ss.sx + ix,
                        ((iy + d) % ss.sy) * ss.sx + ix))
    return out


def _perm_x(ss, d):
    out = []
    for iy in range(ss.sy):
        for ix in range(ss.sx):
            out.append((iy * ss.sx + ix,
                        iy * ss.sx + (ix + d) % ss.sx))
    return out


def _exchange_bundle(ss: StructuredShards, bundle, axis_name: str):
    """Halo refresh of a (T, nyl, nxl, K) stacked grid array."""
    hw, hwx = ss.hw, ss.hwx
    # stage 1: rows between y-neighbors (full local width)
    if ss.sy > 1:
        up = jax.lax.ppermute(bundle[:, ss.band:ss.band + hw],
                              axis_name, _perm_y(ss, 1))
        dn = jax.lax.ppermute(bundle[:, hw:2 * hw],
                              axis_name, _perm_y(ss, -1))
    else:
        up = bundle[:, ss.band:ss.band + hw]
        dn = bundle[:, hw:2 * hw]
    bundle = jnp.concatenate([up, bundle[:, hw:ss.band + hw], dn], axis=1)
    # stage 2: columns between x-neighbors (full local height including
    # the fresh y-halos, which fills the corners)
    if ss.sx > 1:
        rt = jax.lax.ppermute(bundle[:, :, ss.band_x:ss.band_x + hwx],
                              axis_name, _perm_x(ss, 1))
        lt = jax.lax.ppermute(bundle[:, :, hwx:2 * hwx],
                              axis_name, _perm_x(ss, -1))
        bundle = jnp.concatenate(
            [rt, bundle[:, :, hwx:ss.band_x + hwx], lt], axis=2)
    return bundle


def _exchange_array(ss: StructuredShards, x, nper: int, axis_name: str):
    """Halo refresh of one element array (..., nper*nyl*nxl, K)."""
    K = x.shape[-1]
    lead = x.shape[:-2]
    g = x.reshape((-1, ss.nyl, ss.nxl, K))
    g = _exchange_bundle(ss, g, axis_name)
    return g.reshape(lead + (nper * ss.nyl * ss.nxl, K))


def _exchange_rows(ss: StructuredShards, st: ModelState,
                   axis_name: str) -> ModelState:
    nyl, nxl = ss.nyl, ss.nxl
    K = st.h.shape[-1]
    L = st.tracers.shape[0]

    h = st.h.reshape(1, nyl, nxl, K)
    u = st.u.reshape(3, nyl, nxl, K)
    tr = st.tracers.reshape(L, nyl, nxl, K)
    bundle = jnp.concatenate([h, u, tr], axis=0)     # (4+L, nyl, nxl, K)
    bundle = _exchange_bundle(ss, bundle, axis_name)
    h, u, tr = bundle[:1], bundle[1:4], bundle[4:]
    return ModelState(h=h.reshape(nyl * nxl, K),
                      u=u.reshape(3 * nyl * nxl, K),
                      tracers=tr.reshape(L, nyl * nxl, K))


def make_sharded_step(ss: StructuredShards, cfg: ModelConfig, stepper,
                      device_mesh: Mesh, axis_name: str = "x",
                      wind_stress=None, exchange_every: int = 1) -> Callable:
    """Jittable sharded step over the structured decomposition.

    Every shard runs the SAME structured local mesh (roll fast path
    stays on); the halo callback is the two-stage block ppermute.

    exchange_every=k > 1 amortizes communication (the reference's
    deep-halo pattern, base/Halo.h:849 + RK4's mid-step skip): the
    returned step advances k steps per call with ONE exchange at the
    end, trading halo redundancy for 1/k the collectives. Requires
    hw >= k * (per-step stencil radius, 3 with del4 enabled) + 1 and a
    stepper whose only halo use is the end-of-step refresh (FB, RK2 —
    not split-explicit, whose subcycles exchange internally)."""
    pspec = P(axis_name)
    state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)
    local = ss.local_mesh

    def scatter_wind(w):
        """(zonal, merid) global (C,) arrays -> stacked per-shard windows
        (for time-varying forcing updates between segments)."""
        return tuple(
            jnp.asarray(_split_field(ss, np.asarray(x)[:, None], 1))[..., 0]
            for x in w)

    if wind_stress is not None:
        wind_stress = scatter_wind(wind_stress)
    wspecs = (P() if wind_stress is None
              else tuple(pspec for _ in wind_stress))

    ov_names = tuple(a for a, _ in ss.mesh_overrides)
    ov_data = tuple(v for _, v in ss.mesh_overrides)
    ovspecs = tuple(pspec for _ in ov_data)

    def local_step(state_stacked, wind_stacked, ov_stacked, t, dt):
        st = jax.tree.map(lambda a: a[0], state_stacked)
        mesh_l = local
        if ov_names:
            mesh_l = dataclasses.replace(
                mesh_l, **{a: v[0] for a, v in zip(ov_names, ov_stacked)})
        halo_fn = lambda s: _exchange_rows(ss, s, axis_name)
        # split-explicit subcycles refresh their own 2D fields through
        # these per-array exchanges (cells nper=1, edges nper=3)
        halo_fn.cell = lambda x: _exchange_array(ss, x, 1, axis_name)
        halo_fn.edge = lambda x: _exchange_array(ss, x, 3, axis_name)
        wind = (None if wind_stacked is None
                else tuple(w[0] for w in wind_stacked))
        for i in range(exchange_every - 1):
            # halo garbage creeps inward one radius per un-exchanged
            # step; hw budgets for it
            st = stepper(mesh_l, cfg, st, t + i * dt, dt,
                         wind_stress=wind)
        out = stepper(mesh_l, cfg, st, t + (exchange_every - 1) * dt, dt,
                      halo_fn, wind_stress=wind)
        return jax.tree.map(lambda a: a[None], out)

    sharded = jax.shard_map(local_step, mesh=device_mesh,
                            in_specs=(state_specs, wspecs, ovspecs,
                                      P(), P()),
                            out_specs=state_specs)

    def step(st, t, dt, wind=None):
        return sharded(st, wind_stress if wind is None else wind,
                       ov_data, t, dt)

    step.scatter_wind = scatter_wind
    return step


def make_sharded_energetics(ss: StructuredShards, cfg,
                            device_mesh: Mesh, axis_name: str = "x"):
    """Sharded energetics sampler for the structured decomposition
    (analysis.energetics_local per shard + double-double psum): removes
    the global-state gather at analysis sample boundaries. Returns
    sample(state, ssh_ref=None) -> (row dict, ssh_ref)."""
    import dataclasses as _dc

    from omega_tpu import analysis as ana
    pspec = P(axis_name)
    state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)
    local = ss.local_mesh
    ov_names = tuple(a for a, _ in ss.mesh_overrides)
    ov_data = tuple(v for _, v in ss.mesh_overrides)
    ovspecs = tuple(pspec for _ in ov_data)
    own_c = jnp.asarray(element_maps(ss, "cell")[1].astype(np.float64))
    own_v = jnp.asarray(element_maps(ss, "vertex")[1].astype(np.float64))

    def mesh_of(ov_stacked):
        m = local
        if ov_names:
            m = _dc.replace(m, **{a: v[0] for a, v in
                                  zip(ov_names, ov_stacked)})
        return m

    def local_row(ov_st, oc, ov_, state_st, ssh_ref):
        st = jax.tree.map(lambda a: a[0], state_st)
        return tuple(d[1] for d in sorted(ana.energetics_local(
            mesh_of(ov_st), cfg, st, oc[0], ov_[0], ssh_ref,
            axis_name).items()))

    def local_mean(ov_st, oc, state_st):
        st = jax.tree.map(lambda a: a[0], state_st)
        return ana.mean_ssh_local(mesh_of(ov_st), cfg, st, oc[0],
                                  axis_name)

    def sample(state, ssh_ref=None):
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
                in_specs=(ovspecs, pspec, state_specs),
                out_specs=P(), check_vma=False))(ov_data, own_c, state))
        vals = jax.jit(jax.shard_map(
            local_row, mesh=device_mesh,
            in_specs=(ovspecs, pspec, pspec, state_specs, P()),
            out_specs=tuple(P() for _ in keys), check_vma=False))(
                ov_data, own_c, own_v, state, jnp.asarray(ssh_ref))
        row = {k: float(v) for k, v in zip(keys, vals)}
        row["total_energy"] = (row["kinetic_energy"]
                               + row["potential_energy"])
        return row, ssh_ref

    return sample
