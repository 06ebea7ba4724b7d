"""Domain decomposition — the JAX analogue of base/Decomp + base/Halo.

The reference partitions the cell graph with METIS (base/Decomp.cpp:968),
derives edge/vertex ownership from the first adjacent cell
(base/Decomp.h:108-130), grows HaloWidth=3 layers of ghost elements, and
builds per-neighbor send/recv index lists for MPI halo exchange
(base/Halo.cpp:455-600).

Here the same construction happens once on host (numpy): cells are
partitioned (space-filling-curve by default; METIS-free), each shard gets an
owned+halo local mesh with locally renumbered connectivity padded to a
common size, and the exchange lists are baked into static gather indices.
At runtime the halo exchange is a shard_map collective (see
omega_tpu/parallel/halo.py) instead of MPI_Irecv/Isend polling
(base/Halo.h:769-915).

Every local mesh gets one trailing dummy row per element class; padded
exchange-list slots target the dummy row so scatter stays in-bounds.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np

from omega_tpu.mesh.horz_mesh import HorzMesh, finalize_mesh

HALO_WIDTH = 3   # configs/Default.yml Decomp.HaloWidth


def _morton_key(x, y, bits=16):
    """Interleave normalized coordinates into a Morton (Z-order) key."""
    xi = np.clip((x * (1 << bits)).astype(np.uint64), 0, (1 << bits) - 1)
    yi = np.clip((y * (1 << bits)).astype(np.uint64), 0, (1 << bits) - 1)
    key = np.zeros_like(xi)
    for b in range(bits):
        key |= ((xi >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
        key |= ((yi >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b + 1)
    return key


def _norm_coords(mesh: HorzMesh):
    """Cell coordinates normalized to [0, 1)^2 (cylindrical on the sphere)."""
    if mesh.on_sphere:
        x = (np.asarray(mesh.lon_cell) % (2 * np.pi)) / (2 * np.pi)
        y = (np.asarray(mesh.lat_cell) + np.pi / 2) / np.pi
    else:
        x = np.asarray(mesh.x_cell) / max(mesh.x_period, 1e-30)
        y = np.asarray(mesh.y_cell) / max(mesh.y_period, 1e-30)
    return x % 1.0, np.clip(y, 0.0, 1.0 - 1e-12)


def partition_cells(mesh: HorzMesh, nshards: int,
                    method: str = "hilbert") -> np.ndarray:
    """Assign an owning shard to every cell.

    "hilbert": Hilbert space-filling-curve chunking via the native C++
    partitioner (omega_tpu.parallel.native; numpy fallback built in) —
    the METIS-free stand-in for base/Decomp.cpp:968 with good locality.
    "sfc": Morton (Z-order) curve, pure numpy.
    "stripe": contiguous global-id ranges (useful for tests).
    """
    C = mesh.ncells
    if method == "hilbert":
        from omega_tpu.mesh.horz_mesh import unclamped_connectivity
        from omega_tpu.parallel import native
        x, y = _norm_coords(mesh)
        owner = native.partition_geom(x, y, nshards)
        if nshards > 1:
            # graph-aware KL boundary refinement of the geometric seed
            # (the METIS-gap closer for base/Decomp.cpp:968): lowers
            # edge cut, especially on variable-resolution meshes
            coc = unclamped_connectivity(mesh)["cells_on_cell"]
            owner, _ = native.refine_partition(
                coc, np.asarray(mesh.n_edges_on_cell), owner, nshards)
        return owner
    if method == "stripe":
        order = np.arange(C)
    elif method == "sfc":
        x, y = _norm_coords(mesh)
        order = np.argsort(_morton_key(x, y), kind="stable")
    else:
        raise ValueError(f"unknown partition method {method!r}")
    owner = np.empty(C, np.int64)
    bounds = np.linspace(0, C, nshards + 1).astype(np.int64)
    for s in range(nshards):
        owner[order[bounds[s]:bounds[s + 1]]] = s
    return owner


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "mesh", "owned_cell_mask", "owned_edge_mask", "owned_vertex_mask",
        "cell_send_idx", "cell_recv_src_shard", "cell_recv_src_slot", "cell_recv_dst",
        "edge_send_idx", "edge_recv_src_shard", "edge_recv_src_slot", "edge_recv_dst",
        "vertex_send_idx", "vertex_recv_src_shard", "vertex_recv_src_slot",
        "vertex_recv_dst",
        "cell_local_to_global", "edge_local_to_global", "vertex_local_to_global",
    ],
    meta_fields=["nshards", "halo_width"],
)
@dataclasses.dataclass(frozen=True)
class ShardedMesh:
    """Stacked per-shard local meshes + halo exchange index lists.

    All `mesh` leaves have a leading shard axis (S, ...); exchange lists are
    (S, N) int32 padded with entries that target each shard's dummy row.
    """
    nshards: int
    halo_width: int
    mesh: HorzMesh                      # leaves stacked (S, ...)
    owned_cell_mask: jax.Array          # (S, Cl) 1.0 where this shard owns
    owned_edge_mask: jax.Array          # (S, El)
    owned_vertex_mask: jax.Array        # (S, Vl)
    cell_send_idx: jax.Array            # (S, NSc)
    cell_recv_src_shard: jax.Array      # (S, NHc)
    cell_recv_src_slot: jax.Array       # (S, NHc)
    cell_recv_dst: jax.Array            # (S, NHc)
    edge_send_idx: jax.Array            # (S, NSe)
    edge_recv_src_shard: jax.Array      # (S, NHe)
    edge_recv_src_slot: jax.Array       # (S, NHe)
    edge_recv_dst: jax.Array            # (S, NHe)
    # vertex-space exchange (the reference's Halo exchanges any array on
    # any of the three index spaces, base/Halo.h:45; diagnostics like
    # vorticity snapshots need it even though the step loop does not)
    vertex_send_idx: jax.Array          # (S, NSv)
    vertex_recv_src_shard: jax.Array    # (S, NHv)
    vertex_recv_src_slot: jax.Array     # (S, NHv)
    vertex_recv_dst: jax.Array          # (S, NHv)
    cell_local_to_global: jax.Array     # (S, Cl), -1 on padding
    edge_local_to_global: jax.Array     # (S, El)
    vertex_local_to_global: jax.Array   # (S, Vl)


def _halo_layers(owned, cells_on_cell, n_edges_on_cell, width):
    """BFS halo rings over the cell graph (base/Decomp.cpp halo growth)."""
    seen = set(owned.tolist())
    layers = []
    frontier = owned
    for _ in range(width):
        nbrs = cells_on_cell[frontier]
        valid = (np.arange(cells_on_cell.shape[1])[None, :]
                 < n_edges_on_cell[frontier][:, None]) & (nbrs >= 0)
        cand = np.unique(nbrs[valid])
        new = np.array(sorted(c for c in cand.tolist() if c not in seen),
                       np.int64)
        seen.update(new.tolist())
        layers.append(new)
        frontier = new
    return layers


def decompose(mesh: HorzMesh, nshards: int, *, halo_width: int = HALO_WIDTH,
              method: str = "hilbert") -> ShardedMesh:
    """Build the full sharded mesh from a global HorzMesh (host-side)."""
    C, E, V, M, D = (mesh.ncells, mesh.nedges, mesh.nvertices,
                     mesh.max_edges, mesh.vertex_degree)
    g = {name: np.asarray(getattr(mesh, name)) for name in (
        "x_cell", "y_cell", "lon_cell", "lat_cell", "area_cell", "f_cell",
        "bottom_depth", "n_edges_on_cell", "edges_on_cell", "cells_on_cell",
        "vertices_on_cell",
        "x_edge", "y_edge", "lon_edge", "lat_edge", "dc_edge", "dv_edge",
        "angle_edge", "f_edge", "cells_on_edge", "vertices_on_edge",
        "n_edges_on_edge", "edges_on_edge", "weights_on_edge", "edge_mask",
        "mesh_scaling_del2", "mesh_scaling_del4",
        "x_vertex", "y_vertex", "lon_vertex", "lat_vertex", "area_triangle",
        "f_vertex", "cells_on_vertex", "edges_on_vertex",
        "kite_areas_on_vertex", "edge_sign_on_vertex",
    )}
    # the stored connectivity clamps padding to element 0, which collides
    # with the REAL element 0 on boundary (carved/coastal) meshes — remap
    # from the -1-padded form so local finalize sees true padding
    from omega_tpu.mesh.horz_mesh import unclamped_connectivity
    g.update(unclamped_connectivity(mesh))

    owner_cell = partition_cells(mesh, nshards, method)
    # edge/vertex ownership = first VALID adjacent cell (boundary slots
    # are -1 on carved meshes; base/Decomp.h:108-130)
    coe_g = g["cells_on_edge"]
    owner_edge = owner_cell[np.where(coe_g[:, 0] >= 0, coe_g[:, 0],
                                     coe_g[:, 1])]
    cov_g = g["cells_on_vertex"]
    first_v = cov_g[np.arange(V), np.argmax(cov_g >= 0, axis=1)]
    owner_vertex = owner_cell[np.maximum(first_v, 0)]

    from omega_tpu.parallel import native
    all_halos = native.halo_layers(g["cells_on_cell"],
                                   g["n_edges_on_cell"].astype(np.int32),
                                   owner_cell, nshards, halo_width)

    shards = []
    for s in range(nshards):
        owned_cells, halo = all_halos[s]
        local_cells = np.concatenate([owned_cells] + list(halo))

        # edges/vertices incident to any local cell (skip -1 padding)
        valid = (np.arange(M)[None, :] <
                 g["n_edges_on_cell"][local_cells][:, None])
        eoc_l = g["edges_on_cell"][local_cells]
        voc_l = g["vertices_on_cell"][local_cells]
        loc_e = np.unique(eoc_l[valid & (eoc_l >= 0)])
        loc_v = np.unique(voc_l[valid & (voc_l >= 0)])
        # owned first (sorted by global id), then halo
        loc_e = np.concatenate([loc_e[owner_edge[loc_e] == s],
                                loc_e[owner_edge[loc_e] != s]])
        loc_v = np.concatenate([loc_v[owner_vertex[loc_v] == s],
                                loc_v[owner_vertex[loc_v] != s]])
        shards.append(dict(cells=local_cells, edges=loc_e, verts=loc_v,
                           n_owned_c=len(owned_cells),
                           n_owned_e=int((owner_edge[loc_e] == s).sum()),
                           n_owned_v=int((owner_vertex[loc_v] == s).sum())))

    # common padded sizes (+1 dummy row)
    Cl = max(len(sh["cells"]) for sh in shards) + 1
    El = max(len(sh["edges"]) for sh in shards) + 1
    Vl = max(len(sh["verts"]) for sh in shards) + 1

    # ---- send lists: owned elements needed by any other shard ----
    cell_needed = [set() for _ in range(nshards)]   # global ids per owner
    edge_needed = [set() for _ in range(nshards)]
    vert_needed = [set() for _ in range(nshards)]
    for s, sh in enumerate(shards):
        for gc in sh["cells"][sh["n_owned_c"]:].tolist():
            cell_needed[owner_cell[gc]].add(gc)
        for ge in sh["edges"][sh["n_owned_e"]:].tolist():
            edge_needed[owner_edge[ge]].add(ge)
        for gv in sh["verts"][sh["n_owned_v"]:].tolist():
            vert_needed[owner_vertex[gv]].add(gv)
    cell_send_global = [np.array(sorted(cn), np.int64) for cn in cell_needed]
    edge_send_global = [np.array(sorted(en), np.int64) for en in edge_needed]
    vert_send_global = [np.array(sorted(vn), np.int64) for vn in vert_needed]
    NSc = max(1, max(len(a) for a in cell_send_global))
    NSe = max(1, max(len(a) for a in edge_send_global))
    NSv = max(1, max(len(a) for a in vert_send_global))
    NHc = max(1, max(len(sh["cells"]) - sh["n_owned_c"] for sh in shards))
    NHe = max(1, max(len(sh["edges"]) - sh["n_owned_e"] for sh in shards))
    NHv = max(1, max(len(sh["verts"]) - sh["n_owned_v"] for sh in shards))

    # global slot lookup: for each global element, its slot in owner's buffer
    cell_slot = np.full(C, -1, np.int64)
    for o, arr in enumerate(cell_send_global):
        cell_slot[arr] = np.arange(len(arr))
    edge_slot = np.full(E, -1, np.int64)
    for o, arr in enumerate(edge_send_global):
        edge_slot[arr] = np.arange(len(arr))
    vert_slot = np.full(V, -1, np.int64)
    for o, arr in enumerate(vert_send_global):
        vert_slot[arr] = np.arange(len(arr))

    # ---- per-shard arrays ----
    def new(shape, fill, dtype=np.int64):
        return np.full((nshards,) + shape, fill, dtype)

    meshes = []
    owned_cm = np.zeros((nshards, Cl))
    owned_em = np.zeros((nshards, El))
    owned_vm = np.zeros((nshards, Vl))
    c_l2g = new((Cl,), -1)
    e_l2g = new((El,), -1)
    v_l2g = new((Vl,), -1)
    c_send = new((NSc,), Cl - 1)
    e_send = new((NSe,), El - 1)
    c_rsrc = new((NHc,), 0)
    c_rslot = new((NHc,), 0)
    c_rdst = new((NHc,), Cl - 1)
    e_rsrc = new((NHe,), 0)
    e_rslot = new((NHe,), 0)
    e_rdst = new((NHe,), El - 1)
    v_send = new((NSv,), Vl - 1)
    v_rsrc = new((NHv,), 0)
    v_rslot = new((NHv,), 0)
    v_rdst = new((NHv,), Vl - 1)

    for s, sh in enumerate(shards):
        lc, le, lv = sh["cells"], sh["edges"], sh["verts"]
        nc, ne, nv = len(lc), len(le), len(lv)
        c_l2g[s, :nc] = lc
        e_l2g[s, :ne] = le
        v_l2g[s, :nv] = lv
        owned_cm[s, :sh["n_owned_c"]] = 1.0
        owned_em[s, :sh["n_owned_e"]] = 1.0
        owned_vm[s, :sh["n_owned_v"]] = 1.0

        # global -> local lookup (absent -> -1)
        cmap = np.full(C, -1, np.int64); cmap[lc] = np.arange(nc)
        emap = np.full(E, -1, np.int64); emap[le] = np.arange(ne)
        vmap = np.full(V, -1, np.int64); vmap[lv] = np.arange(nv)

        def map_idx(global_rows, lookup):
            out = lookup[np.maximum(global_rows, 0)]
            return np.where(global_rows >= 0, out, -1)

        raw = dict(
            x_cell=_pad(g["x_cell"][lc], Cl),
            y_cell=_pad(g["y_cell"][lc], Cl),
            lon_cell=_pad(g["lon_cell"][lc], Cl),
            lat_cell=_pad(g["lat_cell"][lc], Cl),
            area_cell=_pad(g["area_cell"][lc], Cl, 1.0),
            f_cell=_pad(g["f_cell"][lc], Cl),
            bottom_depth=_pad(g["bottom_depth"][lc], Cl, 1.0),
            n_edges_on_cell=_pad(g["n_edges_on_cell"][lc], Cl).astype(np.int64),
            edges_on_cell=_pad2(map_idx(g["edges_on_cell"][lc], emap), Cl),
            cells_on_cell=_pad2(map_idx(g["cells_on_cell"][lc], cmap), Cl),
            vertices_on_cell=_pad2(map_idx(g["vertices_on_cell"][lc], vmap), Cl),
            x_edge=_pad(g["x_edge"][le], El),
            y_edge=_pad(g["y_edge"][le], El),
            lon_edge=_pad(g["lon_edge"][le], El),
            lat_edge=_pad(g["lat_edge"][le], El),
            dc_edge=_pad(g["dc_edge"][le], El, 1.0),
            dv_edge=_pad(g["dv_edge"][le], El, 1.0),
            angle_edge=_pad(g["angle_edge"][le], El),
            f_edge=_pad(g["f_edge"][le], El),
            cells_on_edge=_pad2(map_idx(g["cells_on_edge"][le], cmap), El),
            vertices_on_edge=_pad2(map_idx(g["vertices_on_edge"][le], vmap), El),
            n_edges_on_edge=_pad(g["n_edges_on_edge"][le], El).astype(np.int64),
            edges_on_edge=_pad2(map_idx(g["edges_on_edge"][le], emap), El),
            weights_on_edge=_pad2(g["weights_on_edge"][le], El),
            mesh_scaling_del2=_pad(g["mesh_scaling_del2"][le], El, 1.0),
            mesh_scaling_del4=_pad(g["mesh_scaling_del4"][le], El, 1.0),
            x_vertex=_pad(g["x_vertex"][lv], Vl),
            y_vertex=_pad(g["y_vertex"][lv], Vl),
            lon_vertex=_pad(g["lon_vertex"][lv], Vl),
            lat_vertex=_pad(g["lat_vertex"][lv], Vl),
            area_triangle=_pad(g["area_triangle"][lv], Vl, 1.0),
            f_vertex=_pad(g["f_vertex"][lv], Vl),
            cells_on_vertex=_pad2(map_idx(g["cells_on_vertex"][lv], cmap), Vl),
            edges_on_vertex=_pad2(map_idx(g["edges_on_vertex"][lv], emap), Vl),
            kite_areas_on_vertex=_pad2(g["kite_areas_on_vertex"][lv], Vl),
        )
        lmesh = finalize_mesh(raw, ncells=Cl, nedges=El, nvertices=Vl,
                              max_edges=M, vertex_degree=D,
                              on_sphere=mesh.on_sphere,
                              sphere_radius=mesh.sphere_radius,
                              x_period=mesh.x_period, y_period=mesh.y_period)
        # boundary-edge mask must reflect the *global* mesh, not local
        # truncation: take the owner's global mask rows
        lmesh = dataclasses.replace(lmesh, edge_mask=_pad(g["edge_mask"][le], El))
        # keep 1/h_vertex finite on fringe/dummy vertices with no local cells
        wk = np.asarray(lmesh.w_kite_frac)
        dead = wk.sum(axis=1) <= 0.0
        wk = np.where(dead[:, None],
                      np.concatenate([np.ones((Vl, 1)), np.zeros((Vl, D - 1))], 1),
                      wk)
        lmesh = dataclasses.replace(lmesh, w_kite_frac=wk)
        meshes.append(lmesh)

        # halo recv lists
        halo_c = lc[sh["n_owned_c"]:]
        c_rsrc[s, :len(halo_c)] = owner_cell[halo_c]
        c_rslot[s, :len(halo_c)] = cell_slot[halo_c]
        c_rdst[s, :len(halo_c)] = np.arange(sh["n_owned_c"], nc)
        halo_e = le[sh["n_owned_e"]:]
        e_rsrc[s, :len(halo_e)] = owner_edge[halo_e]
        e_rslot[s, :len(halo_e)] = edge_slot[halo_e]
        e_rdst[s, :len(halo_e)] = np.arange(sh["n_owned_e"], ne)
        halo_v = lv[sh["n_owned_v"]:]
        v_rsrc[s, :len(halo_v)] = owner_vertex[halo_v]
        v_rslot[s, :len(halo_v)] = vert_slot[halo_v]
        v_rdst[s, :len(halo_v)] = np.arange(sh["n_owned_v"], nv)

        # send lists in *local* indices
        cs = cell_send_global[s]
        c_send[s, :len(cs)] = cmap[cs]
        es = edge_send_global[s]
        e_send[s, :len(es)] = emap[es]
        vs = vert_send_global[s]
        v_send[s, :len(vs)] = vmap[vs]

    stacked = jax.tree.map(lambda *xs: np.stack(xs), *meshes)
    i32 = lambda a: a.astype(np.int32)
    return ShardedMesh(
        nshards=nshards, halo_width=halo_width, mesh=stacked,
        owned_cell_mask=owned_cm, owned_edge_mask=owned_em,
        owned_vertex_mask=owned_vm,
        cell_send_idx=i32(c_send),
        cell_recv_src_shard=i32(c_rsrc), cell_recv_src_slot=i32(c_rslot),
        cell_recv_dst=i32(c_rdst),
        edge_send_idx=i32(e_send),
        edge_recv_src_shard=i32(e_rsrc), edge_recv_src_slot=i32(e_rslot),
        edge_recv_dst=i32(e_rdst),
        vertex_send_idx=i32(v_send),
        vertex_recv_src_shard=i32(v_rsrc), vertex_recv_src_slot=i32(v_rslot),
        vertex_recv_dst=i32(v_rdst),
        cell_local_to_global=i32(c_l2g), edge_local_to_global=i32(e_l2g),
        vertex_local_to_global=i32(v_l2g),
    )


def _pad(arr, n, fill=0.0):
    out = np.full((n,) + arr.shape[1:], fill, arr.dtype)
    out[:len(arr)] = arr
    return out


def _pad2(arr, n):
    out = np.full((n,) + arr.shape[1:], -1, arr.dtype)
    out[:len(arr)] = arr
    return out
