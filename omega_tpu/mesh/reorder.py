"""Space-filling-curve renumbering of unstructured meshes.

SURVEY.md hard part (a): TRiSK gathers live or die by index locality. This module permutes cells, edges, and vertices of a HorzMesh
along a Hilbert curve (cells), with edges/vertices renumbered by their
first adjacent cell — the same locality-sorted, degree-padded layout seed
the reference gets from its CPU VecLength blocking (SURVEY.md section
2.6) and METIS partition locality.

Applying this to a loaded MPAS mesh keeps all operator results identical
up to the permutation (tested) while tightening the index windows every
gather touches, so neighbouring destinations read neighbouring rows.
"""

from __future__ import annotations

import numpy as np

from omega_tpu.mesh.horz_mesh import HorzMesh, finalize_mesh


def _morton3(x, y, z, bits: int = 20) -> np.ndarray:
    """3-D Morton keys of coordinates normalized to [0, 1)."""
    def q(v):
        return np.minimum((v * (1 << bits)).astype(np.uint64),
                          np.uint64((1 << bits) - 1))
    xi, yi, zi = q(x), q(y), q(z)
    key = np.zeros_like(xi)
    for b in range(bits):
        bb = np.uint64(b)
        key |= ((xi >> bb) & np.uint64(1)) << np.uint64(3 * b)
        key |= ((yi >> bb) & np.uint64(1)) << np.uint64(3 * b + 1)
        key |= ((zi >> bb) & np.uint64(1)) << np.uint64(3 * b + 2)
    return key


def _rcm_cell_perm(mesh: HorzMesh) -> np.ndarray:
    """Reverse Cuthill-McKee order of the cell graph: bounded bandwidth
    (~O(sqrt N) with no curve seams) — Morton/Hilbert curves on a sphere
    have seam blocks whose index window spans the whole mesh."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    coc = np.asarray(mesh.cells_on_cell, np.int64)
    n_eoc = np.asarray(mesh.n_edges_on_cell, np.int64)
    C = mesh.ncells
    slot = np.arange(coc.shape[1])[None, :] < n_eoc[:, None]
    slot &= coc >= 0
    rows = np.broadcast_to(np.arange(C)[:, None], coc.shape)[slot]
    cols = coc[slot]
    A = csr_matrix((np.ones_like(cols), (rows, cols)), shape=(C, C))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      np.int64)


def sfc_permutations(mesh: HorzMesh, method: str = "rcm"):
    """(cell_perm, edge_perm, vertex_perm): new order -> old index.

    method 'rcm' (default): reverse Cuthill-McKee — bounded index
    bandwidth. method 'sfc':
    planar meshes use a 2-D Hilbert curve; spherical meshes 3-D Morton
    keys of the unit-sphere positions."""
    from omega_tpu.parallel import native
    from omega_tpu.parallel.decomp import _norm_coords

    if method == "rcm":
        cell_perm = _rcm_cell_perm(mesh)
    elif mesh.on_sphere:
        lat = np.asarray(mesh.lat_cell)
        lon = np.asarray(mesh.lon_cell)
        px = 0.5 * (np.cos(lat) * np.cos(lon) + 1.0)
        py = 0.5 * (np.cos(lat) * np.sin(lon) + 1.0)
        pz = 0.5 * (np.sin(lat) + 1.0)
        keys = _morton3(px, py, pz)
        cell_perm = np.argsort(keys, kind="stable")
    else:
        x, y = _norm_coords(mesh)
        keys = native.hilbert_keys(x, y)
        cell_perm = np.argsort(keys, kind="stable")
    cell_rank = np.empty_like(cell_perm)
    cell_rank[cell_perm] = np.arange(mesh.ncells)

    # edges/vertices ordered by (rank of first adjacent cell, old id)
    coe = np.asarray(mesh.cells_on_edge)
    cov = np.asarray(mesh.cells_on_vertex)
    edge_perm = np.lexsort((np.arange(mesh.nedges), cell_rank[coe[:, 0]]))
    vertex_perm = np.lexsort((np.arange(mesh.nvertices),
                              cell_rank[cov[:, 0]]))
    return cell_perm, edge_perm, vertex_perm


def reorder_mesh(mesh: HorzMesh, method: str = "rcm") -> HorzMesh:
    """Return an equivalent HorzMesh with locality-local element
    numbering ('rcm' default: bounded bandwidth; 'sfc': space-filling
    curve)."""
    cp, ep, vp = sfc_permutations(mesh, method)
    C, E, V = mesh.ncells, mesh.nedges, mesh.nvertices
    cr = np.empty(C, np.int64); cr[cp] = np.arange(C)
    er = np.empty(E, np.int64); er[ep] = np.arange(E)
    vr = np.empty(V, np.int64); vr[vp] = np.arange(V)

    def remap(idx, rank):
        idx = np.asarray(idx, np.int64)
        out = rank[np.maximum(idx, 0)]
        return np.where(idx >= 0, out, -1)

    a = lambda n: np.asarray(getattr(mesh, n))
    n_eoc = a("n_edges_on_cell")[cp]
    M = mesh.max_edges
    pad_c = np.arange(M)[None, :] >= n_eoc[:, None]

    raw = dict(
        x_cell=a("x_cell")[cp], y_cell=a("y_cell")[cp],
        lon_cell=a("lon_cell")[cp], lat_cell=a("lat_cell")[cp],
        area_cell=a("area_cell")[cp], f_cell=a("f_cell")[cp],
        bottom_depth=a("bottom_depth")[cp],
        n_edges_on_cell=n_eoc,
        edges_on_cell=np.where(pad_c, -1, remap(a("edges_on_cell")[cp], er)),
        cells_on_cell=np.where(pad_c, -1, remap(a("cells_on_cell")[cp], cr)),
        vertices_on_cell=np.where(pad_c, -1,
                                  remap(a("vertices_on_cell")[cp], vr)),
        x_edge=a("x_edge")[ep], y_edge=a("y_edge")[ep],
        lon_edge=a("lon_edge")[ep], lat_edge=a("lat_edge")[ep],
        dc_edge=a("dc_edge")[ep], dv_edge=a("dv_edge")[ep],
        angle_edge=a("angle_edge")[ep], f_edge=a("f_edge")[ep],
        cells_on_edge=remap(a("cells_on_edge")[ep], cr),
        vertices_on_edge=remap(a("vertices_on_edge")[ep], vr),
        n_edges_on_edge=a("n_edges_on_edge")[ep],
        edges_on_edge=remap(a("edges_on_edge")[ep], er),
        weights_on_edge=a("weights_on_edge")[ep],
        mesh_scaling_del2=a("mesh_scaling_del2")[ep],
        mesh_scaling_del4=a("mesh_scaling_del4")[ep],
        x_vertex=a("x_vertex")[vp], y_vertex=a("y_vertex")[vp],
        lon_vertex=a("lon_vertex")[vp], lat_vertex=a("lat_vertex")[vp],
        area_triangle=a("area_triangle")[vp], f_vertex=a("f_vertex")[vp],
        cells_on_vertex=remap(a("cells_on_vertex")[vp], cr),
        edges_on_vertex=remap(a("edges_on_vertex")[vp], er),
        kite_areas_on_vertex=a("kite_areas_on_vertex")[vp],
    )
    return finalize_mesh(raw, ncells=C, nedges=E, nvertices=V,
                         max_edges=M, vertex_degree=mesh.vertex_degree,
                         on_sphere=mesh.on_sphere,
                         sphere_radius=mesh.sphere_radius,
                         x_period=mesh.x_period, y_period=mesh.y_period)


def gather_window_stats(mesh: HorzMesh, block: int = 256,
                        reduce: str = "max") -> dict:
    """Index window each `block` of consecutive destinations touches, per
    stencil — the locality measure the renumbering tightens.

    reduce: 'max' (worst block; dominated by periodic-seam blocks) or
    'median' (typical block, the cache-locality indicator)."""
    out = {}
    for name, idx in (("edges_on_cell", mesh.edges_on_cell),
                      ("cells_on_edge", mesh.cells_on_edge),
                      ("edges_on_vertex", mesh.edges_on_vertex),
                      ("cells_on_vertex", mesh.cells_on_vertex),
                      ("edges_on_edge", mesh.edges_on_edge)):
        idx = np.asarray(idx)
        N = idx.shape[0]
        nb = (N + block - 1) // block
        ws = []
        for b in range(nb):
            sl = idx[b * block:(b + 1) * block]
            valid = sl[sl >= 0]
            if valid.size:
                ws.append(int(valid.max() - valid.min() + 1))
        out[name] = int(np.max(ws) if reduce == "max" else np.median(ws))
    return out
