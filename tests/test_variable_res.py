"""Variable-resolution sphere meshes (EC30to60-class analogue).

The reference runs variable-resolution MPAS meshes (EC30to60 etc.,
partitioned by METIS — base/Decomp.cpp:968). Our generator builds one by
a conformal (Mobius) dilation of the icos generators
(mesh/spherical.spherical_icos_mesh refine_factor): Delaunay-preserving,
so the Voronoi mesh stays valid while cell spacing varies smoothly by
~1/a^2 pole to pole. These tests cover the three things VERDICT r1
flagged as unexercised on nonuniform meshes: mesh validity + operator
behavior, SFC partition quality (work balance and edge cut), and
decomposition invariance of the general sharded path.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.stepping import forward_backward_step

A = 0.5     # conformal factor: ~4x spacing ratio pole to pole


@pytest.fixture(scope="module")
def vmesh():
    return spherical_icos_mesh(12, refine_factor=A)


def test_variable_res_mesh_valid(vmesh):
    """Geometry stays consistent after the warp: positive areas/kites,
    areas sum to the sphere, and the dc ratio shows real variable
    resolution (~1/A^2 up to mesh-discreteness)."""
    m = vmesh
    area = np.asarray(m.area_cell)
    kites = np.asarray(m.kite_areas_on_vertex)
    dc = np.asarray(m.dc_edge)
    dv = np.asarray(m.dv_edge)
    assert (area > 0).all() and (dc > 0).all() and (dv > 0).all()
    assert (kites > 0).all()
    R = float(m.sphere_radius)
    np.testing.assert_allclose(area.sum(), 4 * np.pi * R * R, rtol=1e-9)
    ratio = dc.max() / dc.min()
    assert 2.0 < ratio < 10.0, ratio
    # resolution correlates with latitude (finer at the north pole)
    lat_e = np.asarray(m.lat_edge)
    north = dc[lat_e > np.deg2rad(45)].mean()
    south = dc[lat_e < np.deg2rad(-45)].mean()
    assert south / north > 2.0


def test_variable_res_operator_accuracy(vmesh):
    """Divergence of an analytic spherical field converges on the warped
    mesh: error at n=24 below error at n=12 by ~2x (first order at the
    distorted-cell floor is acceptable; uniform-mesh order tests live in
    test_spherical.py)."""
    from omega_tpu.ops import trisk

    errs = []
    for n in (12, 24):
        m = spherical_icos_mesh(n, refine_factor=A)
        R = float(m.sphere_radius)
        lat_e = np.asarray(m.lat_edge)
        lon_e = np.asarray(m.lon_edge)
        lat_c = np.asarray(m.lat_cell)
        # zonal solid-body flow u = U0 cos(lat): div = 0... use a
        # meridional field v = V0 cos(lat) instead:
        # div = -2 V0 sin(lat) / R  (exact on the sphere)
        V0 = 1.0
        ang = np.asarray(m.angle_edge)
        ve = V0 * np.cos(lat_e)
        un = jnp.asarray((ve * np.sin(ang))[:, None])   # normal component
        div = np.asarray(trisk.div_cell(m, un))[:, 0]
        exact = -2 * V0 * np.sin(lat_c) / R
        errs.append(np.sqrt(np.mean((div - exact) ** 2))
                    / np.sqrt(np.mean(exact ** 2)))
    assert errs[1] < 0.6 * errs[0], errs


def test_variable_res_partition_quality(vmesh):
    """SFC + KL refinement on the nonuniform mesh: equal per-shard cell
    counts (work balance — every cell costs the same K columns) and an
    edge cut well below a random partition's expectation."""
    from omega_tpu.parallel.decomp import partition_cells

    m = vmesh
    nsh = 8
    own = np.asarray(partition_cells(m, nsh))
    counts = np.bincount(own, minlength=nsh)
    # KL refinement trades a few cells of balance for edge cut; METIS's
    # own default imbalance tolerance is 3-5% (ubvec), allow 5%
    assert counts.max() <= 1.05 * counts.mean(), counts
    coc = np.asarray(m.cells_on_cell)
    ne = np.asarray(m.n_edges_on_cell)
    cut = 0
    total = 0
    for c in range(m.ncells):
        for k in range(int(ne[c])):
            nb = int(coc[c, k])
            if nb > c:
                total += 1
                cut += own[nb] != own[c]
    # random expectation: (1 - 1/nsh) * total ~ 0.875 total; a locality-
    # preserving partition should cut far less
    assert cut < 0.25 * total, (cut, total)


def test_variable_res_sharded_invariance(vmesh):
    """General sharded step on the variable-resolution mesh matches the
    single-device composed step (the decomposition-invariance gate,
    doc/design/OmegaV0ShallowWater.md:57-59, on a nonuniform mesh)."""
    from omega_tpu.parallel import (decompose, gather_state,
                                    make_sharded_step, shard_state)
    from omega_tpu.parallel.sharded import default_device_mesh

    m = vmesh
    K, L = 3, 2
    cfg = ModelConfig(nvertlayers=K, ntracers=L,
                      tendencies=TendencyConfig(visc_del2=1e3,
                                                visc_del4=1e7))
    ssh = 2.0 * np.sin(2 * np.asarray(m.lat_cell)) * \
        np.cos(np.asarray(m.lon_cell))
    d0 = float(np.asarray(m.bottom_depth)[0]) \
        if np.ndim(m.bottom_depth) else float(m.bottom_depth)
    h = jnp.asarray((d0 + ssh[:, None]) / K) * jnp.ones((1, K))
    st = ModelState(h=h, u=jnp.zeros((m.nedges, K)),
                    tracers=10.0 + jnp.zeros((L, m.ncells, K)))
    dt, nsteps = 100.0, 4

    ref = st
    for i in range(nsteps):
        ref = forward_backward_step(m, cfg, ref, i * dt, dt)

    import jax
    sm = decompose(m, 4)
    dmesh = default_device_mesh(4)
    step = jax.jit(make_sharded_step(sm, cfg, forward_backward_step, dmesh))
    sst = shard_state(sm, st)
    for i in range(nsteps):
        sst = step(sst, i * dt, dt)
    out = gather_state(sm, sst, m.ncells, m.nedges)
    for nm in ("h", "u", "tracers"):
        np.testing.assert_allclose(np.asarray(getattr(out, nm)),
                                   np.asarray(getattr(ref, nm)),
                                   rtol=0, atol=1e-11, err_msg=nm)
    vol0 = float(jnp.sum(st.h * m.area_cell[:, None]))
    vol1 = float(jnp.sum(ref.h * m.area_cell[:, None]))
    assert abs(vol1 - vol0) / vol0 < 1e-13
