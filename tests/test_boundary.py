"""Land-boundary (carved mesh) tests.

Exercises the boundary-mask code paths (ocn/HorzMesh.cpp:581-604 analogue)
that periodic/sphere generated meshes never hit: no-flux at the coast,
conservation with land present, and the MPAS file round trip with real
0-padding in the connectivity.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.mesh.carve import carve_mesh
from omega_tpu.stepping import forward_backward_step, run_steps


@pytest.fixture(scope="module")
def coastal():
    """24x24 planar mesh with a 6x6 island of land removed."""
    base = planar_hex_mesh(24, 24, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    i = np.arange(base.ncells) % 24
    j = np.arange(base.ncells) // 24
    land = (i >= 9) & (i < 15) & (j >= 9) & (j < 15)
    mesh = carve_mesh(base, ~land)
    assert mesh.ncells == base.ncells - 36
    # real boundary edges exist and are masked
    em = np.asarray(mesh.edge_mask)
    assert (em == 0).sum() > 0 and (em == 1).sum() > 0
    return mesh


def _state(mesh, K=3):
    kx = 2 * np.pi / mesh.x_period
    ky = 2 * np.pi / mesh.y_period
    ssh = 0.5 * np.sin(kx * np.asarray(mesh.x_cell)) * \
        np.sin(ky * np.asarray(mesh.y_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / K) * jnp.ones((1, K))
    tr = jnp.stack([
        10.0 + jnp.asarray(np.cos(kx * np.asarray(mesh.x_cell))[:, None])
        * jnp.ones((1, K)),
        20.0 * jnp.ones((mesh.ncells, K))])
    return ModelState(h=h, u=jnp.zeros((mesh.nedges, K)), tracers=tr)


def test_no_flux_and_conservation(coastal):
    """50 steps against an island: finite, conservative, no normal flow
    through the coast, and active dynamics in the water."""
    mesh = coastal
    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    st = _state(mesh)
    area = np.asarray(mesh.area_cell)[:, None]
    vol0 = np.sum(area * np.asarray(st.h))
    trc0 = np.sum(area * np.asarray(st.h) * np.asarray(st.tracers),
                  axis=(1, 2))
    out = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, 30.0, 50, stepper=forward_backward_step))(st))
    assert np.isfinite(np.asarray(out.h)).all()
    assert np.isfinite(np.asarray(out.u)).all()
    # no-flux: boundary-edge normal velocity never leaves zero
    em = np.asarray(mesh.edge_mask)
    np.testing.assert_array_equal(np.asarray(out.u)[em == 0], 0.0)
    # conservation with land present
    vol1 = np.sum(area * np.asarray(out.h))
    trc1 = np.sum(area * np.asarray(out.h) * np.asarray(out.tracers),
                  axis=(1, 2))
    assert abs(vol1 - vol0) / vol0 < 1e-13
    np.testing.assert_allclose(trc1, trc0, rtol=1e-12)
    # the wave still propagates in the water
    assert np.abs(np.asarray(out.u)[em == 1]).max() > 1e-6


def test_carved_mesh_mpas_roundtrip(coastal, tmp_path):
    """Write the carved mesh as MPAS NetCDF and read it back: padded
    connectivity slots must be 0 in the file (MPAS convention) and the
    re-read mesh must reproduce the dynamics bit-for-bit."""
    from omega_tpu.io.netcdf import read_netcdf
    from omega_tpu.mesh.mpas_io import read_mpas_mesh, write_mpas_mesh

    mesh = coastal
    path = str(tmp_path / "coastal.nc")
    write_mpas_mesh(mesh, path)

    nc = read_netcdf(path)
    coe = np.asarray(nc.get("cellsOnEdge"))
    em = np.asarray(mesh.edge_mask)
    # every boundary edge has exactly one 0 (missing cell) in the file
    assert (coe[em == 0] == 0).sum(axis=None) == (em == 0).sum()
    assert (coe[em == 1] > 0).all()

    mesh2 = read_mpas_mesh(path)
    assert mesh2.ncells == mesh.ncells
    np.testing.assert_array_equal(np.asarray(mesh2.edge_mask), em)

    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    st = _state(mesh)
    run = lambda m: jax.block_until_ready(jax.jit(lambda s: run_steps(
        m, cfg, s, 0.0, 30.0, 5, stepper=forward_backward_step))(st))
    a, b = run(mesh), run(mesh2)
    np.testing.assert_array_equal(np.asarray(a.h), np.asarray(b.h))
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_carved_mesh_sharded(coastal):
    """The carved (unstructured) mesh goes through the general
    decomposition; 8-shard run matches single device."""
    from omega_tpu.parallel import (decompose, gather_state,
                                    make_sharded_step, shard_state)
    from omega_tpu.parallel.sharded import default_device_mesh

    mesh = coastal
    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    st = _state(mesh)
    nst, dt = 4, 30.0
    ref = run_steps(mesh, cfg, st, 0.0, dt, nst,
                    stepper=forward_backward_step)
    sm = decompose(mesh, 8)
    step = jax.jit(make_sharded_step(sm, cfg, forward_backward_step,
                                     default_device_mesh(8)))
    sst = shard_state(sm, st)
    t = 0.0
    for _ in range(nst):
        sst = step(sst, t, dt)
        t += dt
    out = gather_state(sm, sst, mesh.ncells, mesh.nedges)
    np.testing.assert_allclose(np.asarray(out.h), np.asarray(ref.h),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-13, atol=1e-15)


def test_carved_sphere_continent():
    """Land on a global sphere (polar cap carved from an icos mesh):
    no-flux at the coast, conservation, stable dynamics — the
    closest in-repo analogue of a realistic land-mask mesh."""
    from omega_tpu.mesh.spherical import spherical_icos_mesh

    base = spherical_icos_mesh(12, bottom_depth=1000.0)
    land = np.asarray(base.lat_cell) > np.deg2rad(55.0)
    assert land.sum() > 20
    mesh = carve_mesh(base, ~land)
    em = np.asarray(mesh.edge_mask)
    assert (em == 0).sum() > 0

    cfg = ModelConfig(nvertlayers=3, ntracers=1,
                      tendencies=TendencyConfig(visc_del2=1e3,
                                                visc_del4=1e7))
    ssh = 2.0 * np.sin(2 * np.asarray(mesh.lat_cell)) * \
        np.cos(np.asarray(mesh.lon_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / 3) * jnp.ones((1, 3))
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, 3)),
                    tracers=10.0 + jnp.zeros((1, mesh.ncells, 3)))
    area = np.asarray(mesh.area_cell)[:, None]
    vol0 = np.sum(area * np.asarray(st.h))
    out = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, 600.0, 30, stepper=forward_backward_step))(st))
    assert np.isfinite(np.asarray(out.h)).all()
    np.testing.assert_array_equal(np.asarray(out.u)[em == 0], 0.0)
    vol1 = np.sum(area * np.asarray(out.h))
    assert abs(vol1 - vol0) / vol0 < 1e-13
    assert np.abs(np.asarray(out.u)[em == 1]).max() > 1e-6


# ----------------------------------------------------------------------
# land on the patch-structured sphere layout (mesh/icos_patches.
# apply_land_mask): land is masked, not carved, so the fused patch
# kernel keeps its 10 n x n lattice

def _patch_land(n=8, latdeg=55.0):
    from omega_tpu.mesh.icos_patches import apply_land_mask, patch_icos_mesh
    from omega_tpu.mesh.spherical import spherical_icos_mesh
    pmesh = patch_icos_mesh(spherical_icos_mesh(n, bottom_depth=1000.0), n)
    land = np.asarray(pmesh.lat_cell) > np.deg2rad(latdeg)
    assert land.sum() > 10
    return pmesh, apply_land_mask(pmesh, land), land


def _sphere_state(mesh, K, L):
    ssh = 2.0 * np.sin(2 * np.asarray(mesh.lat_cell)) * \
        np.cos(np.asarray(mesh.lon_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / K) * jnp.ones((1, K))
    trc = 10.0 + jnp.asarray(
        np.cos(np.asarray(mesh.lat_cell))[None, :, None]
        * np.ones((L, 1, K)))
    return ModelState(h=h, u=jnp.zeros((mesh.nedges, K)), tracers=trc)


def test_land_masked_patch_matches_carved():
    """The mask formulation is the same ocean as carving: composed runs
    on the masked patch mesh and on carve_mesh(base, ~land) agree on
    every ocean cell (matched by physical position)."""
    from omega_tpu.mesh.spherical import spherical_icos_mesh

    n, latdeg = 8, 55.0
    pmesh, masked, land = _patch_land(n, latdeg)
    base = spherical_icos_mesh(n, bottom_depth=1000.0)
    land_b = np.asarray(base.lat_cell) > np.deg2rad(latdeg)
    carved = carve_mesh(base, ~land_b)

    cfg = ModelConfig(nvertlayers=3, ntracers=1,
                      tendencies=TendencyConfig(visc_del2=1e3,
                                                visc_del4=1e7))
    out_m = run_steps(masked, cfg, _sphere_state(masked, 3, 1),
                      0.0, 300.0, 10, stepper=forward_backward_step)
    out_c = run_steps(carved, cfg, _sphere_state(carved, 3, 1),
                      0.0, 300.0, 10, stepper=forward_backward_step)

    key = lambda m: {(round(float(la), 9), round(float(lo), 9)): i
                     for i, (la, lo) in enumerate(zip(
                         np.asarray(m.lat_cell), np.asarray(m.lon_cell)))}
    km, kc = key(masked), key(carved)
    rows_m, rows_c = [], []
    for k, i in kc.items():
        rows_c.append(i)
        rows_m.append(km[k])
    assert len(rows_c) == carved.ncells
    np.testing.assert_allclose(np.asarray(out_m.h)[rows_m],
                               np.asarray(out_c.h)[rows_c],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(out_m.tracers)[:, rows_m],
                               np.asarray(out_c.tracers)[:, rows_c],
                               rtol=1e-9, atol=1e-9)
    # land rows frozen at their initial state
    h0 = np.asarray(_sphere_state(masked, 3, 1).h)
    np.testing.assert_array_equal(np.asarray(out_m.h)[land], h0[land])
