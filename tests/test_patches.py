"""Patch-structured icosahedral sphere path (mesh/icos_patches.py,
ops/patch_stencil.py): exact agreement with the general gather path.

The patch mesh is the SAME ocean as the generator mesh (permuted ids
with a few dead seam slots), and every stencil's fix-up recipe IS the
gather recipe — so patch-on vs patch-off must agree to float summation
order on every row, which is what these tests pin. Reference analogue:
HorzOperatorsTest.cpp exercises the operators on one decomposition;
here the second execution path plays the role of the oracle."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.mesh.icos_patches import _REGISTRY, patch_icos_mesh
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.ops import trisk
from omega_tpu.stepping import rk4_step, run_steps


@pytest.fixture(scope="module")
def pmesh():
    n = 8
    return patch_icos_mesh(spherical_icos_mesh(n), n)


class _gather_path:
    """Force the general gather path (patches off) inside the block."""

    def __enter__(self):
        os.environ["OMEGA_PATCHES"] = "0"

    def __exit__(self, *exc):
        del os.environ["OMEGA_PATCHES"]


def test_mesh_accounting(pmesh):
    n = 8
    info = _REGISTRY[pmesh.patch_key]
    assert info.ngrid == 10 * n * n
    assert pmesh.ncells == 10 * n * n + 2
    # dead ids (holes) == appended orphans for edges and vertices
    assert pmesh.nedges - 3 * info.ngrid == pmesh.nedges - 30 * n * n + \
        (3 * info.ngrid - 30 * n * n)
    # real (non-dead) elements match the generator counts
    em = np.asarray(pmesh.edge_mask)
    assert int((em > 0).sum()) == 30 * n * n  # all real edges interior
    # cell-destination stencils fix up only pentagons + poles: O(1)
    assert len(info.tables["div"].fix_ids) <= 30
    assert len(info.tables["kite"].fix_ids) <= 30 * n  # O(n) seams
    for t in info.tables.values():
        assert len(t.entries) <= 33


def test_all_operators_match_gather(pmesh):
    mesh = pmesh
    rng = np.random.default_rng(3)
    K = 4
    fc = jnp.asarray(rng.standard_normal((mesh.ncells, K)))
    fe = jnp.asarray(rng.standard_normal((mesh.nedges, K)))
    fv = jnp.asarray(rng.standard_normal((mesh.nvertices, K)))
    ops = {
        "div": lambda: trisk.div_cell(mesh, fe),
        "curl": lambda: trisk.curl_vertex(mesh, fe),
        "tang": lambda: trisk.tangential_edge(mesh, fe),
        "grad": lambda: trisk.grad_edge(mesh, fc),
        "ke": lambda: trisk.ke_cell(mesh, fe),
        "kite": lambda: trisk.cell_to_vertex_kite(mesh, fc),
        "cmean": lambda: trisk.cell_mean_on_edge(mesh, fc),
        "cdiff": lambda: trisk.cell_diff_on_edge(mesh, fc),
        "vmean": lambda: trisk.vertex_mean_on_edge(mesh, fv),
        "vdiff": lambda: trisk.vertex_diff_on_edge(mesh, fv),
        "signed": lambda: trisk.edge_to_cell_signed(mesh, fe),
        "divpos": lambda: trisk.div_cell_pos(mesh, fe),
        "divneg": lambda: trisk.div_cell_neg(mesh, fe),
        "cpair0": lambda: trisk.cell_pair_on_edge(mesh, fc)[0],
        "vpair1": lambda: trisk.vertex_pair_on_edge(mesh, fv)[1],
        "iso": lambda: trisk.interp_cell_to_edge_iso(mesh, fc),
    }
    for name, fn in ops.items():
        on = fn()
        with _gather_path():
            off = fn()
        err = float(jnp.max(jnp.abs(on - off))
                    / (jnp.max(jnp.abs(off)) + 1e-300))
        assert err < 1e-13, (name, err)


def test_batched_leading_dims(pmesh):
    rng = np.random.default_rng(5)
    fe = jnp.asarray(rng.standard_normal((3, pmesh.nedges, 4)))
    on = trisk.div_cell(pmesh, fe)
    with _gather_path():
        off = trisk.div_cell(pmesh, fe)
    np.testing.assert_allclose(np.asarray(on), np.asarray(off),
                               rtol=0, atol=1e-13)


def _initial_state(mesh, K, ntracers=2):
    ssh = np.sin(2 * np.asarray(mesh.lat_cell)) \
        * np.cos(np.asarray(mesh.lon_cell))
    depth0 = float(np.asarray(mesh.bottom_depth)[0])
    h = jnp.asarray((depth0 + 100.0 * ssh[:, None]) / K) * jnp.ones((1, K))
    return ModelState(
        h=h, u=jnp.zeros((mesh.nedges, K)),
        tracers=10.0 + jnp.zeros((ntracers, mesh.ncells, K)))


@pytest.mark.parametrize("stepper", [None, rk4_step],
                         ids=["fb", "rk4"])
def test_steps_match_gather(pmesh, stepper):
    K = 5
    cfg = ModelConfig(nvertlayers=K, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    state = _initial_state(pmesh, K)
    kw = {} if stepper is None else {"stepper": stepper}
    on = run_steps(pmesh, cfg, state, 0.0, 60.0, 8, **kw)
    with _gather_path():
        off = run_steps(pmesh, cfg, state, 0.0, 60.0, 8, **kw)
    for fld in ("h", "u", "tracers"):
        a, b = np.asarray(getattr(on, fld)), np.asarray(getattr(off, fld))
        scale = np.max(np.abs(b)) + 1e-300
        assert np.max(np.abs(a - b)) / scale < 1e-12, fld
        assert np.all(np.isfinite(a)), fld


def test_conservation_and_dead_rows(pmesh):
    K = 4
    cfg = ModelConfig(nvertlayers=K, ntracers=1,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    state = _initial_state(pmesh, K, 1)
    out = run_steps(pmesh, cfg, state, 0.0, 60.0, 12)
    area = np.asarray(pmesh.area_cell)[:, None]
    v0 = float(np.sum(np.asarray(state.h) * area))
    v1 = float(np.sum(np.asarray(out.h) * area))
    assert abs(v1 - v0) / v0 < 1e-13
    # dead (masked) edges never acquire velocity: every tendency term
    # is edge_mask-gated, so u stays identically zero there
    dead = np.asarray(pmesh.edge_mask) == 0.0
    assert dead.any()
    assert np.all(np.asarray(out.u)[dead] == 0.0)
