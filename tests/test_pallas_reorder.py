"""SFC mesh reordering tests."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.mesh.reorder import (gather_window_stats, reorder_mesh,
                                    sfc_permutations)
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.ops import trisk


def test_reorder_preserves_operators():
    """SFC renumbering is a pure permutation: all operators commute."""
    m = spherical_icos_mesh(8)
    m2 = reorder_mesh(m)
    cp, ep, vp = sfc_permutations(m)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((m.nedges, 3))
    h = 100 + rng.standard_normal((m.ncells, 3))
    for op, perm_in, perm_out in (
            (trisk.div_cell, ep, cp),
            (trisk.curl_vertex, ep, vp),
            (trisk.tangential_edge, ep, ep)):
        a = np.asarray(op(m, jnp.asarray(u)))
        b = np.asarray(op(m2, jnp.asarray(u[perm_in])))
        np.testing.assert_allclose(b, a[perm_out], rtol=1e-11)
    a = np.asarray(trisk.grad_edge(m, jnp.asarray(h)))
    b = np.asarray(trisk.grad_edge(m2, jnp.asarray(h[cp])))
    np.testing.assert_allclose(b, a[ep], rtol=1e-11)
    # geometry totals invariant (up to summation-order roundoff)
    tot = float(np.sum(m.area_cell))
    assert abs(float(np.sum(m2.area_cell)) - tot) / tot < 1e-12


def test_reorder_recovers_locality_from_scrambled_input():
    """The reorder's use case: MPAS files with arbitrary element order.
    Scramble a mesh, reorder, and the typical per-block gather window
    must shrink drastically (median is the cache-locality indicator;
    periodic-seam blocks always span the full range)."""
    from omega_tpu.mesh.horz_mesh import finalize_mesh

    m = spherical_icos_mesh(16)
    # scramble: apply a random permutation via reorder machinery
    rng = np.random.default_rng(7)

    import omega_tpu.mesh.reorder as ro
    orig = ro.sfc_permutations

    def random_perms(mesh, method="rcm"):
        return (rng.permutation(mesh.ncells), rng.permutation(mesh.nedges),
                rng.permutation(mesh.nvertices))

    ro.sfc_permutations = random_perms
    try:
        scrambled = reorder_mesh(m)
    finally:
        ro.sfc_permutations = orig

    bad = gather_window_stats(scrambled, block=128, reduce="median")
    good = gather_window_stats(reorder_mesh(scrambled), block=128,
                               reduce="median")
    # scrambled windows span nearly the whole mesh; reordered ones shrink
    assert bad["cells_on_edge"] > scrambled.ncells // 2
    assert good["cells_on_edge"] < bad["cells_on_edge"] // 2
