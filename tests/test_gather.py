"""General gather path on renumbered sphere meshes."""

import numpy as np

import conftest  # noqa: F401

import jax.numpy as jnp

from omega_tpu.mesh.reorder import reorder_mesh
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.ops import trisk


def test_reorder_preserves_operator_results():
    """RCM reorder is a pure permutation: operator results on permuted
    inputs equal permuted operator results."""
    from omega_tpu.mesh.reorder import sfc_permutations

    mesh0 = spherical_icos_mesh(8)
    mesh1 = reorder_mesh(mesh0)
    cp, ep, vp = sfc_permutations(mesh0, "rcm")
    rng = np.random.default_rng(2)
    u0 = jnp.asarray(rng.standard_normal((mesh0.nedges, 3)))
    u1 = u0[ep]
    d0 = np.asarray(trisk.div_cell(mesh0, u0))
    d1 = np.asarray(trisk.div_cell(mesh1, u1))
    np.testing.assert_allclose(d1, d0[cp], rtol=1e-12, atol=1e-12)
