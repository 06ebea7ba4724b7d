"""Structured (roll) vs gather operator-path equivalence.

The roll path must be numerically interchangeable with the general gather
path on the uniform planar mesh — same discretization, different
execution. Tolerances are roundoff-level in float64.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.core import aux as auxmod
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.ops import structured, trisk
from omega_tpu.stepping import forward_backward_step, rk4_step


@pytest.fixture(scope="module")
def mesh():
    return planar_hex_mesh(12, 16, dc=3000.0, f0=1e-4)


@pytest.fixture()
def gather_only(monkeypatch):
    monkeypatch.setattr(structured, "_DISABLED", True)


def _rand(mesh, seed=0, K=4, L=2):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(1000 + rng.standard_normal((mesh.ncells, K))),
            jnp.asarray(rng.standard_normal((mesh.nedges, K))),
            jnp.asarray(10 + rng.standard_normal((L, mesh.ncells, K))))


def test_detection(mesh):
    assert structured.enabled(mesh)
    table = structured.stencil_table(mesh, "div", mesh.edges_on_cell,
                                     "cell", "edge", mesh.w_div_cell)
    assert table[0] is not None and len(table[0]) == 6
    # sharded local meshes must NOT detect as structured
    from omega_tpu.parallel import decompose
    sm = decompose(mesh, 4)
    sub = jax.tree.map(lambda a: a[0], sm.mesh)
    assert not structured.enabled(sub)


OPS = [
    ("div", lambda m, h, u, tr: trisk.div_cell(m, u)),
    ("grad", lambda m, h, u, tr: trisk.grad_edge(m, h)),
    ("curl", lambda m, h, u, tr: trisk.curl_vertex(m, u)),
    ("tang", lambda m, h, u, tr: trisk.tangential_edge(m, u)),
    ("ke", lambda m, h, u, tr: trisk.ke_cell(m, u)),
    ("kite", lambda m, h, u, tr: trisk.cell_to_vertex_kite(m, h)),
    ("signed", lambda m, h, u, tr: trisk.edge_to_cell_signed(m, u)),
    ("pair_c", lambda m, h, u, tr: trisk.cell_pair_on_edge(m, h)[1]),
    ("pair_tr", lambda m, h, u, tr: trisk.cell_pair_on_edge(m, tr)[0]),
    ("iso", lambda m, h, u, tr: trisk.interp_cell_to_edge_iso(m, h)),
    ("div_batched", lambda m, h, u, tr: trisk.div_cell(
        m, jnp.stack([u, 2 * u]))),
]


@pytest.mark.parametrize("name,op", OPS, ids=[o[0] for o in OPS])
def test_op_equivalence(mesh, name, op):
    h, u, tr = _rand(mesh)
    fast = np.asarray(op(mesh, h, u, tr))
    import omega_tpu.ops.structured as st
    old = st._DISABLED
    st._DISABLED = True
    try:
        slow = np.asarray(op(mesh, h, u, tr))
    finally:
        st._DISABLED = old
    np.testing.assert_allclose(fast, slow, rtol=1e-12, atol=1e-12)


def test_full_step_equivalence(mesh):
    """A complete FB and RK4 step agree between paths to roundoff."""
    h, u, tr = _rand(mesh, seed=1)
    u = 0.01 * u
    cfg = ModelConfig(nvertlayers=4, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=10.0,
                                                visc_del4=1.0e7))
    st0 = ModelState(h=h, u=u, tracers=tr)
    import omega_tpu.ops.structured as st
    for stepper in (forward_backward_step, rk4_step):
        fast = stepper(mesh, cfg, st0, 0.0, 10.0)
        old = st._DISABLED
        st._DISABLED = True
        try:
            slow = stepper(mesh, cfg, st0, 0.0, 10.0)
        finally:
            st._DISABLED = old
        np.testing.assert_allclose(np.asarray(fast.h), np.asarray(slow.h),
                                   rtol=1e-11)
        np.testing.assert_allclose(np.asarray(fast.u), np.asarray(slow.u),
                                   rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(np.asarray(fast.tracers),
                                   np.asarray(slow.tracers), rtol=1e-11)


def test_momentum_aux_equivalence(mesh):
    h, u, tr = _rand(mesh, seed=2)
    cfg = ModelConfig(nvertlayers=4, ntracers=2)
    import omega_tpu.ops.structured as st
    fast = auxmod.compute_momentum_aux(mesh, cfg, h, u)
    old = st._DISABLED
    st._DISABLED = True
    try:
        slow = auxmod.compute_momentum_aux(mesh, cfg, h, u)
    finally:
        st._DISABLED = old
    for a, b in zip(jax.tree.leaves(fast), jax.tree.leaves(slow)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-11, atol=1e-12)
