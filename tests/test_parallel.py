"""Distributed-correctness tests on a virtual 8-device CPU mesh.

Analogue of the reference's HaloTest (global-ID oracle, exact equality,
test/base/HaloTest.cpp:30-70) and the QU240 partition test
(decomposition invariance: results identical across shard counts,
doc/design/OmegaV0ShallowWater.md:57-59).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from omega_tpu.core import ModelState
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.parallel import decompose, gather_state, make_sharded_step, shard_state
from omega_tpu.parallel.sharded import default_device_mesh, make_halo_fn
from omega_tpu.stepping import forward_backward_step, rk4_step, run_steps

from test_model import _inertia_gravity_setup


def _id_state(mesh, smesh, nlayers=2, ntracers=2):
    """State filled with global-ID-derived values (the HaloTest oracle)."""
    k = np.arange(nlayers)[None, :]
    h = np.arange(mesh.ncells)[:, None] * 10.0 + k + 1.0
    u = np.arange(mesh.nedges)[:, None] * 7.0 + k + 1.0
    tr = np.stack([np.arange(mesh.ncells)[:, None] * (3.0 + l) + k + 1.0
                   for l in range(ntracers)])
    return ModelState(h=jnp.asarray(h * 1.0), u=jnp.asarray(u * 1.0),
                      tracers=jnp.asarray(tr * 1.0))


@pytest.mark.parametrize("nshards", [2, 8])
def test_halo_exchange_id_oracle(nshards):
    """Zero the halos, exchange, require exact equality with the ID oracle."""
    mesh = planar_hex_mesh(16, 16, dc=1000.0)
    smesh = decompose(mesh, nshards)
    state = _id_state(mesh, smesh)
    sstate = shard_state(smesh, state)

    # corrupt all non-owned entries
    def corrupt(x, owned_mask):
        return jnp.where(jnp.asarray(owned_mask)[..., None] > 0, x, -9999.0)

    corrupted = ModelState(
        h=corrupt(sstate.h, smesh.owned_cell_mask),
        u=corrupt(sstate.u, smesh.owned_edge_mask),
        tracers=corrupt(sstate.tracers,
                        np.asarray(smesh.owned_cell_mask)[:, None, :]),
    )

    dmesh = default_device_mesh(nshards)
    from jax.sharding import PartitionSpec as P
    pspec = P("x")
    smesh_specs = jax.tree.map(lambda _: pspec, smesh)
    state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)

    def fix(sm_stacked, st_stacked):
        sm = jax.tree.map(lambda a: a[0], sm_stacked)
        st = jax.tree.map(lambda a: a[0], st_stacked)
        out = make_halo_fn(sm)(st)
        return jax.tree.map(lambda a: a[None], out)

    fixed = jax.jit(jax.shard_map(fix, mesh=dmesh,
                                  in_specs=(smesh_specs, state_specs),
                                  out_specs=state_specs))(smesh, corrupted)

    # every real (non-dummy) local entry must now equal the oracle exactly
    c_l2g = np.asarray(smesh.cell_local_to_global)
    e_l2g = np.asarray(smesh.edge_local_to_global)
    h_ref = np.asarray(state.h)
    u_ref = np.asarray(state.u)
    tr_ref = np.asarray(state.tracers)
    for s in range(nshards):
        cm = c_l2g[s] >= 0
        em = e_l2g[s] >= 0
        np.testing.assert_array_equal(np.asarray(fixed.h)[s][cm],
                                      h_ref[c_l2g[s][cm]])
        np.testing.assert_array_equal(np.asarray(fixed.u)[s][em],
                                      u_ref[e_l2g[s][em]])
        np.testing.assert_array_equal(np.asarray(fixed.tracers)[s][:, cm],
                                      tr_ref[:, c_l2g[s][cm]])


@pytest.mark.parametrize("stepper,nsteps", [(forward_backward_step, 6),
                                            (rk4_step, 4)])
def test_decomposition_invariance(stepper, nsteps):
    """1-device vs 8-shard runs must agree on owned values."""
    mesh, cfg, state = _inertia_gravity_setup(nx=16, dc=5000.0)
    dt = 60.0

    ref = run_steps(mesh, cfg, state, 0.0, dt, nsteps, stepper=stepper)

    nshards = 8
    smesh = decompose(mesh, nshards)
    dmesh = default_device_mesh(nshards)
    step = jax.jit(make_sharded_step(smesh, cfg, stepper, dmesh))
    sstate = shard_state(smesh, state)
    t = 0.0
    for _ in range(nsteps):
        sstate = step(sstate, t, dt)
        t += dt
    out = gather_state(smesh, sstate, mesh.ncells, mesh.nedges)

    np.testing.assert_allclose(np.asarray(out.h), np.asarray(ref.h),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(np.asarray(out.tracers), np.asarray(ref.tracers),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("layout,beta", [((2, 4), 0.0), ((4, 2), 1e-11),
                                         ((8, 1), 0.0), (None, 1e-11)])
def test_structured_2d_decomposition_invariance(layout, beta):
    """2-D rectangle decomposition (and beta-plane via per-shard mesh
    overrides) must match the single-device run exactly. Row bands
    ((8,1)) and auto layout selection covered too."""
    from omega_tpu.core import ModelConfig, TendencyConfig
    from omega_tpu.parallel import structured_shard as sshard

    mesh = planar_hex_mesh(32, 16, dc=5000.0, f0=1e-4, beta=beta,
                           bottom_depth=1000.0)
    if layout == (8, 1):
        mesh = planar_hex_mesh(16, 32, dc=5000.0, f0=1e-4, beta=beta,
                               bottom_depth=1000.0)
    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1e3,
                                                visc_del4=1e9))
    kx = 2 * np.pi / mesh.x_period
    ky = 2 * np.pi / mesh.y_period
    ssh = np.sin(kx * np.asarray(mesh.x_cell)) * \
        np.sin(ky * np.asarray(mesh.y_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / 3) * jnp.ones((1, 3))
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, 3)),
                    tracers=10.0 + jnp.zeros((2, mesh.ncells, 3)))
    nst, dt = 4, 60.0
    ref = run_steps(mesh, cfg, st, 0.0, dt, nst,
                    stepper=forward_backward_step)

    ss = sshard.decompose_structured(mesh, 8, layout=layout)
    # round-trip identity
    rt = sshard.gather_state(ss, sshard.shard_state(ss, st))
    np.testing.assert_array_equal(np.asarray(rt.h), np.asarray(st.h))
    np.testing.assert_array_equal(np.asarray(rt.u), np.asarray(st.u))

    step = jax.jit(sshard.make_sharded_step(
        ss, cfg, forward_backward_step, default_device_mesh(8)))
    sst = sshard.shard_state(ss, st)
    t = 0.0
    for _ in range(nst):
        sst = step(sst, t, dt)
        t += dt
    out = sshard.gather_state(ss, sst)
    np.testing.assert_allclose(np.asarray(out.h), np.asarray(ref.h),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.tracers),
                               np.asarray(ref.tracers),
                               rtol=0, atol=1e-12)


def test_host_major_mesh_ordering_and_link_volumes():
    """Multi-host layout: the host-major device mesh gives bit-identical
    results to the default ordering (device placement cannot change
    numerics), and the SFC decomposition keeps the inter-host share of halo
    traffic small — distance-1 ppermutes dominate and stay intra-host."""
    from omega_tpu.parallel.sharded import comm_volume_by_link, \
        host_major_device_mesh

    mesh, cfg, state = _inertia_gravity_setup(nx=16, dc=5000.0)
    nshards, dt, nsteps = 8, 60.0, 3
    smesh = decompose(mesh, nshards)
    sstate = shard_state(smesh, state)

    # emulate a 2-host x 4-chip ordering: interleave the virtual devices
    # so the host-major sort actually reorders them
    devs = jax.devices()[:nshards]
    shuffled = [devs[i] for i in (3, 7, 1, 5, 0, 4, 2, 6)]
    dmesh_hm = host_major_device_mesh(nshards, devices=shuffled)
    assert [d.id for d in dmesh_hm.devices.ravel()] == \
        sorted(d.id for d in devs)

    def run(dmesh):
        step = jax.jit(make_sharded_step(smesh, cfg, forward_backward_step,
                                         dmesh))
        st, t = sstate, 0.0
        for _ in range(nsteps):
            st = step(st, t, dt)
            t += dt
        return gather_state(smesh, st, mesh.ncells, mesh.nedges)

    ref = run(default_device_mesh(nshards))
    out = run(dmesh_hm)
    np.testing.assert_array_equal(np.asarray(out.h), np.asarray(ref.h))
    np.testing.assert_array_equal(np.asarray(out.u), np.asarray(ref.u))

    # link accounting: 2 hosts x 4 consecutive ranks each -> inter-host rows
    # come only from the two host-seam crossings of the rank ring (the
    # per-pair map must name host pair (0,1) alone), and intra-host
    # traffic dominates; the split is structural (2 of 8 ring seams),
    # not volume-proportional
    host_of = np.arange(nshards) // 4
    vol = comm_volume_by_link(smesh, host_of)
    assert vol["intra"] > 0 and vol["inter"] > 0
    assert vol["inter"] < vol["intra"], vol
    assert set(vol["per_host_pair"]) == {(0, 1)}
    # every exchanged row is accounted exactly once
    total = vol["intra"] + vol["inter"]
    expect = 0
    for kind in ("cell", "edge"):
        from omega_tpu.parallel.sharded import build_permute_lists
        l2g = np.asarray(smesh.cell_local_to_global if kind == "cell"
                         else smesh.edge_local_to_global)
        for (d, send, recv) in build_permute_lists(smesh, kind):
            expect += int((recv != l2g.shape[1] - 1).sum())
    assert total == expect


def test_partition_refinement_reduces_cut():
    """The KL boundary refinement must not worsen edge cut or balance,
    and the refined partition feeds the normal decompose path (exactness
    covered by the invariance tests, which now run on refined owners)."""
    from omega_tpu.mesh.horz_mesh import unclamped_connectivity
    from omega_tpu.mesh.spherical import spherical_icos_mesh
    from omega_tpu.parallel import native
    from omega_tpu.parallel.decomp import partition_cells

    mesh = spherical_icos_mesh(16)
    unc = unclamped_connectivity(mesh)
    coc = unc["cells_on_cell"]
    ne = np.asarray(mesh.n_edges_on_cell)

    def cut(o):
        tot = 0
        for j in range(coc.shape[1]):
            v = coc[:, j] >= 0
            tot += int((o[coc[:, j][v]] != o[np.where(v)[0]]).sum())
        return tot // 2

    from omega_tpu.parallel import native as nat
    x = np.asarray(mesh.lon_cell) / (2 * np.pi)
    y = (np.asarray(mesh.lat_cell) + np.pi / 2) / np.pi
    seed = nat.partition_geom(x, y, 8)
    refined, c_after = native.refine_partition(coc, ne, seed, 8)
    if c_after is None:
        pytest.skip("native library unavailable")
    assert c_after == cut(refined)
    assert c_after <= cut(seed)
    sizes = np.bincount(refined, minlength=8)
    target = mesh.ncells / 8
    assert sizes.max() <= target * 1.03 + 1
    assert sizes.min() >= target * 0.97 - 1


@pytest.mark.parametrize("width", [1, 2, 4])
def test_halo_width_knob(width):
    """Decomp.HaloWidth is configurable (base/Decomp.h:19-30): the ID
    oracle holds at any width, and wider halos carry more fringe rows."""
    mesh = planar_hex_mesh(16, 16, dc=1000.0)
    smesh = decompose(mesh, 4, halo_width=width)
    assert smesh.halo_width == width
    state = _id_state(mesh, smesh)
    sstate = shard_state(smesh, state)
    corrupted = ModelState(
        h=jnp.where(jnp.asarray(smesh.owned_cell_mask)[..., None] > 0,
                    sstate.h, -9999.0),
        u=sstate.u, tracers=sstate.tracers)

    dmesh = default_device_mesh(4)
    from jax.sharding import PartitionSpec as P
    pspec = P("x")
    smesh_specs = jax.tree.map(lambda _: pspec, smesh)
    state_specs = ModelState(h=pspec, u=pspec, tracers=pspec)

    def fix(sm_stacked, st_stacked):
        sm = jax.tree.map(lambda a: a[0], sm_stacked)
        st = jax.tree.map(lambda a: a[0], st_stacked)
        out = make_halo_fn(sm)(st)
        return jax.tree.map(lambda a: a[None], out)

    fixed = jax.jit(jax.shard_map(fix, mesh=dmesh,
                                  in_specs=(smesh_specs, state_specs),
                                  out_specs=state_specs))(smesh, corrupted)
    c_l2g = np.asarray(smesh.cell_local_to_global)
    h_ref = np.asarray(state.h)
    for s in range(4):
        cm = c_l2g[s] >= 0
        np.testing.assert_array_equal(np.asarray(fixed.h)[s][cm],
                                      h_ref[c_l2g[s][cm]])


def test_halo_rank4_array():
    """exchangeFullArrayHalo accepts 1-5-D arrays (base/Halo.h:45): a
    rank-4 (time-level, tracer, cell, K) array refreshes exactly."""
    from omega_tpu.parallel.sharded import exchange_any
    mesh = planar_hex_mesh(16, 16, dc=1000.0)
    smesh = decompose(mesh, 4)
    c_l2g = np.asarray(smesh.cell_local_to_global)
    Cl = c_l2g.shape[1]
    T, L, K = 2, 3, 2
    ref = (np.arange(mesh.ncells)[None, None, :, None] * 10.0
           + np.arange(T)[:, None, None, None] * 1000.0
           + np.arange(L)[None, :, None, None] * 100.0
           + np.arange(K)[None, None, None, :])
    local = ref[:, :, np.maximum(c_l2g, 0), :]      # (T, L, S, Cl, K)
    local = np.moveaxis(local, 2, 0)                # (S, T, L, Cl, K)
    own = np.asarray(smesh.owned_cell_mask) > 0
    corrupted = np.where(own[:, None, None, :, None], local, -1.0)

    dmesh = default_device_mesh(4)
    from jax.sharding import PartitionSpec as P
    pspec = P("x")
    smesh_specs = jax.tree.map(lambda _: pspec, smesh)

    def fix(sm_stacked, x_stacked):
        sm = jax.tree.map(lambda a: a[0], sm_stacked)
        out = exchange_any(sm, x_stacked[0], "cell")
        return out[None]

    fixed = jax.jit(jax.shard_map(
        fix, mesh=dmesh, in_specs=(smesh_specs, pspec),
        out_specs=pspec))(smesh, jnp.asarray(corrupted))
    fixed = np.asarray(fixed)
    for s in range(4):
        cm = c_l2g[s] >= 0
        np.testing.assert_array_equal(fixed[s][:, :, cm],
                                      ref[:, :, c_l2g[s][cm]])


def test_halo_overlap_bit_identical():
    """Compute/comm overlap (FB issues the cell exchange before the
    velocity stage): results match the trailing-exchange schedule and
    the single-device run to 1 ulp (the overlapped program gives XLA a
    different fusion graph, which can re-associate an FMA — observed as
    a single-last-bit difference on some hosts), and in the compiled
    HLO the velocity-stage fusions have no dependency on the cell
    collective (the overlap demonstration of SCALING_r05.md)."""
    import os
    import re

    mesh, cfg, state = _inertia_gravity_setup(nx=16, dc=5000.0)
    sm = decompose(mesh, 8)
    dmesh = default_device_mesh(8)
    sst0 = shard_state(sm, state)

    def run(overlap):
        os.environ["OMEGA_HALO_OVERLAP"] = "1" if overlap else "0"
        try:
            step = make_sharded_step(sm, cfg, forward_backward_step,
                                     dmesh)
            st = sst0
            for i in range(4):
                st = step(st, i * 30.0, 30.0)
            return step, gather_state(sm, st, mesh.ncells, mesh.nedges)
        finally:
            os.environ.pop("OMEGA_HALO_OVERLAP", None)

    step_on, a = run(True)
    _, b = run(False)

    def assert_ulp(x, y):
        x, y = np.asarray(x), np.asarray(y)
        np.testing.assert_allclose(x, y, rtol=5e-16, atol=1e-300)

    for f in ("h", "u", "tracers"):
        assert_ulp(getattr(a, f), getattr(b, f))
    ref = run_steps(mesh, cfg, state, 0.0, 30.0, 4)
    assert_ulp(a.h, ref.h)
    assert_ulp(a.u, ref.u)

    # dataflow: no velocity-stage fusion depends on the cell ppermutes
    txt = jax.jit(lambda st: step_on(st, 0.0, 30.0)).lower(
        sst0).compile().as_text()
    deps, kind = {}, {}
    for m in re.finditer(r'%([\w.\-]+) = \S+ ([\w\-]+)\(([^)]*)\)', txt):
        deps[m.group(1)] = re.findall(r'%([\w.\-]+)', m.group(3))
        kind[m.group(1)] = m.group(2)
    import functools as ft
    import sys
    sys.setrecursionlimit(100000)

    @ft.lru_cache(maxsize=None)
    def reach(name):
        out = set()
        for d in deps.get(name, ()):
            out.add(d)
            out |= reach(d)
        return frozenset(out)

    perms = {n for n, k in kind.items() if k == "collective-permute"}
    assert perms, "no collectives in compiled module?"
    fusions = [n for n, k in kind.items() if k == "fusion"]
    indep = [n for n in fusions if not (reach(n) & perms)]
    # a healthy overlap schedule leaves the majority of compute fusions
    # independent of every collective
    assert len(indep) >= len(fusions) // 2, (len(indep), len(fusions))
