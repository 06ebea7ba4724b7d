"""Structure-preserving row-band decomposition tests.

The sharded run must reproduce the single-device structured run exactly
on owned rows (same local operators, same order — the bitwise
decomposition-invariance contract), while every shard stays on the
structured fast path.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.ops import structured
from omega_tpu.parallel import structured_shard as sshard
from omega_tpu.parallel.sharded import default_device_mesh
from omega_tpu.stepping import forward_backward_step, rk2_step


@pytest.fixture(scope="module")
def setup():
    mesh = planar_hex_mesh(16, 32, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    K = 3
    cfg = ModelConfig(nvertlayers=K, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1e2,
                                                visc_del4=1e8))
    kx = 2 * np.pi / mesh.x_period
    ky = 2 * np.pi / mesh.y_period
    ssh = np.sin(kx * np.asarray(mesh.x_cell)) * \
        np.sin(ky * np.asarray(mesh.y_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / K) * jnp.ones((1, K))
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, K)),
                    tracers=10.0 + jnp.zeros((2, mesh.ncells, K)))
    return mesh, cfg, st


def test_local_mesh_is_structured(setup):
    mesh, cfg, st = setup
    ss = sshard.decompose_structured(mesh, 4)
    assert structured.enabled(ss.local_mesh)
    assert ss.local_mesh.structured_ny == 32 // 4 + 2 * ss.hw


def test_roundtrip_shard_gather(setup):
    mesh, cfg, st = setup
    ss = sshard.decompose_structured(mesh, 4)
    back = sshard.gather_state(ss, sshard.shard_state(ss, st))
    for a, b in zip(back, st):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("nshards", [2, 4, 8])
@pytest.mark.parametrize("stepper", [forward_backward_step])
def test_decomposition_invariance(setup, nshards, stepper):
    """Owned rows after N sharded steps match the single-device run to
    the last few ulps. (Exact bitwise equality is not achievable here:
    XLA compiles the ny-local and ny-global shapes separately and may
    contract FMAs differently — measured one-ulp u differences after a
    single step. The discretization and operation ORDER are identical;
    only compiler instruction selection differs.)"""
    mesh, cfg, st = setup
    ref = st
    for _ in range(4):
        ref = stepper(mesh, cfg, ref, 0.0, 30.0)

    ss = sshard.decompose_structured(mesh, nshards)
    dm = default_device_mesh(nshards)
    step = jax.jit(sshard.make_sharded_step(ss, cfg, stepper, dm))
    s = sshard.shard_state(ss, st)
    for _ in range(4):
        s = step(s, 0.0, 30.0)
    got = sshard.gather_state(ss, jax.block_until_ready(s))
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.asarray(got.tracers),
                               np.asarray(ref.tracers), rtol=0, atol=1e-12)


def test_rk2_invariance_close(setup):
    """RK2 does 2 evals between exchanges: owned rows stay within the
    documented staleness tolerance (hw=4 vs radius ~3 per eval)."""
    mesh, cfg, st = setup
    ref = st
    for _ in range(4):
        ref = rk2_step(mesh, cfg, ref, 0.0, 30.0)
    ss = sshard.decompose_structured(mesh, 4)
    dm = default_device_mesh(4)
    step = jax.jit(sshard.make_sharded_step(ss, cfg, rk2_step, dm))
    s = sshard.shard_state(ss, st)
    for _ in range(4):
        s = step(s, 0.0, 30.0)
    got = sshard.gather_state(ss, jax.block_until_ready(s))
    np.testing.assert_allclose(np.asarray(got.h), np.asarray(ref.h),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=1e-8)


def test_errors(setup):
    mesh, cfg, st = setup
    with pytest.raises(ValueError):
        sshard.decompose_structured(mesh, 5)      # no (sy, sx) divides 16x16
    # beta-plane decomposes with per-shard f windows (round-2 feature):
    # the non-uniform f attrs are carried as mesh overrides and stripped
    # from the local static scalar table
    beta_mesh = planar_hex_mesh(8, 8, dc=5000.0, f0=1e-4, beta=1e-11)
    ss = sshard.decompose_structured(beta_mesh, 2)
    names = {a for a, _ in ss.mesh_overrides}
    assert {"f_cell", "f_edge", "f_vertex"} <= names
    assert not any(a.startswith("f_")
                   for a, _ in ss.local_mesh.structured_scalars)


def test_exchange_every_amortized_halos():
    """exchange_every=2 with hw=8: two steps per exchange must still
    match the single-device run exactly (halo garbage stays outside the
    owned band; collectives halve)."""
    from omega_tpu.core import ModelConfig, TendencyConfig
    from omega_tpu.parallel.sharded import default_device_mesh
    from omega_tpu.stepping import forward_backward_step, run_steps

    mesh = planar_hex_mesh(16, 64, dc=5000.0, f0=1e-4, bottom_depth=1000.0)
    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1e3,
                                                visc_del4=1e9))
    kx = 2 * np.pi / mesh.x_period
    ssh = np.sin(kx * np.asarray(mesh.x_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / 3) * jnp.ones((1, 3))
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, 3)),
                    tracers=10.0 + jnp.zeros((2, mesh.ncells, 3)))
    nst, dt = 4, 60.0
    ref = run_steps(mesh, cfg, st, 0.0, dt, nst,
                    stepper=forward_backward_step)

    ss = sshard.decompose_structured(mesh, 4, hw=8)
    step2 = jax.jit(sshard.make_sharded_step(
        ss, cfg, forward_backward_step, default_device_mesh(4),
        exchange_every=2))
    sst = sshard.shard_state(ss, st)
    t = 0.0
    for _ in range(nst // 2):
        sst = step2(sst, t, dt)
        t += 2 * dt
    out = sshard.gather_state(ss, sst)
    np.testing.assert_allclose(np.asarray(out.h), np.asarray(ref.h),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=0, atol=1e-12)
