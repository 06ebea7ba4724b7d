"""Single-precision correctness gate.

The reference builds and tests the whole library in single precision
(src/CMakeLists.txt:91-111, test/CMakeLists.txt:314-323); the production
bench here runs float32. These tests run the conservation, decomposition
-invariance, and integration checks at f32 with appropriate tolerances so
the shipped bench dtype is exercised by the suite, not just f64.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.stepping import forward_backward_step, run_steps

DTYPE = jnp.float32


def _setup(nx=16, ny=16, dc=5000.0):
    mesh = planar_hex_mesh(nx, ny, dc=dc, f0=1e-4,
                           bottom_depth=1000.0).astype(DTYPE)
    cfg = ModelConfig(nvertlayers=3, ntracers=2,
                      tendencies=TendencyConfig(visc_del2=1.0e3,
                                                visc_del4=1.0e9))
    kx = 2 * np.pi / mesh.x_period
    ky = 2 * np.pi / mesh.y_period
    ssh = np.sin(kx * np.asarray(mesh.x_cell)) * \
        np.sin(ky * np.asarray(mesh.y_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / 3, DTYPE) * \
        jnp.ones((1, 3), DTYPE)
    tr = jnp.stack([
        10.0 + jnp.asarray(np.cos(kx * np.asarray(mesh.x_cell))[:, None],
                           DTYPE) * jnp.ones((1, 3), DTYPE),
        20.0 * jnp.ones((mesh.ncells, 3), DTYPE)])
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, 3), DTYPE), tracers=tr)
    return mesh, cfg, st


def test_f32_conservation_and_activity():
    """Volume conserved to f32 roundoff over 50 steps; waves radiate."""
    mesh, cfg, st = _setup()
    area = np.asarray(mesh.area_cell, np.float64)[:, None]
    vol0 = np.sum(area * np.asarray(st.h, np.float64))
    trc0 = np.sum(area * np.asarray(st.h, np.float64)
                  * np.asarray(st.tracers[0], np.float64))
    out = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, 30.0, 50, stepper=forward_backward_step))(st))
    assert out.h.dtype == DTYPE and out.u.dtype == DTYPE
    vol1 = np.sum(area * np.asarray(out.h, np.float64))
    trc1 = np.sum(area * np.asarray(out.h, np.float64)
                  * np.asarray(out.tracers[0], np.float64))
    # f32 roundoff accumulates ~sqrt(nsteps)*eps_f32 relative
    assert abs(vol1 - vol0) / vol0 < 5e-6
    assert abs(trc1 - trc0) / trc0 < 5e-6
    umax = float(np.abs(np.asarray(out.u)).max())
    assert np.isfinite(np.asarray(out.h)).all() and 0 < umax < 1.0


def test_f32_tracks_f64():
    """The f32 trajectory stays within f32-roundoff growth of the f64
    trajectory over 50 steps."""
    mesh32, cfg, st32 = _setup()
    mesh64 = planar_hex_mesh(16, 16, dc=5000.0, f0=1e-4,
                             bottom_depth=1000.0)
    st64 = ModelState(h=jnp.asarray(st32.h, jnp.float64),
                      u=jnp.asarray(st32.u, jnp.float64),
                      tracers=jnp.asarray(st32.tracers, jnp.float64))
    run = lambda mesh, s: jax.block_until_ready(jax.jit(
        lambda x: run_steps(mesh, cfg, x, 0.0, 30.0, 50,
                            stepper=forward_backward_step))(s))
    o32 = run(mesh32, st32)
    o64 = run(mesh64, st64)
    ssh32 = np.asarray(o32.h, np.float64).sum(-1)
    ssh64 = np.asarray(o64.h, np.float64).sum(-1)
    err = np.abs(ssh32 - ssh64).max()
    assert err < 1000.0 * 50 * np.finfo(np.float32).eps, err


@pytest.mark.parametrize("structured", [True, False])
def test_f32_decomposition_invariance(structured):
    """8-shard f32 run matches the single-device f32 run to roundoff on
    both decomposition paths."""
    mesh, cfg, st = _setup()
    nst, dt = 4, 60.0
    ref = run_steps(mesh, cfg, st, 0.0, dt, nst,
                    stepper=forward_backward_step)

    if structured:
        from omega_tpu.parallel import structured_shard as sshard
        from omega_tpu.parallel.sharded import default_device_mesh
        ss = sshard.decompose_structured(mesh, 8, layout=(4, 2))
        step = jax.jit(sshard.make_sharded_step(
            ss, cfg, forward_backward_step, default_device_mesh(8)))
        sst = sshard.shard_state(ss, st)
        t = 0.0
        for _ in range(nst):
            sst = step(sst, t, dt)
            t += dt
        out = sshard.gather_state(ss, sst)
    else:
        from omega_tpu.parallel import (decompose, gather_state,
                                        make_sharded_step, shard_state)
        from omega_tpu.parallel.sharded import default_device_mesh
        sm = decompose(mesh, 8)
        step = jax.jit(make_sharded_step(sm, cfg, forward_backward_step,
                                         default_device_mesh(8)))
        sst = shard_state(sm, st)
        t = 0.0
        for _ in range(nst):
            sst = step(sst, t, dt)
            t += dt
        out = gather_state(sm, sst, mesh.ncells, mesh.nedges)

    # identical math per shard; differences only from reduction/order
    np.testing.assert_allclose(np.asarray(out.h), np.asarray(ref.h),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=0, atol=1e-4)
