"""Split-explicit barotropic/baroclinic stepper tests.

The split stepper must (a) conserve volume and tracer content exactly,
(b) remain stable at time steps well beyond the unsplit external-gravity-
wave CFL, and (c) track a resolved reference solution.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

from omega_tpu.core import ModelConfig, ModelState, TendencyConfig
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.stepping import (forward_backward_step, make_stepper,
                                run_steps, split_forward_backward_step)


def _setup(nx=16, dc=10000.0, K=3):
    mesh = planar_hex_mesh(nx, nx, dc=dc, f0=1e-4, bottom_depth=1000.0)
    cfg = ModelConfig(
        nvertlayers=K, ntracers=2, ssh_formulation="column",
        tendencies=TendencyConfig(visc_del2=0.0, velocity_diffusion=False,
                                  velocity_hyperdiff=False,
                                  tracer_diffusion=False,
                                  tracer_hyperdiff=False))
    kx = 2 * np.pi / mesh.x_period
    ky = 2 * np.pi / mesh.y_period
    ssh = np.sin(kx * np.asarray(mesh.x_cell)) * \
        np.sin(ky * np.asarray(mesh.y_cell))
    h = jnp.asarray((1000.0 + ssh[:, None]) / K) * jnp.ones((1, K))
    tr_base = 10.0 + np.cos(kx * np.asarray(mesh.x_cell))
    tr = jnp.stack([jnp.asarray(tr_base[:, None]) * jnp.ones((1, K)),
                    20.0 * jnp.ones((mesh.ncells, K))])
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, K)), tracers=tr)
    return mesh, cfg, st


def test_split_conservation():
    mesh, cfg, st = _setup()
    area = np.asarray(mesh.area_cell)[:, None]
    vol0 = np.sum(area * np.asarray(st.h))
    trc0 = np.sum(area * np.asarray(st.h) * np.asarray(st.tracers), axis=(1, 2))
    out = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, 120.0, 20,
        stepper=split_forward_backward_step))(st))
    vol1 = np.sum(area * np.asarray(out.h))
    trc1 = np.sum(area * np.asarray(out.h) * np.asarray(out.tracers),
                  axis=(1, 2))
    assert abs(vol1 - vol0) / vol0 < 1e-13
    np.testing.assert_allclose(trc1, trc0, rtol=1e-12)
    assert np.isfinite(np.asarray(out.u)).all()
    assert np.abs(np.asarray(out.u)).max() > 0


def test_split_stable_beyond_unsplit_cfl():
    """dt 4x past the external-wave CFL: unsplit FB blows up, split holds.
    dc=10 km, c = sqrt(gH) ~ 99 m/s -> unsplit dt_max ~ 60 s."""
    mesh, cfg, st = _setup()
    dt_big = 240.0
    run = lambda stepper: jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, dt_big, 40, stepper=stepper))(st))
    out_unsplit = run(forward_backward_step)
    assert not np.isfinite(np.asarray(out_unsplit.h)).all() or \
        np.abs(np.asarray(out_unsplit.u)).max() > 1e3   # unstable
    out_split = run(split_forward_backward_step)
    assert np.isfinite(np.asarray(out_split.h)).all()
    assert np.abs(np.asarray(out_split.u)).max() < 1.0


def test_split_tracks_reference():
    """At a CFL-stable dt, the split solution stays close to a small-dt
    RK4 reference over an hour of gravity-wave evolution."""
    mesh, cfg, st = _setup()
    ref = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, 10.0, 360, stepper=make_stepper("RungeKutta4")))(st))
    got = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, 120.0, 30,
        stepper=split_forward_backward_step))(st))
    ssh_ref = np.asarray(ref.h).sum(1) - 1000.0
    ssh_got = np.asarray(got.h).sum(1) - 1000.0
    err = np.linalg.norm(ssh_got - ssh_ref) / np.linalg.norm(ssh_ref)
    assert err < 0.15, err


def test_split_stepper_registered():
    assert make_stepper("SplitExplicit") is not None
    assert make_stepper("split-explicit") is not None


def test_split_10x_cfl_planar():
    """dt 10x past the unsplit external-wave CFL with 30 subcycles:
    stable and volume-conservative (the barotropic Coriolis term is
    re-evaluated per subcycle, which this regime requires)."""
    from omega_tpu.stepping.split import make_split_stepper
    mesh, cfg, st = _setup()
    dt = 600.0    # unsplit dt_max ~ 60 s at dc=10 km, c ~ 99 m/s
    area = np.asarray(mesh.area_cell)[:, None]
    vol0 = np.sum(area * np.asarray(st.h))
    out = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, dt, 24,
        stepper=make_split_stepper(n_subcycles=30)))(st))
    assert np.isfinite(np.asarray(out.h)).all()
    assert np.abs(np.asarray(out.u)).max() < 1.0
    vol1 = np.sum(area * np.asarray(out.h))
    assert abs(vol1 - vol0) / vol0 < 1e-12


def test_split_10x_cfl_sphere():
    """Same regime on a global sphere mesh (gather path): stability at
    10x the unsplit CFL over 4 simulated hours."""
    from omega_tpu.mesh.spherical import spherical_icos_mesh
    from omega_tpu.stepping.split import make_split_stepper

    mesh = spherical_icos_mesh(12, bottom_depth=1000.0)
    cfg = ModelConfig(
        nvertlayers=3, ntracers=1, ssh_formulation="column",
        tendencies=TendencyConfig(visc_del2=0.0, velocity_diffusion=False,
                                  velocity_hyperdiff=False,
                                  tracer_diffusion=False,
                                  tracer_hyperdiff=False))
    ssh = np.sin(2 * np.asarray(mesh.lat_cell)) * \
        np.cos(np.asarray(mesh.lon_cell))
    K = 3
    h = jnp.asarray((1000.0 + 5.0 * ssh[:, None]) / K) * jnp.ones((1, K))
    st = ModelState(h=h, u=jnp.zeros((mesh.nedges, K)),
                    tracers=10.0 + jnp.zeros((1, mesh.ncells, K)))
    # dc ~ 2*pi*R/(5*12*sqrt(3)) ~ 385 km; c ~ 99 m/s -> unsplit
    # dt_max ~ 2300 s; run at 10x with 30 subcycles
    dt = 23000.0
    area = np.asarray(mesh.area_cell)[:, None]
    vol0 = np.sum(area * np.asarray(st.h))
    out = jax.block_until_ready(jax.jit(lambda s: run_steps(
        mesh, cfg, s, 0.0, dt, 8,
        stepper=make_split_stepper(n_subcycles=30)))(st))
    assert np.isfinite(np.asarray(out.h)).all()
    assert np.abs(np.asarray(out.u)).max() < 10.0
    vol1 = np.sum(area * np.asarray(out.h))
    assert abs(vol1 - vol0) / vol0 < 1e-12


def test_split_decomposition_invariance():
    """Sharded split-explicit must agree with the single-device run: the
    barotropic subcycles refresh (ubar, ssh) through the per-array halo
    exchange each subcycle (pre-fix this diverged at ~1e-5 after 4 steps
    because the subcycled stencil radius exceeded the halo width)."""
    from omega_tpu.parallel import (decompose, gather_state,
                                    make_sharded_step, shard_state)
    from omega_tpu.parallel.sharded import default_device_mesh

    mesh, cfg, st = _setup()
    dt, nsteps = 120.0, 4

    ref = run_steps(mesh, cfg, st, 0.0, dt, nsteps,
                    stepper=split_forward_backward_step)

    nshards = 8
    smesh = decompose(mesh, nshards)
    dmesh = default_device_mesh(nshards)
    step = jax.jit(make_sharded_step(smesh, cfg,
                                     split_forward_backward_step, dmesh))
    sstate = shard_state(smesh, st)
    t = 0.0
    for _ in range(nsteps):
        sstate = step(sstate, t, dt)
        t += dt
    out = gather_state(smesh, sstate, mesh.ncells, mesh.nedges)

    np.testing.assert_allclose(np.asarray(out.h), np.asarray(ref.h),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(out.u), np.asarray(ref.u),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(out.tracers),
                               np.asarray(ref.tracers),
                               rtol=1e-12, atol=1e-12)
