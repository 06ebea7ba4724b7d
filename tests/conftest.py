"""Test configuration: CPU backend with 8 virtual devices, float64.

Mirrors the reference's test strategy (SURVEY.md section 4): multi-rank
behavior is exercised on one node — here via XLA's virtual host devices —
and numerics are validated in double precision. JAX_PLATFORMS defaults
to cpu; the GPU tests (marker `gpu`) need it to name the GPU as well:
`JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from omega_tpu.mesh import planar_hex_mesh  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Bound host memory across the suite: compiled executables and
    their baked-in mesh constants otherwise accumulate over a full run.
    Clearing per module trades some recompilation for a bounded
    footprint."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def mesh16():
    return planar_hex_mesh(16, 16, dc=1000.0)


@pytest.fixture(scope="session")
def mesh32():
    return planar_hex_mesh(32, 32, dc=500.0)


# Configurations each operator path must run identically: every stepper
# and every physics set that a former fused kernel served.
STEP_CASES = ("fb", "rk2", "rk4", "split", "wind_drag_vmix", "pp81",
              "upwind", "fct")


def step_case(name, K, L):
    """(stepper, ModelConfig, wind_on) of a named STEP_CASES entry."""
    from omega_tpu.core import ModelConfig, TendencyConfig
    from omega_tpu.core.config import VertMixConfig
    from omega_tpu.stepping import (forward_backward_step,
                                    make_split_stepper, rk2_step, rk4_step)

    stepper = {"rk2": rk2_step, "rk4": rk4_step,
               "split": make_split_stepper(n_subcycles=4)}.get(
                   name, forward_backward_step)
    tend = dict(visc_del2=1.0e3, visc_del4=1.0e9)
    kw = {}
    if name == "split":
        kw["ssh_formulation"] = "column"
    elif name == "wind_drag_vmix":
        tend.update(wind_forcing=True, bottom_drag=True,
                    bottom_drag_coeff=1.0e-3)
        kw["vert_mix"] = VertMixConfig(enabled=True)
    elif name == "pp81":
        kw["vert_mix"] = VertMixConfig(enabled=True, scheme="pp81",
                                       temp_index=0, salt_index=1)
    elif name == "upwind":
        kw.update(flux_thickness_type="upwind", flux_tracer_type="upwind")
    elif name == "fct":
        kw["flux_tracer_type"] = "fct"
    cfg = ModelConfig(nvertlayers=K, ntracers=L,
                      tendencies=TendencyConfig(**tend), **kw)
    return stepper, cfg, name == "wind_drag_vmix"


def wave_state(mesh, K, amplitude=1.0, dtype=np.float64):
    """SSH wave over the mesh depth, a smooth temperature and uniform
    salinity in K identical layers, at rest."""
    import jax.numpy as jnp

    from omega_tpu.core import ModelState

    if mesh.on_sphere:
        lat, lon = np.asarray(mesh.lat_cell), np.asarray(mesh.lon_cell)
        ssh, temp = np.sin(2 * lat) * np.cos(lon), 10.0 + 5.0 * np.cos(lat)
    else:
        kx, ky = 2 * np.pi / mesh.x_period, 2 * np.pi / mesh.y_period
        x, y = np.asarray(mesh.x_cell), np.asarray(mesh.y_cell)
        ssh, temp = np.sin(kx * x) * np.sin(ky * y), 10.0 + np.cos(kx * x)
    depth = np.asarray(mesh.bottom_depth, np.float64)
    h = np.repeat(((depth + amplitude * ssh) / K)[:, None], K, axis=1)
    tr = np.stack([np.repeat(temp[:, None], K, axis=1),
                   np.full_like(h, 35.0)])
    return ModelState(h=jnp.asarray(h, dtype),
                      u=jnp.zeros((mesh.nedges, K), dtype),
                      tracers=jnp.asarray(tr, dtype))


def wind_for(mesh, dtype=np.float64):
    import jax.numpy as jnp
    return (jnp.full((mesh.ncells,), 0.1, dtype),
            jnp.full((mesh.ncells,), 0.05, dtype))


def assert_paths_agree(fast_mesh, slow_mesh, case, dt, nsteps, K=3, L=2):
    """Run STEP_CASES[case] on two execution paths of one mesh and
    require the same trajectory to float64 roundoff."""
    import jax

    from omega_tpu.stepping import run_steps

    stepper, cfg, wind_on = step_case(case, K, L)
    outs = []
    for mesh in (fast_mesh, slow_mesh):
        st = wave_state(mesh, K, amplitude=5.0)
        wind = wind_for(mesh) if wind_on else None
        outs.append(jax.jit(lambda s: run_steps(
            mesh, cfg, s, 0.0, dt, nsteps, stepper=stepper,
            wind_stress=wind))(st))
    fast, slow = outs
    for f in ("h", "u", "tracers"):
        a, b = np.asarray(getattr(fast, f)), np.asarray(getattr(slow, f))
        assert np.isfinite(a).all(), f
        scale = np.abs(b).max() + 1e-300
        assert np.abs(a - b).max() / scale < 1e-12, (case, f)
    assert np.abs(np.asarray(fast.u)).max() > 0
