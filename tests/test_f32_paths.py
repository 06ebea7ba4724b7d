"""float32 tracks float64 on every operator path, to the tolerances the
GPU smoke run (chip_smoke.py) holds the card to.

Each case runs the same configuration in f32 and f64 on the CPU from the
same f32-representable state and checks the trajectory error and the
error of one tendency evaluation at the final f32 state.
"""

import dataclasses
import types

import numpy as np
import pytest

import conftest
from conftest import step_case, wave_state

import jax

import chip_smoke
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.mesh.icos_patches import patch_icos_mesh
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.stepping import run_steps


@pytest.fixture(scope="module")
def meshes():
    planar = planar_hex_mesh(16, 16, dc=5000.0, f0=1e-4,
                             bottom_depth=1000.0)
    patch = patch_icos_mesh(spherical_icos_mesh(8, bottom_depth=4000.0), 8)
    return {"roll": (planar, 30.0, 1.0), "patch": (patch, 300.0, 10.0),
            "gather": (dataclasses.replace(patch, patch_key=0), 300.0, 10.0)}


def _run(mesh, cfg, stepper, state, dt, nsteps):
    out = jax.jit(lambda s: run_steps(mesh, cfg, s, 0.0, dt, nsteps,
                                      stepper=stepper))(state)
    return tuple(np.asarray(a, np.float64) for a in out)


@pytest.mark.parametrize("case", ["fb", "rk4", "split"])
@pytest.mark.parametrize("path", ["roll", "patch", "gather"])
def test_f32_tracks_f64(meshes, path, case):
    mesh64, dt, amp = meshes[path]
    mesh32 = mesh64.astype(np.float32)
    K, L, nsteps = 6, 2, 20
    stepper, cfg, _ = step_case(case, K, L)
    st32 = wave_state(mesh64, K, amplitude=amp, dtype=np.float32)
    st64 = jax.tree.map(lambda a: a.astype(np.float64), st32)
    out32 = _run(mesh32, cfg, stepper, st32, dt, nsteps)
    out64 = _run(mesh64, cfg, stepper, st64, dt, nsteps)
    assert all(np.isfinite(a).all() for a in out32)
    depth = np.asarray(mesh64.bottom_depth, np.float64)
    err, parts = chip_smoke.rel_error(out32, out64, depth)
    assert err < chip_smoke.TOL_F32, parts
    assert parts["u"] < chip_smoke.TOL_U, parts

    state = tuple(a.astype(np.float32) for a in out32)
    model = types.SimpleNamespace(mesh=mesh32, model_cfg=cfg,
                                  wind_stress=None)
    ref = types.SimpleNamespace(mesh=mesh64, model_cfg=cfg,
                                wind_stress=None)
    terr = chip_smoke.tendency_error(model, ref, state)
    assert max(terr["dh"], terr["dtr"]) < chip_smoke.TOL_TENDENCY, terr
