"""GPU-only checks (marker `gpu`); each skips without a GPU.

Run on a machine with an NVIDIA GPU:
    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import dataclasses
import types

import numpy as np
import pytest

import conftest
from conftest import step_case, wave_state

import jax

import chip_smoke
from omega_tpu.mesh.icos_patches import patch_icos_mesh
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.stepping import run_steps


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["patch", "gather"])
def test_f32_sphere_step_on_gpu_matches_f64(gpu, path):
    """icos8 in f32 on the GPU tracks f64 on the CPU; its transport
    tendency stays within the smoke tolerance that TF32 fails."""
    mesh64 = patch_icos_mesh(spherical_icos_mesh(8, bottom_depth=4000.0), 8)
    if path == "gather":
        mesh64 = dataclasses.replace(mesh64, patch_key=0)
    mesh32 = mesh64.astype(np.float32)
    stepper, cfg, _ = step_case("fb", 6, 2)
    st32 = wave_state(mesh64, 6, amplitude=10.0, dtype=np.float32)
    with jax.default_device(gpu):
        out = jax.jit(lambda s: run_steps(mesh32, cfg, s, 0.0, 300.0, 20,
                                          stepper=stepper))(
            jax.device_put(st32, gpu))
        assert out.h.devices() == {gpu}
    out32 = tuple(np.asarray(a, np.float64) for a in out)
    st64 = jax.tree.map(lambda a: np.asarray(a, np.float64), st32)
    ref = run_steps(mesh64, cfg, st64, 0.0, 300.0, 20, stepper=stepper)
    ref = tuple(np.asarray(a) for a in ref)
    depth = np.asarray(mesh64.bottom_depth, np.float64)
    err, parts = chip_smoke.rel_error(out32, ref, depth)
    assert err < chip_smoke.TOL_F32 and parts["u"] < chip_smoke.TOL_U, parts

    model = types.SimpleNamespace(mesh=mesh32, model_cfg=cfg,
                                  wind_stress=None)
    refm = types.SimpleNamespace(mesh=mesh64, model_cfg=cfg,
                                 wind_stress=None)
    with jax.default_device(gpu):
        terr = chip_smoke.tendency_error(
            model, refm, tuple(a.astype(np.float32) for a in out32))
    assert max(terr["dh"], terr["dtr"]) < chip_smoke.TOL_TENDENCY, terr
