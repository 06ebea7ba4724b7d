"""float32 contractions are pinned to full precision.

On GPU tensor cores a f32 dot at default precision may run in TF32 (a
10-bit mantissa). The gather path's weighted neighbour sums
(trisk._gather_sum) and the patch path's exact fix-up rows
(patch_stencil._apply2d) are the model's contractions; every dot_general
in a step must carry Precision.HIGHEST. The last test shows that the GPU
smoke run's tendency tolerance is one TF32 fails.
"""

import dataclasses
import types

import numpy as np
import pytest

import conftest
from conftest import step_case, wave_state

import jax
import jax.numpy as jnp

import chip_smoke
from omega_tpu.mesh import planar_hex_mesh
from omega_tpu.mesh.icos_patches import patch_icos_mesh
from omega_tpu.mesh.spherical import spherical_icos_mesh
from omega_tpu.ops import patch_stencil, trisk
from omega_tpu.stepping import forward_backward_step, run_steps

HIGHEST = jax.lax.Precision.HIGHEST


def _dots(jaxpr):
    """Every dot_general equation of a jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    yield from _dots(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    yield from _dots(sub)


def _assert_pinned(fn, *args):
    dots = list(_dots(jax.make_jaxpr(fn)(*args).jaxpr))
    for eqn in dots:
        prec = eqn.params["precision"]
        prec = prec if isinstance(prec, tuple) else (prec,)
        assert prec and all(p == HIGHEST for p in prec), eqn
    return len(dots)


@pytest.fixture(scope="module")
def sphere():
    return patch_icos_mesh(spherical_icos_mesh(6, bottom_depth=1000.0), 6)


def test_gather_sum_pins_precision(sphere):
    mesh = sphere.astype(np.float32)
    f = jnp.ones((mesh.nedges, 4), jnp.float32)
    assert _assert_pinned(lambda x: trisk._gather_sum(
        mesh.w_div_cell, mesh.edges_on_cell, x), f) >= 1


def test_patch_fixup_pins_precision(sphere):
    mesh = sphere.astype(np.float32)
    tab = patch_stencil.table(mesh, "div")
    assert tab.fix_ids.size, "icos6 has pentagon fix-up rows"
    f = jnp.ones((mesh.nedges, 4), jnp.float32)
    assert _assert_pinned(lambda x: patch_stencil.apply_patch_stencil(
        mesh, tab, x), f) >= 1


@pytest.mark.parametrize("path", ["roll", "patch", "gather"])
def test_step_pins_precision(sphere, path):
    if path == "roll":
        mesh = planar_hex_mesh(8, 8, dc=5000.0, f0=1e-4)
    elif path == "patch":
        mesh = sphere
    else:
        mesh = dataclasses.replace(sphere, patch_key=0)
    mesh = mesh.astype(np.float32)
    _, cfg, _ = step_case("fb", 3, 2)
    st = wave_state(mesh, 3, dtype=np.float32)
    _assert_pinned(lambda s: forward_backward_step(mesh, cfg, s, 0.0, 60.0),
                   st)


def _tf32(x):
    """Round f32 values to TF32's 10-bit mantissa (nearest)."""
    i = jax.lax.bitcast_convert_type(x, jnp.uint32)
    i = (i + jnp.uint32(1 << 12)) & jnp.uint32(0xFFFFE000)
    return jax.lax.bitcast_convert_type(i, jnp.float32)


def test_tf32_contractions_exceed_smoke_tolerance(monkeypatch):
    """Rounding the gather path's contraction operands to TF32 pushes the
    transport-tendency error past chip_smoke.TOL_TENDENCY; f32 at full
    precision stays far below it."""
    mesh64 = dataclasses.replace(patch_icos_mesh(
        spherical_icos_mesh(8, bottom_depth=4000.0), 8), patch_key=0)
    mesh32 = mesh64.astype(np.float32)
    stepper, cfg, _ = step_case("fb", 6, 2)
    st = run_steps(mesh64, cfg, wave_state(mesh64, 6, amplitude=10.0),
                   0.0, 300.0, 10, stepper=stepper)
    state = tuple(np.asarray(a, np.float32) for a in st)
    model = types.SimpleNamespace(mesh=mesh32, model_cfg=cfg,
                                  wind_stress=None)
    ref = types.SimpleNamespace(mesh=mesh64, model_cfg=cfg, wind_stress=None)

    transport = lambda e: max(e["dh"], e["dtr"])
    full = transport(chip_smoke.tendency_error(model, ref, state))

    def tf32_gather_sum(weights, idx, field):
        g = jnp.take(field, idx, axis=-2)
        if field.dtype == jnp.float32:
            g = _tf32(g)
            weights = _tf32(jnp.asarray(weights, jnp.float32))
        return jnp.einsum("nj,...njk->...nk", weights, g,
                          precision=HIGHEST)

    monkeypatch.setattr(trisk, "_gather_sum", tf32_gather_sum)
    tf32 = transport(chip_smoke.tendency_error(model, ref, state))
    assert full < chip_smoke.TOL_TENDENCY / 10, full
    assert tf32 > chip_smoke.TOL_TENDENCY * 3, tf32
