"""Four-device runs on virtual CPU devices: the dry run of the graft
entry point and NShards=4 through the driver on both decompositions
that remain (structured row bands for uniform planar meshes, SFC for any
mesh)."""

import copy

import numpy as np
import pytest

import conftest  # noqa: F401

import jax

import chip_smoke
from __graft_entry__ import dryrun_multichip
from omega_tpu.infra.config import Config
from omega_tpu.infra.errors import ConfigError
from omega_tpu.driver import ocn_finalize, ocn_init, ocn_run


def test_dryrun_multichip_four_devices():
    assert len(jax.devices()) >= 4
    dryrun_multichip(4)


def test_dryrun_multichip_refuses_missing_devices():
    with pytest.raises(ValueError, match="needs 64 devices"):
        dryrun_multichip(64)


def _run(doc, tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    model = ocn_init(Config("Omega", copy.deepcopy(doc)), directory=str(d))
    init = chip_smoke.initial_state(model.mesh,
                                    model.model_cfg.nvertlayers)
    import jax.numpy as jnp
    from omega_tpu.core.state import ModelState
    model.state = ModelState(*(jnp.asarray(a) for a in init))
    return model, ocn_finalize(ocn_run(model))


@pytest.mark.parametrize("kind,method", [("planar", "structured"),
                                         ("sphere", "sfc")])
def test_four_shards_match_one_through_driver(tmp_path, kind, method):
    if kind == "planar":
        doc = chip_smoke.planar_doc(nx=16, nlayers=3, nsteps=6, segment=3)
    else:
        doc = chip_smoke.sphere_doc(subdiv=6, nlayers=3, nsteps=4,
                                    segment=2, patch=False)
    sharded = copy.deepcopy(doc)
    sharded["Decomp"] = {"NShards": 4, "Method": method}
    m4, st4 = _run(sharded, tmp_path, "x4")
    assert m4._decomp[0] == method
    _, st1 = _run(doc, tmp_path, "x1")
    for f in ("h", "u", "tracers"):
        a, b = np.asarray(getattr(st4, f)), np.asarray(getattr(st1, f))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    assert np.abs(np.asarray(st4.u)).max() > 0


def test_unknown_decomp_method_lists_remaining(tmp_path):
    doc = chip_smoke.planar_doc(nx=8, nlayers=2, nsteps=2, segment=2)
    doc["Decomp"] = {"NShards": 2, "Method": "rhombus"}
    with pytest.raises(ConfigError, match=r"auto\|structured\|sfc, got"):
        ocn_init(Config("Omega", doc), directory=str(tmp_path))
