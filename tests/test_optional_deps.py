"""The single-device main path needs neither PyYAML nor h5py: a config
built in code (or the built-in defaults) runs, and NetCDF3 history
streams write and read back, with both packages unimportable."""

import copy
import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

from omega_tpu.driver import ocn_finalize, ocn_init, ocn_run
from omega_tpu.infra.config import DEFAULT_CONFIG, Config, default_config
from omega_tpu.infra.errors import IOError_
from omega_tpu.io.netcdf import read_netcdf, write_netcdf


@pytest.fixture
def blocked(monkeypatch):
    """Make `import yaml` and `import h5py` raise ImportError."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import yaml  # noqa: F401


def _doc(streams=None):
    doc = copy.deepcopy(DEFAULT_CONFIG)
    doc["TimeIntegration"].update(TimeStep="0000_00:01:00",
                                  StopTime="0001-01-01_00:10:00")
    doc["Mesh"] = {"Generate": {"Kind": "planar", "Nx": 8, "Ny": 8,
                                "Dc": 25000.0, "F0": 1.0e-4,
                                "BottomDepth": 1000.0}}
    doc["VertCoord"] = {"NVertLayers": 2}
    doc["Tendencies"].update(ViscDel4=0.0)
    doc["IOStreams"] = streams or {}
    return Config("Omega", doc)


def test_default_config_runs_without_yaml(blocked, tmp_path):
    cfg = default_config()
    assert cfg.get_group("Tendencies").get_float("ViscDel4") == 1.2e11
    assert cfg.get_group("Tracers").get_list("Base") == ["Temperature",
                                                         "Salinity"]
    model = ocn_run(ocn_init(_doc(), directory=str(tmp_path)))
    st = ocn_finalize(model)
    assert model.step_count == 10 and np.isfinite(np.asarray(st.h)).all()


def test_netcdf3_history_without_yaml_or_h5py(blocked, tmp_path):
    streams = {"History": {"UsePointerFile": False, "Filename": "hist",
                           "Mode": "write", "IfExists": "append",
                           "Freq": 5, "FreqUnits": "minutes",
                           "Contents": ["State", "SshCell"]}}
    model = ocn_run(ocn_init(_doc(streams), directory=str(tmp_path)))
    ocn_finalize(model)
    nc = read_netcdf(os.path.join(str(tmp_path), "hist.nc"))
    assert nc.get("LayerThickness").shape[0] == 2       # minutes 5 and 10
    assert nc.has("SshCell")


@pytest.mark.parametrize("op", ["write", "read"])
def test_hdf5_without_h5py_names_the_package(tmp_path, monkeypatch, op):
    path = str(tmp_path / "x.h5")
    if op == "read":
        write_netcdf(path, dims={"n": 2}, variables={"a": np.zeros(2)},
                     var_dims={"a": ("n",)}, fmt="hdf5")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(IOError_, match="h5py"):
        if op == "read":
            read_netcdf(path)
        else:
            write_netcdf(path, dims={"n": 2}, variables={"a": np.zeros(2)},
                         var_dims={"a": ("n",)}, fmt="hdf5")


def test_default_config_matches_its_yaml_round_trip():
    """The built-in defaults survive the YAML writer and parser unchanged
    (types included), so a written omega.yml reproduces them."""
    cfg = default_config()
    back = Config.from_yaml(cfg.to_yaml())
    assert back.as_dict() == DEFAULT_CONFIG
    assert type(back.get_group("Tendencies").get("ViscDel4")) is float
