"""Driver + IOStream end-to-end tests.

Mirrors the reference's StandaloneDriverTest (ocnInit -> steps ->
ocnFinalize) plus the restart/pointer-file chaining contract of
infra/IOStream.h:28-59,129-134: job 1 writes restarts via a pointer file,
job 2 dereferences it, resets the clock from SimulationTime, and continues
bit-exactly as an unbroken run.
"""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import yaml

from omega_tpu.driver import ocn_init, ocn_run, ocn_finalize
from omega_tpu.infra.config import Config
from omega_tpu.io.netcdf import read_netcdf


def _base_config(tmp, stop="0001-01-01_01:00:00", streams=None,
                 start="0001-01-01_00:00:00"):
    doc = {
        "Omega": {
            "TimeIntegration": {
                "CalendarType": "No Leap",
                "TimeStepper": "Forward-Backward",
                "TimeStep": "0000_00:01:00",
                "StartTime": start,
                "StopTime": stop,
                "RunDuration": "none",
            },
            "Mesh": {"Generate": {"Kind": "planar", "Nx": 8, "Ny": 8,
                                  "Dc": 25000.0, "F0": 1.0e-4,
                                  "BottomDepth": 1000.0}},
            "VertCoord": {"NVertLayers": 3},
            "Tracers": {"Base": ["Temperature", "Salinity"]},
            "Tendencies": {
                "ThicknessFluxTendencyEnable": True,
                "PVTendencyEnable": True,
                "KETendencyEnable": True,
                "SSHTendencyEnable": True,
                "VelDiffTendencyEnable": False,
                "VelHyperDiffTendencyEnable": False,
                "TracerHorzAdvTendencyEnable": True,
                "TracerDiffTendencyEnable": False,
                "TracerHyperDiffTendencyEnable": False,
            },
            "IOStreams": streams or {},
        }
    }
    path = os.path.join(tmp, "omega.yml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


def _perturb(model):
    """Put a wave in the initial SSH so the run does something."""
    mesh = model.mesh
    kx = 2 * np.pi / mesh.x_period
    ssh = np.sin(kx * np.asarray(mesh.x_cell))
    K = model.model_cfg.nvertlayers
    h = np.asarray(model.state.h) + ssh[:, None] / K
    model.state = model.state._replace(h=jnp.asarray(h))
    return model


def test_driver_smoke(tmp_path):
    """ocn_init -> ocn_run -> ocn_finalize on a generated mesh."""
    tmp = str(tmp_path)
    cfg_path = _base_config(tmp, stop="0001-01-01_00:30:00")
    model = ocn_init(config_file=cfg_path, directory=tmp)
    assert model.model_cfg.nvertlayers == 3
    assert model.tracers.ntracers == 2
    model = _perturb(model)
    vol0 = float(np.sum(np.asarray(model.mesh.area_cell)[:, None]
                        * np.asarray(model.state.h)))
    model = ocn_run(model)
    state = ocn_finalize(model)
    assert model.step_count == 30
    assert str(model.clock.get_current_time()) == "0001-01-01_00:30:00"
    vol1 = float(np.sum(np.asarray(model.mesh.area_cell)[:, None]
                        * np.asarray(state.h)))
    assert abs(vol1 - vol0) / vol0 < 1e-13
    assert np.abs(np.asarray(state.u)).max() > 0


def test_history_stream_output(tmp_path):
    """History stream writes on its alarm cadence with CF metadata and
    SimulationTime; file count matches the alarm schedule."""
    tmp = str(tmp_path)
    streams = {
        "History": {
            "UsePointerFile": False,
            "Filename": "ocn.hist.$SimTime",
            "Mode": "write",
            "IfExists": "replace",
            "Precision": "double",
            "Freq": 10,
            "FreqUnits": "minutes",
            "UseStartEnd": False,
            "Contents": ["State", "SshCell", "Tracers"],
        },
    }
    cfg_path = _base_config(tmp, stop="0001-01-01_00:30:00", streams=streams)
    model = _perturb(ocn_init(config_file=cfg_path, directory=tmp))
    model = ocn_run(model)
    ocn_finalize(model)

    hist = sorted(f for f in os.listdir(tmp) if f.startswith("ocn.hist."))
    assert len(hist) == 3        # minutes 10, 20, 30
    nc = read_netcdf(os.path.join(tmp, hist[-1]))
    assert nc.attrs["SimulationTime"].startswith("0001-01-01_00:30:00")
    assert nc.var_attrs["LayerThickness"]["units"] == "m"
    assert nc.has("Temperature") and nc.has("SshCell")
    h = nc.get("LayerThickness")
    assert h.shape == (1, model.mesh.ncells, 3)
    np.testing.assert_allclose(h[0], np.asarray(model.state.h), rtol=1e-12)


def test_restart_chain_bit_exact(tmp_path):
    """Job 1 (0-30 min) writes restarts through a pointer file; job 2
    restarts and continues to 60 min. Must equal an unbroken 60-min run
    bit for bit (restart fidelity, SURVEY.md section 5)."""
    streams_w = {
        "RestartWrite": {
            "UsePointerFile": True,
            "PointerFilename": "ocn.pointer",
            "Filename": "ocn.restart.$Y-$M-$D_$h.$m.$s",
            "Mode": "write",
            "IfExists": "replace",
            "Precision": "double",
            "Freq": 30,
            "FreqUnits": "minutes",
            "UseStartEnd": False,
            "Contents": ["Restart"],
        },
        "RestartRead": {
            "UsePointerFile": True,
            "PointerFilename": "ocn.pointer",
            "Mode": "read",
            "Precision": "double",
            "Freq": 1,
            "FreqUnits": "OnStartup",
            "UseStartEnd": True,
            "StartTime": "0001-01-01_00:00:01",
            "EndTime": "9999-12-31_00:00:00",
            "Contents": ["Restart"],
        },
    }

    # --- unbroken 60-minute reference run
    tmp_ref = str(tmp_path / "ref")
    os.makedirs(tmp_ref)
    cfg = _base_config(tmp_ref, stop="0001-01-01_01:00:00")
    m_ref = _perturb(ocn_init(config_file=cfg, directory=tmp_ref))
    m_ref = ocn_run(m_ref)
    ref_state = ocn_finalize(m_ref)

    # --- job 1: 0 -> 30 min, writes restart
    tmp1 = str(tmp_path / "chain")
    os.makedirs(tmp1)
    cfg1 = _base_config(tmp1, stop="0001-01-01_00:30:00", streams=streams_w)
    m1 = _perturb(ocn_init(config_file=cfg1, directory=tmp1))
    m1 = ocn_run(m1)
    ocn_finalize(m1)
    assert os.path.exists(os.path.join(tmp1, "ocn.pointer"))
    restart_files = [f for f in os.listdir(tmp1) if "restart" in f]
    assert len(restart_files) == 1

    # --- job 2: continuation config (StartTime advanced past the stream
    # window start, the E3SM resubmission pattern), reads pointer
    cfg2 = _base_config(tmp1, stop="0001-01-01_01:00:00", streams=streams_w,
                        start="0001-01-01_00:30:00")
    m2 = ocn_init(config_file=cfg2, directory=tmp1)   # no perturb: restart
    # forcing time reference recovered from restart metadata
    assert str(m2.sim_start) == "0001-01-01_00:00:00"
    assert str(m2.clock.get_current_time()) == "0001-01-01_00:30:00"
    m2 = ocn_run(m2)
    state2 = ocn_finalize(m2)
    assert str(m2.clock.get_current_time()) == "0001-01-01_01:00:00"

    np.testing.assert_array_equal(np.asarray(state2.h),
                                  np.asarray(ref_state.h))
    np.testing.assert_array_equal(np.asarray(state2.u),
                                  np.asarray(ref_state.u))
    np.testing.assert_array_equal(np.asarray(state2.tracers),
                                  np.asarray(ref_state.tracers))


def test_start_end_window(tmp_path):
    """UseStartEnd: start inclusive, end exclusive (IOStream.h:136-140)."""
    tmp = str(tmp_path)
    streams = {
        "Highfreq": {
            "Filename": "ocn.hifreq.$SimTime",
            "Mode": "write",
            "IfExists": "replace",
            "Freq": 10,
            "FreqUnits": "minutes",
            "UseStartEnd": True,
            "StartTime": "0001-01-01_00:15:00",
            "EndTime": "0001-01-01_00:30:00",
            "Contents": ["SshCell"],
        },
    }
    cfg_path = _base_config(tmp, stop="0001-01-01_00:40:00", streams=streams)
    model = _perturb(ocn_init(config_file=cfg_path, directory=tmp))
    model = ocn_run(model)
    ocn_finalize(model)
    files = [f for f in os.listdir(tmp) if f.startswith("ocn.hifreq")]
    # rings at 10 (before window), 20 (in), 30 (== end, excluded), 40 (after)
    assert len(files) == 1
    assert "00.20.00" in files[0].replace(":", ".")


def test_sharded_driver_matches_single(tmp_path):
    """Decomp.NShards > 1 runs the row-band decomposition through the
    driver; results match the single-device run to roundoff."""
    import dataclasses

    tmp = str(tmp_path)
    cfg_path = _base_config(tmp, stop="0001-01-01_00:20:00")
    # rewrite mesh so ny divides 4 with an even band >= 4
    import yaml as _y
    doc = _y.safe_load(open(cfg_path))
    doc["Omega"]["Mesh"]["Generate"].update(Nx=8, Ny=16)
    doc["Omega"]["Decomp"] = {"NShards": 4}
    _y.safe_dump(doc, open(cfg_path, "w"))

    mA = ocn_init(config_file=cfg_path, directory=tmp)
    mA = _perturb(mA)
    h0 = mA.state.h
    mA = ocn_run(mA)
    stA = ocn_finalize(mA)

    doc["Omega"]["Decomp"] = {"NShards": 1}
    _y.safe_dump(doc, open(cfg_path, "w"))
    mB = ocn_init(config_file=cfg_path, directory=tmp)
    mB.state = mB.state._replace(h=h0)
    mB = ocn_run(mB)
    stB = ocn_finalize(mB)

    np.testing.assert_allclose(np.asarray(stA.h), np.asarray(stB.h),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(stA.u), np.asarray(stB.u),
                               rtol=0, atol=1e-12)


def test_multiframe_stream(tmp_path):
    """FileFreq opens a new file on its own alarm while frames accumulate
    on the Time axis (the Highfreq pattern, IOStream.h Multiframe)."""
    tmp = str(tmp_path)
    streams = {
        "Highfreq": {
            "Filename": "ocn.hifreq.$Y-$M-$D_$h.$m",
            "Mode": "write",
            "IfExists": "append",
            "Freq": 5,
            "FreqUnits": "minutes",
            "FileFreq": 15,
            "FileFreqUnits": "minutes",
            "UseStartEnd": False,
            "Contents": ["SshCell"],
        },
    }
    cfg_path = _base_config(tmp, stop="0001-01-01_00:30:00", streams=streams)
    model = _perturb(ocn_init(config_file=cfg_path, directory=tmp))
    model = ocn_run(model)
    ocn_finalize(model)
    files = sorted(f for f in os.listdir(tmp) if f.startswith("ocn.hifreq"))
    # stream writes at 5,10,15,20,25,30; the file alarm rings at 15 and
    # 30, so frames land [5,10] | [15,20,25] | [30]
    assert len(files) == 3, files
    frames = [read_netcdf(os.path.join(tmp, f)).get("SshCell").shape[0]
              for f in files]
    assert frames == [2, 3, 1], frames


def test_driver_sphere_patch_layout(tmp_path):
    """Mesh.Generate.PatchLayout: true builds the patch-renumbered icos
    mesh (fast streaming-stencil path); physics matches the plain
    sphere generator cell-for-cell (matched by coordinates)."""
    tmp = str(tmp_path)
    cfg_path = _base_config(tmp, stop="0001-01-01_00:10:00")
    doc = yaml.safe_load(open(cfg_path))
    doc["Omega"]["Mesh"] = {"Generate": {"Kind": "sphere", "Subdivisions": 8,
                                         "BottomDepth": 1000.0,
                                         "PatchLayout": True}}
    yaml.safe_dump(doc, open(cfg_path, "w"))

    def perturb(model):
        mesh = model.mesh
        ssh = np.sin(2 * np.asarray(mesh.lat_cell)) * \
            np.cos(np.asarray(mesh.lon_cell))
        K = model.model_cfg.nvertlayers
        h = np.asarray(model.state.h) + ssh[:, None] / K
        model.state = model.state._replace(h=jnp.asarray(h))
        return model

    mA = ocn_init(config_file=cfg_path, directory=tmp)
    assert getattr(mA.mesh, "patch_key", 0) != 0
    meshA = mA.mesh
    mA = perturb(mA)
    stA = ocn_finalize(ocn_run(mA))

    doc["Omega"]["Mesh"]["Generate"]["PatchLayout"] = False
    yaml.safe_dump(doc, open(cfg_path, "w"))
    mB = ocn_init(config_file=cfg_path, directory=tmp)
    assert getattr(mB.mesh, "patch_key", 0) == 0
    meshB = mB.mesh
    mB = perturb(mB)
    stB = ocn_finalize(ocn_run(mB))

    key = lambda m: {(round(float(la), 9), round(float(lo), 9)): i
                     for i, (la, lo) in enumerate(zip(
                         np.asarray(m.lat_cell), np.asarray(m.lon_cell)))}
    ka, kb = key(meshA), key(meshB)
    rows_a = [ka[k] for k in kb]
    np.testing.assert_allclose(np.asarray(stA.h)[rows_a],
                               np.asarray(stB.h),
                               rtol=0, atol=1e-11)


def test_sharded_driver_sphere_general_decomp(tmp_path):
    """Config-driven multi-device execution of an UNSTRUCTURED mesh: a
    generated sphere with Decomp.NShards > 1 must dispatch to the general
    SFC decomposition (base/Decomp.h:19-30 partitions any MPAS mesh from
    config) and match the single-device run to roundoff."""
    tmp = str(tmp_path)
    cfg_path = _base_config(tmp, stop="0001-01-01_00:10:00")
    doc = yaml.safe_load(open(cfg_path))
    doc["Omega"]["Mesh"] = {"Generate": {"Kind": "sphere", "Subdivisions": 8,
                                         "BottomDepth": 1000.0}}
    doc["Omega"]["Decomp"] = {"NShards": 4, "Method": "auto"}
    yaml.safe_dump(doc, open(cfg_path, "w"))

    def perturb(model):
        mesh = model.mesh
        ssh = np.sin(2 * np.asarray(mesh.lat_cell)) * \
            np.cos(np.asarray(mesh.lon_cell))
        K = model.model_cfg.nvertlayers
        h = np.asarray(model.state.h) + ssh[:, None] / K
        model.state = model.state._replace(h=jnp.asarray(h))
        return model

    mA = perturb(ocn_init(config_file=cfg_path, directory=tmp))
    h0 = mA.state.h
    mA = ocn_run(mA)
    stA = ocn_finalize(mA)

    doc["Omega"]["Decomp"] = {"NShards": 1}
    yaml.safe_dump(doc, open(cfg_path, "w"))
    mB = ocn_init(config_file=cfg_path, directory=tmp)
    mB.state = mB.state._replace(h=h0)
    mB = ocn_run(mB)
    stB = ocn_finalize(mB)

    np.testing.assert_allclose(np.asarray(stA.h), np.asarray(stB.h),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(stA.u), np.asarray(stB.u),
                               rtol=0, atol=1e-12)


def test_sharded_driver_patch_method(tmp_path):
    """Decomp.Method: patch (the removed rhombus-per-device path) is
    refused at init with an error that names the decompositions that
    remain: structured and sfc."""
    from omega_tpu.infra.errors import ConfigError

    tmp = str(tmp_path)
    cfg_path = _base_config(tmp, stop="0001-01-01_00:06:00")
    doc = yaml.safe_load(open(cfg_path))
    doc["Omega"]["Mesh"] = {"Generate": {"Kind": "sphere", "Subdivisions": 8,
                                         "BottomDepth": 1000.0,
                                         "PatchLayout": True}}
    doc["Omega"]["Decomp"] = {"NShards": 2, "Method": "patch"}
    yaml.safe_dump(doc, open(cfg_path, "w"))
    with pytest.raises(ConfigError,
                       match=r"auto\|structured\|sfc, got 'patch'"):
        ocn_init(config_file=cfg_path, directory=tmp)


def test_sharded_driver_forced_sfc_on_planar(tmp_path):
    """Decomp.Method: sfc sends even a structured planar mesh through the
    general decomposition; results still match single-device."""
    tmp = str(tmp_path)
    cfg_path = _base_config(tmp, stop="0001-01-01_00:10:00")
    doc = yaml.safe_load(open(cfg_path))
    doc["Omega"]["Decomp"] = {"NShards": 4, "Method": "sfc"}
    yaml.safe_dump(doc, open(cfg_path, "w"))

    mA = _perturb(ocn_init(config_file=cfg_path, directory=tmp))
    h0 = mA.state.h
    mA = ocn_run(mA)
    stA = ocn_finalize(mA)

    doc["Omega"]["Decomp"] = {"NShards": 1}
    yaml.safe_dump(doc, open(cfg_path, "w"))
    mB = ocn_init(config_file=cfg_path, directory=tmp)
    mB.state = mB.state._replace(h=h0)
    mB = ocn_run(mB)
    stB = ocn_finalize(mB)

    np.testing.assert_allclose(np.asarray(stA.h), np.asarray(stB.h),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(stA.u), np.asarray(stB.u),
                               rtol=0, atol=1e-12)


def _write_wind_file(path, ncells, frames, times):
    """Forcing file: (T, C) stress frames + Time seconds variable."""
    from omega_tpu.io.netcdf import write_netcdf
    tz = np.asarray(frames)
    write_netcdf(
        path,
        dims={"Time": tz.shape[0], "nCells": ncells},
        variables={"Time": np.asarray(times, np.float64),
                   "ZonalStressCell": tz,
                   "MeridionalStressCell": np.zeros_like(tz)},
        var_dims={"Time": ("Time",),
                  "ZonalStressCell": ("Time", "nCells"),
                  "MeridionalStressCell": ("Time", "nCells")},
        unlimited="Time")


def test_wind_forcing_stream_constant_limit(tmp_path):
    """A forcing stream with identical frames must reproduce the
    constant-wind config exactly (WindForcingAuxVars.h:13-40 read through
    IOStream; VERDICT r1 missing #5)."""
    tmp = str(tmp_path)
    stop = "0001-01-01_00:20:00"

    # run A: constant wind from config
    cfg_path = _base_config(tmp, stop=stop)
    doc = yaml.safe_load(open(cfg_path))
    doc["Omega"]["WindStress"] = {"ConstantZonal": 0.1}
    yaml.safe_dump(doc, open(cfg_path, "w"))
    mA = _perturb(ocn_init(config_file=cfg_path, directory=tmp))
    h0 = mA.state.h
    stA = ocn_finalize(ocn_run(mA))
    assert np.abs(np.asarray(stA.u)).max() > 0

    # run B: the same wind through a forcing stream (2 identical frames)
    doc = yaml.safe_load(open(cfg_path))
    del doc["Omega"]["WindStress"]
    doc["Omega"]["IOStreams"] = {
        "WindForcing": {"Mode": "read", "Filename": "wind.nc",
                        "Freq": 10, "FreqUnits": "minutes",
                        "Contents": ["ZonalStressCell",
                                     "MeridionalStressCell"]}}
    yaml.safe_dump(doc, open(cfg_path, "w"))
    ncells = mA.mesh.ncells
    _write_wind_file(os.path.join(tmp, "wind.nc"), ncells,
                     [0.1 * np.ones(ncells)] * 2, [0.0, 600.0])
    mB = ocn_init(config_file=cfg_path, directory=tmp)
    assert mB.wind_forcing is not None
    mB.state = mB.state._replace(h=h0)
    stB = ocn_finalize(ocn_run(mB))

    np.testing.assert_allclose(np.asarray(stA.u), np.asarray(stB.u),
                               rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(stA.h), np.asarray(stB.h),
                               rtol=0, atol=0)


def test_wind_forcing_stream_time_varying(tmp_path):
    """Ramping frames are linearly interpolated at segment boundaries: a
    ramp 0 -> 0.2 over the run must differ from both endpoints and from
    the 0.1 constant only through the piecewise sampling."""
    tmp = str(tmp_path)
    stop = "0001-01-01_00:20:00"
    cfg_path = _base_config(tmp, stop=stop)
    doc = yaml.safe_load(open(cfg_path))
    doc["Omega"]["IOStreams"] = {
        "WindForcing": {"Mode": "read", "Filename": "wind.nc",
                        "Freq": 5, "FreqUnits": "minutes",
                        "Contents": ["ZonalStressCell",
                                     "MeridionalStressCell"]}}
    yaml.safe_dump(doc, open(cfg_path, "w"))

    # learn the mesh size via a throwaway init without the stream
    doc2 = yaml.safe_load(open(cfg_path))
    doc2["Omega"]["IOStreams"] = {}
    p2 = os.path.join(tmp, "probe.yml")
    yaml.safe_dump(doc2, open(p2, "w"))
    ncells = ocn_init(config_file=p2, directory=tmp).mesh.ncells

    _write_wind_file(os.path.join(tmp, "wind.nc"), ncells,
                     [0.0 * np.ones(ncells), 0.2 * np.ones(ncells)],
                     [0.0, 1200.0])
    m = _perturb(ocn_init(config_file=cfg_path, directory=tmp))
    # interpolation check at init + midpoint
    from omega_tpu.driver import _wind_at
    wz0, _ = _wind_at(m, 0.0)
    wz6, _ = _wind_at(m, 600.0)
    assert np.allclose(wz0, 0.0) and np.allclose(wz6, 0.1)
    st = ocn_finalize(ocn_run(m))
    assert np.isfinite(np.asarray(st.u)).all()
    assert np.abs(np.asarray(st.u)).max() > 0
