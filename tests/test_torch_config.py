"""The port's configuration module (pathintegralgroundstate_torch/config.py)
against the reference's, of which it is a copy: the same fields and
defaults in the same order, the same geometry, namelist parsing, echo and
crystal-file reading."""

import dataclasses

import numpy as np
import pytest
from torch_bridge import other_cfg

from pathintegralgroundstate_torch import config as tc
from pathintegralgroundstate_tpu import config as jc

# the 1-D harmonic oscillator input of the verify recipe
HO_IN = """\
&system
 dim = 1, Np = 1, trap = T /
&samp
 resume = F, dt = 0.05d0, Nb = 8, seed = 1982, delta_cm = 0.5d0, CMFreq = 1,
 sampling = 'sta', Lstag = 8, Nlev = 2, Nstag = 2, Nblock = 2, Nstep = 10,
 Nbin = 50, Nk = 10 /
&obdm
 swapping = F, CWorm = 0.d0, Nobdm = 0, Npw = 0 /
&wavefun
 Nmax = 1000, wf_table = F, v_table = F /
&jastrow
 Rm = 1.20d0 /  ! McMillan core
&extpot
 a_ho = 1.0d0 /
&tpu
 n_walkers = 16, dtype = 'float64', potential = 'none' /
"""

CASES = {
    "flagship": {},
    "trap": dict(trap=True, dim=2, Np=4, a_ho=(1.0, 0.5)),
    "crystal": dict(crystal=True, Np=8, crystal_Lbox=(5.0, 6.0, 7.0)),
}


def _fields(cls):
    return [(f.name, f.type, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["SimConfig", "Geometry"])
def test_fields_and_defaults_match(cls):
    assert _fields(getattr(tc, cls)) == _fields(getattr(jc, cls))


@pytest.mark.parametrize("name", list(CASES))
def test_geometry_matches(name):
    got = tc.geometry(tc.SimConfig(**CASES[name]))
    want = jc.geometry(jc.SimConfig(**CASES[name]))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_other_cfg_round_trip():
    cfg = tc.SimConfig(**CASES["trap"], sampling="sta", n_walkers=16)
    ref = other_cfg(cfg)
    assert isinstance(ref, jc.SimConfig) and ref.M == cfg.M
    assert other_cfg(ref) == cfg


@pytest.mark.parametrize("overrides", [{}, {"n_walkers": 32, "Nb": 16}])
def test_namelists_match(overrides):
    assert tc.parse_namelists(HO_IN) == jc.parse_namelists(HO_IN)
    got = tc.load_namelist_config(HO_IN, is_text=True, **overrides)
    want = jc.load_namelist_config(HO_IN, is_text=True, **overrides)
    assert isinstance(got, tc.SimConfig)
    assert other_cfg(got) == want
    assert got.a_ho == (1.0,) and got.sampling == "sta" and got.trap


def test_echo_namelists_match():
    cfg = tc.load_namelist_config(HO_IN, is_text=True)
    got, want = [], []
    tc.echo_namelists(cfg, got.append)
    jc.echo_namelists(other_cfg(cfg), want.append)
    assert got == want and got[0] == "&SYSTEM"


def test_read_crystal_file_matches(tmp_path):
    path = tmp_path / "config_ini.in"
    rows = np.random.default_rng(0).uniform(-2.0, 2.0, (4, 3))
    path.write_text("4\n5.0 6.0 7.0\n0.0190476\n"
                    + "\n".join(" ".join(f"{x:.6f}" for x in r)
                                for r in rows) + "\n")
    got, want = tc.read_crystal_file(str(path)), jc.read_crystal_file(
        str(path))
    assert got[:3] == want[:3] == (4, (5.0, 6.0, 7.0), 0.0190476)
    np.testing.assert_array_equal(got[3], want[3])
