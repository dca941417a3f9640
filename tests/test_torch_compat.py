"""Reference-format I/O of the torch port (utils/compat.py) and the crystal
start: twins of tests/test_compat.py's round trip of the reference's
checkpoint.dat, its config_ini.in reader and its crystal start end to end,
the last through the port's CLI on the CPU (PIGS_PLATFORM=cpu); the port's
files and states against the reference's on the same inputs."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_bridge import other_cfg, small_cfg

from pathintegralgroundstate_torch.config import read_crystal_file
from pathintegralgroundstate_torch.state import init_state, state_to_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.compat import (
    read_reference_checkpoint, reference_checkpoint_to_state,
    write_reference_checkpoint)
from pathintegralgroundstate_tpu.config import \
    read_crystal_file as j_read_crystal_file
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.utils import compat as jcompat

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _system(**kw):
    cfg = small_cfg(**dict(dict(Np=4, Nb=2, n_walkers=3), **kw))
    return cfg, make_system(other_cfg(cfg), "cpu")


def test_reference_checkpoint_roundtrip(tmp_path):
    cfg, system = _system()
    state = init_state(system)
    p = str(tmp_path / "checkpoint.dat")
    write_reference_checkpoint(system, state, p, walker=1)
    raw = read_reference_checkpoint(p)
    assert raw["trap"] is False and raw["isopen"] is False
    assert raw["body"].shape == (cfg.Np * cfg.M, cfg.dim)
    state2 = reference_checkpoint_to_state(system, p)
    assert state2.paths.shape == (3, cfg.M, cfg.Np, cfg.dim)
    for w in (0, 2):
        np.testing.assert_allclose(state2.paths[w].numpy(),
                                   state.paths[1].numpy(), rtol=1e-15)
    np.testing.assert_allclose(state2.xend[0].numpy(), state.xend[1].numpy(),
                               rtol=1e-15)
    assert not state2.isopen.any() and (state2.iperm == 1).all()


def test_checkpoint_file_matches_reference_writer(tmp_path):
    """The port writes the reference's checkpoint.dat text byte for byte
    from the same state, and reads the reference's file to the same
    ensemble as the reference's reader."""
    cfg, system = _system()
    state = init_state(system)
    state.isopen[2] = True
    state.iworm[2] = 3
    mine, ref = str(tmp_path / "mine.dat"), str(tmp_path / "ref.dat")
    write_reference_checkpoint(system, state, mine, walker=2)
    jsys = j_make_system(cfg)
    jstate = jcompat.reference_checkpoint_to_state(jsys, mine)
    jstate = jstate._replace(
        paths=jstate.paths.at[0].set(state.paths[2].numpy()),
        isopen=jstate.isopen.at[0].set(True),
        iworm=jstate.iworm.at[0].set(3))
    jcompat.write_reference_checkpoint(jsys, jstate, ref, walker=0)
    with open(mine) as a, open(ref) as b:
        assert a.read() == b.read()
    got = state_to_numpy(reference_checkpoint_to_state(system, ref))
    want = jcompat.reference_checkpoint_to_state(jsys, ref)
    for k in ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)),
                                      err_msg=k)


def test_checkpoint_shape_mismatch_raises(tmp_path):
    _, system = _system()
    p = str(tmp_path / "checkpoint.dat")
    write_reference_checkpoint(system, init_state(system), p)
    _, other = _system(Nb=4)
    with pytest.raises(ValueError, match="does not match"):
        reference_checkpoint_to_state(other, p)


def test_crystal_file_roundtrip(tmp_path):
    p = tmp_path / "config_ini.in"
    p.write_text(" 4\n 5.0 5.0 5.0\n 0.365\n"
                 " 0.0 0.0 0.0\n 2.5 0.0 0.0\n 0.0 2.5 0.0\n 0.0 0.0 2.5\n")
    Np, Lbox, density, R = read_crystal_file(str(p))
    assert Np == 4 and Lbox == (5.0, 5.0, 5.0) and density == 0.365
    assert R.shape == (4, 3) and R[1, 0] == 2.5
    want = j_read_crystal_file(str(p))
    assert (Np, Lbox, density) == want[:3]
    np.testing.assert_array_equal(R, want[3])


def test_crystal_init_state_seeds_every_bead():
    """init_state with crystal positions: every bead of every walker at
    the lattice, and the generators advanced as by a random start."""
    cfg = small_cfg(Np=4, Nb=2, n_walkers=3, dim=2, crystal=True,
                    crystal_Lbox=(3.0, 3.0))
    system = make_system(other_cfg(cfg), "cpu")
    R = np.array([[-0.75, -0.75], [0.75, -0.75], [-0.75, 0.75],
                  [0.75, 0.75]])
    st = init_state(system, init_positions=R)
    np.testing.assert_array_equal(
        st.paths.numpy(), np.broadcast_to(R, (3, cfg.M, 4, 2)))
    np.testing.assert_array_equal(st.xend[:, 0].numpy(),
                                  np.broadcast_to(R[3], (3, 2)))
    fresh = init_state(system)
    assert torch.equal(st.gen.get_state(), fresh.gen.get_state())


def test_crystal_start_end_to_end(tmp_path):
    """tests/test_compat.py's crystal start through the port's CLI: the
    lattice in config_ini.in seeds every bead of every walker, and the box
    comes from the file's Lbox line (soft spheres, 2-D)."""
    Np, L = 4, 3.0
    R = (np.stack(np.meshgrid([0.25, 0.75], [0.25, 0.75]), -1)
         .reshape(-1, 2) - 0.5) * L
    lines = [f"{Np}", f"{L} {L}", "0.444"] + [f"{x} {y}" for x, y in R]
    (tmp_path / "config_ini.in").write_text("\n".join(lines) + "\n")
    (tmp_path / "run.in").write_text("""
&system
 dim = 2, Np = 4, crystal = T, trap = F /
&samp
 dt = 1.d-2, Nb = 4, sampling = 'sta', Lstag = 4, Nstag = 1, CMFreq = 1,
 delta_cm = 0.1d0, Nblock = 1, Nstep = 2, Nbin = 10, Nk = 5 /
&obdm
 swapping = F, CWorm = 0.d0, Nobdm = 0, Npw = 0 /
&wavefun
 Nmax = 500, wf_table = F, v_table = F /
&jastrow
 Rm = 1.0d0 /
&tpu
 n_walkers = 4, dtype = 'float64', potential = 'soft' /
""")
    env = dict(os.environ, PIGS_PLATFORM="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pathintegralgroundstate_torch",
         str(tmp_path / "run.in"), "-o", str(tmp_path / "out")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-600:], out.stderr[-600:])
    assert "crystal start" in out.stdout
    z = np.load(str(tmp_path / "out" / "checkpoint.npz"))
    assert z["paths"].shape == (4, 9, 4, 2)
    assert np.all(np.abs(z["paths"]) <= L / 2 + 1e-9)
    e = np.loadtxt(str(tmp_path / "out" / "e_vpi.out"), ndmin=2)
    assert e.shape == (1, 4) and np.isfinite(e).all()
