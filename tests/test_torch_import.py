"""The torch port imports without JAX or the reference package, its copies
of the reference's flagship configuration, throughput metric and batched-
randoms threshold equal the originals, and it builds every ported option
and refuses the others: only a dtype other than float32/float64 and
dim > 3, or a configuration the reference itself refuses."""

import os
import subprocess
import sys

import pytest
import torch
from torch_bridge import other_cfg, small_cfg

from pathintegralgroundstate_torch.config import SimConfig
from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.state import init_state
from pathintegralgroundstate_torch.sweep import BATCH_RAND_MAX_W, Sweeper, \
    bead_updates_per_step
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import sweep as jsweep

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "pathintegralgroundstate_torch", "pathintegralgroundstate_torch.config",
    "pathintegralgroundstate_torch.flagship",
    "pathintegralgroundstate_torch.system",
    "pathintegralgroundstate_torch.state",
    "pathintegralgroundstate_torch.sweep",
    "pathintegralgroundstate_torch.driver",
    "pathintegralgroundstate_torch.cli",
    "pathintegralgroundstate_torch.__main__",
    "pathintegralgroundstate_torch.models.potentials",
    "pathintegralgroundstate_torch.models.jastrow",
    "pathintegralgroundstate_torch.ops.kernels",
    "pathintegralgroundstate_torch.ops.pairwise",
    "pathintegralgroundstate_torch.ops.moves",
    "pathintegralgroundstate_torch.ops.bisection",
    "pathintegralgroundstate_torch.ops.cascade",
    "pathintegralgroundstate_torch.ops.worm",
    "pathintegralgroundstate_torch.ops.estimators",
    "pathintegralgroundstate_torch.utils.pbc",
    "pathintegralgroundstate_torch.utils.build",
    "pathintegralgroundstate_torch.utils.draws",
    "pathintegralgroundstate_torch.utils.interpolate",
    "pathintegralgroundstate_torch.utils.refrng",
    "pathintegralgroundstate_torch.utils.replay",
    "pathintegralgroundstate_torch.utils.compat",
    "pathintegralgroundstate_torch.ops.estimators",
    "pathintegralgroundstate_torch.ops.variational",
    "pathintegralgroundstate_torch.ops.total_action",
    "pathintegralgroundstate_torch.parallel",
    "pathintegralgroundstate_torch.parallel.mesh",
    "pathintegralgroundstate_torch.parallel.dryrun",
    "pathintegralgroundstate_torch.parallel.beadshard",
    "pathintegralgroundstate_torch.utils.special",
    "chip_smoke",
]


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pathintegralgroundstate_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("n_walkers", [8, 64, 1024])
def test_flagship_cfg_matches_graft_entry(n_walkers):
    from __graft_entry__ import _flagship_cfg
    assert other_cfg(flagship_cfg(n_walkers)) == _flagship_cfg(n_walkers)


@pytest.mark.parametrize("overrides", [
    {}, {"fused_sweep": True}, {"sampling": "sta"}, {"CWorm": 0.0},
    {"CMFreq": 2}, {"Nstag": 0}, {"smart_mc": 0.1}, {"mesh_beads": 2},
    {"fused_sweep": True, "bis_end_random_depth": True},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "flagship")
def test_bead_updates_per_step_matches_reference(overrides):
    cfg = flagship_cfg(1024).replace(**overrides)
    assert bead_updates_per_step(cfg) == jsweep.bead_updates_per_step(
        other_cfg(cfg))


def test_batch_rand_max_w_matches_reference():
    assert BATCH_RAND_MAX_W == jsweep.BATCH_RAND_MAX_W


def _ids(o):
    return ",".join(f"{k}={v}" for k, v in o.items())


# the SP envelope (sweep.py:237-246): mesh_beads > 1 outside it raises the
# reference's own ValueError from the Sweeper
SP_ENVELOPE = r"mesh_beads>1 is the SP correctness demo"


@pytest.mark.parametrize("overrides", [
    {"mesh_beads": 2}, {"mesh_beads": 4, "sampling": "sta"},
    {"mesh_beads": 2, "mesh_walkers": 2}, {"dtype": "bfloat16"},
    {"dim": 4},
], ids=_ids)
def test_unported_options_raise(overrides):
    """Only a dtype other than float32/float64 and dim > 3 are refused by
    the System (NotImplementedError).  mesh_beads > 1 is ported: outside
    the SP envelope (here the flagship's bisection or its worm, or a dp
    mesh beside it) the port's Sweeper raises the ValueError that the
    reference's Sweeper raises for the same configuration."""
    cfg = small_cfg(**overrides)
    if "mesh_beads" not in overrides:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_system(other_cfg(cfg), "cpu")
        return
    from pathintegralgroundstate_tpu.system import make_system as jmake
    from pathintegralgroundstate_tpu.system import make_tables
    system = make_system(other_cfg(cfg), "cpu")
    with pytest.raises(ValueError, match=SP_ENVELOPE) as got:
        Sweeper(system)
    jsys = jmake(cfg)
    with pytest.raises(ValueError, match=SP_ENVELOPE) as want:
        jsweep.Sweeper(jsys, make_tables(jsys))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [
    {"cascade": True, "bis_monoshot": False},
    {"fused_sweep": True, "bis_monoshot": False},
    {"fused_sweep": True, "cascade": True, "regrow": "scan"},
    {"paired_ends": True}, {"bis_end_random_depth": True},
    {"sampling": "sta"}, {"regrow": "scan"}, {"bis_monoshot": False},
    {"trap": True}, {"density_map": True},
    {"trap": True, "density_map": True, "dim": 1},
    {"trap": True, "dim": 2, "potential": "none", "jastrow": "none"},
    {"trap": True, "dim": 1, "potential": "none"},
    {"trap": True, "dim": 2, "jastrow": "none"},
    {"fused_sweep": True, "exact_f2": True}, {"exact_f2": True},
    {"smart_mc": 0.1, "exact_f2": True},
    {"trap": True, "v_table": True}, {"v_table": True}, {"wf_table": True},
    {"v_table": True, "wf_table": True},
    {"potential": "soft"}, {"potential": "dipolar"}, {"potential": "none"},
    {"potential": "aziz1"}, {"jastrow": "none"}, {"jastrow": "dipolar2d"},
    {"jastrow": "mcmillan"}, {"trap": True, "jastrow": "dipolar2d"},
    {"fused_sweep": True, "cascade": True, "potential": "dipolar",
     "jastrow": "dipolar2d", "dim": 2},
    {"shared_windows": False},
    {"bis_monoshot": False, "shared_windows": False},
    {"mesh_walkers": 2}, {"mesh_pairs": 2}, {"distributed": True},
    {"mesh_beads": 2, "sampling": "sta", "CWorm": 0.0},
    {"mesh_beads": 4, "sampling": "sta", "CWorm": 0.0},
    {"use_pallas": False}, {"use_pallas": False, "fused_sweep": True},
], ids=_ids)
def test_ported_options_build(overrides):
    Sweeper(make_system(other_cfg(small_cfg(**overrides)), "cpu"))


def test_per_walker_windows_name_their_item():
    """Per-walker windows are ported (their item is done): the System
    builds and the Sweeper takes the draws without batched randoms, as
    sweep.py:227 does.  So is the SP bead sharding: mesh_beads=2 builds its
    System, and a Sweeper without an sp mesh runs the unsharded composite
    inside the envelope and refuses a shard geometry the reference
    refuses (_check_sp_geometry)."""
    sweeper = Sweeper(make_system(other_cfg(small_cfg(shared_windows=False)),
                                  "cpu"))
    assert not sweeper.batch_rand
    sp = dict(sampling="sta", CWorm=0.0)
    sweeper = Sweeper(make_system(other_cfg(small_cfg(mesh_beads=2, **sp)),
                                  "cpu"))
    assert sweeper.sp == 2 and not sweeper.sp_sharded
    with pytest.raises(ValueError, match=r"Mloc=3 must be even"):
        Sweeper(make_system(other_cfg(small_cfg(mesh_beads=4, Nb=6, **sp)),
                            "cpu"))


def test_simconfig_default_raises():
    """SimConfig's own default, the fused sweep, is ported and builds, and
    so does the same default with exact F^2, with the cache (its default)
    and without it."""
    assert Sweeper(make_system(SimConfig(dtype="float64"), "cpu")).fused_diag
    for cache in (True, False):
        sweeper = Sweeper(make_system(SimConfig(
            dtype="float64", exact_f2=True, f2_cache=cache), "cpu"))
        assert sweeper.fused_diag and sweeper.use_fcache == cache


@pytest.mark.parametrize("overrides", [
    {"smart_mc": 0.1}, {"smart_mc": 0.1, "fused_sweep": True},
], ids=_ids)
def test_smart_mc_without_exact_f2_raises(overrides):
    """smart_mc > 0 with exact_f2 = F: ValueError from the Sweeper, as the
    reference raises it (sweep.py:166-175)."""
    with pytest.raises(ValueError, match="requires exact_f2"):
        Sweeper(make_system(other_cfg(small_cfg(**overrides)), "cpu"))


def test_make_system_defaults_to_the_card():
    """With no device named, the System goes on the card, and without one
    make_system raises rather than run on the CPU; device='cpu' builds."""
    cfg = other_cfg(small_cfg())
    if torch.cuda.is_available():
        assert make_system(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_system(cfg)
    system = make_system(cfg, "cpu")
    assert system.device == torch.device("cpu") and system.L.device.type \
        == "cpu"


def test_init_state_layout():
    cfg = small_cfg()
    system = make_system(other_cfg(cfg), "cpu")
    st = init_state(system)
    W, M, N, D = cfg.n_walkers, cfg.M, cfg.Np, cfg.dim
    assert st.paths.shape == (W, M, N, D) and st.paths.dtype == torch.float64
    assert torch.equal(st.paths, st.paths[:, :1].expand(W, M, N, D))
    assert torch.equal(st.xend[:, 0], st.paths[:, cfg.Nb, N - 1])
    assert (st.paths.abs() <= 0.5 * system.L).all()
    assert not st.isopen.any() and st.step == 0
    Sweeper(system)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_trap_init_state_layout(dim):
    """Under the trap the particles start in [-a_ho, a_ho] per axis."""
    cfg = small_cfg(trap=True, dim=dim, a_ho=tuple(0.5 + k for k in
                                                   range(dim)))
    system = make_system(other_cfg(cfg), "cpu")
    st = init_state(system)
    assert st.paths.shape == (cfg.n_walkers, cfg.M, cfg.Np, dim)
    assert (st.paths.abs() <= system.a_ho).all() and not system.pbc
