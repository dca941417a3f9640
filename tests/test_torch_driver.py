"""The torch Driver against the reference Driver.

The statistics helpers (var, drift_z, shell_norm) equal the reference's on
seeded inputs.  Then both drivers run 2 blocks of 2 steps from one burned-in
reference state, the port on the CPU on the reference's own draws
(tests/torch_bridge.JaxDraws): every output file equal at rtol 1e-9 / atol
1e-12, metrics.jsonl with the same keys and values (but the block times),
the same final results, and checkpoints with the same state and
accumulators.  The reference Driver's block function is replaced by a loop
over the one jitted step that burned the state in, so that the file
compiles one JAX step.  Also: debug mode, the generators across a
checkpoint, and the refusal of a reference checkpoint.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import STATE_FIELDS, JaxDraws, other_cfg, small_cfg

from pathintegralgroundstate_torch import driver as tdriver
from pathintegralgroundstate_torch.state import generator_states, \
    init_state, set_generator_states, state_from_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import driver as jdriver
from pathintegralgroundstate_tpu import sweep as jsweep

torch.set_num_threads(1)

NBLOCK, NSTEP = 2, 2
OUTPUTS = ("e_vpi.out", "et_vpi.out", "gr_vpi.out", "sk_vpi.out",
           "nr_vpi.out", "perm_histogram.out")
TOL = dict(rtol=1e-9, atol=1e-12)
UNTIMED = ("time_s", "bead_updates_per_s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference dir, port dir, reference Driver, port Driver) after
    NBLOCK blocks of each from one burned-in reference state."""
    cfg = small_cfg(Nstep=NSTEP, Nblock=NBLOCK)
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("torch"))
    jdrv = jdriver.Driver(cfg, out_dir=jdir, verbose=False)
    step = jax.jit(jdrv.sweeper.step)
    st, stats = jdrv.state, jsweep.zero_stats(jdrv.system)
    for _ in range(150):
        st, stats = step(st, stats)
    burned = st
    nopen = int(np.sum(np.asarray(burned.isopen)))
    assert 0 < nopen < cfg.n_walkers, nopen

    def block(state):
        acc = jsweep.zero_stats(jdrv.system)
        for _ in range(cfg.Nstep):
            state, acc = step(state, acc)
        return state, acc

    jdrv._block_fn = block
    jdrv.state = burned
    jdrv.run()

    tdrv = tdriver.Driver(other_cfg(cfg), out_dir=tdir, device="cpu",
                          verbose=False,
                          draws=JaxDraws(burned.key, cfg.dim, jnp.float64))
    tdrv.state = state_from_numpy(tdrv.system, {k: getattr(burned, k)
                                                for k in STATE_FIELDS})
    tdrv.run()
    return jdir, tdir, jdrv, tdrv


@pytest.mark.parametrize("seed", range(6))
def test_var_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=int(rng.integers(1, 50)))
    args = (len(x) if seed else 0, float(x.mean()), float((x * x).mean()))
    assert tdriver.var(*args) == jdriver.var(*args)


@pytest.mark.parametrize("seed", range(6))
def test_drift_z_matches_reference(seed):
    """Series from 4 to 39 block means with a drift growing with seed, at
    both thresholds of the reference's calls, and a constant series."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    x = rng.normal(size=n) + 0.05 * seed * np.arange(n)
    for min_n in (6, 8):
        assert tdriver.drift_z(x, min_n) == jdriver.drift_z(x, min_n)
    assert tdriver.drift_z(np.ones(10)) == jdriver.drift_z(np.ones(10)) == 0.0


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_shell_norm_matches_reference(dim):
    rng = np.random.default_rng(dim)
    args = (dim, float(rng.uniform(0.1, 1.0)), float(rng.uniform(0.01, 0.1)),
            int(rng.integers(10, 200)))
    np.testing.assert_array_equal(tdriver.shell_norm(*args),
                                  jdriver.shell_norm(*args))


@pytest.mark.parametrize("name", OUTPUTS)
def test_output_file_matches_reference(runs, name):
    jdir, tdir = runs[:2]
    want = np.loadtxt(os.path.join(jdir, name))
    got = np.loadtxt(os.path.join(tdir, name))
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_block_files_have_one_row_per_block(runs):
    for d in runs[:2]:
        e = np.loadtxt(os.path.join(d, "e_vpi.out"), ndmin=2)
        assert e.shape == (NBLOCK, 4)
        np.testing.assert_array_equal(e[:, 0], np.arange(1, NBLOCK + 1))
        assert np.isfinite(e).all()


def _metrics(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_metrics_match_reference(runs):
    want, got = _metrics(runs[0]), _metrics(runs[1])
    assert len(got) == len(want) == NBLOCK
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k in UNTIMED:
                continue
            if isinstance(w[k], float):
                assert math.isclose(g[k], w[k], rel_tol=1e-9, abs_tol=1e-12), k
            else:
                assert g[k] == w[k], k
        assert g["bead_updates"] > 0 and g["try_cm"] > 0


def test_final_results_match_reference(runs):
    jdrv, tdrv = runs[2:]
    assert set(tdrv.final) == set(jdrv.final) and tdrv.final
    for k, w in jdrv.final.items():
        assert math.isclose(tdrv.final[k], w, rel_tol=1e-9, abs_tol=1e-12), k


def test_checkpoint_matches_reference(runs):
    """The same state fields and accumulators; the port carries its two
    generators' states where the reference carries its key."""
    jdir, tdir = runs[:2]
    zj = np.load(os.path.join(jdir, "checkpoint.npz"))
    zt = np.load(os.path.join(tdir, "checkpoint.npz"))
    assert set(zt.files) - {"gen_state", "host_gen_state"} == \
        set(zj.files) - {"key"}
    for k in zj.files:
        if k == "key" or k.startswith("__"):
            continue
        if zj[k].dtype.kind == "f":
            np.testing.assert_allclose(zt[k], zj[k], **TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    sj = json.loads(str(zj["__scalars__"]))
    st = json.loads(str(zt["__scalars__"]))
    assert set(st) == set(sj) and st["iblock"] == NBLOCK
    for k in sj:
        assert math.isclose(st[k], sj[k], rel_tol=1e-9, abs_tol=1e-12), k
    assert json.loads(str(zt["__config__"])) == json.loads(
        str(zj["__config__"]))
    assert int(zt["step"]) == 150 + NBLOCK * NSTEP


def test_reference_checkpoint_is_refused(runs):
    """A checkpoint of the JAX package (a threefry key, no generator
    states) raises ValueError saying why, rather than resume from it."""
    jdir = runs[0]
    cfg = other_cfg(small_cfg(Nstep=NSTEP, resume=True))
    with pytest.raises(ValueError, match="JAX package"):
        tdriver.Driver(cfg, out_dir=jdir, device="cpu", verbose=False)


def test_generator_states_round_trip():
    """generator_states / set_generator_states: a state set back replays
    the same draws from both generators."""
    system = make_system(other_cfg(small_cfg()), "cpu")
    st = init_state(system)
    saved = generator_states(st)
    a = (torch.rand(5, generator=st.gen), torch.rand(5, generator=st.host_gen))
    set_generator_states(st, *saved)
    b = (torch.rand(5, generator=st.gen), torch.rand(5, generator=st.host_gen))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(s.dtype == np.uint8 for s in saved)


def test_debug_mode_matches_and_names_the_step(tmp_path):
    """debug=True runs the block step by step: the same state as the block
    of run_block; a non-finite path raises FloatingPointError naming the
    MC step."""
    cfg = other_cfg(small_cfg(Nstep=NSTEP))
    plain = tdriver.Driver(cfg, out_dir=str(tmp_path / "a"), device="cpu",
                           verbose=False)
    dbg = tdriver.Driver(cfg.replace(debug=True), out_dir=str(tmp_path / "b"),
                         device="cpu", verbose=False)
    plain.run(1)
    dbg.run(1)
    assert torch.equal(plain.state.paths, dbg.state.paths)
    dbg.state.paths[0, 3, 2, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=f"MC step {NSTEP + 1}"):
        dbg.run(1)


def test_distributed_is_refused(tmp_path, monkeypatch):
    """distributed=True outside torchrun's environment (no MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE) is refused, naming the torchrun command;
    under it the Driver joins the process group
    (tests/test_torch_multihost.py)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    cfg = other_cfg(small_cfg(distributed=True))
    with pytest.raises(RuntimeError, match=r"torchrun --nproc-per-node"):
        tdriver.Driver(cfg, out_dir=str(tmp_path), device="cpu",
                       verbose=False)
