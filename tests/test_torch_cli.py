"""The torch CLI: `python -m pathintegralgroundstate_torch <vpi.in>`.

Its override parsing equals the reference CLI's.  Under PIGS_PLATFORM=cpu
it runs a namelist of the small float64 configuration (torch_bridge.
small_cfg, written by config.namelist_text) and writes the
reference's output files; three blocks in one run are bitwise equal to two
blocks followed by a resumed `--blocks 1` (which prints BLOCK NUMBER : 3
and appends to e_vpi.out); --profile writes a trace.  Without a card and
without PIGS_PLATFORM it raises, and a run that needs ranks outside
torchrun names the torchrun command.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_bridge import small_cfg

from pathintegralgroundstate_torch import cli
from pathintegralgroundstate_torch.config import load_namelist_config, \
    namelist_text
from pathintegralgroundstate_tpu import cli as jcli

torch.set_num_threads(1)

SCALARS = ["1", "-3", "2.5", "1e-3", "T", "f", "true", "False", "bis",
           "float64", "0x10", ""]
OVERRIDES = ["n_walkers=16", "dt=5d-3", "a_ho=1.0,1.0,2.0", "trap=T",
             "sampling=bis", "x=1,", "seed=-7", "name=a=b"]
OUTPUTS = ("e_vpi.out", "et_vpi.out", "gr_vpi.out", "sk_vpi.out",
           "nr_vpi.out", "perm_histogram.out", "metrics.jsonl",
           "checkpoint.npz")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Under PIGS_PLATFORM=cpu: one run of 3 blocks into `one`, and one of
    2 blocks then a resumed --blocks 1 into `two`; (namelist, one, two, the
    resumed run's stdout)."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("cli")
    nml = root / "small.in"
    nml.write_text(namelist_text(small_cfg(Nstep=2, Nblock=2)))
    one, two = str(root / "one"), str(root / "two")
    saved = os.environ.get("PIGS_PLATFORM")
    os.environ["PIGS_PLATFORM"] = "cpu"
    out = io.StringIO()
    try:
        assert cli.main([str(nml), "-o", one, "--blocks", "3"]) == 0
        assert cli.main([str(nml), "-o", two]) == 0
        with contextlib.redirect_stdout(out):
            assert cli.main([str(nml), "-o", two, "--set", "resume=T",
                             "--blocks", "1"]) == 0
    finally:
        if saved is None:
            del os.environ["PIGS_PLATFORM"]
        else:
            os.environ["PIGS_PLATFORM"] = saved
    return str(nml), one, two, out.getvalue()


@pytest.mark.parametrize("val", SCALARS)
def test_parse_scalar_matches_reference(val):
    got, want = cli._parse_scalar(val), jcli._parse_scalar(val)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("kv", OVERRIDES)
def test_parse_override_matches_reference(kv):
    assert cli._parse_override(kv) == jcli._parse_override(kv)


@pytest.mark.parametrize("name", OUTPUTS)
def test_cli_writes_output_files(runs, name):
    for d in runs[1:3]:
        path = os.path.join(d, name)
        assert os.path.getsize(path) > 0, path


def test_namelist_round_trips():
    from pathintegralgroundstate_torch.config import load_namelist_config
    from pathintegralgroundstate_torch.flagship import flagship_cfg
    from torch_bridge import other_cfg
    cfg = other_cfg(small_cfg(Nstep=2, Nblock=2))
    assert load_namelist_config(namelist_text(cfg), is_text=True) == cfg


def test_resume_prints_block_3_and_appends(runs):
    _, one, two, stdout = runs
    assert "BLOCK NUMBER : 3" in stdout
    assert "BLOCK NUMBER : 1\n" not in stdout
    e = np.loadtxt(os.path.join(two, "e_vpi.out"), ndmin=2)
    np.testing.assert_array_equal(e[:, 0], [1, 2, 3])
    assert np.isfinite(e).all()


@pytest.mark.parametrize("name", ["e_vpi.out", "et_vpi.out", "gr_vpi.out",
                                  "sk_vpi.out", "nr_vpi.out",
                                  "perm_histogram.out"])
def test_resume_equals_one_run_bitwise(runs, name):
    """2 blocks + a resumed block == 3 blocks in one run, to the last
    digit written: the walkers, both generators and the accumulators come
    back from the checkpoint exactly."""
    _, one, two, _ = runs
    with open(os.path.join(one, name)) as a, open(os.path.join(two,
                                                               name)) as b:
        assert a.read() == b.read()


def test_resume_checkpoint_and_metrics_equal_one_run(runs):
    _, one, two, _ = runs
    za = np.load(os.path.join(one, "checkpoint.npz"))
    zb = np.load(os.path.join(two, "checkpoint.npz"))
    assert za.files == zb.files
    for k in za.files:
        if k != "__config__":
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    ca, cb = (json.loads(str(z["__config__"])) for z in (za, zb))
    assert not ca["resume"] and cb["resume"] and dict(ca, resume=True) == cb

    def metrics(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items()
                     if k not in ("time_s", "bead_updates_per_s")}
                    for line in f]
    ma, mb = metrics(one), metrics(two)
    assert [m["block"] for m in mb] == [1, 2, 3] and ma == mb


def test_profile_writes_a_trace(runs, tmp_path, monkeypatch):
    monkeypatch.setenv("PIGS_PLATFORM", "cpu")
    prof = tmp_path / "prof"
    assert cli.main([runs[0], "-o", str(tmp_path / "out"), "--profile",
                     str(prof), "--blocks", "2"]) == 0
    assert (prof / "trace.json").stat().st_size > 0
    with open(prof / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"pigs::block", "pigs::step", "pigs::diag", "pigs::move.bis",
            "pigs::report", "pigs::readback", "pigs::checkpoint"} <= names
    e = np.loadtxt(tmp_path / "out" / "e_vpi.out", ndmin=2)
    np.testing.assert_array_equal(e[:, 0], [1, 2])


def test_without_a_card_the_cli_raises(runs, tmp_path, monkeypatch):
    """The CLI runs on the card unless PIGS_PLATFORM=cpu asks for the CPU;
    with neither it raises rather than fall back to the CPU.  JAX_PLATFORMS
    names JAX's platform and is not read."""
    monkeypatch.delenv("PIGS_PLATFORM", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([runs[0], "-o", str(tmp_path)])


def test_unknown_platform_raises(runs, tmp_path, monkeypatch):
    monkeypatch.setenv("PIGS_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="PIGS_PLATFORM"):
        cli.main([runs[0], "-o", str(tmp_path)])


@pytest.mark.parametrize("kv,exc,item", [
    ("mesh_beads=2", ValueError,
     r"mesh_beads=2 does not match the 1 ranks .* torchrun "
     r"--nproc-per-node 2"),
    ("distributed=T", RuntimeError, r"torchrun --nproc-per-node"),
], ids=["mesh_beads=2", "distributed=T"])
def test_unported_options_raise(runs, tmp_path, monkeypatch, kv, exc, item):
    """Outside torchrun's environment a run that needs ranks names the
    torchrun command: mesh_beads=2 (on the staging sampler without the
    worm, inside the SP envelope: one rank per bead shard, as the reference
    wants a device per shard) and distributed=T."""
    monkeypatch.setenv("PIGS_PLATFORM", "cpu")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    sets = [kv] + (["sampling=sta", "CWorm=0"] if "mesh_beads" in kv else [])
    with pytest.raises(exc, match=item):
        cli.main([runs[0], "-o", str(tmp_path)]
                 + [a for s in sets for a in ("--set", s)])


def test_crystal_start_runs(runs, tmp_path, monkeypatch, capsys):
    """crystal=T: the CLI reads config_ini.in beside the input file and
    starts every walker from its positions, with its box and density."""
    monkeypatch.setenv("PIGS_PLATFORM", "cpu")
    cfg = load_namelist_config(runs[0])
    L = 5.0
    g = (np.arange(2) + 0.25) * L / 2 - L / 2
    R = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    lines = [f"{len(R)}", f"{L} {L} {L}", f"{len(R) / L ** 3}"]
    lines += [" ".join(map(str, x)) for x in R]
    nml = tmp_path / "run.in"
    nml.write_text(open(runs[0]).read())
    (tmp_path / "config_ini.in").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    cli.main([str(nml), "-o", str(out), "--set", "crystal=T", "--blocks",
              "1"])
    assert "# crystal start from" in capsys.readouterr().out
    z = np.load(str(out / "checkpoint.npz"))
    assert z["paths"].shape == (cfg.n_walkers, cfg.M, len(R), 3)
    assert np.all(np.abs(z["paths"]) <= L / 2 + 1e-9)
