"""The port's bench path on the CPU: bench_torch.py (the counterpart of
bench.py), tools/torch_benchgrid.py (tools/benchgrid.py) and
tools/torch_stepprobe.py (tools/stepprobe.py).  The JSON line carries
bench.py's keys, the rate arithmetic equals bench.py's on the reference's
count, the CPU shape is bench.py's, the grid's variants are benchgrid.py's
configurations, nothing falls back to the CPU without being asked, and
none of the three imports JAX or the reference package."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_bridge import other_cfg

import bench_torch
from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.sweep import COUNTER_NAMES, Sweeper
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import sweep as jsweep
from tools import torch_benchgrid, torch_stepprobe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source_tree(name):
    with open(os.path.join(REPO, name)) as f:
        return ast.parse(f.read())


def _bench_py_keys():
    """The keys of bench.py's JSON line (bench.py:140-164), read from its
    source: the dict literal whose keys include 'metric'."""
    for node in ast.walk(_source_tree("bench.py")):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise AssertionError("bench.py prints no 'metric' line")


def _benchgrid_variants():
    """{name: overrides} of tools/benchgrid.py's variants, read from its
    source: every (name, base.replace(**overrides)) tuple."""
    out = {}
    for node in ast.walk(_source_tree("tools/benchgrid.py")):
        if (isinstance(node, ast.Tuple) and len(node.elts) == 2
                and isinstance(node.elts[0], ast.Constant)
                and isinstance(node.elts[1], ast.Call)
                and isinstance(node.elts[1].func, ast.Attribute)
                and node.elts[1].func.attr == "replace"):
            out[node.elts[0].value] = {
                kw.arg: ast.literal_eval(kw.value)
                for kw in node.elts[1].keywords}
    return out


BENCH_PY_KEYS = _bench_py_keys()
BENCHGRID = {"default": {}, **_benchgrid_variants()}
# the grid's rows that tools/benchgrid.py does not have, with their overrides
# of the flagship
ADDED = {"fused": {"fused_sweep": True},
         "fused + cascade": {"fused_sweep": True, "cascade": True},
         "per level + random end depth": {"bis_monoshot": False,
                                          "bis_end_random_depth": True}}


def _lines(capsys):
    return [x for x in capsys.readouterr().out.splitlines() if x]


def test_main_cpu_prints_one_line(capsys):
    bench_torch.main(["--device", "cpu"])
    lines = _lines(capsys)
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert BENCH_PY_KEYS <= set(line)
    assert set(line) == set(bench_torch.KEYS)
    assert line["n_walkers"] == 8
    assert len(line["reps_s"]) == bench_torch.NREPS
    assert line["value"] > 0
    assert line["pallas"] is True
    assert line["device"] == "cpu" and line["peak_mem_gib"] is None
    assert line["metric"] != "bead_updates_per_s_per_chip"
    assert 0.0 <= line["open_walker_frac"] <= 1.0
    # the denominators divide the card's rate only
    assert line["vs_baseline"] is None and line["vs_numpy_ref"] is None
    cfg = bench_torch.bench_cfg(8, "cpu")
    want = (8 * bench_torch.bead_updates_per_step(cfg) * bench_torch.NSTEP
            / float(np.median(line["reps_s"])))
    assert line["value"] == pytest.approx(want, rel=1e-12)
    # the plain forms on the CPU: no kernel launched
    assert not any(line["launches"].values())


@pytest.mark.parametrize("worm", [True, False], ids=["worm", "no_worm"])
def test_rates_match_bench_py(worm):
    """rates() against a numpy transcription of bench.py:120-137 with the
    reference's own count (JAX sweep.bead_updates_per_step)."""
    W, nstep = 1024, 5
    cfg = flagship_cfg(W)
    if not worm:
        cfg = cfg.replace(CWorm=0.0)
    reps = [3.7, 3.1, 4.4]
    counters = np.zeros(len(COUNTER_NAMES), np.int32)
    counters[COUNTER_NAMES.index("try_cm_half")] = 43_520
    got = bench_torch.rates(cfg, reps, counters, W, nstep)

    jcfg = other_cfg(cfg)
    dt = float(np.median(reps))
    per = jsweep.bead_updates_per_step(jcfg)
    rate = per * nstep * W / dt
    diag_per = jsweep.bead_updates_per_step(
        jcfg.replace(CWorm=0.0, Nobdm=0, swapping=False))
    if jcfg.CWorm > 0 and jcfg.Nobdm > 0:
        open_frac = float(counters[jsweep._CIDX["try_cm_half"]]) / (
            2.0 * jcfg.Nobdm * W * nstep)
    else:
        open_frac = 0.0
    useful = (diag_per + (per - diag_per) * open_frac) * nstep * W / dt
    want = {"value": rate, "useful_bead_updates_per_s": useful,
            "open_walker_frac": round(open_frac, 4),
            "walkers_per_s": W * nstep / dt,
            "ms_per_step": dt / nstep * 1e3}
    want["vs_baseline"] = rate / bench_torch.CPU_1WALKER_BEAD_UPDATES_PER_S
    want["vs_numpy_ref"] = rate / bench_torch.NUMPY_REF_BEAD_UPDATES_PER_S
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert (got["open_walker_frac"] > 0) == worm


def test_cpu_shape_is_bench_py_shape():
    """bench.py's CPU shape (bench.py:110-113) with Lstag cut to Nb."""
    from __graft_entry__ import _flagship_cfg
    want = _flagship_cfg(8).replace(Nb=8, Np=16, Nstag=1, Nobdm=2, Lstag=8)
    assert other_cfg(bench_torch.bench_cfg(8, "cpu")) == want


def test_bench_py_own_cpu_shape_is_refused():
    """bench.py's own CPU shape keeps the flagship's Lstag=32 at Nb=8,
    which the worm moves cannot take: the port's Sweeper refuses it, hence
    the cut in bench_torch.CPU_SHAPE."""
    cfg = flagship_cfg(8).replace(Nb=8, Np=16, Nstag=1, Nobdm=2)
    with pytest.raises(ValueError, match="Lstag <= Nb"):
        Sweeper(make_system(cfg, "cpu"))


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


def test_no_pallas_switch(monkeypatch, capsys):
    monkeypatch.setenv("PIGS_BENCH_NO_PALLAS", "1")
    assert bench_torch.bench_cfg(1024).use_pallas is False
    bench_torch.main(["--device", "cpu", "--steps", "1", "--reps", "1"])
    line = json.loads(_lines(capsys)[-1])
    assert line["pallas"] is False
    assert len(line["reps_s"]) == 1


def test_walker_scan_prints_a_line_per_w(capsys):
    bench_torch.main(["--device", "cpu", "--walkers", "2,4", "--steps", "1",
                      "--reps", "1"])
    lines = [json.loads(x) for x in _lines(capsys)]
    assert [x["n_walkers"] for x in lines] == [2, 4]


def test_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', "
        "'pathintegralgroundstate_tpu'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "for m in ('bench_torch', 'tools.torch_benchgrid', "
        "'tools.torch_stepprobe'):\n"
        "    importlib.import_module(m)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", list(BENCHGRID) + list(ADDED))
def test_grid_variant_matches_benchgrid(name):
    """Each variant of the port's grid, by name, is tools/benchgrid.py's
    configuration (the added rows: the flagship with their overrides)."""
    from __graft_entry__ import _flagship_cfg
    W = 512
    got = dict(torch_benchgrid.variants(W, full=True))
    overrides = BENCHGRID.get(name, ADDED.get(name))
    assert other_cfg(got[name]) == _flagship_cfg(W).replace(**overrides)


def test_grid_names_cover_benchgrid():
    names = [n for n, _ in torch_benchgrid.variants(512, full=True)]
    assert names == list(BENCHGRID) + list(ADDED)
    assert [n for n, _ in torch_benchgrid.variants(512, full=False)] == [
        "default"]


def test_grid_runs_a_variant(capsys):
    cfg = torch_benchgrid.variants(4, False, "cpu")[0][1]
    assert torch_benchgrid.run_one("default", cfg, 4, "cpu", nstep=1,
                                   nreps=1)
    out = capsys.readouterr().out
    assert "default" in out and "ms/step" in out and "bead-updates/s" in out


def test_grid_without_card_fails(monkeypatch, capsys):
    """Without a card every variant prints FAILED and the grid exits
    non-zero: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert torch_benchgrid.main(["4"]) == 1
    out = capsys.readouterr().out
    assert "FAILED: RuntimeError" in out


PROBE_LINES = ("therm_energy", "local_energy x2", "gr+sk", "translate_chain",
               "bisection", "head_bisection", "tail_bisection",
               "translate_half", "head_half", "staging_half", "swap",
               "open_chain", "reconstructed step:", "CM total", "bis sweeps",
               "worm updates", "estimators", "measured run_block step:")


def test_stepprobe_cpu(capsys):
    torch_stepprobe.main(["--device", "cpu", "--walkers", "4", "--calls",
                          "1"])
    lines = [x.strip() for x in _lines(capsys)]
    for name in PROBE_LINES:
        assert any(x.startswith(name) for x in lines), name
    assert not any("measured ~" in x for x in lines)
