"""The port's certification tools at a tiny size on the CPU
(PIGS_PLATFORM=cpu, N = 8, W <= 16, one block): tools/torch_tau_ladder.py,
tools/torch_worm_obdm.py and tools/torch_optimize_rm.py each run, write
the JSON line of the JAX tool they stand for, with its keys, and load no
module of jax, jaxlib or pathintegralgroundstate_tpu."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run a tool as __main__, then list the forbidden modules it loaded
RUNNER = (
    "import runpy, sys\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(sys.argv[0], run_name='__main__')\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'pathintegralgroundstate_tpu'))\n"
    "print('LOADED', bad)\n")


def run_tool(tool, *args):
    env = dict(os.environ, PIGS_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, os.path.join(REPO, "tools", tool)]
        + [str(a) for a in args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "LOADED []", lines[-1]
    return [json.loads(x) for x in lines if x.startswith("{")]


TAU_KEYS = {"Nb", "dt", "tau", "E", "dE", "Et", "dEt", "V", "K", "tail",
            "E_K", "dE_K", "Et_K", "dEt_K", "wall_s"}


def test_tau_ladder_runs(tmp_path):
    rows = run_tool("torch_tau_ladder.py", tmp_path, "8,8:2.5e-3", 4, 0, 1,
                    2, 8)
    assert len(rows) == 2 and all(TAU_KEYS <= set(r) for r in rows)
    assert [(r["Nb"], r["dt"]) for r in rows] == [(8, 5e-3), (8, 2.5e-3)]
    assert rows[0]["tail"] < 0 and rows[0]["device"] == "cpu"
    logged = [json.loads(x) for x in open(tmp_path / "tau_ladder.jsonl")]
    assert logged == rows


def test_worm_obdm_runs(tmp_path):
    (row,) = run_tool("torch_worm_obdm.py", tmp_path, 1, 32, 5e-3, 4, 0, 1,
                      8)
    keys = {"n0", "dn0", "Nb", "dt", "W", "obdm_blocks", "diag_blocks",
            "perm_hist", "wall_s"}
    assert keys <= set(row) and len(row["perm_hist"]) == 8
    assert json.load(open(tmp_path / "condensate.json")) == row


def test_optimize_rm_runs():
    rows = run_tool("torch_optimize_rm.py", 8, 3, 16)
    iters, summary = rows[:-1], rows[-1]
    assert [r["iter"] for r in iters] == [1, 2, 3]
    assert summary["summary"] and summary["Np"] == 8 and summary["W"] == 16
    assert 0.8 <= summary["Rm_opt"] <= 1.8
    assert all(set(r) == {"iter", "Rm", "E_per_N", "dE_dRm_per_N", "acc"}
               for r in iters)


@pytest.mark.parametrize("tool", ["torch_tau_ladder.py",
                                  "torch_worm_obdm.py",
                                  "torch_optimize_rm.py"])
def test_tool_imports_no_jax(tool):
    """The module itself, imported without running: no JAX."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('t', "
            f"{os.path.join(REPO, 'tools', tool)!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pathintegralgroundstate_tpu')]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
