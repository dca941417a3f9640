"""The manifest, the names and units, and finding every part by name."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import manifest  # noqa: E402

BENCH = manifest.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_manifest_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "pigsbench/run.py"]
    assert BENCH["paths"] == ["pigsbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_in_the_charset(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert manifest.NAME_RE.match(n), n


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_entries(kind):
    cells = set(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[kind]:
        assert manifest.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads"}
        if kind == "end_to_end":
            allowed.add("bound")
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            allowed |= {"layer", "moves"}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert set(m) <= allowed, m
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for cell in CELLS:
        e2e = {m["name"] for m in manifest.cell_metrics(BENCH, cell,
                                                        "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(BENCH, cell, "per_layer")


def test_configs_and_cells():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"pigsbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert manifest.NAME_RE.match(k)
            assert not k.endswith(("_dim", "_rank"))
        assert manifest.config(c["name"])["reduced"] == c["reduced"]
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert manifest.NAME_RE.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert manifest.workload(w["name"])["config"] == w["config"]
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(json.dumps(BENCH)) <= 64 * 1024


EXACT_CELL = "he4_exact_f2.w1024"
# the per-layer metrics that read something in the exact-F^2 cell: kernel A,
# kernel 3 and kernel 5 do not run there; the fold kernel and the glue
# kernels (the 960 cached bisections a step) do
STAGES = {f"stage_{q}_per_step.{s}" for q in ("launches", "idle_ms",
                                              "device_ms")
          for s in ("cm", "diag", "worm", "measure")}
EXACT_METRICS = {"device_idle_pct", "host_launches_per_step",
                 "torch_ops_device_ms_per_step", "roofline_pct.all_pairs",
                 "host_ints_per_step", "bis_glue_moves_per_step",
                 "fold_launches_per_step"} | STAGES
# the two cells of the reference's move order and of the per-walker windows
# (no fold, no cascade): kernel A, kernel B, the stages; kernel 3's two
# metrics in the reference order, the glue kernels' count with per-walker
# windows (the 640 end moves a step)
NEW_METRICS = {"device_idle_pct", "host_launches_per_step",
               "torch_ops_device_ms_per_step", "roofline_pct.window_pairs",
               "roofline_pct.all_pairs", "host_ints_per_step"} | STAGES
CELL_METRICS = {
    EXACT_CELL: EXACT_METRICS,
    "he4.reforder_w1024": NEW_METRICS | {"roofline_pct.dense_gate",
                                         "dense_gate_launches_per_step",
                                         "bis_glue_moves_per_step"},
    "he4.perwalker_w16384": NEW_METRICS | {"bis_glue_moves_per_step"},
}


@pytest.mark.parametrize("cell", sorted(CELL_METRICS))
def test_the_exact_f2_cell_is_in_the_metrics_that_read_it(cell):
    assert len(EXACT_METRICS) == 19 and len(NEW_METRICS) == 18
    for m in BENCH["per_layer"]:
        assert (cell in m.get("workloads", [])) == (
            m["name"] in CELL_METRICS[cell]), (cell, m["name"])


def test_fold_launches_list_the_five_accepted_cells():
    fold = next(m for m in BENCH["per_layer"]
                if m["name"] == "fold_launches_per_step")
    assert fold["workloads"] == [
        "he4.vpi_w4096", "dipolar2d.w1024", "he4.vpi_w65536",
        "he4.cascade_w16384", EXACT_CELL]
    for cell in fold["workloads"]:
        assert "bead_updates_per_s" in {
            m["name"] for m in manifest.cell_metrics(BENCH, cell,
                                                     "end_to_end")}


def test_the_reference_order_and_per_walker_cells():
    he4 = manifest.config("he4_n64")["fields"]
    for cell, walkers, steps, over in (
            ("he4.reforder_w1024", 1024, 1,
             {"bis_monoshot": False, "bis_end_random_depth": True}),
            ("he4.perwalker_w16384", 16384, 5, {"shared_windows": False})):
        wl = manifest.workload(cell)
        assert {k: v for k, v in wl.items() if k != "check"} == {
            "config": "he4_n64", "walkers": walkers,
            "steps_per_block": steps, "overrides": over}
        assert all(he4[k] != v for k, v in over.items())
        assert {"bis_dS_gap", "bis_state_gap", "count_gap", "missing"} <= set(
            wl["check"]["limits"])
        assert wl["check"]["limits"]["missing"] == 0
        assert wl["check"]["limits"]["count_gap"] == 0
        entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
        assert entry["chips"] == 1 and entry["config"] == "he4_n64"
    assert {"gate_dS_gap", "depth_gap"} <= set(manifest.workload(
        "he4.reforder_w1024")["check"]["limits"])


def test_the_exact_f2_configuration_and_cell():
    he4 = manifest.config("he4_n64")
    ex = manifest.config("he4_exact_f2_n64")
    assert set(ex) == set(he4) and ex["reduced"] == []
    assert ex["fields"] == {**he4["fields"], "exact_f2": True,
                            "f2_cache": True}
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == "he4_exact_f2_n64")
    assert entry["source"] == ex["source"] and "204109" in ex["source"]
    wl = manifest.workload(EXACT_CELL)
    assert {k: v for k, v in wl.items() if k != "check"} == {
        "config": "he4_exact_f2_n64", "walkers": 1024, "steps_per_block": 1,
        "overrides": {}}
    assert {"dfield_gap", "fcache_gap", "missing"} <= set(
        wl["check"]["limits"])
    cell = next(w for w in BENCH["workloads"] if w["name"] == EXACT_CELL)
    assert cell["chips"] == 1 and cell["config"] == "he4_exact_f2_n64"


def test_every_part_is_found_by_name():
    assert manifest.names("workloads", ".json") == sorted(CELLS)
    assert set(manifest.names("configs", ".json")) == {
        c["name"] for c in BENCH["configs"]}
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert set(manifest.names("metrics", ".py")) == set(metrics)
    for m in metrics:
        assert callable(manifest.metric_reader(m))


def test_a_cell_and_a_metric_added_as_files_alone_are_found(tmp_path):
    root = tmp_path / "pigsbench"
    for part in ("configs", "workloads", "metrics"):
        shutil.copytree(REPO / "pigsbench" / part, root / part)
    wl = manifest.workload("he4.vpi_w4096")
    (root / "workloads" / "he4.dummy_w8.json").write_text(
        json.dumps({**wl, "walkers": 8}))
    (root / "metrics" / "dummy_count.py").write_text(
        "def read(run):\n    return run.walkers\n")
    assert "he4.dummy_w8" in manifest.names("workloads", ".json", root)
    assert manifest.workload("he4.dummy_w8", root)["walkers"] == 8
    assert manifest.config(wl["config"], root)["name"] == wl["config"]
    reader = manifest.metric_reader("dummy_count", root)

    class Run:
        walkers = 8
    assert reader(Run()) == 8
    bench = {**BENCH, "workloads": BENCH["workloads"] + [
        {"name": "he4.dummy_w8", "config": "he4_n64", "traffic": "dummy_w8",
         "chips": 1, "why": "a dummy"}]}
    assert manifest.cell_metrics(bench, "he4.dummy_w8", "end_to_end")
    with pytest.raises(FileNotFoundError):
        manifest.workload("he4.absent", root)


_IMPORTS = """
import sys
sys.path.insert(0, {repo!r})
import pigsbench.reference.physics, pigsbench.reference.moves
import pigsbench.reference.estimators, pigsbench.reference.exact_f2
from pigsbench.reference.physics import PairModel
import json
for name in ("he4_n64", "dipolar2d_n256", "he4_exact_f2_n64"):
    cfg = json.load(open({repo!r} + "/pigsbench/configs/" + name + ".json"))
    PairModel(cfg["fields"])
ref = sorted({{m.split(".")[0] for m in sys.modules}})
{more}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(ref))
"""


def _top_levels(more: str):
    code = _IMPORTS.format(repo=str(REPO), more=more)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    after, ref = out.stdout.strip().splitlines()[-2:]
    return set(json.loads(after)), set(json.loads(ref))


def test_nothing_run_loads_jax_and_the_reference_loads_no_program():
    more = """
from pigsbench.harness import (capture, counting, guard, judge, manifest,
                               roofline, trace, window)
window.port_modules()
for m in manifest.names("metrics", ".py"):
    manifest.metric_reader(m)
bad = guard.forbidden_loaded()
assert not bad, bad
"""
    after, ref = _top_levels(more)
    for name in ("jax", "jaxlib", "flax", "pathintegralgroundstate_tpu",
                 "bench", "bench_torch", "tools"):
        assert name not in after, name
    assert "pathintegralgroundstate_torch" in after
    assert not any(m.startswith("pathintegralgroundstate") for m in ref)


def test_guard_compares_whole_top_level_names():
    from pigsbench.harness.guard import forbidden_loaded
    assert forbidden_loaded(["pathintegralgroundstate_torch.ops",
                             "jaxtyping", "jax_cache"]) == []
    assert forbidden_loaded(["jax.numpy", "pathintegralgroundstate_tpu"]) \
        == ["jax", "pathintegralgroundstate_tpu"]
