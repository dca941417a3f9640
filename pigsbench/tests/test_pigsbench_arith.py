"""The yardstick's arithmetic: the frozen work count, the rate over a
window, the rooflines' bytes and operations on hand-worked shapes, and
the trace's interval arithmetic."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import counting, manifest, roofline, trace, window  # noqa: E402,E501

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
VARIANTS = [{}, {"fused_sweep": True}, {"fused_sweep": True, "cascade": True},
            {"bis_end_random_depth": True}, {"CWorm": 0.0},
            {"sampling": "sta", "Lstag": 8}, {"CMFreq": 3},
            {"sampling": "sta", "Lstag": 8, "mesh_beads": 4, "CWorm": 0.0}]


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("cell", CELLS)
def test_frozen_count_equals_the_programs(cell, variant):
    from pathintegralgroundstate_torch.config import SimConfig
    from pathintegralgroundstate_torch.sweep import bead_updates_per_step
    wl = manifest.workload(cell)
    fields = window.sim_fields(wl, manifest.config(wl["config"]))
    fields = {**fields, **VARIANTS[variant]}
    assert counting.bead_updates_per_step(fields) == \
        bead_updates_per_step(SimConfig(**fields))


def test_counter_names_are_the_programs():
    from pathintegralgroundstate_torch.sweep import COUNTER_NAMES
    assert counting.COUNTER_NAMES == COUNTER_NAMES


def test_flagship_count():
    wl = manifest.workload("he4.vpi_w4096")
    fields = window.sim_fields(wl, manifest.config(wl["config"]))
    # 64 x 65 CM, 5 x 64 x 3 x 16 bisection, 10 x (2 x 33 + 6 x 32) worm
    assert counting.bead_updates_per_step(fields) == 22100


def test_exact_f2_count():
    # the exact F^2 changes the action, not the work: the flagship's count
    wl = manifest.workload("he4_exact_f2.w1024")
    fields = window.sim_fields(wl, manifest.config(wl["config"]))
    assert fields["exact_f2"] and fields["f2_cache"]
    assert counting.bead_updates_per_step(fields) == 22100


@pytest.mark.parametrize("cell", ["he4.reforder_w1024",
                                  "he4.perwalker_w16384"])
def test_reference_order_and_per_walker_counts(cell):
    # the flagship's count: 3 x 2^Nlev a visit whatever end depth is drawn,
    # and per-walker windows move as many beads as shared ones
    wl = manifest.workload(cell)
    fields = window.sim_fields(wl, manifest.config(wl["config"]))
    assert counting.bead_updates_per_step(fields) == 22100


def test_rate_is_all_the_work_over_all_the_time():
    # three 5-step blocks of 0.5, 0.5 and 2.0 s: the window's rate is the
    # work over 3 s, not the median block's rate
    run = window.Run(cell="c", fields={"n_walkers": 10}, workload={},
                     seed=1, device="cpu", window_s=0.5 + 0.5 + 2.0,
                     blocks=3, steps=15, per_step=100)
    assert run.bead_updates_per_s == pytest.approx(10 * 100 * 15 / 3.0)
    assert counting.rate(10, 100, 15, 3.0) == pytest.approx(5000.0)
    median_block = 10 * 100 * 5 / 0.5
    assert run.bead_updates_per_s < median_block


def test_window_pairs_bytes_and_operations():
    rec = dict(dtype="f32", W=2, B=3, N=4, D=3, M=5, ip_mode=0, ib_mode=0,
               need_wf=1, need_f2=1, reduce=0, row_weights=False,
               pot_kind=0, jas_kind=0)
    # bytes: 4 (72 window + 36 positions + 15 table + 6 rows) + 8 x 3 ib
    # ops per pair and side: 12 + 2 + 1 + 45 (V, dV) + 7 (force) + 9 (u)
    assert roofline.window_pairs(rec) == (540, 6 * (2 * 3 * 76 + 18))
    red = {**rec, "reduce": 1, "ip_mode": 1, "ib_mode": 1,
           "row_weights": True, "need_wf": 0, "need_f2": 0}
    # bytes: 4 (72 + 36 + 15 + 3 weights + 2 sums) + 8 (6 ib + 2 ip);
    # ops without force or u: 12 + 2 + 1 + 25 (V)
    assert roofline.window_pairs(red) == (4 * 128 + 8 * 8,
                                          6 * (2 * 3 * 40 + 6))
    dip = {**rec, "dtype": "f64", "D": 2, "pot_kind": 2, "jas_kind": 1}
    # 8 (48 + 24 + 15 + 6) + 24; per pair 8 + 2 + 1 + 5 + 5 + 7
    assert roofline.window_pairs(dip) == (8 * 93 + 24,
                                          6 * (2 * 3 * 28 + 14))


def test_dense_gate_bytes_and_operations():
    rec = dict(dtype="f32", mode=roofline.DENSE_ACTION, force=1, W=2, B=1,
               N=4, D=3, M=5, ip_mode=0, ib_mode=0, pot_kind=0, jas_kind=0)
    # bytes: 4 (24 partners + 12 positions + 15 table + 2 rows) + 8 x 1 ib
    # ops per pair and side: 12 + 2 + 1 + 45 (V, dV) + 7 (force) + 9 (u on
    # the end row); per row both sides' |F|^2 2 x 6 and the weighting 6
    assert roofline.dense_gate(rec) == (4 * 53 + 8, 2 * (2 * 3 * 76 + 18))
    dip = {**rec, "dtype": "f64", "force": 0, "B": 3, "D": 2, "ip_mode": 1,
           "ib_mode": 1, "pot_kind": 2, "jas_kind": 1}
    # 8 (48 + 24 + 15 + 6) + 8 (6 ib + 2 ip); per pair 8 + 2 + 1 + 3 (V)
    # + 7 (u), no force
    assert roofline.dense_gate(dip) == (8 * 93 + 8 * 8, 6 * (2 * 3 * 21 + 6))
    with pytest.raises(ValueError):
        roofline.dense_gate({**rec, "mode": roofline.DENSE_RAW})


def test_all_pairs_bytes_and_operations():
    rec = dict(dtype="f32", W=2, B=3, N=4, D=3, force=1, pot_kind=0)
    # 6 configurations of 4 particles: 6 pairs each at 12 + 2 + 1 + 45 +
    # 13 (both force sums), and |F|^2 over 4 x 3 components
    assert roofline.all_pairs(rec) == (4 * (72 + 12), 6 * (6 * 73 + 24))
    assert roofline.all_pairs({**rec, "force": 0}) == (
        4 * (72 + 12), 6 * 6 * 40)


def test_cascade_move_bytes_and_operations():
    ends = dict(dtype="f32", mode="ends", W=2, S=2, N=4, D=3, L=4, nlev=2,
                beads=10, pot_kind=0, jas_kind=0)
    # bytes: 4 x 2 walkers x (10 beads x 12 + 2 slots x (15 rg + 3 ru + 12
    # rows written)) + 2 x 4 flags (active, acc)
    # ops per slot: the end guess 8 x 3 and its row 2 x 3 x 49 (V, u) + 6;
    # level 1: a midpoint 12 x 3 and its row 2 x 3 x 40 (V) + 6; level 2:
    # two of them at 2 x 3 x 67 (V, dV, force) + 2 x 6 (|F|^2) + 6
    assert roofline.cascade_move(ends) == (
        4 * 2 * (120 + 2 * 30) + 8,
        2 * 2 * ((24 + 300) + (36 + 246) + 2 * (36 + 420)))
    interior = {**ends, "mode": "interior", "S": 3, "beads": 13}
    # 3 slots of 4 links from one shift: 13 beads; 2 gates, 3 rows written;
    # no end guess or end row
    assert roofline.cascade_move(interior) == (
        4 * 2 * (13 * 12 + 3 * (15 + 2 + 9)) + 12,
        2 * 3 * ((36 + 246) + 2 * (36 + 420)))
    dip = {**interior, "dtype": "f64", "D": 2, "pot_kind": 2, "jas_kind": 1}
    # 8 bytes an element, 8 per dimension; dipolar V 3, (V, dV) 5:
    # level 1 2 x 3 x (8 + 2 + 1 + 3) + 6, level 2 2 x 3 x (14 + 2 + 5) + 8
    # + 6 beside 12 x 2 per midpoint
    assert roofline.cascade_move(dip) == (
        8 * 2 * (13 * 8 + 3 * (10 + 2 + 6)) + 12,
        2 * 3 * ((24 + 90) + 2 * (24 + 140)))


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(540, 2844, "f32") == pytest.approx(
        540 / 3.35e12)
    assert roofline.least_seconds(1, 34e12, "f64") == pytest.approx(1.0)
    assert roofline.least_seconds(1, 67e12, "bf16") == pytest.approx(1.0)


def test_trace_arithmetic():
    assert trace.union_seconds([(0, 10), (5, 20), (30, 40)]) == \
        pytest.approx(30e-9)
    calls = [(1, 0, 10), (1, 2, 5), (1, 20, 30), (2, 3, 4)]
    assert trace._count_launch_calls(calls) == 3
    td = trace.TraceData(steps=2, window_s=100e-9,
                         kernels=[("void pair_rows_kernel<float>", 0, 10),
                                  ("at::add", 20, 50)],
                         memops=[("Memcpy HtoD", 40, 60)],
                         host_ops=[("aten::add", 5, 70),
                                   ("cudaLaunchKernel", 12, 18)])
    assert td.busy_s == pytest.approx(50e-9)
    assert td.kernel_seconds("pair_rows_kernel") == (pytest.approx(10e-9), 1)
    b = trace.breakdown(td)
    assert b["device_ops"][0] == ["at::add", pytest.approx(30e-9)]
    assert b["idle_gaps"] == [["cudaLaunchKernel", pytest.approx(10e-9)]]


def test_metric_readers_on_a_trace():
    td = trace.TraceData(
        steps=5, window_s=1.0,
        kernels=[("void pair_rows_kernel<float, 4>", 0, 1000),
                 ("void pair_pot_kernel<float>", 2000, 2500),
                 ("at::add", 3000, 4000)],
        launch_calls=15,
        launches={"pair_rows": [dict(dtype="f32", W=2, B=3, N=4, D=3, M=5,
                                     ip_mode=0, ib_mode=0, need_wf=1,
                                     need_f2=1, reduce=0, row_weights=False,
                                     pot_kind=0, jas_kind=0)],
                  "pair_pot": [dict(dtype="f32", W=2, B=3, N=4, D=3,
                                    force=1, pot_kind=0)]})
    run = SimpleNamespace(trace=td)
    read = manifest.metric_reader
    assert read("host_launches_per_step")(run) == 3.0
    assert read("torch_ops_device_ms_per_step")(run) == pytest.approx(
        1000e-6 / 5)
    assert read("device_idle_pct")(run) == pytest.approx(
        100 * (1 - 2500e-9))
    assert read("roofline_pct.window_pairs")(run) == pytest.approx(
        100 * (540 / 3.35e12) / 1000e-9)
    td.launches["pair_rows"].append(td.launches["pair_rows"][0])
    assert read("roofline_pct.window_pairs")(run) is None
    assert read("device_idle_pct")(SimpleNamespace(trace=None)) is None


def test_cascade_metrics_on_a_trace():
    rec = dict(dtype="f32", mode="ends", W=2, S=2, N=4, D=3, L=4, nlev=2,
               beads=10, pot_kind=0, jas_kind=0)
    td = trace.TraceData(
        steps=2, window_s=1.0,
        kernels=[("void (anonymous namespace)::cascade_kernel<float, 0, 0, "
                  "3>(Consts<float>, CascadeArgs)", 0, 500),
                 ("void (anonymous namespace)::cascade_kernel<float, 0, 0, "
                  "3>(Consts<float>, CascadeArgs)", 600, 1100),
                 ("void pair_rows_kernel<float, 4>", 2000, 3000)],
        launches={"cascade": [rec, rec]})
    run = SimpleNamespace(trace=td)
    read = manifest.metric_reader
    assert read("cascade_launches_per_step")(run) == 1.0
    assert read("roofline_pct.cascade_move")(run) == pytest.approx(
        100 * 2 * (1448 / 3.35e12) / 1000e-9)
    td.launches["cascade"].pop()
    assert read("roofline_pct.cascade_move")(run) is None
    td.kernels = td.kernels[2:]
    assert read("cascade_launches_per_step")(run) == 0.0
    assert read("cascade_launches_per_step")(
        SimpleNamespace(trace=None)) is None


def test_dense_gate_metrics_on_a_trace():
    rec = dict(dtype="f32", mode=roofline.DENSE_ACTION, force=1, W=2, B=1,
               N=4, D=3, M=5, ip_mode=0, ib_mode=0, pot_kind=0, jas_kind=0)
    name = ("void (anonymous namespace)::pair_delta_kernel<float, 2, true, "
            "0, 0, 3>(Consts<float>, RowArgs, float const*)")
    td = trace.TraceData(steps=2, window_s=1.0,
                         kernels=[(name, 0, 1000), (name, 2000, 3000),
                                  ("void pair_rows_kernel<float, 4>", 3000,
                                   4000)],
                         launches={"pair_delta": [rec, rec]})
    run = SimpleNamespace(trace=td)
    read = manifest.metric_reader
    assert read("dense_gate_launches_per_step")(run) == 1.0
    assert read("roofline_pct.dense_gate")(run) == pytest.approx(
        100 * 2 * (220 / 3.35e12) / 2000e-9)
    td.launches["pair_delta"][1] = {**rec, "mode": roofline.DENSE_U}
    assert read("roofline_pct.dense_gate")(run) is None
    td.launches["pair_delta"].pop()
    assert read("roofline_pct.dense_gate")(run) is None
    td.kernels = td.kernels[2:]
    assert read("dense_gate_launches_per_step")(run) == 0.0
    assert read("dense_gate_launches_per_step")(
        SimpleNamespace(trace=None)) is None


def test_launch_tap_reads_a_dense_launch():
    import ctypes

    from pathintegralgroundstate_torch.ops import kernels
    seen = []
    lib = SimpleNamespace(**{f"pigs_{k}_{d}": (lambda *a: seen.append(a) or 0)
                             for k in ("pair_rows", "pair_pot", "pair_delta",
                                       "cascade")
                             for d in ("f32", "f64", "bf16")})
    p = kernels._PairParams(dim=3, pot_kind=0, jas_kind=0)
    a = kernels._RowArgs(ip_mode=0, W=1024, B=1, N=64, ib_mode=0, M=65)
    tap = trace.LaunchTap(lib)
    tap.install()
    # (params, rows, R, xnew, xold, ip, mode, with_force, ib, tab, out0,
    #  out1, stream), as ops/kernels._dense hands them over
    lib.pigs_pair_delta_f64(ctypes.byref(p), ctypes.byref(a), 0, 1, 2, None,
                            kernels._ACTION, 1, 3, 4, 5, 5, None)
    tap.uninstall()
    assert len(seen) == 1 and tap.records["pair_delta"] == [dict(
        dtype="f64", mode=roofline.DENSE_ACTION, force=1, W=1024, B=1,
        N=64, D=3, M=65, ip_mode=0, ib_mode=0, pot_kind=0, jas_kind=0)]
    assert (kernels._RAW, kernels._U, kernels._ACTION) == (
        roofline.DENSE_RAW, roofline.DENSE_U, roofline.DENSE_ACTION)


def test_launch_tap_reads_a_cascade_launch():
    import ctypes

    from pathintegralgroundstate_torch.ops import kernels
    seen = []
    lib = SimpleNamespace(**{f"pigs_{k}_{d}": (lambda *a: seen.append(a) or 0)
                             for k in ("pair_rows", "pair_pot", "pair_delta",
                                       "cascade")
                             for d in ("f32", "f64", "bf16")})
    p = kernels._PairParams(dim=3, pot_kind=0, jas_kind=0)
    a = kernels._CascadeArgs()
    for s_, (b0, d) in enumerate([(0, 1), (16, -1)]):   # ends, M = 17
        a.bead0[s_], a.dir[s_], a.ip[s_] = b0, d, 5
    orig = lib.pigs_cascade_f32
    tap = trace.LaunchTap(lib)
    tap.install()
    lib.pigs_cascade_f32(ctypes.byref(p), ctypes.byref(a), 0, 1, 2, 3, 0, 0,
                         0, 2, 1, 0, 1024, 2, 64, 8, 3, 1, 1, None)
    tap.uninstall()
    assert len(seen) == 1 and tap.records["cascade"] == [dict(
        dtype="f32", mode="ends", W=1024, S=2, N=64, D=3, L=8, nlev=3,
        beads=17, pot_kind=0, jas_kind=0)]
    assert lib.pigs_cascade_f32 is orig


def test_start_positions_are_the_seeds():
    fields = {"n_walkers": 3, "Np": 64, "dim": 3, "density": 0.365}
    a = window.start_positions(fields, 2 ** 33 + 5, 0.1, "cpu",
                               torch.float32)
    b = window.start_positions(fields, 2 ** 33 + 5, 0.1, "cpu",
                               torch.float32)
    c = window.start_positions(fields, 2 ** 33 + 6, 0.1, "cpu",
                               torch.float32)
    L = (64 / 0.365) ** (1 / 3)
    assert a.shape == (3, 64, 3) and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.abs().max() <= 0.5 * L


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "pigsbench/run.py", "--workload", "dipolar2d.w1024",
         "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"bead_updates_per_s", "peak_mem_gib",
                                    "setup_s"}
    assert list(line)[-1] == "checks"
