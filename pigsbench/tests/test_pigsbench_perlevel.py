"""The reference's per-level bisections and per-walker windows
(reference/moves.py, through the capture and the judge) against the
program's plain forms, both in float64 at a small size on the CPU: the
per-level head and tail moves at every end depth 2..Nlev, their gate
through the dense delta_action (kernel 3's plain form with kernel 4's u)
and through delta_action_sum, the per-level interior move with a shared
and with per-walker window starts, and the monoshot interior move with
per-walker starts, at D = 1, 2, 3.  Each captured move is judged as a
window move is: its passes matched to the reference's accept groups by
bead, the gaps at float64 rounding, every decision the reference's."""

from __future__ import annotations

import sys
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import capture, judge, manifest, window  # noqa: E402
from pigsbench.reference import moves as ref_mv  # noqa: E402
from pigsbench.reference.physics import geometry, wrap  # noqa: E402

W, N, NB, NLEV = 16, 8, 16, 4
M = 2 * NB + 1
SEED = 2 ** 31 + 9173
# float64 on both sides: the gaps are rounding
TOL = 1e-10
# a time step per dimension at which the moves both accept and reject
DT = {1: 0.5, 2: 0.02, 3: 0.005}


def _fields(D, **over):
    wl = manifest.workload("he4.reforder_w1024")
    conf = manifest.config(wl["config"])
    fields = {**window.sim_fields({**wl, "walkers": W}, conf), "Np": N,
              "Nb": NB, "Nlev": NLEV, "dim": D, "dtype": "float64",
              "dt": DT[D], "Lstag": 8}
    return {**fields, **over}


@pytest.fixture(scope="module", params=[1, 2, 3])
def setup(request):
    D = request.param
    port = window.port_modules()
    fields = _fields(D)
    gen = torch.Generator().manual_seed(SEED + D)
    start = window.start_positions(fields, SEED + D, 0.1, "cpu",
                                   torch.float64)
    paths = start[:, None].expand(W, M, N, D) + 0.1 * torch.randn(
        (W, M, N, D), generator=gen, dtype=torch.float64)
    paths = wrap(paths, geometry(fields).L).contiguous()
    return port, D, paths


def _gen(*case):
    """A generator of the test case's own (the same draws in any order of
    the tests)."""
    return torch.Generator().manual_seed(SEED + zlib.crc32(
        repr(case).encode()))


def _captured(port, fields, kind, call):
    """The judged record of one call of the move `kind`, made by call()
    under the benchmark's capture, all walkers sampled."""
    system = port.system.make_system(port.config.SimConfig(**fields), "cpu")
    sweeper = port.sweep.Sweeper(system)
    cap = capture.Capture(port, sweeper, W, np.random.default_rng(SEED),
                          "cpu")
    cap.install()
    try:
        cap.on, cap.blocks, cap.calls, cap.target = True, 1, {}, {kind: 0}
        out = call(system)
    finally:
        cap.uninstall()
    assert len(cap.moves) == 1
    rec = cap.moves[0]
    run = SimpleNamespace(fields=fields)
    return out, rec, judge._judge_move(
        run, {**rec, "rows": judge._slot_rows(rec)}, geometry(fields),
        torch.device("cpu"))


def _randoms(gen, depth, D, start=None):
    g = torch.randn((W, 2 ** depth, D), generator=gen, dtype=torch.float64)
    u = torch.rand((W, depth + 1), generator=gen, dtype=torch.float64)
    return start, g, u


def _active(gen):
    return torch.rand(W, generator=gen) < 0.9


def _check(out, rec, judged, gate, active):
    assert judged is not None, "the move's passes were not matched"
    fam, gap, dist, dfgap, ggap = judged
    assert fam == "bis" and dfgap is None
    assert float(gap.max()) <= TOL, gap
    assert float(dist.max()) <= 1e-12, dist
    if gate:
        assert ggap is not None and float(ggap.max()) <= TOL, ggap
    else:
        assert ggap is None
    acc = out[1]
    assert torch.equal(acc, rec["accept"][0])
    # an accepted walker and an active one rejected, so that the accept
    # chain is held on both sides
    assert acc.any() and (active & ~acc).any(), acc


@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("depth", range(2, NLEV + 1))
def test_per_level_end_move(setup, depth, tail, dense):
    port, D, paths = setup
    gen = _gen(D, depth, tail, dense)
    fields = _fields(D)
    ip, active = 5, _active(gen)
    rand = _randoms(gen, depth, D)
    kind = "bis_tail" if tail else "bis_head"
    # the move as the sweep calls it, through its module: the tapped one
    name = "move_tail_bisection" if tail else "move_head_bisection"
    out, rec, judged = _captured(
        port, fields, kind, lambda system: getattr(port.bisection, name)(
            system, paths.clone(), ip, active, depth, rand, dense))
    # the gate, then one pass per level, the gate's the dense one
    assert [p["entry"] for p in rec["passes"]] == [
        "delta_action" if dense else "delta_action_sum"] + [
        "delta_action_sum"] * depth
    assert rec["args"]["level"] == depth
    _check(out, rec, judged, True, active)


@pytest.mark.parametrize("monoshot, shared", [(False, True), (False, False),
                                              (True, False)])
def test_interior_move(setup, monoshot, shared):
    port, D, paths = setup
    gen = _gen(D, monoshot, shared)
    fields = _fields(D, bis_monoshot=monoshot, shared_windows=shared)
    n_opts = (M - 1 - 2 ** NLEV) // 2 + 1
    start = 2 * (4 if shared else torch.randint(
        0, n_opts, (W,), generator=gen))
    rand = _randoms(gen, NLEV, D, start)
    ip, active = 3, _active(gen)
    out, rec, judged = _captured(
        port, fields, "bis", lambda system: port.bisection.bisection(
            system, paths.clone(), ip, active, NLEV, rand))
    assert len(rec["passes"]) == (1 if monoshot else NLEV)
    if not shared:    # each walker's own window, read through its own ib
        assert all(p["ib"].shape[0] == W for p in rec["passes"])
        assert len(set(start.tolist())) > 1
    _check(out, rec, judged, False, active)
    # the write-back itself: the reference's window of each walker
    slots = ref_mv.move(fields, "bis", paths, rec["args"])
    expect, _ = ref_mv.apply(slots, paths, None, [rec["accept"][0]])
    torch.testing.assert_close(out[0], expect, rtol=0, atol=1e-12)


@pytest.mark.parametrize("depths, nlev, gap", [
    ({2: 10, 3: 10, 4: 10}, 4, 0.0),
    ({2: 30}, 4, 2.0),              # every end move handed depth 2
    ({2: 12, 3: 9, 4: 9}, 4, 0.2),
    ({2: 7, 3: 3}, 3, 0.4),
    ({2: 5, 5: 1}, 2, 1 / 6),       # a depth not due counts against 0
])
def test_depth_gap_hand_worked(depths, nlev, gap):
    assert judge._depth_gap(depths, nlev) == pytest.approx(gap, abs=1e-15)
