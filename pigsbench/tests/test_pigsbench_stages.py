"""The per-stage readings (harness/stages.py): the program's spans matched
with a synthetic trace, the two sums they must keep with the readings of
the whole block, the recorder taken once per run, a program without spans,
and a tiny traced run of the program on the CPU."""

from __future__ import annotations

import sys
import types
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import manifest, stages, trace, window  # noqa: E402

STAGE_METRICS = [m["name"] for m in manifest.manifest()["per_layer"]
                 if m["name"].startswith("stage_")
                 or m["name"] == "host_ints_per_step"]


def Span(name, parent, t0, t1, ms=None):
    return SimpleNamespace(name=name, parent=parent, t0_ns=t0, t1_ns=t1,
                           device_ms=ms)


def _spans():
    """Two steps of a block, then its read-back: block › step › the
    stages › the moves, device times on the block and the stages."""
    out = [Span("block", -1, 100, 2100, 30.0)]
    for base in (110, 1100):
        s = len(out)
        out.append(Span("step", 0, base, base + 950))
        out.append(Span("open_close", s, base + 10, base + 100, 1.0))
        out.append(Span("move.open", s + 1, base + 20, base + 60))
        out.append(Span("cm", s, base + 100, base + 300, 2.0))
        out.append(Span("move.cm", s + 3, base + 110, base + 290))
        out.append(Span("diag", s, base + 300, base + 600, 5.0))
        out.append(Span("move.bis", s + 5, base + 310, base + 590))
        out.append(Span("worm", s, base + 600, base + 800, 3.0))
        out.append(Span("measure", s, base + 800, base + 900, 2.5))
    out.append(Span("readback", -1, 2200, 2300))
    return out


def _trace():
    """Launch calls in every stage, in a move, nested in one another, in
    a step outside its stages, between steps, in the read-back and outside
    every span; device activity leaving gaps whose midpoints fall
    likewise.  The spans (_spans): step 1's stages start at 120, 210, 410,
    710 and 910, step 2's at 1110, 1200, 1400, 1700 and 1900."""
    calls = [(1, 50, 60),                       # no span
             (1, 130, 140), (1, 132, 138),      # open_close, nested: one
             (1, 250, 255), (1, 300, 310),      # cm, the first in move.cm
             (1, 450, 460), (1, 500, 510),      # diag
             (1, 1500, 1510),                   # diag of step 2
             (1, 750, 760),                     # worm
             (1, 950, 960),                     # measure
             (1, 1030, 1040),                   # step 1 after its stages
             (1, 1080, 1085),                   # block, between the steps
             (1, 2250, 2260),                   # readback
             (2, 2400, 2410)]                   # another thread, no span
    host = [("cudaLaunchKernel" if i % 2 else "cuLaunchKernel", s, e)
            for i, (_, s, e) in enumerate(calls)]
    host.append(("aten::add", 120, 1000))       # not a launch call
    kernels = [("k", 60, 130),                  # gap to 180: open_close
               ("k", 180, 400),                 # gap to 500: diag
               ("k", 500, 740),                 # gap to 780: worm
               ("k", 780, 940),                 # gap to 960: measure
               ("k", 960, 1020),                # gap to 1050: step
               ("k", 1050, 1070),               # gap to 1090: block
               ("k", 1090, 1500)]               # gap to 2240: worm, step 2
    memops = [("Memcpy DtoH", 2240, 2290)]
    return trace.TraceData(steps=2, window_s=3e-6, kernels=kernels,
                           memops=memops, host_ops=host,
                           launch_calls=trace._count_launch_calls(calls))


def test_stages_and_the_two_sums():
    td = _trace()
    sd = stages.attribute(_spans(), td, {"host_int": 12})
    assert td.launch_calls == 13
    assert dict(sd.launches) == {"(no span)": 2, "open_close": 1, "cm": 2,
                                 "diag": 3, "worm": 1, "measure": 1,
                                 "step": 1, "block": 1, "readback": 1}
    assert sum(sd.launches.values()) == td.launch_calls
    assert dict(sd.idle_ns) == {"open_close": 50, "diag": 100, "worm": 780,
                                "measure": 20, "step": 30, "block": 20}
    gaps = trace.breakdown(td)["idle_gaps"]
    assert sum(sd.idle_ns.values()) == sd.gap_ns == 1000
    assert sd.gap_ns * 1e-9 == pytest.approx(sum(v for _, v in gaps))
    assert sd.device_ms == {"block": 30.0, "open_close": 2.0, "cm": 4.0,
                            "diag": 10.0, "worm": 6.0, "measure": 5.0}
    assert sum(sd.device_ms[k] for k in stages.STAGES) <= \
        sd.device_ms["block"]
    text = stages.report(sd)
    assert "launches 6.5 against host_launches_per_step 6.5" in text
    assert "outside the four stages: launches 3.0," in text


def test_segments_take_the_innermost_span_that_is_no_move():
    assert stages.segments(_spans()[:9]) == [
        (100, "block"), (110, "step"), (120, "open_close"), (210, "cm"),
        (410, "diag"), (710, "worm"), (910, "step"), (1060, "block"),
        (2100, "(no span)")]


@pytest.fixture
def program(monkeypatch):
    """The program's recorder replaced by one that hands out the synthetic
    spans, counting its takes."""
    mod = types.ModuleType("fake_spans")
    mod.takes = 0

    def take():
        mod.takes += 1
        return _spans(), {"host_int": 680}

    mod.take = take
    monkeypatch.setitem(sys.modules, "fake_spans", mod)
    monkeypatch.setattr(stages, "SPANS", "fake_spans")
    return mod


def test_metrics_read_the_recorder_once(program, capsys):
    run = SimpleNamespace(trace=_trace())
    got = {n: manifest.metric_reader(n)(run) for n in STAGE_METRICS}
    assert len(got) == 13 and program.takes == 1
    assert got["stage_launches_per_step.diag"] == 1.5
    assert got["stage_launches_per_step.cm"] == 1.0
    assert got["stage_idle_ms_per_step.diag"] == pytest.approx(50e-6)
    assert got["stage_idle_ms_per_step.cm"] == 0.0
    assert got["stage_device_ms_per_step.worm"] == 3.0
    assert got["host_ints_per_step"] == 340.0
    assert all(isinstance(v, float) for v in got.values())
    assert capsys.readouterr().err.count("stages, per traced step") == 1


def test_a_program_without_spans_reads_none(monkeypatch):
    monkeypatch.setattr(stages, "SPANS", "no_such_package.utils.spans")
    run = SimpleNamespace(trace=_trace())
    assert all(manifest.metric_reader(n)(run) is None
               for n in STAGE_METRICS)
    assert stages.read(SimpleNamespace(trace=None)) is None


def test_a_tiny_traced_run_of_the_program():
    """One traced block of the program on the CPU: no launches and no
    device there, but the spans and the host-drawn ints (one interior
    start per particle visit and a staging start per worm half and
    round)."""
    wl = manifest.workload("he4.vpi_w4096")
    conf = manifest.config(wl["config"])
    tiny = dict(Np=8, Nb=8, Nlev=2, Lstag=4, Nstag=1, Nobdm=2)
    conf = {**conf, "fields": {**conf["fields"], **tiny}}
    wl = {**wl, "walkers": 4, "steps_per_block": 2}
    run = window.run_cell("he4.vpi_w4096", 2 ** 31 + 5, 0.0, True, "cpu",
                          workload=wl, config=conf)
    sd = stages.read(run)
    assert sd.names >= {"block", "step", "open_close", "cm", "diag", "worm",
                        "measure", "readback", "move.bis"}
    assert stages.host_ints_per_step(run) == 1 * 8 + 2 * 2
    assert stages.launches_per_step(run, "diag") == 0.0
    assert stages.device_ms_per_step(run, "diag") is None


@pytest.mark.cuda
def test_stages_of_a_traced_run_on_the_card():
    """A small traced He-4 block on the card: the program's annotations
    are neither kernels nor memops of the trace, the launches and idle
    gaps of the stages and the rest add up to the block's, and the
    stages' device time lies within the block's."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wl = manifest.workload("he4.vpi_w4096")
    wl = {**wl, "walkers": 256, "steps_per_block": 2}
    run = window.run_cell("he4.vpi_w4096", 2 ** 31 + 9, 0.0, True, "cuda",
                          workload=wl)
    td = run.trace
    assert not any(n.startswith("pigs::")
                   for n, _, _ in td.kernels + td.memops)
    sd = stages.read(run)
    assert sum(sd.launches.values()) == td.launch_calls
    assert sum(sd.idle_ns.values()) == sd.gap_ns
    assert sum(sd.device_ms[k] for k in stages.STAGES) <= \
        sd.device_ms["block"]
    assert sd.counters == {"host_int": 2 * 340}
    for name in STAGE_METRICS:
        assert isinstance(manifest.metric_reader(name)(run), float), name
