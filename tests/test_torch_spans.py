"""The program's spans and counters (utils/spans.py): nothing recorded
without a profiler, the nesting block › step › stages › moves with the
schedule's count of every move, the annotations on the recorder's clock,
the host-drawn ints of the He-4 flagship and the dipolar gas, and steps
bitwise equal with and without the profiler.  The last test needs a CUDA
device; the file imports no JAX, so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pathintegralgroundstate_torch import sweep
from pathintegralgroundstate_torch.config import SimConfig
from pathintegralgroundstate_torch.flagship import dipolar_cfg, flagship_cfg
from pathintegralgroundstate_torch.state import init_state
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils import spans

torch.set_num_threads(1)

STAGES = ["open_close", "cm", "diag", "worm", "measure"]
TINY = dict(dim=3, Np=8, density=0.365, dt=5e-3, Nb=8, sampling="bis",
            Lstag=4, Nlev=2, Nstag=1, CMFreq=1, delta_cm=0.12, Rm=1.2,
            swapping=True, CWorm=0.5, Nobdm=2, n_walkers=4,
            dtype="float64", potential="aziz2", jastrow="mcmillan_c1",
            fused_sweep=False)
FORMS = {"unfused": {}, "fused": dict(fused_sweep=True),
         "cascade": dict(fused_sweep=True, cascade=True),
         "staging": dict(sampling="sta")}


def _setup(cfg, seed=7):
    system = make_system(cfg, "cpu")
    return sweep.Sweeper(system), init_state(system, seed)


def _block(sw, st, nstep):
    """The benchmark's window block: run_block and its read-back."""
    st, stats = sweep.run_block(sw, st, nstep)
    return st, sweep.stats_to_numpy(stats)


def _traced(sw, st, nstep):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st, stats = _block(sw, st, nstep)
    recorded, counts = spans.take()
    return st, stats, recorded, counts, prof


def _schedule(cfg, sw) -> dict:
    """Move spans of each kind per step, from the step's schedule."""
    visits = cfg.Nstag * cfg.Np
    groups = cfg.Nstag * -(-cfg.Np // sw.K_int)
    rounds = cfg.Nobdm
    casc = cfg.cascade
    out = {"move.cm_cascade" if casc else "move.cm": cfg.Np,
           "move.open": 1, "move.close": 1,
           "move.worm_cm": 2 * rounds, "move.head_half": 2 * rounds,
           "move.tail_half": 2 * rounds, "move.sta_half": 2 * rounds,
           "move.swap": rounds, "move.obdm": rounds}
    if cfg.sampling == "sta":
        out.update({"move.sta_head": visits, "move.sta_tail": visits,
                    "move.sta": visits})
    elif sw.fused_diag:
        out.update({"move.cascade_ends" if casc else "move.bis_ends": visits,
                    "move.cascade_int" if casc else "move.bis_multi": groups})
    else:
        out.update({"move.bis_head": visits, "move.bis_tail": visits,
                    "move.bis": visits})
    return out


def _host_ints(cfg, sw) -> int:
    """Ints drawn on the host per step with shared windows and fixed end
    depths: an interior start per particle visit (unfused), or an offset
    and a shift per interior group (fused); a staging start per worm half
    and round."""
    if sw.fused_diag:
        n = 2 * cfg.Nstag * -(-cfg.Np // sw.K_int)
    else:
        n = cfg.Nstag * cfg.Np
    return n + (2 * cfg.Nobdm if cfg.CWorm > 0 and cfg.Nobdm > 0 else 0)


def test_nothing_is_recorded_without_a_profiler():
    sw, st = _setup(SimConfig(**TINY))
    _block(sw, st, 1)
    assert spans.take() == ([], {})
    assert spans.span("cm") is spans.span("diag", device=True)
    with spans.span("cm") as s:
        spans.count("host_int")
    assert s is None and spans.take() == ([], {})


@pytest.mark.parametrize("form", sorted(FORMS))
def test_spans_nest_as_the_step_runs(form):
    cfg = SimConfig(**{**TINY, **FORMS[form]})
    sw, st = _setup(cfg)
    nstep = 2
    _, _, recorded, _, _ = _traced(sw, st, nstep)
    kids = {i: [] for i in range(-1, len(recorded))}
    for i, s in enumerate(recorded):
        kids[s.parent].append(i)
        assert s.t0_ns <= s.t1_ns
        if s.parent >= 0:
            p = recorded[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    top = [recorded[i].name for i in kids[-1]]
    assert top == ["block", "readback"]
    steps = kids[kids[-1][0]]
    assert [recorded[i].name for i in steps] == ["step"] * nstep
    want = _schedule(cfg, sw)
    for i in steps:
        stage_ids = kids[i]
        assert [recorded[j].name for j in stage_ids] == STAGES
        got = {}
        for j in stage_ids:
            for m in kids[j]:
                name = recorded[m].name
                assert name.startswith("move.") and not kids[m]
                got[name] = got.get(name, 0) + 1
        assert got == want
    assert all(s.device_ms is None for s in recorded)


def test_annotations_start_at_the_recorders_stamps():
    sw, st = _setup(SimConfig(**TINY))
    _block(sw, st, 1)
    _, _, recorded, _, prof = _traced(sw, st, 2)
    ev = sorted((e for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("pigs::")),
                key=lambda e: (e.start_ns(), -e.duration_ns()))
    assert [e.name() for e in ev] == ["pigs::" + s.name for s in recorded]
    for e, s in zip(ev, recorded):
        assert abs(e.start_ns() - s.t0_ns) < 1_000_000, s.name
        assert abs(e.start_ns() + e.duration_ns() - s.t1_ns) < 1_000_000


@pytest.mark.parametrize("cfg,want", [(flagship_cfg(2), 340),
                                      (dipolar_cfg(2), 172)],
                         ids=["he4", "dipolar"])
def test_host_int_counter_follows_the_schedule(cfg, want):
    sw, st = _setup(cfg)
    counts = _traced(sw, st, 1)[3]
    assert _host_ints(cfg, sw) == want
    assert counts == {"host_int": want}


@pytest.mark.parametrize("form", ["unfused", "fused"])
def test_steps_are_bitwise_equal_under_the_profiler(form):
    cfg = SimConfig(**{**TINY, **FORMS[form]})
    sw, a = _setup(cfg, seed=11)
    _, b = _setup(cfg, seed=11)
    a, sa = _block(sw, a, 2)
    b, sb, recorded, counts, _ = _traced(sw, b, 2)
    assert recorded and counts["host_int"] == 2 * _host_ints(cfg, sw)
    for k in sa:
        assert np.array_equal(sa[k], sb[k], equal_nan=True), k
    for k in ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert torch.equal(a.host_gen.get_state(), b.host_gen.get_state())


def _span_holds_its_kernel():
    x = torch.ones(1 << 24, device="cuda")
    y = x * 2.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.span("one", device=True):
            y = torch.mul(x, 3.0, out=y)
            torch.cuda.synchronize()
    (s,), _ = spans.take()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith("CUDA")
               and "elementwise" in e.name()]
    assert len(kernels) == 1, [e.name() for e in kernels]
    k0 = kernels[0].start_ns()
    k1 = k0 + kernels[0].duration_ns()
    assert s.t0_ns - 20_000 <= k0 and k1 <= s.t1_ns + 20_000
    assert 0.0 < s.device_ms <= (s.t1_ns - s.t0_ns) * 1e-6


@pytest.mark.cuda
def test_device_span_holds_its_kernel_on_the_trace():
    """A device span around one kernel launch and a synchronisation holds
    that kernel's interval on the profiler's trace (within 20 us at
    either end), and its events' time is no longer than its host span.
    It runs in a process of its own: once a profiler session has ended
    and more kernels have run, a later session in the same process
    records no device activity at all (seen on the card after
    tests/test_torch_cuda.py::test_dense_delta_action_is_one_launch and
    the card tests after it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here]))
    out = subprocess.run(
        [sys.executable, "-c",
         "import test_torch_spans as t; t._span_holds_its_kernel()"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
