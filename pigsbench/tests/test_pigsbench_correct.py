"""The comparison that decides `correct`, driven through the rest of a run
on the CPU at a tiny size (the program's plain forms in place of its
kernels): sound runs pass each cell's limits; the control (the reference
in the next lower precision in the program's place) and each fault
planted in the timed path fail them."""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import capture, judge, manifest, window  # noqa: E402

# tiny shapes of each configuration, the same pair model and schedule
# (He-4's worm weight raised so that most walkers' worms are open, and the
# worm's moves are compared, in one block of two steps)
TINY = {"he4_n64": dict(Np=8, Nb=8, Nlev=2, Lstag=4, Nstag=1, Nobdm=2,
                        CWorm=50.0),   # fused + cascade: L = 4, K = 3
        "dipolar2d_n256": dict(Np=16)}
TINY["he4_exact_f2_n64"] = TINY["he4_n64"]
# a cell's own: the random end depths drawn from two (U{2..3}), over 128
# end moves in the window
TINY_CELL = {"he4.reforder_w1024": dict(Nlev=3, Nstag=4)}
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


def _tiny_run(cell, seed=2 ** 31 + 77, port=None):
    wl = manifest.workload(cell)
    conf = manifest.config(wl["config"])
    conf = {**conf, "fields": {**conf["fields"], **TINY[wl["config"]],
                               **TINY_CELL.get(cell, {})}}
    wl = {**wl, "walkers": 6, "steps_per_block": 2}
    run = window.run_cell(cell, seed, 0.0, False, "cpu", workload=wl,
                          config=conf, port=port)
    return run, wl["check"]["limits"]


def _verdict(run, limits, answers=None):
    answers = answers or judge.program_answers(run)
    vals, attempted, failed = judge.judge(run, answers, limits)
    return judge.correct(vals, limits), vals, failed


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    run, limits = _tiny_run(cell)
    ok, vals, failed = _verdict(run, limits)
    kinds = capture.expected_kinds(run.fields)
    assert run.blocks >= 1 and len(run.capture.moves) == run.blocks * len(
        kinds)
    assert ok and failed == 0, vals
    print(cell, vals)


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_lower_precision_fails(cell):
    run, limits = _tiny_run(cell)
    lower = judge.LOWER[run.fields["dtype"]]
    ok, vals, failed = _verdict(run, limits,
                                judge.control_answers(run, lower))
    assert not ok and failed > 0, vals


class _Faulty:
    """The program's modules with one fault planted in the timed path."""

    def __init__(self, fault):
        self.port = window.port_modules()
        self.fault = fault
        self.saved = []

    def _patch(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        p, f = self.port, self.fault
        sweeper_cls = p.sweep.Sweeper
        if f == "state_unchanged":
            self._patch(sweeper_cls, "step",
                        lambda self, state, stats, draws=None: (state, stats))
        elif f == "half_batch":
            orig = sweeper_cls._measure

            def half(self, paths, isopen, st):
                # half of the walkers measured, the sums scaled to the whole
                W = paths.shape[0]
                h = max(1, W // 2)
                out = orig(self, paths[:h], isopen[:h], st)
                return out._replace(**{
                    k: getattr(st, k) + (getattr(out, k) - getattr(st, k))
                    * (W / h) for k in ("sumE", "sumK", "sumV", "sumEt",
                                        "sumKt", "sumVt", "n_diag", "ngr",
                                        "gr", "sk")})
            self._patch(sweeper_cls, "_measure", half)
            # and every move of the CM and bisection sweeps on half of them
            for mod, fn in ((p.moves, "translate_chain"),
                            (p.bisection, "bisection"),
                            (p.bisection, "bisection_multi")):
                self._patch(mod, fn, self._half_moves(getattr(mod, fn)))
        elif f == "answer_altered":
            orig = p.kernels.pair_rows

            def altered(*a, **k):
                out = orig(*a, **k)
                return out + 0.1 * out.abs().clamp(min=1.0)
            altered.launches = orig.launches
            self._patch(p.kernels, "pair_rows", altered)
            # and the rows of the exact-F^2 cache's pass (the fold)
            fold_rows = p.pairwise._fold_rows

            def altered_fold(*a, **k):
                dS, dfield = fold_rows(*a, **k)
                return dS + 0.1 * dS.abs().clamp(min=1.0), dfield
            self._patch(p.pairwise, "_fold_rows", altered_fold)
        elif f == "bisection_skipped":
            # the sweep's interior bisections (or interior cascades) return
            # without moving
            def skipped(orig):
                @functools.wraps(orig)
                def skip(system, paths, ips, active, *a):
                    W = paths.shape[0]
                    shape = (W, len(ips)) if isinstance(ips, list) else (W,)
                    return paths, torch.zeros(shape, dtype=torch.bool)
                return skip
            for mod, fn in ((p.bisection, "bisection"),
                            (p.bisection, "bisection_multi"),
                            (p.cascade, "interior_cascade")):
                self._patch(mod, fn, skipped(getattr(mod, fn)))
        elif f == "bisection_accept_ignored":
            # every bisection's proposal written back, whatever its dS (the
            # per-level forms' accept chain ignoring every rejected level
            # and gate; the cascades' gates given uniforms of 0)
            self._patch(p.bisection, "_monoshot_accept",
                        lambda system, active, *a, **k: active)
            self._patch(p.bisection, "metropolis_u",
                        lambda u, dS: torch.ones_like(u, dtype=torch.bool))
            self._cascade(lambda orig, system, mode, paths, slots, rg, ru,
                          *a: orig(system, mode, paths, slots, rg,
                                   ru if mode == "rigid"
                                   else torch.zeros_like(ru), *a))
        elif f == "cascade_state_unchanged":
            # the cascades return their decisions and write nothing back
            self._cascade(lambda orig, system, mode, paths, *a: orig(
                system, mode, paths.clone(), *a))
        elif f == "cascade_half_batch":
            # the cascades move half of the walkers
            def half(orig, system, mode, paths, slots, rg, ru, act, *a):
                keep = torch.arange(paths.shape[0]) < max(
                    1, paths.shape[0] // 2)
                return orig(system, mode, paths, slots, rg, ru,
                            act & keep[:, None], *a)
            self._cascade(half)
        elif f == "cascade_answer_altered":
            # each position a cascade writes back, off by 1e-3
            def altered(orig, system, mode, paths, *a):
                before = paths.clone()
                acc = orig(system, mode, paths, *a)
                moved = paths != before
                paths[moved] += 1e-3
                return acc
            self._cascade(altered)
        elif f == "cascade_accept_ignored":
            # every cascade's proposal written back, whatever its gates
            self._cascade(lambda orig, system, mode, paths, slots, rg, ru,
                          *a: orig(system, mode, paths, slots, rg,
                                   torch.zeros_like(ru), *a))
        elif f.startswith("cascade_counter_altered."):
            # one too many of a cascade's counters in each step's counters
            orig = sweeper_cls.step
            i = p.sweep.COUNTER_NAMES.index(f.split(".")[1])

            def step(self, state, stats, draws=None):
                state, st = orig(self, state, stats, draws)
                ctr = st.counters.clone()
                ctr[i] += 1
                return state, st._replace(counters=ctr)
            self._patch(sweeper_cls, "step", step)
        elif f == "partial_f2":
            # the fold's dF^2 without the partners' term: the moved
            # particle's own |F|^2 change, the reference code's partial one
            fold = p.pairwise._fold

            def partial(F_n, F_o, fp_n, fp_o, fold_, notself, system=None):
                _, dfield = fold(F_n, F_o, fp_n, fp_o, fold_, notself, system)
                return (F_n * F_n).sum(-1) - (F_o * F_o).sum(-1), dfield
            self._patch(p.pairwise, "_fold", partial)
        elif f == "dg_sign_flipped":
            # each partner's field increment dg_j with the wrong sign
            fold = p.pairwise._fold
            self._patch(p.pairwise, "_fold",
                        lambda F_n, F_o, fp_n, fp_o, *a: fold(F_n, F_o, fp_o,
                                                              fp_n, *a))
        elif f == "bis_cache_write_skipped":
            # the bisections leave the cache as it was
            self._patch(p.bisection, "_cache_win_write",
                        lambda *a, **k: None)
        elif f == "dfield_for_rejected":
            # the windows' cache increments written for every walker
            for mod in (p.moves, p.bisection):
                write = mod._cache_win_write
                self._patch(mod, "_cache_win_write", functools.partial(
                    lambda write, codd, f_seg, dfield, acc, *a, **k: write(
                        codd, f_seg, dfield, torch.ones_like(acc), *a, **k),
                    write))
        elif f == "fold_not_captured":
            # the moves reach the fold around the pass's entry points
            for mod in (p.moves, p.bisection):
                for name in ("delta_action_rows", "delta_action_sum"):
                    if hasattr(mod, name):
                        self._patch(mod, name, self._around(
                            getattr(mod, name), name == "delta_action_sum"))
        elif f == "fold_rerouted":
            # not a fault: the fold's rows by another code path (on copies)
            fold_rows = p.pairwise._fold_rows

            def rerouted(system, R, xnew, xold, ip, ib, fold, *a):
                return fold_rows(system, R.clone(), xnew.clone(),
                                 xold.clone(), ip, ib.clone(), fold.clone(),
                                 *a)
            self._patch(p.pairwise, "_fold_rows", rerouted)
        elif f == "gate_dS_altered":
            # kernel 3's action rows (the per-level end gates) off by 10 %
            orig = p.kernels.pair_delta

            def altered(*a, **k):
                out = orig(*a, **k)
                if not torch.is_tensor(out):     # the raw mode's two rows
                    return out
                return out + 0.1 * out.abs().clamp(min=1.0)
            altered.launches = orig.launches
            self._patch(p.kernels, "pair_delta", altered)
        elif f == "level_rows_dropped":
            # the per-level moves' last level taken without its pass (dS 0)
            orig = p.bisection.delta_action_sum
            pairwise = p.pairwise

            def dropped(system, R, xnew, xold, ip, ib, *a, **k):
                if k.get("need_f2") is True and k.get("fold") is None:
                    return xnew.new_zeros(xnew.shape[0])
                return pairwise.delta_action_sum(system, R, xnew, xold, ip,
                                                 ib, *a, **k)
            assert orig is pairwise.delta_action_sum
            self._patch(p.bisection, "delta_action_sum", dropped)
        elif f == "end_depth_misreported":
            # the per-level end moves run one level deeper than the depth
            # they were handed (and recorded): the gaussians and uniforms
            # of the extra level 0 (a uniform of 0 always passes)
            orig = p.bisection._end_bisection_per_level

            def deeper(system, paths, ip, active, nlev, tail, rand, *a):
                _, g, u = rand
                n = 2 ** (nlev + 1)
                g = torch.cat([g, g.new_zeros((g.shape[0], n - g.shape[1],
                                               g.shape[2]))], 1)
                u = torch.cat([u, u.new_zeros((u.shape[0], 1))], 1)
                return orig(system, paths, ip, active, nlev + 1, tail,
                            (None, g, u), *a)
            self._patch(p.bisection, "_end_bisection_per_level", deeper)
        elif f == "end_depth_fixed":
            # the sweep hands every end move depth 2, whatever it drew
            draws = sys.modules[p.sweep.DeviceDraws.__module__]
            orig = draws.DeviceDraws.end_bisect

            def fixed(self, tag, it, W, level, *a):
                orig(self, tag, it, W, level, *a)
                return 2, self.bisect(tag, it, W, 2)
            self._patch(draws.DeviceDraws, "end_bisect", fixed)
        elif f == "windows_at_walker0":
            # the per-walker windows written back at walker 0's start
            write = p.bisection._win_write

            def at0(paths, lo, ip, seg):
                if torch.is_tensor(lo):
                    lo = lo[:1].expand_as(lo)
                return write(paths, lo, ip, seg)
            self._patch(p.bisection, "_win_write", at0)
        elif f == "worm_answer_altered":
            orig = p.moves.translate_half_chain

            @functools.wraps(orig)
            def worm(*a, **k):
                paths, xend, acc = orig(*a, **k)
                return paths, xend + 0.01, acc
            self._patch(p.moves, "translate_half_chain", worm)
        elif f == "counter_altered":
            # one CM acceptance too many in each step's counters
            orig = sweeper_cls.step
            i = p.sweep.COUNTER_NAMES.index("acc_cm")

            def step(self, state, stats, draws=None):
                state, st = orig(self, state, stats, draws)
                ctr = st.counters.clone()
                ctr[i] += 1
                return state, st._replace(counters=ctr)
            self._patch(sweeper_cls, "step", step)
        elif f == "estimator_altered":
            orig = p.sweep.est.therm_energy

            def therm(system, paths):
                E, K, Ep = orig(system, paths)
                return E * 1.01, K, Ep
            self._patch(p.sweep.est, "therm_energy", therm)
        return self.port

    def _cascade(self, fault):
        """Every cascade (ops.cascade._dispatch: kernel 5's ends and
        interior through kernels.cascade, the rigid one's plain form) as
        fault(orig, *args)."""
        orig = self.port.cascade._dispatch
        self._patch(self.port.cascade, "_dispatch",
                    functools.wraps(orig)(lambda *a: fault(orig, *a)))

    def _around(self, orig, summed):
        """orig, with the calls that carry the cache's rows made straight
        to the fold (pairwise._fold_rows), past the pass's entry points."""
        fold_rows = self.port.pairwise._fold_rows

        def around(system, R, xnew, xold, ip, ib, need_wf=True, *a, **k):
            names = (("row_weights", "rev", "need_f2", "fold", "fold_sub")
                     if summed else ("need_f2", "rev", "fold", "fold_sub"))
            kw = {"row_weights": None, "rev": False, "fold": None,
                  "fold_sub": (0, 1), **dict(zip(names, a)), **k}
            if kw["fold"] is None:
                return orig(system, R, xnew, xold, ip, ib, need_wf, *a, **k)
            if kw["rev"]:
                R = R.flip(1)
            dS, dfield = fold_rows(system, R, xnew, xold, ip, ib, kw["fold"],
                                   kw["fold_sub"], need_wf)
            if not summed:
                return dS, dfield
            if kw["row_weights"] is not None:
                dS = dS * kw["row_weights"]
            return dS.sum(-1), dfield
        return around

    @staticmethod
    def _half_moves(orig):
        @functools.wraps(orig)
        def half(system, paths, ip, active, *a):
            keep = torch.arange(paths.shape[0]) < max(1, paths.shape[0] // 2)
            if active.dim() == 2:
                keep = keep[:, None]
            return orig(system, paths, ip, active & keep, *a)
        return half

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)


FAULTS = ["state_unchanged", "half_batch", "answer_altered",
          "estimator_altered", "bisection_skipped", "counter_altered"]


# two faults in the cells whose configuration runs the worm (He-4): an
# altered worm move, and bisections accepted whatever their dS, which
# changes nothing where every proposal is accepted, as the dipolar gas's
# are at dt = 1e-3
WORM_CELLS = [c for c in CELLS if manifest.config(
    manifest.workload(c)["config"])["fields"]["CWorm"] > 0.0]
WORM_FAULTS = ["bisection_accept_ignored", "worm_answer_altered"]


# the cells whose moves run as whole-move cascades, and each fault of the
# cascade route with the number that has to catch it
CASCADE_CELLS = [c for c in CELLS
                 if manifest.workload(c).get("overrides", {}).get("cascade")]
CASCADE_FAULTS = {
    "cascade_state_unchanged": "cascade_state_gap",
    "cascade_half_batch": "cascade_flip_gap",
    "cascade_answer_altered": "cascade_state_gap",
    "cascade_accept_ignored": "cascade_flip_gap",
    **{f"cascade_counter_altered.{n}": "count_gap"
       for n in ("acc_cm", "acc_head", "acc_tail", "acc_bd", "try_int")},
}


# the cells whose configuration carries the exact-F^2 cache, and each
# fault of the cache's path with the number that has to catch it
CACHE_CELLS = [c for c in CELLS if judge.carries_cache(window.sim_fields(
    manifest.workload(c), manifest.config(manifest.workload(c)["config"])))]
CACHE_FAULTS = {
    "partial_f2": "bis_dS_gap",
    "bis_cache_write_skipped": "fcache_gap",
    "dfield_for_rejected": "fcache_gap",
    "dg_sign_flipped": "dfield_gap",
    "fold_not_captured": "missing",
}


# the cells whose bisections run level by level (kernel 3's end gates) and
# those whose windows start per walker, and each fault of those paths with
# the number that has to catch it
LEVEL_CELLS = [c for c in CELLS if manifest.workload(c).get(
    "overrides", {}).get("bis_monoshot") is False]
LEVEL_FAULTS = {
    "gate_dS_altered": "gate_dS_gap",
    "level_rows_dropped": "missing",
    "bisection_accept_ignored": "bis_state_gap",
    "end_depth_misreported": "missing",
}
PERWALKER_CELLS = [c for c in CELLS if manifest.workload(c).get(
    "overrides", {}).get("shared_windows") is False]
PERWALKER_FAULTS = {"windows_at_walker0": "bis_state_gap"}
# the cells whose sweep draws the end moves' depths
DEPTH_CELLS = [c for c in CELLS if manifest.workload(c).get(
    "overrides", {}).get("bis_end_random_depth")]
DEPTH_FAULTS = {"end_depth_fixed": "depth_gap"}
NAMED = ([(c, f) for f in LEVEL_FAULTS for c in LEVEL_CELLS
          if f not in WORM_FAULTS]
         + [(c, f) for f in PERWALKER_FAULTS for c in PERWALKER_CELLS]
         + [(c, f) for f in DEPTH_FAULTS for c in DEPTH_CELLS])


@pytest.mark.parametrize("cell, fault", [(c, f) for f in FAULTS for c in CELLS]
                         + [(c, f) for f in WORM_FAULTS for c in WORM_CELLS]
                         + [(c, f) for f in CASCADE_FAULTS
                            for c in CASCADE_CELLS]
                         + [(c, f) for f in CACHE_FAULTS
                            for c in CACHE_CELLS] + NAMED)
def test_fault_in_the_timed_path_is_not_correct(cell, fault):
    with _Faulty(fault) as port:
        run, limits = _tiny_run(cell, port=port)
        ok, vals, failed = _verdict(run, limits)
    assert not ok and failed > 0, (fault, vals)
    number = (CASCADE_FAULTS.get(fault) or CACHE_FAULTS.get(fault)
              or (LEVEL_FAULTS.get(fault) if cell in LEVEL_CELLS else None)
              or (PERWALKER_FAULTS.get(fault) if cell in PERWALKER_CELLS
                  else None)
              or (DEPTH_FAULTS.get(fault) if cell in DEPTH_CELLS else None))
    assert number is None or vals[number] > limits[number], (fault, vals)


# each fault that control.py plants in the float64 reference put in the
# program's place, with the number that has to catch it
REFERENCE_FAULTS = {"partial_f2": "bis_dS_gap", "dg_flipped": "dfield_gap",
                    "bis_cache_skipped": "fcache_gap",
                    "gate_altered": "gate_dS_gap",
                    "level_accept_ignored": "bis_state_gap",
                    "end_depth_fixed": "depth_gap",
                    "windows_at_walker0": "bis_state_gap"}


def _fields(cell):
    wl = manifest.workload(cell)
    return window.sim_fields(wl, manifest.config(wl["config"]))


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in CELLS for f in judge.faults(_fields(c))])
def test_fault_planted_in_the_reference_is_not_correct(cell, fault):
    # control.py reads these on the card (the float64 reference in the
    # program's place, with the fault): each fails its own number
    number = REFERENCE_FAULTS[fault]
    run, limits = _tiny_run(cell)
    ok, vals, failed = _verdict(run, limits, judge.control_answers(
        run, torch.float64, fault=fault))
    assert not ok and vals[number] > limits[number], vals


@pytest.mark.parametrize("cell", CACHE_CELLS)
def test_the_fold_read_on_another_route_is_correct(cell):
    # the same rows and increments by another code path beneath the pass's
    # entry points are still read there, and judged correct
    with _Faulty("fold_rerouted") as port:
        run, limits = _tiny_run(cell, port=port)
        ok, vals, failed = _verdict(run, limits)
    assert ok and failed == 0, vals
    assert all(any("dfield" in p for p in rec["passes"])
               for rec in run.capture.moves), vals
    assert run.capture.last["fcache"] is not None
