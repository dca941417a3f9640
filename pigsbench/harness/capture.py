"""What the timed window produced, kept for the comparison after it.

Pass-through taps on the program's move functions, its step and its OBDM
terms, installed for set-up and window alike:

  moves      per window block, one call of each kind of move that the
             configuration runs (`expected_kinds`; which call of the block
             is drawn from the seed, among as many as the warm-up block
             made): for a sample of walkers drawn from the seed, the
             positions (and the worm's open ends) before the call, its
             arguments (particle, active mask, depth, uniforms and
             gaussians), every output of the window pair pass
             (`ops.kernels.pair_rows`, kernel A) inside the call, the
             decisions it returned and the positions after it, and every
             pair pass that the call makes, in order (`passes`), read
             where every route enters the pass: `ops.pairwise.
             delta_action_rows`, `delta_action_sum` and the dense
             `delta_action` (the per-level end gate's, kernel 3 with
             kernel 4's u), under whatever name a module of the program
             binds them, a pass nested inside one being read not read
             again: its rows or their sum and its bead indices (per
             walker where they are [W, B]); under exact F^2 with the
             cache, where the call carries the cache's rows (`fold`),
             also its field increments `dfield` and its `fold_sub`.  The
             depth an end move was handed, the random end depth that the
             sweep drew as a host int, is among its arguments.  Copied to
             host memory (pinned on the card) as the window runs.  The
             whole-move cascades (`ops.cascade`: the rigid one, whose pair
             pass is kernel A, the ends and the interior, kernel 5) are
             kinds of their own; kernel 5 exposes no rows, so only its
             arguments, decisions and write-back are kept.
  depths     with random end depths (`random_depth`), the depth handed to
             every end move of the window, counted by depth.
  last step  the last step of each block (the window's last step is kept):
             the statistics before and after it, the open masks and
             permutation counts before and after it, the open ends that
             each OBDM round histogrammed, the sums of the decisions
             that every tapped move returned in that step, and under
             exact F^2 the force-field cache (`fodd`) that the step's
             tapped moves were handed, as it stands after the step.

A call that is not captured costs a Python call and a comparison; in a
block's last step, also the sums of its decisions."""

from __future__ import annotations

import inspect
import sys

import numpy as np
import torch

# walkers compared per captured move
SAMPLE_WALKERS = 128

# kind: (module of the program, function); the kinds before "head_half"
# are captured and held against reference/moves.py, all are counted
TAPS = {
    "cm": ("moves", "translate_chain"),
    "worm_cm": ("moves", "translate_half_chain"),
    "bis": ("bisection", "bisection"),
    "bis_head": ("bisection", "move_head_bisection"),
    "bis_tail": ("bisection", "move_tail_bisection"),
    "bis_ends": ("bisection", "fused_end_bisections"),
    "bis_multi": ("bisection", "bisection_multi"),
    "cm_cascade": ("cascade", "rigid_cascade"),
    "cascade_ends": ("cascade", "fused_ends_cascade"),
    "cascade_int": ("cascade", "interior_cascade"),
    "head_half": ("moves", "move_head_half_chain"),
    "tail_half": ("moves", "move_tail_half_chain"),
    "sta_half": ("moves", "staging_half_chain"),
    "swap": ("worm", "swap_move"),
}
CAPTURED = ("cm", "worm_cm", "bis", "bis_head", "bis_tail", "bis_ends",
            "bis_multi", "cm_cascade", "cascade_ends", "cascade_int")
# the step's acceptance counters each kind's outputs add to:
# (counter, index of the decision in the call's outputs)
COUNTS = {
    "cm": [("acc_cm", 1)], "worm_cm": [("acc_cm_half", 2)],
    "bis": [("acc_bd", 1)], "bis_head": [("acc_head", 1)],
    "bis_tail": [("acc_tail", 1)],
    "bis_ends": [("acc_head", 1), ("acc_tail", 2)],
    "bis_multi": [("acc_bd", 1)], "cm_cascade": [("acc_cm", 1)],
    "cascade_ends": [("acc_head", 1), ("acc_tail", 2)],
    "cascade_int": [("acc_bd", 1)],
    "head_half": [("acc_head_half", 2)], "tail_half": [("acc_tail_half", 2)],
    "sta_half": [("acc_bd_half", 2)], "swap": [("acc_swap", 2)],
}
_SKIP = ("system", "paths", "xend", "fodd")
# the pair pass's entry points (ops.pairwise): every pass of a captured
# call is read there
PASSES = ("delta_action_rows", "delta_action_sum", "delta_action")
# the end moves, whose depth the sweep draws with random end depths
ENDS = ("bis_head", "bis_tail")


def expected_kinds(f: dict) -> list:
    """The captured kinds of move that a step of configuration fields f
    runs (the sweep's schedule, sweep.Sweeper.step): with `cascade` and
    the F^2 cache off, the CM move and the fused sweep's composites are
    cascades."""
    cache = f["exact_f2"] and f["f2_cache"]
    cascade = f["cascade"] and not cache
    kinds = []
    if f["CMFreq"] > 0:
        kinds.append("cm_cascade" if cascade else "cm")
    if f["Nstag"] > 0 and f["sampling"] == "bis":
        L, M = 2 ** f["Nlev"], 2 * f["Nb"] + 1
        if (f["fused_sweep"] and not f["bis_end_random_depth"]
                and 2 * L < M - 1):
            if f["end_regrow"] != "sta":
                kinds.append("cascade_ends" if cascade else "bis_ends")
            kinds.append("cascade_int" if cascade else "bis_multi")
        else:
            paired = (f["paired_ends"] and f["bis_monoshot"] and not cache
                      and 2 ** (max(f["Nlev"], 2) + 1) < M - 1)
            if not paired:
                kinds += ["bis_head", "bis_tail"]
            kinds.append("bis")
    if f["CWorm"] > 0.0 and f["Nobdm"] > 0:
        kinds.append("worm_cm")
    return kinds


def random_depth(f: dict) -> bool:
    """Whether the sweep draws each end move's depth, U{2..Nlev} (the
    reference's random end depth; the paired and fused ends keep theirs)."""
    return bool(f["bis_end_random_depth"]) and "bis_head" in expected_kinds(f)


def _host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """An asynchronous copy of t into fresh host memory (pinned on the
    card, so the copy is stream-ordered and does not wait)."""
    if not pinned:
        return t.detach().cpu().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


class Capture:
    """The taps of one run.  `rng` is the run's numpy generator (from the
    seed); SAMPLE_WALKERS walkers are compared per captured move."""

    def __init__(self, port, sweeper, walkers: int, rng, device):
        self.port = port
        self.sweeper = sweeper
        self.rng = rng
        self.W = walkers
        self.pinned = torch.device(device).type == "cuda"
        n = min(walkers, SAMPLE_WALKERS)
        idx = np.sort(rng.choice(walkers, size=n, replace=False))
        self.sample = torch.as_tensor(idx, dtype=torch.long, device=device)
        self.moves = []           # the captured calls
        self.blocks = 0           # window blocks begun
        self.warm = {}            # calls per kind in the warm-up block
        self.calls = {}
        self.target = {}
        self.nsteps = 0
        self.k = 0
        self.on = False
        self.counting = False
        self.acc = {}
        self.obdm = []
        self.last = None          # the window's last step
        self.rows = None          # kernel A's outputs inside a captured call
        self.passes = None        # every pass inside a captured call
        self.nested = False       # inside a pass being read
        # the window's end moves by the depth handed to them
        self.depths = {} if random_depth(vars(sweeper.system.cfg)) else None
        self.fodd = None          # the cache handed to the last step's moves
        self._saved = []

    def _get(self, v):
        """v's sampled walkers on the host (tensors over the walkers),
        recursively through tuples; anything else as it is."""
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == self.W:
            return _host(v.index_select(0, self.sample), self.pinned)
        if isinstance(v, tuple):
            return tuple(self._get(x) for x in v)
        return v

    # -- the taps -----------------------------------------------------------

    def _tap(self, kind, orig):
        sig = inspect.signature(orig)

        def tapped(*a, **k):
            n = self.calls.get(kind, 0)
            self.calls[kind] = n + 1
            rec = args = None
            tally = self.on and self.depths is not None and kind in ENDS
            if (self.counting or tally
                    or (self.on and self.target.get(kind) == n)):
                bound = sig.bind(*a, **k)
                bound.apply_defaults()
                args = bound.arguments
            if tally:
                lv = int(args["level"])
                self.depths[lv] = self.depths.get(lv, 0) + 1
            if self.on and self.target.get(kind) == n:
                rec = {"kind": kind, "block": self.blocks,
                       "before": self._get(args["paths"]),
                       "xend": self._get(args.get("xend")),
                       "args": {k_: self._get(v) for k_, v in args.items()
                                if k_ not in _SKIP}}
                self.rows, self.passes = [], []
            if self.counting and args.get("fodd") is not None:
                self.fodd = args["fodd"]
            try:
                out = orig(*a, **k)
            finally:
                rows, self.rows = self.rows, None
                passes, self.passes = self.passes, None
            if rec is not None:
                rec["rows"] = [self._get(r) for r in rows]
                rec["passes"] = passes
                rec["after"] = self._get(out[0])
                rec["xend_after"] = (self._get(out[1]) if kind == "worm_cm"
                                     else None)
                acc = [self._get(out[i]) for _, i in COUNTS[kind]]
                rec["accept"] = list(acc[0].unbind(1)) if acc[0].dim() == 2 \
                    else acc
                self.moves.append(rec)
            if self.counting:
                for name, i in COUNTS[kind]:
                    self._add(name, out[i].sum())
                if kind in ("bis_multi", "cascade_int"):
                    act = args["active"]
                    self._add("try_int", act.sum() * (
                        len(args["ips"]) if act.dim() == 1 else 1))
            return out
        return tapped

    def _add(self, name, x):
        self.acc[name] = self.acc[name] + x if name in self.acc else x

    def _rows_tap(self, orig):
        def rows(*a, **k):
            out = orig(*a, **k)
            if self.rows is not None:
                self.rows.append(out)
            return out
        # the program counts its launches on the attribute of the function
        # its module's name holds: the tap carries the count meanwhile
        rows.launches = orig.launches
        return rows

    def _entry_tap(self, name, orig):
        sig = inspect.signature(orig)

        def entry(*a, **k):
            if self.passes is None or self.nested:
                return orig(*a, **k)
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            args = bound.arguments
            fold = args.get("fold") is not None
            self.nested = True
            try:
                out = orig(*a, **k)
            finally:
                self.nested = False
            ib = args["ib"]
            rec = {"entry": name, "dS": self._get(out[0] if fold else out),
                   "ib": self._get(ib) if ib.dim() == 2
                   else _host(ib, self.pinned)}
            if fold:
                rec["dfield"] = self._get(out[1])
                rec["sub"] = tuple(args["fold_sub"])
            self.passes.append(rec)
            return out
        return entry

    def _obdm_tap(self, orig):
        def obdm(system, xend):
            if self.counting:
                self.obdm.append(xend.clone())
            return orig(system, xend)
        return obdm

    def _step_tap(self, orig):
        def step(state, stats, draws=None):
            last = self.on and self.k == self.nsteps - 1
            self.k += 1
            if last:
                self.counting, self.acc, self.obdm = True, {}, []
                self.fodd = None
            try:
                out = orig(state, stats, draws)
            finally:
                self.counting = False
            fodd, self.fodd = self.fodd, None
            if last:
                self.last = {"stats_in": stats, "stats_out": out[1],
                             "isopen_in": state.isopen,
                             "iperm_in": state.iperm,
                             "isopen_out": out[0].isopen,
                             "step": out[0].step, "acc": self.acc,
                             "obdm": self.obdm,
                             "fcache": None if fodd is None
                             else self._get(fodd)}
            return out
        return step

    # -- lifetime -----------------------------------------------------------

    def _patch(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def install(self):
        p = self.port
        for kind, (mod, fn) in TAPS.items():
            obj = getattr(p, mod)
            self._patch(obj, fn, self._tap(kind, getattr(obj, fn)))
        self._patch(p.kernels, "pair_rows", self._rows_tap(p.kernels.pair_rows))
        # the pass's entry points, under each name that a module of the
        # program binds them to (`from .pairwise import ...`)
        top = p.pairwise.__name__.split(".")[0]
        mods = [m for n, m in list(sys.modules.items())
                if m is not None and (n == top or n.startswith(top + "."))]
        for name in PASSES:
            orig = getattr(p.pairwise, name)
            tap = self._entry_tap(name, orig)
            for mod in mods:
                for attr, v in list(vars(mod).items()):
                    if v is orig:
                        self._patch(mod, attr, tap)
        # the cascades' plain form binds kernel A as its default pair pass
        # (the rigid cascade's): the same tap there
        self._patch(p.cascade.cascade_ref, "__defaults__",
                    (p.kernels.pair_rows,))
        self._patch(p.worm, "obdm_terms", self._obdm_tap(p.worm.obdm_terms))
        self._patch(self.sweeper, "step", self._step_tap(self.sweeper.step))

    def uninstall(self):
        saved, self._saved = self._saved, []
        for obj, name, value in reversed(saved):
            if name == "pair_rows":
                value.launches = getattr(obj, name).launches
            if obj is self.sweeper:
                del obj.step
            else:
                setattr(obj, name, value)

    def end_warmup(self):
        """The warm-up block's calls per kind: the range the window's
        captured calls are drawn from."""
        self.warm = dict(self.calls)

    def begin_block(self, nsteps: int):
        """Arm the capture of one call of each kind in the next block of
        nsteps steps, drawn from the seed."""
        self.on = True
        self.blocks += 1
        self.nsteps, self.k, self.calls = nsteps, 0, {}
        self.target = {kind: int(self.rng.integers(0, self.warm[kind]))
                       for kind in CAPTURED if self.warm.get(kind)}
