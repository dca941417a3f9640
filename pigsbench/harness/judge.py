"""The comparison that decides `correct`: what the window produced against
the plain reference (pigsbench/reference), in float64.

Numbers compared, each against its limit in the cell's file
(`check.limits`; a cell compares the numbers it names there):

  <f>_dS_gap     the window pair pass (kernel A) inside the captured moves
                 of family f (cm: the rigid CM move, also as the rigid
                 cascade; bis: the bisections,
                 head, tail, interior and their composites; worm: the worm
                 half's rigid move): per compared row of each sampled
                 walker whose particle is active, |dS - dS_ref| / max(1,
                 |dS_ref|), the worst.  A per-level bisection's rows are
                 its passes, one per level, each its level's sum, matched
                 to the reference's accept groups by bead (per walker with
                 per-walker windows) and compared with the group's sum; a
                 per-walker window's pass must read each walker's own
                 beads;
  gate_dS_gap    the end gate of the per-level end bisections, its own
                 pass (the dense delta_action, kernel 3 with kernel 4's u
                 on the chain-end row, or delta_action_sum), against the
                 reference's gate row, normalised as the dS gaps are;
  depth_gap      with random end depths (capture.random_depth): the depths
                 handed to the window's end moves (every call of the head and
                 tail moves in its blocks) against the law that the
                 configuration states, U{2..Nlev}: with n calls and K depths
                 due, the largest |n_d - n/K| / (n/K) over the depths d due
                 or drawn (a depth not due counts against 0); a window
                 without such calls reads `missing`;
  <f>_state_gap  those moves' decisions and write-backs: the walker's
                 positions (and the worm's open ends) after the move
                 against the reference's (the proposal where it accepts,
                 else what stood there; where u lies between exp(-S) and
                 exp(-S_ref) for some accept group, either decision
                 stands), the largest minimum-image distance over the box
                 length; a decision returned otherwise than written reads 1;
  cascade_flip_gap
                 kernel 5's whole-move cascades (the ends and the interior),
                 which expose no rows: over each slot whose decision differs
                 from the float64 reference's, the least relative error of
                 its gates' summed dS that explains the decision (the
                 margin |sum dS_g + ln u_g| / max(1, |sum dS_g|), of the
                 reference's sums: the largest over the gates the reference
                 fails where the program accepts, the smallest over every
                 gate where it rejects), the worst; 0 where no decision
                 differs, inf for an inactive slot accepted;
  cascade_state_gap
                 those moves' write-backs: the positions after the move
                 against the reference's proposals written back under the
                 program's decisions, the largest minimum-image distance over
                 the box length;
  dfield_gap     under exact F^2 with the cache: the field increments
                 (`dfield`) of each captured move's calls that carry the
                 cache's rows, against the reference's F(R') - F(R) of every
                 particle at each displaced bead with a Chin F^2 weight
                 (reference/exact_f2.py), as the dS gaps are normalised but
                 per particle's vector: |dF - dF_ref| / max(1, |dF_ref|)
                 (Euclidean norms over the dimensions), the worst over the
                 rows and particles of each sampled walker whose particle is
                 active; there the dS gaps hold the rows against the exact
                 F^2, and a move without such calls reads `missing`;
  fcache_gap     the cache after the window's last step, as the step's
                 moves left it, against the float64 field of that step's
                 final positions at the odd beads, for the sampled walkers:
                 |F - F_ref| / max(1, |F_ref|) per particle's vector, the
                 worst; a cache not seen reads `missing`;
  energy_gap     the mixed estimator's statistics of the window's last
                 measurement (n_diag, sumE, sumK, sumV and their squares),
                 |delta - ref| / sum|terms|, the worst field;
  therm_gap      the thermodynamic estimator's (sumEt, sumKt, sumVt and
                 their squares; the all-pairs pass, kernel B), the same;
  structure_gap  g(r) and S(k) (ngr, gr, sk; the vectors by the sum of
                 their absolute differences), the same;
  obdm_gap       the OBDM histogram (nrho) that the window's last step
                 added, from the open ends of each of its worm rounds;
  count_gap      the window's last step's bookkeeping, exact: entries of
                 the tries and accepts counters, of the permutation
                 histogram (perm_hist) and of n_diag_all that differ from
                 the reference's (tries from the open masks; accepts the
                 sums of the decisions the step's moves returned; the
                 histogram from the walkers that closed);
  missing        per window block, each kind of move the configuration
                 runs without a captured call, captured calls whose pair
                 pass output was not seen in the form expected (a
                 per-level move: a group of the reference's rows with no
                 pass over its beads, or a pass over no group's beads; a
                 per-walker window's pass over other beads; randoms of
                 another depth than the move was handed), and a missing
                 last step: limit 0.

The control puts the reference, computed in the next lower precision,
in the program's place (`control_answers`), and is judged the same way."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import estimators as ref_est
from ..reference import exact_f2 as ref_f2
from ..reference import moves as ref_mv
from ..reference.physics import PairModel, geometry, wrap
from .capture import expected_kinds, random_depth
from .counting import COUNTER_NAMES

FAMILY = {"cm": "cm", "cm_cascade": "cm", "worm_cm": "worm"}  # else "bis"
# kernel 5's kinds, judged by their decisions and write-backs alone
CASCADES = ("cascade_ends", "cascade_int")
NUMBERS = ("cm_dS_gap", "cm_state_gap", "bis_dS_gap", "bis_state_gap",
           "gate_dS_gap", "depth_gap", "worm_dS_gap", "worm_state_gap",
           "cascade_flip_gap", "cascade_state_gap", "dfield_gap",
           "fcache_gap", "energy_gap", "therm_gap", "structure_gap",
           "obdm_gap", "count_gap", "missing")
LOWER = {"float32": torch.bfloat16, "float64": torch.float32}


def _dev(v, dev):
    """v's tensors on dev, through dicts and tuples."""
    if torch.is_tensor(v):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _dev(x, dev) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_dev(x, dev) for x in v)
    return v


def carries_cache(fields) -> bool:
    """Whether the configuration's moves carry the exact-F^2 cache."""
    return bool(fields["exact_f2"] and fields["f2_cache"])


def _vec_gap(x, ref):
    """[..., N]: |x - ref| / max(1, |ref|) over the last axis, inf where
    not finite."""
    d = (x - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1.0)
    return torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))


def _worst(x):
    """[s]: the largest of x [s, ...] per walker (0 where x has none)."""
    x = x.flatten(1)
    return x.amax(-1) if x.shape[1] else x.new_zeros(x.shape[0])


def _fold_slots(passes, slots):
    """The program's rows and field increments of a captured move's passes
    that carry the cache, as each slot's (the reference's order), matched
    by bead: (rows, dfield) lists, or (None, None) where a slot's bead is
    in no such pass.  A rigid move's pass returns its rows' sum, its one
    row."""
    calls = []
    for f in (p for p in passes if "dfield" in p):
        if f["ib"].dim() != 1:
            return None, None
        beads = f["ib"].tolist()
        r0, step = f["sub"]
        calls.append((f, {b: i for i, b in enumerate(beads)},
                      {b: i for i, b in enumerate(beads[r0::step])}))
    rows, dfield = [], []
    for sl in slots:
        want = sl["beads"].tolist()
        f2 = [b for b, on in zip(want, sl["f2"].tolist()) if on]
        hit = next(((f, rm, dm) for f, rm, dm in calls
                    if all(b in rm for b in want)
                    and all(b in dm for b in f2)), None)
        if hit is None:
            return None, None
        f, rm, dm = hit
        dS = f["dS"]
        if dS.dim() == 1:           # a rigid move's call returns its sum
            rows.append(dS[:, None])
        else:
            rows.append(dS[:, [rm[b] for b in want]])
        dfield.append(f["dfield"][:, [dm[b] for b in f2]])
    return rows, dfield


def per_level(fields, kind) -> bool:
    """Whether a captured move of `kind` is a per-level bisection (one pass
    per level, and an end move's gate), judged by its accept groups."""
    return not fields["bis_monoshot"] and kind in ("bis", "bis_head",
                                                   "bis_tail")


def _same_beads(ib, beads) -> bool:
    """Whether a pass's bead indices ib ([B] or per walker [s, B]) are the
    beads [B] or [s, B] of some reference rows, as sets per walker."""
    ib = ib.to(beads.device)
    if ib.shape[-1] != beads.shape[-1]:
        return False
    return bool((ib.sort(-1).values == beads.sort(-1).values).all())


def _grouped(slot, used):
    """The slot with one row per accept group in `used` [G'], each the
    reference's sum of the group's rows; `gate` marks the end gate's."""
    return {**slot, "dS": ref_mv.group_sums(slot, slot["dS"])[:, used],
            "group": used, "gate": used == 0}


def _level_rows(rec, slots):
    """(rows, slots) of a per-level move: each slot's rows by accept group
    (its group sums), from the program's passes matched by bead, or from
    the rows of the reference put in the program's place; (None, None)
    where a group has no pass over its beads or a pass is over none."""
    passes, out, grouped = rec.get("passes"), [], []
    if passes is None and rec["rows"] is None:
        return None, None
    left = list(range(len(passes))) if passes is not None else []
    for k, sl in enumerate(slots):
        used = torch.unique(sl["group"])
        grouped.append(_grouped(sl, used))
        if passes is None:
            out.append(ref_mv.group_sums(sl, rec["rows"][k])[:, used])
            continue
        sums = []
        for g in used.tolist():
            beads = sl["beads"][..., sl["group"].to(sl["beads"].device) == g]
            hit = next((i for i in left
                        if _same_beads(passes[i]["ib"], beads)), None)
            if hit is None:
                return None, None
            left.remove(hit)
            dS = passes[hit]["dS"]
            sums.append(dS.sum(-1) if dS.dim() == 2 else dS)
        out.append(torch.stack(sums, -1))
    return (None, None) if left else (out, grouped)


def _f64(st) -> dict:
    return {k: v.detach().double() for k, v in st._asdict().items()}


def _slot_rows(rec) -> list:
    """The program's pair-pass outputs of a captured call, as each slot's
    rows in the reference's order (reference/moves.py), or None where they
    are not of the form expected (a per-level form, a missing pass)."""
    kind, outs, a = rec["kind"], rec["rows"], rec["args"]
    if kind in CASCADES:    # kernel 5 exposes none
        return None
    n = 2 if kind == "bis_ends" else 1
    if len(outs) != n:
        return None
    if kind in ("cm", "cm_cascade", "worm_cm"):
        return [outs[0][:, None]] if outs[0].dim() == 1 else None
    if outs[0].dim() != 2:
        return None
    if kind == "bis_tail":
        return [outs[0].flip(1)]
    if kind == "bis_multi":
        K, L = len(a["ips"]), 2 ** a["level"]
        r = torch.nn.functional.pad(outs[0], (1, 0))
        if r.shape[1] != K * L:
            return None
        return list(r.view(r.shape[0], K, L)[:, :, 1:].unbind(1))
    return list(outs)


def program_answers(run) -> dict:
    """What the window produced: the captured moves, the statistics of its
    last step, and that step's bookkeeping."""
    cap = run.capture
    moves = [{**rec, "rows": _slot_rows(rec)} for rec in cap.moves]
    ans = {"moves": moves, "stats": None, "book": None, "fcache": None,
           "depths": cap.depths}
    last = cap.last
    if last is not None:
        ans["fcache"] = last.get("fcache")
        a, b = _f64(last["stats_in"]), _f64(last["stats_out"])
        ans["stats"] = {k: b[k] - a[k] for k in
                        ref_est.ENERGY + ref_est.THERM + ref_est.STRUCTURE
                        + ("nrho",)}
        ans["book"] = {"counters": b["counters"] - a["counters"],
                       "perm_hist": b["perm_hist"] - a["perm_hist"],
                       "n_diag_all": b["n_diag_all"] - a["n_diag_all"]}
    return ans


def _reference_book(run, last) -> dict:
    """The reference's bookkeeping of the last step (see count_gap)."""
    f = run.fields
    W, Np, dev = run.walkers, f["Np"], last["isopen_in"].device
    iso_in, iso_out = last["isopen_in"], last["isopen_out"]
    nopen = float(iso_out.sum())
    acc = {k: float(v) for k, v in last["acc"].items()}
    kinds = expected_kinds(f)
    act_all = Np * W - nopen
    c = {}
    if f["CMFreq"] > 0 and last["step"] % f["CMFreq"] == 0:
        c["try_cm"] = act_all
        c["acc_cm"] = acc.get("acc_cm", 0.0)
    if f["Nstag"] > 0 and f["sampling"] == "bis":
        c["try_stag"] = f["Nstag"] * act_all
        for k, names in (("bis_head", ("acc_head",)),
                         ("bis_tail", ("acc_tail",)), ("bis", ("acc_bd",)),
                         ("bis_ends", ("acc_head", "acc_tail")),
                         ("bis_multi", ("acc_bd", "try_int")),
                         ("cascade_ends", ("acc_head", "acc_tail")),
                         ("cascade_int", ("acc_bd", "try_int"))):
            if k in kinds:
                c.update({n: acc.get(n, 0.0) for n in names})
    worm = f["CWorm"] > 0.0
    if worm and f["Nobdm"] > 0:
        c["try_cm_half"] = c["try_stag_half"] = 2 * f["Nobdm"] * nopen
        names = ["acc_cm_half", "acc_head_half", "acc_tail_half",
                 "acc_bd_half"]
        if f["swapping"]:
            c["try_swap"] = f["Nobdm"] * nopen
            names.append("acc_swap")
        c.update({n: acc.get(n, 0.0) for n in names})
    book = {"n_diag_all": torch.tensor(float(W) - nopen,
                                       dtype=torch.float64)}
    if worm:
        closed = iso_in & ~iso_out
        c["acc_open"] = float((~iso_in & iso_out).sum())
        c["acc_close"] = float(closed.sum())
        ph = torch.zeros(Np, dtype=torch.float64, device=dev)
        ph.index_add_(0, (last["iperm_in"] - 1).clamp(0, Np - 1),
                      closed.double())
        book["perm_hist"] = ph
    book["counters"] = {COUNTER_NAMES.index(k): v for k, v in c.items()}
    return book


def _count_gap(book, ref) -> int:
    if book is None:
        return 0
    bad = int(book["n_diag_all"].cpu() != ref["n_diag_all"])
    if "perm_hist" in ref:
        bad += int((book["perm_hist"] != ref["perm_hist"]).sum())
    ctr = book["counters"].cpu()
    bad += sum(int(float(ctr[i]) != v) for i, v in ref["counters"].items())
    return bad


# faults that control_answers can plant in the reference put in the
# program's place: of the exact-F^2 path, of the per-level bisections, of
# the random end depths and of the per-walker windows
F2_FAULTS = ("partial_f2", "dg_flipped", "bis_cache_skipped")
LEVEL_FAULTS = ("gate_altered", "level_accept_ignored")
DEPTH_FAULTS = ("end_depth_fixed",)
PERWALKER_FAULTS = ("windows_at_walker0",)


def faults(fields) -> tuple:
    """The faults of F2_FAULTS, LEVEL_FAULTS, DEPTH_FAULTS and
    PERWALKER_FAULTS that a configuration's path can have."""
    return ((F2_FAULTS if carries_cache(fields) else ())
            + (LEVEL_FAULTS if not fields["bis_monoshot"] else ())
            + (DEPTH_FAULTS if random_depth(fields) else ())
            + (PERWALKER_FAULTS if not fields["shared_windows"] else ()))


def control_answers(run, dtype, fault: str = None) -> dict:
    """The reference in `dtype` in the program's place, on the same
    captured inputs, the same final state and the same OBDM rounds; the
    bookkeeping, integer counts that no precision changes, is the
    program's.  fault (one of faults(fields)): planted in the reference so
    put in the program's place --
      partial_f2         the moves' rows and decisions with the reference
                         code's partial dF^2 in place of the exact one;
      dg_flipped         the partners' field increments with the wrong
                         sign (the moved particle's kept);
      bis_cache_skipped  the cache without the increments that the last
                         block's captured interior bisection made for its
                         accepted walkers (increments add, so the moves
                         after it leave them missing);
      gate_altered       the per-level end moves' gate rows (kernel 3's)
                         off by a tenth, max(1, |dS|) / 10, and their
                         decisions taken from them;
      level_accept_ignored
                         the per-level moves' proposals written back for
                         every active walker, whatever its gates;
      end_depth_fixed    every end move of the window handed depth 2, the
                         lowest, in place of the depths the sweep drew;
      windows_at_walker0 the interior bisections' per-walker windows
                         written back at the first sampled walker's
                         beads."""
    fields = run.fields
    dev = run.final_paths.device
    prog = program_answers(run)
    moves, skipped = [], None
    for rec in run.capture.moves:
        R = rec["before"].to(dev, dtype)
        xend = None if rec["xend"] is None else rec["xend"].to(dev, dtype)
        slots = ref_mv.move(fields, rec["kind"], R, _dev(rec["args"], dev),
                            xend)
        if fault == "partial_f2":
            part = ref_mv.move({**fields, "exact_f2": False}, rec["kind"], R,
                               _dev(rec["args"], dev), xend)
            slots = [{**sl, "dS": q["dS"]} for sl, q in zip(slots, part)]
        levels = per_level(fields, rec["kind"])
        if fault == "gate_altered" and levels:
            slots = [{**sl, "dS": sl["dS"] + torch.where(
                (sl["group"] == 0).to(dev), 0.1 * sl["dS"].abs().clamp(
                    min=1.0), torch.zeros_like(sl["dS"]))} for sl in slots]
        dec = [sl["active"] if fault == "level_accept_ignored" and levels
               else ref_mv.decide(sl, sl["dS"]) for sl in slots]
        written = slots
        if fault == "windows_at_walker0" and rec["kind"] == "bis":
            written = [{**sl, "beads": sl["beads"][..., :1, :].expand_as(
                sl["beads"]) if sl["beads"].dim() == 2 else sl["beads"]}
                for sl in slots]
        after, xa = ref_mv.apply(written, R, xend, dec)
        dfield = [_dfield(sl, fault) if "dfield" in sl else None
                  for sl in slots]
        moves.append({**rec, "rows": [sl["dS"] for sl in slots],
                      "passes": None, "dfield": dfield,
                      "after": after, "xend_after": xa, "accept": dec})
        if rec["kind"] == "bis" and rec["block"] == run.blocks:
            skipped = (slots[0], dec[0])
    stats = fcache = None
    last = run.capture.last
    if last is not None and carries_cache(fields):
        fcache = _field_odd(run, dtype)
        if fault == "bis_cache_skipped":
            if skipped is None:
                raise ValueError("no interior bisection captured in the "
                                 "last block")
            sl, dec = skipped
            rows = (sl["beads"][sl["f2"]] - 1) // 2
            fcache[:, rows.to(dev)] -= torch.where(
                dec[:, None, None, None], sl["dfield"][:, sl["f2"]],
                torch.zeros((), dtype=fcache.dtype, device=dev))
    if last is not None:
        sums, _ = ref_est.measure(fields, run.final_paths,
                                  run.final_isopen, dtype)
        stats = {k: torch.as_tensor(v, dtype=torch.float64)
                 for k, v in sums.items()}
        stats["nrho"] = ref_est.obdm(fields, last["obdm"],
                                     last["isopen_out"], dtype)[0]
    depths = prog["depths"]
    if fault == "end_depth_fixed":
        depths = {2: sum(depths.values())}
    return {"moves": moves, "stats": stats, "book": prog["book"],
            "fcache": fcache, "depths": depths}


def _dfield(slot, fault):
    """The reference's field increments of a slot's F^2 rows (the
    partners' negated under the fault dg_flipped)."""
    d = slot["dfield"][:, slot["f2"]]
    if fault != "dg_flipped":
        return d
    moved = torch.arange(d.shape[2], device=d.device) == slot["p"].to(
        d.device)[:, None]
    return torch.where(moved[:, None, :, None], d, -d)


def _field_odd(run, dtype):
    """[s, Nb, N, D]: the reference's field, in dtype, of the window's
    final positions at the odd beads, for the sampled walkers."""
    fields, dev = run.fields, run.final_paths.device
    X = run.final_paths.index_select(0, run.capture.sample.to(dev))
    return ref_f2.field(geometry(fields), PairModel(fields),
                        X[:, 1::2].to(dtype))


def _judge_move(run, rec, geo, dev):
    """(family, dS gap, state gap, dfield gap or None, gate gap or None)
    per sampled walker of one captured move, or None where its rows are
    missing."""
    f64 = torch.float64
    rows, dfield = rec["rows"], rec.get("dfield")
    levels = per_level(run.fields, rec["kind"])
    cache = (carries_cache(run.fields) and rec.get("passes") is not None
             and not levels)
    if rows is None and not cache and not levels:
        return None
    R = rec["before"].to(dev, f64)
    xend = None if rec["xend"] is None else rec["xend"].to(dev, f64)
    try:
        slots = ref_mv.move(run.fields, rec["kind"], R,
                            _dev(rec["args"], dev), xend)
    except ValueError:      # randoms of another depth than it was handed
        return None
    passes = rec.get("passes")
    if levels:
        rows, slots = _level_rows(rec, slots)
        if rows is None:
            return None
    elif (rec["kind"] == "bis" and passes is not None
          and not run.fields["shared_windows"]
          and not _same_beads(torch.cat([p["ib"].to(dev) for p in passes], -1),
                              torch.cat([sl["beads"] for sl in slots], -1))):
        return None
    if cache:
        rows, dfield = _fold_slots(passes, slots)
    if rows is None or len(rows) != len(slots) or any(
            r.shape != sl["dS"].shape for r, sl in zip(rows, slots)):
        return None
    dfgap = None
    if carries_cache(run.fields):
        if dfield is None or any(
                d is None or d.shape != sl["dfield"][:, sl["f2"]].shape
                for d, sl in zip(dfield, slots)):
            return None
        dfgap = torch.stack([_worst(torch.where(
            sl["active"][:, None, None],
            _vec_gap(d.to(dev, f64), sl["dfield"][:, sl["f2"]]),
            torch.zeros((), dtype=f64, device=dev)))
            for d, sl in zip(dfield, slots)]).amax(0)
    gaps, gates, decisions = [], [], []
    wrong = torch.zeros(R.shape[0], dtype=torch.bool, device=dev)
    for sl, r, acc in zip(slots, rows, rec["accept"]):
        dS, ref = r.to(dev, f64), sl["dS"]
        gap = (dS - ref).abs() / ref.abs().clamp(min=1.0)
        gap = torch.where(torch.isfinite(gap), gap,
                          torch.full_like(gap, math.inf))
        gap = torch.where(sl["active"][:, None], gap, torch.zeros_like(gap))
        if sl.get("gate") is not None and bool(sl["gate"].any()):
            gate = sl["gate"].to(dev)
            gates.append(torch.where(gate, gap, torch.zeros_like(gap))
                          .amax(-1))
            gap = torch.where(gate, torch.zeros_like(gap), gap)
        gaps.append(gap.amax(-1))
        # where the program's sums and the reference's fall on the two
        # sides of u in some group, either decision stands
        tie = (ref_mv.passes(sl, dS) != ref_mv.passes(sl, ref)).any(-1)
        acc = acc.to(dev)
        dec = torch.where(tie, acc, ref_mv.decide(sl, ref))
        wrong |= acc != dec
        decisions.append(dec)
    exp_R, exp_x = ref_mv.apply(slots, R, xend, decisions)
    dist = wrap(rec["after"].to(dev, f64) - exp_R, geo.L).abs()
    dist = dist.amax((1, 2, 3)) / geo.L
    if exp_x is not None:
        dx = wrap(rec["xend_after"].to(dev, f64) - exp_x, geo.L).abs()
        dist = torch.maximum(dist, dx.amax((1, 2)) / geo.L)
    dist = torch.where(torch.isfinite(dist) & ~wrong, dist,
                       torch.where(wrong, torch.ones_like(dist),
                                   torch.full_like(dist, math.inf)))
    gap = torch.stack(gaps).amax(0)
    gate = torch.stack(gates).amax(0) if gates else None
    return FAMILY.get(rec["kind"], "bis"), gap, dist, dfgap, gate


def _flip_gap(slot, acc):
    """[s]: the least relative error of the reference's gate sums that
    explains the decisions acc [s] bool where they differ from the
    reference's (see cascade_flip_gap)."""
    sums = ref_mv.group_sums(slot, slot["dS"])
    used = torch.zeros(sums.shape[1], dtype=torch.bool, device=sums.device)
    used[slot["group"].to(sums.device)] = True
    margin = (sums + torch.log(slot["u"].to(sums.dtype))).abs() \
        / sums.abs().clamp(min=1.0)
    margin = torch.where(torch.isnan(margin), torch.full_like(margin,
                                                              math.inf),
                         margin)
    fails = ~ref_mv.passes(slot, slot["dS"]) & used
    ref = ref_mv.decide(slot, slot["dS"])
    # accepted where the reference rejects: every gate it fails flipped
    up = torch.where(fails, margin, torch.zeros_like(margin)).amax(-1)
    # rejected where the reference accepts: one gate at least flipped
    down = torch.where(used, margin, torch.full_like(margin,
                                                     math.inf)).amin(-1)
    gap = torch.where(acc & ~ref, up, torch.where(~acc & ref, down,
                                                   torch.zeros_like(up)))
    return torch.where(acc & ~slot["active"], torch.full_like(gap, math.inf),
                       gap)


def _judge_cascade(run, rec, geo, dev):
    """(flip gap, state gap) per sampled walker of one captured call of
    kernel 5's cascades."""
    f64 = torch.float64
    R = rec["before"].to(dev, f64)
    slots = ref_mv.move(run.fields, rec["kind"], R, _dev(rec["args"], dev))
    acc = [a.to(dev) for a in rec["accept"]]
    flip = torch.stack([_flip_gap(sl, a) for sl, a in zip(slots, acc)])
    exp_R, _ = ref_mv.apply(slots, R, None, acc)
    dist = wrap(rec["after"].to(dev, f64) - exp_R, geo.L).abs()
    dist = dist.amax((1, 2, 3)) / geo.L
    dist = torch.where(torch.isfinite(dist), dist,
                       torch.full_like(dist, math.inf))
    return flip.amax(0), dist


def _depth_gap(depths: dict, nlev: int) -> float:
    """depth_gap of the window's end moves, counted by depth."""
    due = range(2, max(nlev, 2) + 1)
    n = sum(depths.values())
    e = n / len(due)
    return max(abs(depths.get(d, 0) - (e if d in due else 0.0)) / e
               for d in set(due) | set(depths))


def judge(run, answers: dict, limits: dict) -> tuple:
    """({number: value}, attempted, failed) of the answers against the
    float64 reference."""
    fields = run.fields
    geo = geometry(fields)
    dev = run.final_paths.device
    vals = {k: 0.0 for k in NUMBERS}
    lim = {k: limits.get(k, math.inf) for k in NUMBERS}
    attempted = failed = 0
    kinds = expected_kinds(fields)
    seen = {(m["block"], m["kind"]) for m in answers["moves"]}
    missing = sum((b, k) not in seen for b in range(1, run.blocks + 1)
                  for k in kinds)
    for rec in answers["moves"]:
        if rec["kind"] in CASCADES:
            flip, dist = _judge_cascade(run, rec, geo, dev)
            g, s = "cascade_flip_gap", "cascade_state_gap"
            vals[g] = max(vals[g], float(flip.max()))
            vals[s] = max(vals[s], float(dist.max()))
            attempted += flip.numel()
            failed += int(((flip > lim[g]) | (dist > lim[s])).sum())
            continue
        out = _judge_move(run, rec, geo, dev)
        if out is None:
            missing += 1
            continue
        fam, gap, dist, dfgap, gate = out
        g, s = f"{fam}_dS_gap", f"{fam}_state_gap"
        vals[g] = max(vals[g], float(gap.max()))
        vals[s] = max(vals[s], float(dist.max()))
        attempted += gap.numel()
        bad = (gap > lim[g]) | (dist > lim[s])
        if gate is not None:
            vals["gate_dS_gap"] = max(vals["gate_dS_gap"], float(gate.max()))
            bad |= gate > lim["gate_dS_gap"]
        if dfgap is not None:
            vals["dfield_gap"] = max(vals["dfield_gap"], float(dfgap.max()))
            bad |= dfgap > lim["dfield_gap"]
        failed += int(bad.sum())
    if random_depth(fields):
        depths = answers.get("depths")
        if not depths:
            missing += 1
        else:
            g = _depth_gap(depths, fields["Nlev"])
            vals["depth_gap"] = g
            attempted += 1
            failed += int(g > lim["depth_gap"])
    stats, last = answers["stats"], run.capture.last
    if stats is None or last is None:
        missing += 1
    else:
        if run.reference is None:   # once per run
            run.reference = ref_est.measure(fields, run.final_paths,
                                            run.final_isopen, torch.float64)
        sums, scale = run.reference
        attempted += run.walkers
        for group, keys in (("energy_gap", ref_est.ENERGY),
                            ("therm_gap", ref_est.THERM),
                            ("structure_gap", ref_est.STRUCTURE)):
            for k in keys:
                ref = sums[k].cpu().numpy() if torch.is_tensor(sums[k]) \
                    else np.float64(sums[k])
                d = float(np.abs(stats[k].cpu().numpy() - ref).sum())
                g = d / max(float(scale[k]), 1e-300) if math.isfinite(d) \
                    else math.inf
                vals[group] = max(vals[group], g)
                failed += int(g > lim[group])
        if fields["CWorm"] > 0.0 and fields["Nobdm"] > 0:
            nrho, sc = ref_est.obdm(fields, last["obdm"], last["isopen_out"],
                                    torch.float64)
            d = float((stats["nrho"].to(nrho.device) - nrho).abs().sum())
            g = d / max(sc, 1e-300) if math.isfinite(d) else math.inf
            vals["obdm_gap"] = g
            failed += int(g > lim["obdm_gap"])
        bad = _count_gap(answers["book"], _reference_book(run, last))
        vals["count_gap"] = float(bad)
        failed += int(bad > lim["count_gap"])
        if carries_cache(fields):
            fc = answers.get("fcache")
            if fc is None:
                missing += 1
            else:
                ref = _field_odd(run, torch.float64)
                g = float(_vec_gap(fc.to(dev, torch.float64), ref).max())
                vals["fcache_gap"] = g
                attempted += ref.shape[0]
                failed += int(g > lim["fcache_gap"])
    vals["missing"] = float(missing)
    failed += missing
    return vals, attempted, failed


def correct(vals: dict, limits: dict) -> bool:
    return all(vals[k] <= limits[k] for k in limits)
