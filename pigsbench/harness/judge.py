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
                 |dS_ref|), the worst;
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
                 pass output was not seen in the form expected, and a
                 missing last step: limit 0.

The control puts the reference, computed in the next lower precision,
in the program's place (`control_answers`), and is judged the same way."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import estimators as ref_est
from ..reference import moves as ref_mv
from ..reference.physics import geometry, wrap
from .capture import expected_kinds
from .counting import COUNTER_NAMES

FAMILY = {"cm": "cm", "cm_cascade": "cm", "worm_cm": "worm"}  # else "bis"
# kernel 5's kinds, judged by their decisions and write-backs alone
CASCADES = ("cascade_ends", "cascade_int")
NUMBERS = ("cm_dS_gap", "cm_state_gap", "bis_dS_gap", "bis_state_gap",
           "worm_dS_gap", "worm_state_gap", "cascade_flip_gap",
           "cascade_state_gap", "energy_gap", "therm_gap", "structure_gap",
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
    ans = {"moves": moves, "stats": None, "book": None}
    last = cap.last
    if last is not None:
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


def control_answers(run, dtype) -> dict:
    """The reference in `dtype` in the program's place, on the same
    captured inputs, the same final state and the same OBDM rounds; the
    bookkeeping, integer counts that no precision changes, is the
    program's."""
    fields = run.fields
    dev = run.final_paths.device
    prog = program_answers(run)
    moves = []
    for rec in run.capture.moves:
        R = rec["before"].to(dev, dtype)
        xend = None if rec["xend"] is None else rec["xend"].to(dev, dtype)
        slots = ref_mv.move(fields, rec["kind"], R, _dev(rec["args"], dev),
                            xend)
        dec = [ref_mv.decide(sl, sl["dS"]) for sl in slots]
        after, xa = ref_mv.apply(slots, R, xend, dec)
        moves.append({**rec, "rows": [sl["dS"] for sl in slots],
                      "after": after, "xend_after": xa, "accept": dec})
    stats = None
    last = run.capture.last
    if last is not None:
        sums, _ = ref_est.measure(fields, run.final_paths,
                                  run.final_isopen, dtype)
        stats = {k: torch.as_tensor(v, dtype=torch.float64)
                 for k, v in sums.items()}
        stats["nrho"] = ref_est.obdm(fields, last["obdm"],
                                     last["isopen_out"], dtype)[0]
    return {"moves": moves, "stats": stats, "book": prog["book"]}


def _judge_move(run, rec, geo, dev):
    """(family, dS gap, state gap, walkers over limits' test inputs) of one
    captured move, or None where its rows are missing."""
    f64 = torch.float64
    rows = rec["rows"]
    if rows is None:
        return None
    R = rec["before"].to(dev, f64)
    xend = None if rec["xend"] is None else rec["xend"].to(dev, f64)
    slots = ref_mv.move(run.fields, rec["kind"], R, _dev(rec["args"], dev),
                        xend)
    if len(rows) != len(slots) or any(
            r.shape != sl["dS"].shape for r, sl in zip(rows, slots)):
        return None
    gaps, decisions, wrong = [], [], torch.zeros(R.shape[0], dtype=torch.bool,
                                                 device=dev)
    for sl, r, acc in zip(slots, rows, rec["accept"]):
        dS, ref = r.to(dev, f64), sl["dS"]
        gap = (dS - ref).abs() / ref.abs().clamp(min=1.0)
        gap = torch.where(torch.isfinite(gap), gap,
                          torch.full_like(gap, math.inf))
        gaps.append(torch.where(sl["active"][:, None], gap,
                                torch.zeros_like(gap)).amax(-1))
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
    return FAMILY.get(rec["kind"], "bis"), gap, dist


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
        fam, gap, dist = out
        g, s = f"{fam}_dS_gap", f"{fam}_state_gap"
        vals[g] = max(vals[g], float(gap.max()))
        vals[s] = max(vals[s], float(dist.max()))
        attempted += gap.numel()
        failed += int(((gap > lim[g]) | (dist > lim[s])).sum())
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
    vals["missing"] = float(missing)
    failed += missing
    return vals, attempted, failed


def correct(vals: dict, limits: dict) -> bool:
    return all(vals[k] <= limits[k] for k in limits)
