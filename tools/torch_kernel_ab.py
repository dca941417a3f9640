"""Time the flagship's kernels of two checkouts on one card, in turns.

    python3 tools/torch_kernel_ab.py ROOT_A ROOT_B [rounds]

Each ROOT is a checkout of the repo (e.g. an earlier commit unpacked with
`git archive <commit> | tar -x -C build/parent`, and `.`).  Each turn is a
process of its own that imports ROOT's package and benchmark (pigsbench)
and this checkout's tests/torch_card.py, so that both roots get the same
inputs, and times, with CUDA events on the Aziz flagship's inputs
(W=1024, float32): kernel A on an end move's window (B=1, 4, 8 and 16:
lanes per row G = 32, 16, 8 and 4; f2 and u, weighted rows), kernel B's
two ThermEnergy calls (with and without force), the dense delta_action
(kernels 3 and 4 in one launch) at the end gate's row, and kernel 5
'ends'.  Each kernel's least time is the benchmark's own: its launches
recorded by pigsbench's launch tap, counted by pigsbench/harness/roofline
and priced by roofline.least_seconds (null where the benchmark counts no
such launch: the dense kernel).  The turns run A, B, B, A for each round,
so that drift of the card's clocks between turns shows in both.  It prints
one JSON line per turn and, per kernel, each root's median with its share
of the least time.
"""

import json
import os
import subprocess
import sys

CARD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests")

CODE = r"""
import json, sys, torch
sys.path[:0] = [ROOT, CARD]
import torch_card as tc
from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import kernels as K
from pathintegralgroundstate_torch.ops.pairwise import chin_table, delta_action
from pathintegralgroundstate_torch.utils import build
from pigsbench.harness import roofline
from pigsbench.harness.trace import LaunchTap

lib = build.kernels()
COUNT = {"pair_rows": roofline.window_pairs, "pair_pot": roofline.all_pairs,
         "cascade": roofline.cascade_move}
dev = torch.device("cuda")
cfg = flagship_cfg(1024)
out = {}


def timed(name, fn, reps):
    tap = LaunchTap(lib)
    tap.install()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        tap.uninstall()
    recs = [(k, r) for k, rs in tap.records.items() for r in rs]
    least = (sum(roofline.least_seconds(*COUNT[k](r), r["dtype"])
                 for k, r in recs) * 1e3 if recs else None)
    out[name] = {"ms": tc._events_ms(fn, reps=reps), "least_ms": least}


for B in (1, 4, 8, 16):
    system, case, cold, ib = tc.rows_case(cfg, 1024, B)
    tab = chin_table(system)
    timed(f"pair_rows B={B}",
          lambda: K.pair_rows(system, *case, 5, tab, ib, True, True), 200)
paths = tc._flagship_paths(cfg, 1024, torch.float32, dev, 35)
M = cfg.M
for wf in (True, False):
    R = paths[:, int(wf):M - 1:2]
    timed(f"pair_pot force={wf}", lambda: K.pair_pot(system, R, wf), 50)
R = paths[:, :1]
xo = R[:, :, 5]
xn = (xo + 0.05).contiguous()
ib0 = system.arange(0, 1)
timed("delta_action", lambda: delta_action(system, R, xn, xo, 5, ib0), 200)
sysc, p, slots, rg, ru, act = tc._cascade_inputs(cfg, 1024, torch.float32,
                                                 "ends", 12)
timed("cascade ends",
      lambda: K.cascade(sysc, "ends", p, slots, rg, ru, act, cfg.Nlev), 50)
print(json.dumps(out))
"""


def turn(root):
    root = os.path.abspath(root)
    proc = subprocess.run(
        [sys.executable, "-c", f"ROOT = {root!r}\nCARD = {CARD!r}\n" + CODE],
        cwd=root, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    a, b = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    got = {a: [], b: []}
    for _ in range(rounds):
        for root in (a, b, b, a):
            t = turn(root)
            got[root].append(t)
            print(json.dumps({"root": root, "kernels": t}), flush=True)
    for k in got[a][0]:
        med = {r: sorted(x[k]["ms"] for x in got[r])[len(got[r]) // 2]
               for r in (a, b)}
        least = {r: got[r][0][k]["least_ms"] for r in (a, b)}
        print(f"[ab] {k}: " + ", ".join(
            f"{r} {v:.5f} ms" + (f" ({100 * least[r] / v:.1f} % of the "
                                 f"least {least[r]:.5f} ms)" if least[r]
                                 else "")
            for r, v in med.items()))


if __name__ == "__main__":
    main()
