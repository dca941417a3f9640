"""Time the flagship's kernels of two checkouts on one card, in turns.

    python3 tools/torch_kernel_ab.py ROOT_A ROOT_B [rounds]

Each ROOT is a checkout of the repo (e.g. an earlier commit unpacked with
`git archive <commit> | tar -x -C build/parent`, and `.`).  Each turn is a
process of its own that imports ROOT's package and ROOT's chip_smoke.py
and times, with CUDA events on the Aziz flagship's inputs (W=1024,
float32): kernel A on an end move's window (B=1, 4, 8 and 16: lanes per
row G = 32, 16, 8 and 4; f2 and u, weighted rows), kernel B's two
ThermEnergy calls (with and without force), the
dense delta_action (kernels 3 and 4 in one launch) at the end gate's row,
and kernel 5 'ends'.  The turns run A, B, B, A for each round, so that
drift of the card's clocks between turns shows in both.  It prints one
JSON line per turn and, per kernel, each root's median.
"""

import json
import os
import subprocess
import sys

CODE = r"""
import json, sys, torch
sys.path.insert(0, ROOT)
import chip_smoke as cs
from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import kernels as K
from pathintegralgroundstate_torch.ops.pairwise import chin_table, delta_action
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils import build

build.kernels()
dev = torch.device("cuda")
cfg = flagship_cfg(1024)
out = {}
for B in (1, 4, 8, 16):
    system, case, cold, ib = cs.rows_case(cfg, 1024, B)
    tab = chin_table(system)
    out[f"pair_rows B={B}"] = cs._events_ms(
        lambda: K.pair_rows(system, *case, 5, tab, ib, True, True), reps=200)
paths = cs._flagship_paths(cfg, 1024, torch.float32, dev, 35)
M = cfg.M
for wf in (True, False):
    R = paths[:, int(wf):M - 1:2]
    out[f"pair_pot force={wf}"] = cs._events_ms(
        lambda: K.pair_pot(system, R, wf), reps=50)
R = paths[:, :1]
xo = R[:, :, 5]
xn = (xo + 0.05).contiguous()
ib0 = system.arange(0, 1)
out["delta_action"] = cs._events_ms(
    lambda: delta_action(system, R, xn, xo, 5, ib0), reps=200)
sysc, p, slots, rg, ru, act = cs._cascade_inputs(cfg, 1024, torch.float32,
                                                 "ends", 12)
out["cascade ends"] = cs._events_ms(
    lambda: K.cascade(sysc, "ends", p, slots, rg, ru, act, cfg.Nlev),
    reps=50)
print(json.dumps(out))
"""


def turn(root):
    root = os.path.abspath(root)
    proc = subprocess.run([sys.executable, "-c", f"ROOT = {root!r}\n" + CODE],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
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
            print(json.dumps({"root": root, "ms": t}), flush=True)
    for k in got[a][0]:
        med = {r: sorted(x[k] for x in got[r])[len(got[r]) // 2]
               for r in (a, b)}
        print(f"[ab] {k}: " + ", ".join(f"{r} {v:.5f} ms"
                                        for r, v in med.items()))


if __name__ == "__main__":
    main()
