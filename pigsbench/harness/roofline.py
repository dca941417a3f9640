"""The table of peaks and the bytes and operations of each launch of the
pair kernels (the window pass, the all-pairs pass, the dense gate) and of
the whole-move cascade, counted from the launch's own shapes.

Peaks: one NVIDIA H100 SXM by its data sheet (dense, 700 W): 3.35 TB/s of
HBM3, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor
cores.  bfloat16 storage is computed in float32.

Bytes: each input byte read once and each output byte written once,
whatever the kernel reads again.  Operations: per pair and side, what the
pair model's formulas need (an FMA counts two; exp, sqrt, rsqrt and a
division one each), counted from the program's stated formulas
(the minimum image and r^2 4 per dimension, r and 1/r 2, V or (V, dV/dr)
by potential, the force 1 + 2 per dimension, u by Jastrow, one per masked
accumulate).  A launch's least time is the larger of bytes over the
memory rate and operations over the compute rate."""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 67e12, "f64": 34e12}
ESIZE = {"f32": 4, "bf16": 2, "f64": 8}

# the program's pair-model selectors (its kernels' PotKind and JasKind)
POT_KINDS = {0: "aziz", 1: "soft", 2: "dipolar", 3: "none"}
JAS_KINDS = {0: "mcmillan", 1: "dipolar", 2: "none"}

OPS_V = {"aziz": 25, "soft": 8, "dipolar": 3, "none": 0}
OPS_V_DV = {"aziz": 45, "soft": 10, "dipolar": 5, "none": 0}
OPS_U = {"mcmillan": 8, "dipolar": 6, "none": 0}


def _pair_ops(D: int, pot: str, jas: str, force: bool, wf: bool) -> int:
    ops = 4 * D + 2 + 1 + (OPS_V_DV[pot] if force else OPS_V[pot])
    if force:
        ops += 1 + 2 * D
    if wf:
        ops += OPS_U[jas] + 1
    return ops


def window_pairs(rec: dict) -> tuple:
    """(bytes, operations) of one launch of the window pair pass: W x B
    displaced rows, both Metropolis sides against N - 1 partners each,
    the Chin-weighted row sums (or walker sums) written out."""
    W, B, N, D, M = rec["W"], rec["B"], rec["N"], rec["D"], rec["M"]
    es = ESIZE[rec["dtype"]]
    ib = B if rec["ib_mode"] == 0 else W * B
    ip = {0: 0, 1: W, 2: W * B, 3: B}[rec["ip_mode"]]
    nbytes = (es * (W * B * N * D + 2 * W * B * D + 3 * M
                    + (B if rec["row_weights"] else 0)
                    + (W if rec["reduce"] else W * B))
              + 8 * (ib + ip))
    per_pair = _pair_ops(D, POT_KINDS[rec["pot_kind"]],
                         JAS_KINDS[rec["jas_kind"]], bool(rec["need_f2"]),
                         bool(rec["need_wf"]))
    per_row = 2 * (2 * D if rec["need_f2"] else 0) + 6
    ops = W * B * (2 * (N - 1) * per_pair + per_row)
    return nbytes, ops


# the dense kernel's modes (enum Mode in the program's csrc/pair_delta.cu)
DENSE_RAW, DENSE_U, DENSE_ACTION = 0, 1, 2


def dense_gate(rec: dict) -> tuple:
    """(bytes, operations) of one launch of the dense pass in its action
    mode (kernel 3 with kernel 4's u pass, the per-level end gate): W x B
    rows, each the moved particle at its new and old place against N - 1
    partners, counted as the window pass's rows (window_pairs) with the
    force when the launch asks for it and u on every row (the gate's one
    row is a chain end), the rows written out.  ValueError for the other
    modes."""
    if rec["mode"] != DENSE_ACTION:
        raise ValueError(f"not the action mode: {rec['mode']}")
    return window_pairs({**rec, "need_wf": 1, "need_f2": rec["force"],
                         "reduce": 0, "row_weights": False})


def all_pairs(rec: dict) -> tuple:
    """(bytes, operations) of one launch of the all-pairs pass: W x B
    configurations of N particles, each unordered pair once, the potential
    and (with force) both particles' force sums and sum |F|^2."""
    W, B, N, D = rec["W"], rec["B"], rec["N"], rec["D"]
    es = ESIZE[rec["dtype"]]
    force = bool(rec["force"])
    nbytes = es * (W * B * N * D + 2 * W * B)
    pot = POT_KINDS[rec["pot_kind"]]
    per_pair = 4 * D + 2 + 1 + (OPS_V_DV[pot] if force else OPS_V[pot])
    if force:
        per_pair += 1 + 4 * D
    ops = W * B * (N * (N - 1) // 2 * per_pair + (2 * D * N if force else 0))
    return nbytes, ops


# a proposal's arithmetic per dimension: a bisection midpoint (the minimum
# images of both anchors 3 each, the mean 2, the gaussian step 2, the wrap
# 2) and the free-gaussian end guess (the minimum image 3, the midpoint 1,
# the step 2, the wrap 2)
OPS_MIDPOINT = 12
OPS_END_GUESS = 8


def cascade_move(rec: dict) -> tuple:
    """(bytes, operations) of one launch of the whole-move cascade (kernel
    5): W x S slots, each the whole move of one window of L + 1 beads.
    Bytes: the slots' windows of all N particles (each distinct bead of
    the launch's windows once per walker), the gaussians rg [L+1, D] and
    the gate uniforms ru [G] of each slot and its active flag read; each
    slot's displaced rows (ends 0..L-1, interior 1..L-1) and its decision
    written.  Operations: every gate of every slot, as if it passed each
    one: for the ends the end guess and its row (V and u; the Chin weight
    of F^2 at a chain end is 0), then level ilev's 2**(ilev-1) midpoints
    and rows (V; V and the force at the last level, whose rows are odd
    beads), both sides against N - 1 partners each."""
    W, S, N, D, L, nlev = (rec[k] for k in ("W", "S", "N", "D", "L", "nlev"))
    es = ESIZE[rec["dtype"]]
    ends = rec["mode"] == "ends"
    gates = nlev + ends
    written = L if ends else L - 1
    nbytes = (es * W * (rec["beads"] * N * D
                        + S * ((L + 1) * D + gates + written * D))
              + 2 * W * S)
    pot, jas = POT_KINDS[rec["pot_kind"]], JAS_KINDS[rec["jas_kind"]]

    def row(force, wf):
        return (2 * (N - 1) * _pair_ops(D, pot, jas, force, wf)
                + 2 * (2 * D if force else 0) + 6)

    per_slot = (OPS_END_GUESS * D + row(False, True)) if ends else 0
    for ilev in range(1, nlev + 1):
        per_slot += 2 ** (ilev - 1) * (OPS_MIDPOINT * D
                                       + row(ilev == nlev, False))
    return nbytes, W * S * per_slot


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype])
