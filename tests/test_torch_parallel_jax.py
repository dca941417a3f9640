"""The sharded port against the reference on the reference's own draws.

A dp 2 x tp 2 mesh of four gloo ranks on the CPU runs a block of the port
from a burned-in reference state, on the draws of the reference's step
(tests/torch_bridge.JaxDraws, logged for all walkers by an unsharded port
run and replayed on each rank, which keeps its rows as DeviceDraws._keep
does).  Every rank's gathered paths and block statistics are held to the
reference's block from the same state: the new sharded arithmetic (each
rank's walker rows, its N/tp partners with the self mask in global
indices, the one-body terms on tp rank 0, the sums all-reduced before the
Metropolis test, the statistics summed over dp) against
pathintegralgroundstate_tpu itself.  Float64: paths and statistics within
rtol 1e-10, the integer state and the counters exactly equal.  Two forms:
the flagship's default order with shared windows, and per-walker windows,
whose per-walker starts are walker rows like any other draw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import run_worker
from torch_bridge import STATE_FIELDS, JaxDraws, burn_ref, other_cfg, \
    small_cfg

from pathintegralgroundstate_torch.state import state_from_numpy
from pathintegralgroundstate_torch.sweep import Sweeper, run_block
from pathintegralgroundstate_torch.system import make_system

torch.set_num_threads(1)

NSTEP = 2
FORMS = {"default": {}, "per_walker_windows": dict(shared_windows=False)}


class Recorder:
    """Passes a draw source through and logs each call as (site, result)."""

    def __init__(self, src):
        self.src, self.log = src, []

    def __getattr__(self, site):
        def call(*args, **kw):
            out = getattr(self.src, site)(*args, **kw)
            self.log.append((site, out))
            return out
        return call


@pytest.mark.parametrize("form", sorted(FORMS))
def test_dp_tp_block_matches_reference(tmp_path, form):
    cfg = small_cfg(**FORMS[form])
    burned, ref, ref_stats = burn_ref(cfg, NSTEP)
    start = {k: np.asarray(getattr(burned, k)) for k in STATE_FIELDS}
    tsys = make_system(other_cfg(cfg), "cpu")
    rec = Recorder(JaxDraws(burned.key, cfg.dim, jnp.float64,
                            cfg.shared_windows))
    run_block(Sweeper(tsys), state_from_numpy(tsys, start), NSTEP, rec)
    if form == "per_walker_windows":
        starts = [o[0] for s, o in rec.log if s == "bisect_keyed"]
        assert starts and all(torch.is_tensor(x) for x in starts)
    np.savez(tmp_path / "start.npz", **start)
    torch.save(rec.log, tmp_path / "draws.pt")
    res = run_worker(tmp_path, 4, "replay",
                     other_cfg(cfg).replace(mesh_walkers=2, mesh_pairs=2),
                     NSTEP, start=str(tmp_path / "start.npz"),
                     draws=str(tmp_path / "draws.pt"))
    for r in range(4):
        z = np.load(res / f"rank{r}.npz")
        assert int(z["collectives"]) > 0
        for k in STATE_FIELDS:
            want = np.asarray(getattr(ref, k))
            if k in ("paths", "xend"):
                np.testing.assert_allclose(z[f"state_{k}"], want, rtol=1e-10,
                                           atol=1e-12, err_msg=f"{r} {k}")
            else:
                np.testing.assert_array_equal(z[f"state_{k}"], want,
                                              err_msg=f"{r} {k}")
        for k in ref_stats._fields:
            want = np.asarray(getattr(ref_stats, k))
            if k == "counters":
                np.testing.assert_array_equal(z[f"stats_{k}"], want)
            else:
                np.testing.assert_allclose(z[f"stats_{k}"], want, rtol=1e-10,
                                           atol=1e-12, err_msg=f"{r} {k}")
