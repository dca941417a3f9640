"""Walker (dp) and partner (tp) sharding of the port over gloo ranks on the
CPU, against the unsharded port (the counterparts of tests/test_parallel.py).

Each test starts its ranks with torchrun itself (`torchrun` below: one
process per rank, every rank's output in torchrun's log directory, the
whole launch under a timeout) running tests/torch_mesh_worker.py:

  * a dp-sharded Driver run equals the unsharded port run of the same seed
    (test_parallel.py:80-137): the block averages within rtol 1e-10, the
    per-block counters of metrics.jsonl and perm_hist exactly equal, the
    gathered paths within rtol 1e-12; in four forms (the flagship default
    order, the fused composites with the exact-F^2 cache, per-walker
    windows, the staging sampler);
  * the same for dp x tp meshes (1 x 2 and 2 x 2);
  * the tp partner seam equals the plain forms without a mesh within rtol
    1e-11 (test_parallel.py:33-76), under PBC and under the trap;
  * the sharded dry run (parallel/dryrun.py) over 2 and 4 ranks.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch_bridge import other_cfg, small_cfg
from torch_mesh_worker import REPO, torchrun

from pathintegralgroundstate_torch.driver import Driver

torch.set_num_threads(1)

WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")


def run_worker(tmp_path, n, mode, cfg, blocks=1, out=None, **extra):
    """Run `mode` on n ranks (extra: more keys of the spec); returns the
    results directory."""
    res = tmp_path / f"res_{mode}_{n}"
    res.mkdir(exist_ok=True)
    spec = tmp_path / f"spec_{mode}_{n}.json"
    spec.write_text(json.dumps(dict(cfg=dataclasses.asdict(cfg),
                                    out=str(out or tmp_path / "out"),
                                    blocks=blocks, **extra)))
    rc, so, se, err = torchrun(n, [WORKER, mode, str(spec), str(res)],
                               tmp_path / f"logs_{mode}_{n}")
    assert rc == 0, "\n".join([err[-2000:]] + [
        f"rank {r}: {so[r][-1500:]}\n{se[r][-3000:]}" for r in range(n)])
    return res


def port_cfg(**kw):
    base = dict(Nstep=2, Nblock=2)
    base.update(kw)
    return other_cfg(small_cfg(**base))


def unsharded(cfg, out, blocks):
    drv = Driver(cfg.replace(mesh_walkers=1, mesh_pairs=1), out_dir=str(out),
                 device="cpu", verbose=False)
    return drv, drv.run(blocks)


def counters(path):
    """Each block's counters from a metrics.jsonl."""
    from pathintegralgroundstate_torch.sweep import COUNTER_NAMES
    rows = [json.loads(x) for x in open(path).read().splitlines()]
    return [[r[n] for n in COUNTER_NAMES] for r in rows]


def assert_matches_unsharded(tmp_path, cfg, n, blocks=2):
    res = run_worker(tmp_path, n, "run", cfg, blocks, tmp_path / "mesh")
    drv1, acc1 = unsharded(cfg, tmp_path / "one", blocks)
    z = [np.load(res / f"rank{r}.npz") for r in range(n)]
    for k in ("AvE", "AvEt", "AvK", "AvV", "diag_bl", "AvGr", "AvSk",
              "AvNr"):
        for zr in z:
            np.testing.assert_allclose(zr[f"acc_{k}"], np.asarray(acc1[k]),
                                       rtol=1e-10, atol=1e-14, err_msg=k)
    for zr in z:
        np.testing.assert_array_equal(zr["acc_perm_hist"], acc1["perm_hist"])
        np.testing.assert_allclose(zr["paths"], drv1.state.paths.numpy(),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_array_equal(zr["iworm"], drv1.state.iworm.numpy())
        assert str(zr["backend"]) == "gloo"
    assert counters(tmp_path / "mesh" / "metrics.jsonl") == counters(
        tmp_path / "one" / "metrics.jsonl")
    return z


DP_FORMS = {
    "default": {},
    "fused_exact_f2": dict(fused_sweep=True, exact_f2=True),
    "per_walker_windows": dict(shared_windows=False),
    "staging": dict(sampling="sta"),
}


@pytest.mark.parametrize("form", sorted(DP_FORMS))
def test_dp_block_matches_unsharded(tmp_path, form):
    cfg = port_cfg(mesh_walkers=2, **DP_FORMS[form])
    z = assert_matches_unsharded(tmp_path, cfg, 2)
    assert int(z[0]["collectives"]) > 0


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_dp_tp_block_matches_unsharded(tmp_path, dp, tp):
    """The partner axis split over tp (every pair call on the plain forms,
    the sums all-reduced), the walkers over dp."""
    cfg = port_cfg(mesh_walkers=dp, mesh_pairs=tp)
    assert_matches_unsharded(tmp_path, cfg, dp * tp)


@pytest.mark.parametrize("geometry", ["pbc", "trap"])
def test_tp_seam_matches_plain_forms(tmp_path, geometry):
    """Every plain pair form under tp = 2 (partners split, self mask in
    global indices, sums all-reduced) against the same form without a
    mesh, for ip an int, [W] and [W, B]."""
    kw = (dict(trap=True, dim=2, a_ho=(1.0, 1.3)) if geometry == "trap"
          else {})
    res = run_worker(tmp_path, 2, "seam", port_cfg(Np=16, **kw))
    for r in range(2):
        z = np.load(res / f"rank{r}.npz")
        assert float(z["worst"]) < 1e-11 and int(z["collectives"]) > 0


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(tmp_path, world):
    """parallel/dryrun.py, the counterpart of test_parallel.py's
    test_graft_entry_dryrun: both configurations sharded equal unsharded."""
    rc, so, se, err = torchrun(world, ["-m", "pathintegralgroundstate_torch."
                                       "parallel.dryrun", "--cpu"],
                               tmp_path / "logs")
    assert rc == 0, "\n".join([err[-2000:]] + [s[-3000:] for s in se])
    rep = json.loads(so[0].strip().splitlines()[-1])
    assert rep["world"] == world and rep["backend"] == "gloo"
    want = [world // 2, 2]
    for tag in ("default", "fused+exact_f2"):
        assert rep["dryrun"][tag]["mesh"] == want
        assert rep["dryrun"][tag]["max_rel"] < 1e-9
    assert not any(so[1:])                          # rank 0 alone prints
