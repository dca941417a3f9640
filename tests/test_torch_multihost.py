"""The port's multi-process Driver discipline over gloo ranks on the CPU
(the counterparts of tests/test_multihost.py and of test_parallel.py's
test_distributed_init_path):

  * two processes with distributed=True over a dp = 2 mesh compute the same
    replicated averages, equal to the single-process run; only rank 0
    writes e_vpi.out, metrics.jsonl and checkpoint.npz, and the checkpoint
    holds the whole gathered ensemble;
  * distributed=True in one process initialises the process group from
    torchrun's environment and runs a block;
  * a checkpoint written by 2 ranks resumes on 1 and the other way round,
    each equal to the uninterrupted run;
  * a rank other than 0 creates no output directory;
  * the mesh's errors (a world that does not match, W or Np not divisible,
    distributed without torchrun's environment) and a resume without the
    checkpoint on a rank raise as the reference's do;
  * the CLI under torchrun: rank 0 alone prints.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from test_torch_parallel import port_cfg, run_worker, unsharded
from torch_mesh_worker import ENV, REPO, torchrun

from pathintegralgroundstate_torch.config import namelist_text
from pathintegralgroundstate_torch.driver import Driver

torch.set_num_threads(1)


def staging_cfg(**kw):
    """test_multihost.py's configuration (_CFG_KW)."""
    base = dict(Nb=4, sampling="sta", Lstag=4, Nobdm=1, seed=5)
    base.update(kw)
    return port_cfg(**base)


def test_two_process_cluster_matches_single_process(tmp_path):
    cfg = staging_cfg(mesh_walkers=2)
    out = tmp_path / "cluster"
    res = run_worker(tmp_path, 2, "run", cfg, 2, out)
    z0, z1 = (np.load(res / f"rank{r}.npz") for r in range(2))
    for k in ("AvE", "AvEt", "AvK", "AvGr", "perm_hist"):
        np.testing.assert_allclose(z0[f"acc_{k}"], z1[f"acc_{k}"],
                                   rtol=1e-12, err_msg=k)
    _, acc1 = unsharded(cfg, tmp_path / "single", 2)
    for k in ("AvE", "AvEt", "AvK"):
        np.testing.assert_allclose(z0[f"acc_{k}"], acc1[k], rtol=1e-10)
    np.testing.assert_allclose(z0["acc_AvGr"].sum(), acc1["AvGr"].sum(),
                               rtol=1e-10)
    np.testing.assert_array_equal(z0["acc_perm_hist"], acc1["perm_hist"])
    assert len((out / "e_vpi.out").read_text().splitlines()) == 2
    rows = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and {r["backend"] for r in rows} == {"gloo"}
    assert all(r["mesh"] == [2, 1] for r in rows)
    ck = np.load(out / "checkpoint.npz")
    assert ck["paths"].shape[0] == cfg.n_walkers
    np.testing.assert_allclose(ck["paths"], z0["paths"], rtol=1e-15)


def test_distributed_init_path(tmp_path):
    """distributed=True in one process: the process group comes up from
    torchrun's environment (world 1), the block runs, the backend is named
    in metrics.jsonl."""
    res = run_worker(tmp_path, 1, "run", staging_cfg(Nblock=1), 1,
                     tmp_path / "out")
    z = np.load(res / "rank0.npz")
    assert str(z["backend"]) == "gloo" and int(z["acc_iblock"]) == 1
    rec = json.loads((tmp_path / "out" / "metrics.jsonl").read_text())
    assert rec["backend"] == "gloo" and rec["try_cm"] > 0


@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_checkpoint_resumes_across_layouts(tmp_path, direction):
    """One block under one layout, its checkpoint resumed for a second
    block under the other: the run equals two uninterrupted blocks."""
    cfg = port_cfg(mesh_walkers=2)
    out = tmp_path / "run"
    if direction == "2to1":
        run_worker(tmp_path, 2, "run", cfg, 1, out)
        drv = Driver(cfg.replace(mesh_walkers=1, resume=True),
                     out_dir=str(out), device="cpu", verbose=False)
        acc = drv.run(1)
        paths = drv.state.paths.numpy()
    else:
        unsharded(cfg, out, 1)
        res = run_worker(tmp_path, 2, "run", cfg.replace(resume=True), 1,
                         out)
        z = np.load(res / "rank0.npz")
        acc = {k[4:]: z[k] for k in z.files if k.startswith("acc_")}
        paths = z["paths"]
    drv2, acc2 = unsharded(cfg, tmp_path / "straight", 2)
    assert int(acc["iblock"]) == 2
    for k in ("AvE", "AvEt", "AvK", "AvV", "AvGr"):
        np.testing.assert_allclose(acc[k], acc2[k], rtol=1e-10, err_msg=k)
    np.testing.assert_array_equal(acc["perm_hist"], acc2["perm_hist"])
    np.testing.assert_allclose(paths, drv2.state.paths.numpy(), rtol=1e-12,
                               atol=1e-13)
    assert len((out / "e_vpi.out").read_text().splitlines()) == 2


def test_only_rank0_writes(tmp_path):
    """Each rank named its own output directory: only rank 0's exists."""
    run_worker(tmp_path, 2, "run", port_cfg(mesh_walkers=2), 1,
               str(tmp_path / "out{rank}"))
    assert sorted(os.listdir(tmp_path / "out0")) == [
        "checkpoint.npz", "e_vpi.out", "et_vpi.out", "gr_vpi.out",
        "metrics.jsonl", "nr_vpi.out", "perm_histogram.out", "sk_vpi.out"]
    assert not (tmp_path / "out1").exists()


def test_mesh_errors(tmp_path, monkeypatch):
    """driver.py:119-130's ValueErrors, with the process group in place of
    the visible devices; distributed=True without torchrun's environment
    raises and names the torchrun command."""
    with pytest.raises(ValueError, match=r"mesh_walkers\*mesh_pairs=2 does "
                       r"not match the 1 ranks.*torchrun --nproc-per-node 2"):
        Driver(port_cfg(mesh_walkers=2), out_dir=str(tmp_path), device="cpu",
               verbose=False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        Driver(port_cfg(distributed=True), out_dir=str(tmp_path),
               device="cpu", verbose=False)
    res = run_worker(tmp_path, 2, "errors", port_cfg())
    for r in range(2):
        msgs = json.loads((res / f"rank{r}.json").read_text())
        assert msgs == ["n_walkers=7 must divide mesh_walkers=2",
                        "Np=9 must divide mesh_pairs=2"]


def test_missing_checkpoint_raises(tmp_path):
    """resume=True over several ranks without the checkpoint on a rank's
    storage raises on that rank rather than start it fresh."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(
        cfg=dataclasses.asdict(port_cfg(mesh_walkers=2, resume=True)),
        out=str(tmp_path / "empty"), blocks=1)))
    rc, _, se, _ = torchrun(2, [os.path.join(REPO, "tests",
                                             "torch_mesh_worker.py"),
                                "run", str(spec), str(tmp_path)],
                            tmp_path / "logs")
    assert rc != 0 and any("is not visible on rank" in s for s in se), [
        s[-800:] for s in se]


def test_cli_under_torchrun(tmp_path):
    """The CLI as torchrun starts it: distributed comes on from the
    environment, the run is sharded, rank 0 alone prints and writes."""
    nml = tmp_path / "small.in"
    nml.write_text(namelist_text(port_cfg(Nblock=2)))
    rc, so, se, err = torchrun(2, ["-m", "pathintegralgroundstate_torch",
                                   str(nml), "-o", str(tmp_path / "out"),
                                   "--set", "mesh_walkers=2"],
                               tmp_path / "logs",
                               env=dict(ENV, PIGS_PLATFORM="cpu"))
    assert rc == 0, "\n".join([err[-2000:]] + [s[-3000:] for s in se])
    assert "BLOCK NUMBER : 2" in so[0]
    assert "backend gloo, mesh dp x tp = 2 x 1" in so[0]
    assert so[1] == ""
    assert len((tmp_path / "out" / "e_vpi.out").read_text()
               .splitlines()) == 2
