"""The reference of the whole-move cascades (reference/cascade.py) against
the program's own plain form of them (`ops.cascade.cascade_ref`, which the
public moves reach on the CPU), both in float64 at a small size: the same
decisions and the same positions after the move, for the ends, the
interior and the rigid cascade."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import manifest, window  # noqa: E402
from pigsbench.reference import moves as ref_mv  # noqa: E402
from pigsbench.reference.physics import geometry, wrap  # noqa: E402

W, NLEV = 8, 2


@pytest.fixture(scope="module")
def setup():
    port = window.port_modules()
    wl = manifest.workload("he4.cascade_w16384")
    conf = manifest.config(wl["config"])
    fields = {**window.sim_fields({**wl, "walkers": W}, conf), "Np": 8,
              "Nb": 8, "Nlev": NLEV, "dtype": "float64"}
    system = port.system.make_system(port.config.SimConfig(**fields), "cpu")
    gen = torch.Generator().manual_seed(2 ** 31 + 1234)
    start = window.start_positions(fields, 2 ** 31 + 1234, 0.1, "cpu",
                                   torch.float64)
    M = 2 * fields["Nb"] + 1
    paths = start[:, None].expand(W, M, 8, 3) + 0.15 * torch.randn(
        (W, M, 8, 3), generator=gen, dtype=torch.float64)
    paths = wrap(paths, geometry(fields).L)
    return port, fields, system, paths.contiguous(), gen


def _reference(fields, kind, paths, a):
    slots = ref_mv.move(fields, kind, paths, a)
    dec = [ref_mv.decide(sl, sl["dS"]) for sl in slots]
    after, _ = ref_mv.apply(slots, paths, None, dec)
    return torch.stack(dec, 1), after


@pytest.mark.parametrize("kind", ["cascade_ends", "cascade_int",
                                  "cm_cascade"])
def test_reference_equals_the_programs_plain_cascade(setup, kind):
    port, fields, system, paths, gen = setup
    cas, L, D = port.cascade, 2 ** NLEV, 3
    active = torch.rand(W, generator=gen) < 0.8
    prog = paths.clone()
    if kind == "cascade_ends":
        rg = torch.randn((W, 2, L + 1, D), generator=gen, dtype=torch.float64)
        ru = torch.rand((W, 2, NLEV + 1), generator=gen, dtype=torch.float64)
        a = dict(ip=5, active=active, nlev=NLEV, rg=rg, ru=ru)
        _, acc_h, acc_t = cas.fused_ends_cascade(system, prog, **a)
        acc = torch.stack([acc_h, acc_t], 1)
    elif kind == "cascade_int":
        K = 3
        act = torch.rand((W, K), generator=gen) < 0.8
        rg = torch.randn((W, K, L + 1, D), generator=gen, dtype=torch.float64)
        ru = torch.rand((W, K, NLEV), generator=gen, dtype=torch.float64)
        a = dict(ips=[6, 1, 3], active=act, nlev=NLEV, shift=2, rg=rg, ru=ru)
        _, acc = cas.interior_cascade(system, prog, **a)
    else:
        u_dx = torch.rand((W, 1, D), generator=gen, dtype=torch.float64)
        u_acc = torch.rand(W, generator=gen, dtype=torch.float64)
        a = dict(ip=2, active=active, delta=system.geo.delta_cm, u_dx=u_dx,
                 u_acc=u_acc)
        _, acc = cas.rigid_cascade(system, prog, **a)
        acc = acc[:, None]
    dec, after = _reference(fields, kind, paths, a)
    assert torch.equal(acc, dec)
    # some slots accepted, some rejected
    assert acc.any() and not acc.all()
    assert torch.allclose(prog, after, rtol=0.0, atol=1e-12)
    assert not torch.equal(prog, paths)
