"""The kernel routes (ops/kernels.py) and the plug-in potential.

use_pallas=False turns all five kernel routes off (rows_route for kernel
A, cascade_route for 5, pair_route for B and 3, u_route for 4, and
action_route through them), as the reference's pallas_ok, pallas_ok_wf and
use_cascade_kernel do: on the flagship, the dipolar gas and the trapped
worm.  A potential registered with models/potentials.register has no
kernel kind: every route is off for it.  A registered copy of the soft
core gives the built-in soft's block bit for bit through the plain forms,
and the JAX package's block with the same potential registered there, on
the reference's draws (rtol 1e-10 on the paths, exact counters).  The
card's side (0 launches) is chip_smoke.py's [routes] phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import JaxDraws, other_cfg, small_cfg

from pathintegralgroundstate_torch.flagship import dipolar_cfg, flagship_cfg, \
    trap_worm_cfg
from pathintegralgroundstate_torch.models import potentials as tpot
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.state import init_state, state_from_numpy
from pathintegralgroundstate_torch.sweep import Sweeper, run_block, \
    stats_to_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.models import potentials as jpot

torch.set_num_threads(1)

ROUTES = (kernels.rows_route, kernels.cascade_route, kernels.pair_route,
          kernels.u_route, kernels.action_route)
CFGS = {"flagship": flagship_cfg(8), "dipolar": dipolar_cfg(8),
        "trap": trap_worm_cfg(1, 8)}
PLUGIN = "soft_plugin"


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", list(CFGS))
def test_use_pallas_turns_every_route_off(name, use_pallas):
    system = make_system(CFGS[name].replace(use_pallas=use_pallas), "cpu")
    want = use_pallas and name != "trap"
    assert [f(system) for f in ROUTES] == [want] * len(ROUTES)


@pytest.fixture(scope="module")
def plugin():
    """The soft core registered under one name in both packages: the
    port's with the built-in soft's own functions, the reference's with
    its _soft_factory."""
    soft = tpot.get_potential("soft")
    tpot.register(PLUGIN, soft.v, soft.dvdr)
    jpot.register(PLUGIN, *jpot._soft_factory())
    return soft


def test_registered_potential_routes_to_plain_forms(plugin):
    pot = tpot.get_potential(PLUGIN)
    assert pot.kind is None and pot.name == PLUGIN
    system = make_system(flagship_cfg(8).replace(potential=PLUGIN), "cpu")
    assert not any(f(system) for f in ROUTES)
    r = torch.linspace(0.8, 2.0, 7, dtype=torch.float64)
    v, dv = pot.v_dv(r, 1.0 / r)
    assert torch.equal(v, plugin.v(r)) and torch.equal(dv, plugin.dvdr(r))
    with pytest.raises(KeyError, match="unknown potential"):
        tpot.get_potential("no_such_potential")


def _block(cfg, draws=None, start=None):
    system = make_system(cfg, "cpu")
    state = init_state(system) if start is None else \
        state_from_numpy(system, start)
    return run_block(Sweeper(system), state, 2, draws)


def test_registered_soft_equals_builtin_soft(plugin):
    """Through the plain forms the registered copy is the built-in soft:
    the same block bit for bit (the flagship's default order, worm on)."""
    cfg = other_cfg(small_cfg(potential="soft", Nstep=2))
    s1, st1 = _block(cfg)
    s2, st2 = _block(cfg.replace(potential=PLUGIN))
    assert torch.equal(s1.paths, s2.paths)
    for a, b in zip(stats_to_numpy(st1).values(),
                    stats_to_numpy(st2).values()):
        np.testing.assert_array_equal(a, b)


def test_registered_potential_matches_jax(plugin):
    """The port's block with the registered potential equals the JAX
    block with the same potential registered there, on its draws (the
    staging sampler without the worm, from the JAX initial state)."""
    from pathintegralgroundstate_tpu import sweep as jsweep
    from pathintegralgroundstate_tpu.state import init_state as jinit
    from pathintegralgroundstate_tpu.system import make_system as jmake
    from pathintegralgroundstate_tpu.system import make_tables

    jcfg = small_cfg(potential=PLUGIN, sampling="sta", CWorm=0.0,
                     swapping=False)
    jsys = jmake(jcfg)
    tables = make_tables(jsys)
    jsw = jsweep.Sweeper(jsys, tables)
    st0 = jinit(jsys)
    st, jstats = jax.jit(lambda s: jsweep.run_block(jsys, tables, jsw, s,
                                                    2))(st0)
    start = {k: getattr(st0, k) for k in (
        "paths", "xend", "isopen", "iworm", "in_cycle", "iperm", "step")}
    state, stats = _block(other_cfg(jcfg),
                          JaxDraws(st0.key, jcfg.dim, jnp.float64), start)
    np.testing.assert_allclose(state.paths.numpy(), np.asarray(st.paths),
                               rtol=1e-10, atol=1e-12)
    got = stats_to_numpy(stats)
    np.testing.assert_array_equal(got["counters"],
                                  np.asarray(jstats.counters))
    for k in ("sumE", "sumEt", "sumV"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jstats, k)),
                                   rtol=1e-9, err_msg=k)
