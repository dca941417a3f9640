"""The torch Sweeper.step against the reference Sweeper.step.

The reference state is burned in with its own jitted step until some
walkers are open (worm sector) and some closed, carried into the port with
state_from_numpy, and both run 2 steps on the reference's own draws
(tests/torch_bridge.JaxDraws): states and counters equal, stats at rtol 1e-9.
The same for a 2-D He-4 film under PBC (density 0.26 sigma^-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import assert_step_pair, other_cfg, JaxDraws, small_cfg, \
    step_pair

from pathintegralgroundstate_torch.state import state_from_numpy, \
    state_to_numpy
from pathintegralgroundstate_torch.sweep import COUNTER_NAMES, Sweeper, \
    StepStats, run_block, stats_to_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import sweep as jsweep
from pathintegralgroundstate_tpu.state import init_state as j_init_state
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

FIELDS = ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm", "step")
NSTEP = 2


@pytest.fixture(scope="module")
def runs():
    cfg = small_cfg()
    jsys = j_make_system(cfg)
    step = jax.jit(jsweep.Sweeper(jsys, make_tables(jsys)).step)
    st, stats = j_init_state(jsys), jsweep.zero_stats(jsys)
    for _ in range(150):
        st, stats = step(st, stats)
    burned = st

    ref_stats = jsweep.zero_stats(jsys)
    for _ in range(NSTEP):
        st, ref_stats = step(st, ref_stats)

    tsys = make_system(other_cfg(cfg), "cpu")
    state = state_from_numpy(tsys, {k: getattr(burned, k) for k in FIELDS})
    state, stats = run_block(Sweeper(tsys), state, NSTEP,
                             JaxDraws(burned.key, cfg.dim, jnp.float64))
    return burned, st, ref_stats, state, stats


def test_burn_in_reaches_both_sectors(runs):
    burned = runs[0]
    nopen = int(np.sum(np.asarray(burned.isopen)))
    assert 0 < nopen < burned.paths.shape[0]


def test_step_state_matches_reference(runs):
    _, ref, _, state, _ = runs
    got = state_to_numpy(state)
    np.testing.assert_allclose(got["paths"], np.asarray(ref.paths),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["xend"], np.asarray(ref.xend),
                               rtol=1e-10, atol=1e-12)
    for k in ("isopen", "iworm", "in_cycle", "iperm", "step"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)


def test_step_counters_match_reference(runs):
    _, _, ref_stats, _, stats = runs
    got = stats_to_numpy(stats)["counters"]
    want = np.asarray(ref_stats.counters)
    assert COUNTER_NAMES == jsweep.COUNTER_NAMES
    np.testing.assert_array_equal(got, want)
    c = dict(zip(COUNTER_NAMES, got))
    assert c["try_cm"] > 0 and c["try_cm_half"] > 0 and c["try_swap"] > 0


def test_step_stats_match_reference(runs):
    _, _, ref_stats, _, stats = runs
    got = stats_to_numpy(stats)
    assert StepStats._fields == jsweep.StepStats._fields
    for k in StepStats._fields:
        if k != "counters":
            np.testing.assert_allclose(got[k], np.asarray(getattr(ref_stats,
                                                                  k)),
                                       rtol=1e-9, atol=1e-12, err_msg=k)


def test_2d_film_step_matches_reference():
    """The flagship's moves on a 2-D He-4 film (aziz2, mcmillan_c1, PBC) at
    density 0.26 sigma^-2: states and counters equal, stats at rtol 1e-9."""
    cfg = small_cfg(dim=2, density=0.26)
    ctr = assert_step_pair(*step_pair(cfg, nstep=NSTEP),
                           dict(rtol=1e-10, atol=1e-12))
    c = dict(zip(COUNTER_NAMES, ctr))
    assert c["try_cm"] > 0 and c["try_cm_half"] > 0 and c["try_swap"] > 0
