"""The brute exact-F^2 step (exact_f2=True, f2_cache=False: F^2(R') - F^2(R)
of the whole configurations by kernel B's plain form here) against the
reference step on its own draws (tests/torch_bridge.step_pair), for the
flagship, the reference order (the dense exact gate), the fused sweep and
the worm phase under staging: rtol 1e-10, atol 1e-12, counters equal.  A
file of its own beside tests/test_torch_exact_f2.py, so that the JAX step
compiles of the two halves run on different workers.
"""

import pytest
import torch
from test_torch_exact_f2 import FORMS, check_step

torch.set_num_threads(1)


@pytest.mark.parametrize("form", list(FORMS))
def test_brute_step_matches_reference(form):
    check_step(form, False)
