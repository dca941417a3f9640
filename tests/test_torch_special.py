"""utils/special of the port (Gamma, Bessel J, Y, I, K) against scipy at
tests/test_core_math.py's tolerances, and against the JAX package's
functions in float64 to 1e-12 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch

from pathintegralgroundstate_torch.utils import special
from pathintegralgroundstate_tpu.utils import special as jspecial

XS = np.array([0.1, 0.5, 1.0, 2.0, 3.7, 5.0, 9.0, 12.0])
GAMMA_XS = np.array([0.5, 1.0, 1.5, 2.5, 3.0, 7.2, -0.5, -1.5])


def _np(t):
    return t.numpy()


def test_gamma_vs_scipy():
    got = _np(special.gamma(torch.from_numpy(GAMMA_XS)))
    np.testing.assert_allclose(got, sps.gamma(GAMMA_XS), rtol=1e-10)


@pytest.mark.parametrize("name,ref", [
    ("bessj0", lambda x: sps.jv(0, x)), ("bessj1", lambda x: sps.jv(1, x)),
    ("bessi0", lambda x: sps.iv(0, x)), ("bessi1", lambda x: sps.iv(1, x)),
])
def test_bessel_j_i_01(name, ref):
    got = _np(getattr(special, name)(torch.from_numpy(XS)))
    np.testing.assert_allclose(got, ref(XS), rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("name,ref", [
    ("bessy0", lambda x: sps.yv(0, x)), ("bessy1", lambda x: sps.yv(1, x)),
    ("bessk0", lambda x: sps.kv(0, x)), ("bessk1", lambda x: sps.kv(1, x)),
])
def test_bessel_y_k_01(name, ref):
    xs = XS[:-1]
    got = _np(getattr(special, name)(torch.from_numpy(xs)))
    np.testing.assert_allclose(got, ref(xs), rtol=3e-6, atol=3e-7)


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("name,ref,tol", [
    ("bessj", sps.jv, dict(rtol=2e-6, atol=2e-7)),
    ("bessi", sps.iv, dict(rtol=2e-6, atol=2e-7)),
    ("bessy", sps.yv, dict(rtol=3e-6, atol=3e-7)),
    ("bessk", sps.kv, dict(rtol=3e-6, atol=3e-7)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_bessel_n_vs_scipy(name, ref, tol, n):
    """The integer orders (power series, recurrences) at the 0/1 orders'
    tolerances, negative arguments too where the function is defined."""
    xs = np.concatenate([XS, -XS]) if name in ("bessj", "bessi") else XS
    got = _np(getattr(special, name)(n, torch.from_numpy(xs)))
    np.testing.assert_allclose(got, ref(n, xs), **tol)


FNS = ["bessj0", "bessj1", "bessy0", "bessy1", "bessi0", "bessi1", "bessk0",
       "bessk1"]


@pytest.mark.parametrize("name", FNS + [f"{f}{n}" for f in ("bessj", "bessy",
                                                             "bessi", "bessk")
                                        for n in (2, 3, 5)] + ["gamma"])
def test_matches_jax_float64(name):
    """The same numbers as the JAX package's functions, float64, 1e-12."""
    if name == "gamma":
        xs = GAMMA_XS
        got = special.gamma(torch.from_numpy(xs))
        want = jspecial.gamma(jnp.asarray(xs))
    elif name in FNS:
        xs = np.concatenate([XS, -XS]) if name[4] in "ji" else XS
        got = getattr(special, name)(torch.from_numpy(xs))
        want = getattr(jspecial, name)(jnp.asarray(xs))
    else:
        fn, n = name[:5], int(name[5:])
        xs = np.concatenate([XS, -XS]) if fn in ("bessj", "bessi") else XS
        got = getattr(special, fn)(n, torch.from_numpy(xs))
        want = getattr(jspecial, fn)(n, jnp.asarray(xs))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12,
                               atol=0)


def test_python_floats_are_float64():
    assert special.bessj0(2.0).dtype == torch.float64
    assert special.gamma(3).item() == pytest.approx(2.0, rel=1e-14)
