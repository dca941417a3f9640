"""Special functions: Gamma and the Bessel families J, Y, I, K.

The torch counterpart of pathintegralgroundstate_tpu/utils/special.py
(the reference's r8_gamma.f90:1-259 and bessel_mod.f90:5-396), with its
own numerics, not torch.special's: Gamma from lgamma with the reflection
formula for x < 0, the Bessel functions from the Abramowitz & Stegun
9.4/9.8 rational approximations below a threshold and the asymptotic forms
above it, power series for J_n (|x| <= n) and I_n, and the recurrences
for J_n, Y_n and K_n, in the same operations as the reference, branch-free
on tensors.  Inputs that are not tensors become float64 tensors.
"""

from __future__ import annotations

import math

import torch


def _t(x):
    """x as a floating tensor (float64 unless it is a float tensor)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(x, dtype=torch.float64)


def gamma(x):
    """Gamma(x) for real x (poles at non-positive integers -> inf/nan):
    exp(lgamma(x)) for x > 0, pi / (sin(pi x) Gamma(1 - x)) below."""
    x = _t(x)
    one = torch.ones_like(x)
    pos = torch.exp(torch.lgamma(torch.where(x > 0, x, one)))
    neg = math.pi / (torch.sin(math.pi * x) * torch.exp(
        torch.lgamma(torch.where(x > 0, one, 1.0 - x))))
    return torch.where(x > 0, pos, neg)


def _poly(x, coeffs):
    """Horner's rule, highest coefficient first (special.py:36-40)."""
    out = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


def _floor(x):
    return torch.clamp(x, min=1e-30)


# --- Bessel J ---------------------------------------------------------------

_P0 = [1.0, -0.1098628627e-2, 0.2734510407e-4, -0.2073370639e-5,
       0.2093887211e-6][::-1]
_Q0 = [-0.1562499995e-1, 0.1430488765e-3, -0.6911147651e-5,
       0.7621095161e-6, -0.934935152e-7][::-1]
_P1 = [1.0, 0.183105e-2, -0.3516396496e-4, 0.2457520174e-5,
       -0.240337019e-6][::-1]
_Q1 = [0.04687499995, -0.2002690873e-3, 0.8449199096e-5, -0.88228987e-6,
       0.105787412e-6][::-1]


def bessj0(x):
    x = _t(x)
    ax = torch.abs(x)
    y = x * x
    num = _poly(y, [-184.9052456, 77392.33017, -11214424.18, 651619640.7,
                    -13362590354.0, 57568490574.0])
    den = _poly(y, [1.0, 267.8532712, 59272.64853, 9494680.718,
                    1029532985.0, 57568490411.0])
    small = num / den
    z = 8.0 / _floor(ax)
    y2 = z * z
    xx = ax - 0.785398164
    large = torch.sqrt(0.636619772 / ax) * (
        torch.cos(xx) * _poly(y2, _P0) - z * torch.sin(xx) * _poly(y2, _Q0))
    return torch.where(ax < 8.0, small, large)


def bessj1(x):
    x = _t(x)
    ax = torch.abs(x)
    y = x * x
    num = x * _poly(y, [-30.16036606, 15704.48260, -2972611.439,
                        242396853.1, -7895059235.0, 72362614232.0])
    den = _poly(y, [1.0, 376.9991397, 99447.43394, 18583304.74,
                    2300535178.0, 144725228442.0])
    small = num / den
    z = 8.0 / _floor(ax)
    y2 = z * z
    xx = ax - 2.356194491
    large = torch.sqrt(0.636619772 / ax) * (
        torch.cos(xx) * _poly(y2, _P1) - z * torch.sin(xx) * _poly(y2, _Q1))
    large = large * torch.sign(x)
    return torch.where(ax < 8.0, small, large)


def _jn_series(n: int, x, sign: float, terms: int = 40):
    """sum_k sign^k (x/2)^(n+2k) / (k! (n+k)!): J (sign=-1) or I
    (sign=+1); accurate in float64 for |x| up to about 30."""
    h = 0.5 * x
    h2 = h * h
    t = h ** n / math.factorial(n)
    out = t
    for k in range(1, terms):
        t = t * sign * h2 / (k * (n + k))
        out = out + t
    return out


def bessj(n: int, x):
    """J_n(x) for integer n >= 0: the power series for |x| <= n (where the
    upward recurrence is unstable), the upward recurrence from J0, J1
    beyond."""
    if n == 0:
        return bessj0(x)
    if n == 1:
        return bessj1(x)
    x = _t(x)
    ax = torch.abs(x)
    tox = 2.0 / _floor(ax)
    bjm, bj = bessj0(ax), bessj1(ax)
    for j in range(1, n):
        bjm, bj = bj, j * tox * bj - bjm
    res = torch.where(ax > n, bj, _jn_series(n, ax, -1.0))
    if n % 2 == 1:
        res = torch.where(x < 0, -res, res)
    return res


# --- Bessel Y ---------------------------------------------------------------

def bessy0(x):
    x = _t(x)
    y = x * x
    num = _poly(y, [228.4622733, -86327.92757, 10879881.29, -512359803.6,
                    7062834065.0, -2957821389.0])
    den = _poly(y, [1.0, 226.1030244, 47447.26470, 7189466.438,
                    745249964.8, 40076544269.0])
    small = num / den + 0.636619772 * bessj0(x) * torch.log(_floor(x))
    z = 8.0 / _floor(x)
    y2 = z * z
    xx = x - 0.785398164
    large = torch.sqrt(0.636619772 / x) * (
        torch.sin(xx) * _poly(y2, _P0) + z * torch.cos(xx) * _poly(y2, _Q0))
    return torch.where(x < 8.0, small, large)


def bessy1(x):
    x = _t(x)
    y = x * x
    num = x * _poly(y, [0.8511937935e4, -0.4237922726e7, 0.7349264551e9,
                        -0.5153438139e11, 0.1275274390e13, -0.4900604943e13])
    den = _poly(y, [1.0, 0.3549632885e3, 0.1020426050e6, 0.2245904002e8,
                    0.3733650367e10, 0.4244419664e12, 0.2499580570e14])
    small = num / den + 0.636619772 * (bessj1(x) * torch.log(_floor(x))
                                       - 1.0 / _floor(x))
    z = 8.0 / _floor(x)
    y2 = z * z
    xx = x - 2.356194491
    large = torch.sqrt(0.636619772 / x) * (
        torch.sin(xx) * _poly(y2, _P1) + z * torch.cos(xx) * _poly(y2, _Q1))
    return torch.where(x < 8.0, small, large)


def bessy(n: int, x):
    """Y_n(x) for integer n >= 0 by the upward recurrence."""
    if n == 0:
        return bessy0(x)
    if n == 1:
        return bessy1(x)
    x = _t(x)
    tox = 2.0 / x
    bym, by = bessy0(x), bessy1(x)
    for j in range(1, n):
        bym, by = by, j * tox * by - bym
    return by


# --- Modified Bessel I, K ---------------------------------------------------

def bessi0(x):
    x = _t(x)
    ax = torch.abs(x)
    y = (x / 3.75) ** 2
    small = _poly(y, [1.0, 3.5156229, 3.0899424, 1.2067492,
                      0.2659732, 0.360768e-1, 0.45813e-2][::-1])
    y2 = 3.75 / _floor(ax)
    large = (torch.exp(ax) / torch.sqrt(_floor(ax))) * _poly(
        y2, [0.39894228, 0.1328592e-1, 0.225319e-2, -0.157565e-2, 0.916281e-2,
             -0.2057706e-1, 0.2635537e-1, -0.1647633e-1, 0.392377e-2][::-1])
    return torch.where(ax < 3.75, small, large)


def bessi1(x):
    x = _t(x)
    ax = torch.abs(x)
    y = (x / 3.75) ** 2
    small = ax * _poly(y, [0.5, 0.87890594, 0.51498869, 0.15084934,
                           0.2658733e-1, 0.301532e-2, 0.32411e-3][::-1])
    y2 = 3.75 / _floor(ax)
    large = (torch.exp(ax) / torch.sqrt(_floor(ax))) * _poly(
        y2, [0.39894228, -0.3988024e-1, -0.362018e-2, 0.163801e-2,
             -0.1031555e-1, 0.2282967e-1, -0.2895312e-1, 0.1787654e-1,
             -0.420059e-2][::-1])
    res = torch.where(ax < 3.75, small, large)
    return torch.where(x < 0, -res, res)


def bessi(n: int, x):
    """I_n(x) for integer n >= 0, n >= 2 by the (monotone) power series,
    accurate in float64 for |x| up to about 30."""
    if n == 0:
        return bessi0(x)
    if n == 1:
        return bessi1(x)
    x = _t(x)
    ax = torch.abs(x)
    res = _jn_series(n, ax, +1.0, terms=60)
    if n % 2 == 1:
        res = torch.where(x < 0, -res, res)
    return res


def bessk0(x):
    x = _t(x)
    y_s = x * x / 4.0
    small = -torch.log(_floor(x) / 2.0) * bessi0(x) + _poly(
        y_s, [-0.57721566, 0.42278420, 0.23069756, 0.3488590e-1,
              0.262698e-2, 0.10750e-3, 0.74e-5][::-1])
    y_l = 2.0 / _floor(x)
    large = (torch.exp(-x) / torch.sqrt(_floor(x))) * _poly(
        y_l, [1.25331414, -0.7832358e-1, 0.2189568e-1, -0.1062446e-1,
              0.587872e-2, -0.251540e-2, 0.53208e-3][::-1])
    return torch.where(x <= 2.0, small, large)


def bessk1(x):
    x = _t(x)
    y_s = x * x / 4.0
    small = torch.log(_floor(x) / 2.0) * bessi1(x) + (1.0 / _floor(x)) * _poly(
        y_s, [1.0, 0.15443144, -0.67278579, -0.18156897, -0.1919402e-1,
              -0.110404e-2, -0.4686e-4][::-1])
    y_l = 2.0 / _floor(x)
    large = (torch.exp(-x) / torch.sqrt(_floor(x))) * _poly(
        y_l, [1.25331414, 0.23498619, -0.3655620e-1, 0.1504268e-1,
              -0.780353e-2, 0.325614e-2, -0.68245e-3][::-1])
    return torch.where(x <= 2.0, small, large)


def bessk(n: int, x):
    """K_n(x) for integer n >= 0 by the stable upward recurrence."""
    if n == 0:
        return bessk0(x)
    if n == 1:
        return bessk1(x)
    x = _t(x)
    tox = 2.0 / x
    bkm, bk = bessk0(x), bessk1(x)
    for j in range(1, n):
        bkm, bk = bk, j * tox * bk + bkm
    return bk
