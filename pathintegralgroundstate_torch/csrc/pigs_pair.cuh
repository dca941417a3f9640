// Shared pair physics of the hand-written Hopper kernels (pair_rows.cu,
// pair_pot.cu, pair_delta.cu, cascade.cu): the single-image minimum image,
// the pair-model selector, the closed-form potentials and the two-body
// Jastrows.  Every formula follows the plain-PyTorch forms in models/,
// which follow pathintegralgroundstate_tpu/models operation for operation.
//
// The selector.  The pair model is two template parameters of every kernel
// that evaluates it: the potential PK (enum PotKind: Aziz, whose aziz2 and
// aziz1 share the form and differ in the constants, the soft sphere
// V0 (1/r^6 - 1)/r^6, the dipolar Cdd/r^3, or none, the ideal gas, whose
// pass sums zero terms) and the Jastrow JK (enum JasKind: McMillan
// -1/2 (Rm/r)^5, the 2-D dipolar -2 sqrt(Rm/r), or none), each Jastrow
// C1-shifted at rcut when the runtime flag c1 is set (the System sets it
// for mcmillan_c1 and dipolar2d under PBC).  Both Jastrows come from
// q = Rm/r, which the row passes take from the one reciprocal square root.
// Each launcher picks the instantiation from PairParams::pot_kind and
// ::jas_kind (with_pair_model), so the Aziz + McMillan instantiation is the
// code it was before the selector: a runtime Jastrow switch measured 14 %
// slower on kernel A at the flagship's shape (PERF.md).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

enum PotKind { kAziz = 0, kSoft = 1, kDipolar = 2, kPotNone = 3 };
enum JasKind { kMcMillan = 0, kDipolar2d = 1, kJasNone = 2 };

// Host-side parameter block, filled field for field by ops/kernels.py
// (ctypes.Structure _PairParams).  Doubles first, ints last: no padding.
struct PairParams {
  double L[3];
  double half[3];
  double rcut2;
  double V0, V0s, s, s_inv, A, neg_alpha, beta, two_beta;
  double C6, C8, C10, Dcore, d_min, d_min_inv, two_C8, four_C10;
  double Rm, rc, u_rc, du_rc;
  double soft_V0, Cdd;
  int c1;
  int dim;
  int pot_kind;  // enum PotKind
  int jas_kind;  // enum JasKind
};

// The same constants in the kernel's working type.
template <typename T>
struct Consts {
  T L[3], half[3], rcut2;
  T V0, V0s, s, s_inv, A, neg_alpha, beta, two_beta;
  T C6, C8, C10, Dcore, d_min, d_min_inv, two_C8, four_C10;
  T Rm, rc, u_rc, du_rc;
  T soft_V0, Cdd;
  int c1, dim;
};

// fn(std::integral_constant<int, PK>) for the PotKind `kind`: the host
// side of the selector.
template <typename Fn>
inline int with_pot_kind(int kind, Fn&& fn) {
  switch (kind) {
    case kAziz:
      return fn(std::integral_constant<int, kAziz>{});
    case kSoft:
      return fn(std::integral_constant<int, kSoft>{});
    case kDipolar:
      return fn(std::integral_constant<int, kDipolar>{});
    case kPotNone:
      return fn(std::integral_constant<int, kPotNone>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// fn(std::integral_constant<int, JK>) for the JasKind `kind`.
template <typename Fn>
inline int with_jas_kind(int kind, Fn&& fn) {
  switch (kind) {
    case kMcMillan:
      return fn(std::integral_constant<int, kMcMillan>{});
    case kDipolar2d:
      return fn(std::integral_constant<int, kDipolar2d>{});
    case kJasNone:
      return fn(std::integral_constant<int, kJasNone>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// fn(PK, JK) for the pair model of p.
template <typename Fn>
inline int with_pair_model(const PairParams& p, Fn&& fn) {
  return with_pot_kind(p.pot_kind, [&](auto pk) {
    return with_jas_kind(p.jas_kind, [&](auto jk) { return fn(pk, jk); });
  });
}

template <typename T>
inline Consts<T> make_consts(const PairParams& p) {
  Consts<T> c;
  for (int k = 0; k < 3; ++k) {
    c.L[k] = T(p.L[k]);
    c.half[k] = T(p.half[k]);
  }
  c.rcut2 = T(p.rcut2);
  c.V0 = T(p.V0); c.V0s = T(p.V0s); c.s = T(p.s); c.s_inv = T(p.s_inv);
  c.A = T(p.A); c.neg_alpha = T(p.neg_alpha); c.beta = T(p.beta);
  c.two_beta = T(p.two_beta);
  c.C6 = T(p.C6); c.C8 = T(p.C8); c.C10 = T(p.C10); c.Dcore = T(p.Dcore);
  c.d_min = T(p.d_min); c.d_min_inv = T(p.d_min_inv);
  c.two_C8 = T(p.two_C8); c.four_C10 = T(p.four_C10);
  c.Rm = T(p.Rm); c.rc = T(p.rc); c.u_rc = T(p.u_rc); c.du_rc = T(p.du_rc);
  c.soft_V0 = T(p.soft_V0); c.Cdd = T(p.Cdd);
  c.c1 = p.c1;
  c.dim = p.dim;
  return c;
}

// Single-image wrap of one displacement component (utils/pbc.wrap).
template <typename T>
__device__ __forceinline__ T wrap1(T d, T L, T half) {
  if (d > half) d -= L;
  if (d < -half) d += L;
  return d;
}

// Aziz V(r) in its plain form (models/potentials v).
template <typename T>
__device__ __forceinline__ T aziz_v(const Consts<T>& c, T r) {
  T d = fmax(c.s * r, c.d_min);
  T d2 = d * d;
  T rep = c.A * exp(c.neg_alpha * d + c.beta * d2);
  T q = c.Dcore / d - T(1);
  T H = (d <= c.Dcore) ? exp(-(q * q)) : T(1);
  T W = c.C6 + c.C8 / d2 + c.C10 / (d2 * d2);
  return c.V0 * (rep - W * H / (d2 * d2 * d2));
}

// Fused (V, dV/dr) from r and 1/r (models/potentials v_dv).
template <typename T>
__device__ __forceinline__ void aziz_v_dv(const Consts<T>& c, T r, T rinv,
                                          T& val, T& dv) {
  T d = fmax(c.s * r, c.d_min);
  T di = fmin(c.s_inv * rinv, c.d_min_inv);
  T d2i = di * di;
  T rep = c.A * exp(c.neg_alpha * d + c.beta * (d * d));
  T t = c.Dcore * di - T(1);
  bool core = d <= c.Dcore;
  T H = core ? exp(-t * t) : T(1);
  T dH = core ? H * T(2) * t * c.Dcore * d2i : T(0);
  T W = c.C6 + d2i * (c.C8 + c.C10 * d2i);
  T dW = -d2i * di * (c.two_C8 + c.four_C10 * d2i);
  T d6i = d2i * d2i * d2i;
  T WH6 = W * H * d6i;
  val = c.V0 * (rep - WH6);
  T drep = rep * (c.neg_alpha + c.two_beta * d);
  T dG = (dW * H + W * dH) * d6i - T(6) * WH6 * di;
  dv = c.V0s * (drep - dG);
}

// V(r) from r alone, the potential's plain form (models/potentials v);
// the Aziz form is the kernels' V without force.
template <int PK, typename T>
__device__ __forceinline__ T pot_v(const Consts<T>& c, T r) {
  if constexpr (PK == kAziz) {
    return aziz_v(c, r);
  } else if constexpr (PK == kSoft) {
    const T r2 = r * r;
    const T r6 = r2 * r2 * r2;
    return c.soft_V0 * (T(1) / r6 - T(1)) / r6;
  } else if constexpr (PK == kDipolar) {
    return c.Cdd / (r * r * r);
  } else {
    return T(0);
  }
}

// Fused (V, dV/dr) from r and 1/r.  The soft and dipolar forms are powers
// of 1/r: r^2 = 0 gives V = +inf, as the plain form's V(0) does.
template <int PK, typename T>
__device__ __forceinline__ void pot_v_dv(const Consts<T>& c, T r, T rinv,
                                         T& val, T& dv) {
  if constexpr (PK == kAziz) {
    aziz_v_dv(c, r, rinv, val, dv);
  } else if constexpr (PK == kSoft) {
    const T r2i = rinv * rinv;
    const T r6i = r2i * r2i * r2i;
    val = c.soft_V0 * (r6i - T(1)) * r6i;
    dv = c.soft_V0 * (r6i * rinv) * (T(6) - T(12) * r6i);
  } else if constexpr (PK == kDipolar) {
    const T r3i = rinv * rinv * rinv;
    val = c.Cdd * r3i;
    dv = T(-3) * c.Cdd * (r3i * rinv);
  } else {
    val = T(0);
    dv = T(0);
  }
}

// The two-body log-Jastrow u(r) of JK from q = Rm/r, C1-shifted at rcut
// when c1.
template <int JK, typename T>
__device__ __forceinline__ T jastrow_u_q(const Consts<T>& c, T r, T q) {
  if constexpr (JK == kJasNone) {
    return T(0);
  } else {
    T u;
    if constexpr (JK == kMcMillan) {
      const T q2 = q * q;
      u = T(-0.5) * (q2 * q2 * q);
    } else {
      u = T(-2) * sqrt(q);
    }
    if (c.c1) u = u - c.u_rc - c.du_rc * (r - c.rc);
    return u;
  }
}

template <int JK, typename T>
__device__ __forceinline__ T jastrow_u(const Consts<T>& c, T r) {
  return jastrow_u_q<JK>(c, r, c.Rm / r);
}

// One Metropolis side of one displaced row against one partner rj: adds the
// partner's V (potential PK) to pot (m = notself & r^2 <= rc^2), and over mf = m & r^2 > 0
// its force to F when need_f2 and its u to u when need_wf.  Components
// k >= dim are zero on both sides and add nothing.  r and Rm/r come from
// the one reciprocal square root (r = r^2 rsqrt(r^2)) in place of a precise
// sqrt and a precise division, which cost the pass more instructions; the
// results stay within a few ulp of the plain form's.
template <int PK, int JK, typename T>
__device__ __forceinline__ void pair_side(const Consts<T>& c, const T* x,
                                          const T* rj, bool notself,
                                          bool need_f2, bool need_wf, T& pot,
                                          T* F, T& u) {
  T dx[3];
  T r2 = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dx[k] = wrap1(x[k] - rj[k], c.L[k], c.half[k]);
    r2 += dx[k] * dx[k];
  }
  T r2s = notself ? r2 : T(1);
  T rinv = rsqrt(r2s);
  T r = r2s * rinv;
  bool m = notself && r2 <= c.rcut2;
  bool mf = m && r2 > T(0);
  T v, dv;
  pot_v_dv<PK>(c, r, rinv, v, dv);
  if (m) pot += v;
  if (need_f2 && mf) {
    T fr = dv * rinv;
#pragma unroll
    for (int k = 0; k < 3; ++k) F[k] += fr * dx[k];
  }
  if (need_wf && mf) u += jastrow_u_q<JK>(c, r, c.Rm * rinv);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Row passes by lane groups (pair_rows.cu, cascade.cu): a group of G lanes
// evaluates one displaced row, lane l taking the partners j = l, l + G, ...
// for both Metropolis sides from one read of each partner.
// ---------------------------------------------------------------------------

// One row's sums: the potential and u differences (new - old) and the
// moved particle's force on both sides.
template <typename T>
struct RowPart {
  T dpot, du;
  T Fn[3], Fo[3];
};

// Lane l's partial sums over the partners j = l, l + G, ... < N of the row
// P (partner j's coordinates at P[j * D], D = c.dim), for the positions
// xn (new) and xo (old) of particle ip.
template <int PK, int JK, typename T>
__device__ __forceinline__ RowPart<T> row_part(const Consts<T>& c,
                                               const T* P, int N,
                                               long long ip, const T* xn,
                                               const T* xo, bool need_f2,
                                               bool need_wf, int l, int G) {
  T pn = T(0), po = T(0), un = T(0), uo = T(0);
  RowPart<T> r;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.Fn[k] = r.Fo[k] = T(0);
  for (int j = l; j < N; j += G) {
    T rj[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rj[k] = k < c.dim ? P[j * c.dim + k] : T(0);
    const bool notself = j != ip;
    pair_side<PK, JK>(c, xn, rj, notself, need_f2, need_wf, pn, r.Fn, un);
    pair_side<PK, JK>(c, xo, rj, notself, need_f2, need_wf, po, r.Fo, uo);
  }
  r.dpot = pn - po;
  r.du = un - uo;
  return r;
}

// Sum over an aligned group of `width` lanes (a power of two <= 32) whose
// lanes are the set bits of mask; every lane of the group gets the sum.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width, unsigned mask) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(mask, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ void group_sum(RowPart<T>& r, int width,
                                          unsigned mask, bool need_f2,
                                          bool need_wf) {
  r.dpot = group_sum(r.dpot, width, mask);
  if (need_f2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.Fn[k] = group_sum(r.Fn[k], width, mask);
      r.Fo[k] = group_sum(r.Fo[k], width, mask);
    }
  }
  if (need_wf) r.du = group_sum(r.du, width, mask);
}

// Lanes of the aligned group of `width` lanes that holds lane `lane` of
// its warp.
__device__ __forceinline__ unsigned group_mask(int lane, int width) {
  return width >= 32 ? 0xffffffffu
                     : ((1u << width) - 1u) << (lane & ~(width - 1));
}

// The row's action delta from its summed terms, in the order of the plain
// form (ops/kernels.pair_rows_ref): wv dpot + wf (|Fn|^2 - |Fo|^2), then
// - wpsi du.
template <typename T>
__device__ __forceinline__ T row_ds(const RowPart<T>& r, T wv, T wf, T wpsi,
                                    bool need_f2, bool need_wf) {
  T dS = wv * r.dpot;
  if (need_f2) {
    T f2n = T(0), f2o = T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f2n += r.Fn[k] * r.Fn[k];
      f2o += r.Fo[k] * r.Fo[k];
    }
    dS = dS + wf * (f2n - f2o);
  }
  if (need_wf) dS = dS - wpsi * r.du;
  return dS;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
