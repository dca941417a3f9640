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
//
// The dimension.  Every kernel takes it as one more template parameter DP,
// picked the same way (with_dims): DP = 3 serves dim 1, 2 and 3 with
// per-dimension vectors of three registers whose components k >= dim are
// zero (the code of the D <= 3 kernels as they were), and DP = 0 serves
// every dim >= 4 with the dimension read at run time: a point is read where
// it lies (shared or global memory, `Pt`), a displacement is recomputed
// where it is needed again, and the per-thread sums (forces) live in the
// block's dynamic shared memory, dim values per thread with the threads
// interleaved (`Vec`), so no dim is refused short of the shared memory.
// The box lengths then come from PairParams::box, a device array [2, dim]
// (L, then L/2) in the arithmetic type.
//
// The storage type.  A kernel reads and writes its tensors in their dtype S
// (float, double or __nv_bfloat16) and computes in T = compute_t<S>: S
// itself, float for bfloat16 (Consts<float>), as the reference's kernels
// write in R's dtype.
#pragma once

// Each source is compiled once per storage type, in parallel
// (utils/build.py passes -DPIGS_STORAGE=0 float, 1 double, 2 bfloat16):
// that compilation instantiates the entry points of its type alone.
#ifndef PIGS_STORAGE
#define PIGS_STORAGE -1  // every type
#endif
#define PIGS_HAS(n) (PIGS_STORAGE < 0 || PIGS_STORAGE == (n))

#include <cuda_bf16.h>
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
  const void* box;  // dim >= 4: device [2, dim] (L, L/2) in compute_t<S>
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
  const T* box;
};

// The arithmetic type of a storage type.
template <typename S>
struct ComputeOf {
  using type = S;
};
template <>
struct ComputeOf<__nv_bfloat16> {
  using type = float;
};
template <typename S>
using compute_t = typename ComputeOf<S>::type;

// A stored value in the arithmetic type T, and back (round to nearest).
template <typename T, typename E>
__device__ __forceinline__ T to_c(E x) {
  if constexpr (std::is_same<E, __nv_bfloat16>::value)
    return T(__bfloat162float(x));
  else
    return T(x);
}
template <typename S, typename T>
__device__ __forceinline__ S to_s(T x) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return __float2bfloat16_rn(float(x));
  else
    return S(x);
}
// A value rounded to the storage type S and read back: a position as the
// tensor will hold it.
template <typename S, typename T>
__device__ __forceinline__ T round_s(T x) {
  return to_c<T>(to_s<S>(x));
}

// Components of a per-dimension vector, and the dimensions a loop runs
// over: DP, or dim at run time (DP = 0).
template <int DP>
__host__ __device__ constexpr int vdims(int dim) {
  return DP > 0 ? DP : dim;
}

// Box length and half length of axis k.
template <int DP, typename T>
__device__ __forceinline__ T box_L(const Consts<T>& c, int k) {
  if constexpr (DP > 0)
    return c.L[k];
  else
    return c.box[k];
}
template <int DP, typename T>
__device__ __forceinline__ T box_h(const Consts<T>& c, int k) {
  if constexpr (DP > 0)
    return c.half[k];
  else
    return c.box[c.dim + k];
}

// One point (dim coordinates at p, element type E) in T: DP > 0 loads it
// into DP registers, zero past dim; DP = 0 reads it in place.
template <typename T, typename E, int DP>
struct Pt {
  T v[DP];
  __device__ __forceinline__ Pt(const Consts<T>& c, const E* p) {
#pragma unroll
    for (int k = 0; k < DP; ++k) v[k] = k < c.dim ? to_c<T>(p[k]) : T(0);
  }
  __device__ __forceinline__ T operator[](int k) const { return v[k]; }
};
template <typename T, typename E>
struct Pt<T, E, 0> {
  const E* p;
  __device__ __forceinline__ Pt(const Consts<T>&, const E* q) : p(q) {}
  __device__ __forceinline__ T operator[](int k) const {
    return to_c<T>(p[k]);
  }
};

// One thread's per-dimension sums: DP registers, or (DP = 0) dim values in
// shared memory at stride s (the block's threads interleaved).
template <typename T, int DP>
struct Vec {
  T v[DP];
  __device__ __forceinline__ T& operator[](int k) { return v[k]; }
  __device__ __forceinline__ const T& operator[](int k) const { return v[k]; }
};
template <typename T>
struct Vec<T, 0> {
  T* p;
  int s;
  __device__ __forceinline__ T& operator[](int k) const { return p[k * s]; }
};

// Vector i of thread t of the nthr threads of a block in the scratch scr
// ([i][k][t]); DP > 0 needs no scratch.
template <typename T, int DP>
__device__ __forceinline__ Vec<T, DP> vec_at(T* scr, int i, int dim,
                                            int nthr, int t) {
  if constexpr (DP > 0) {
    return Vec<T, DP>{};
  } else {
    return Vec<T, 0>{scr + (long long)i * dim * nthr + t, nthr};
  }
}

// Shared-memory elements (of T) of the per-thread vectors of a DP = 0
// block: nvec vectors of dim values for each of nthr threads.
__host__ __device__ inline long long scratch_elems(int DP, int dim, int nvec,
                                                   int nthr) {
  return DP > 0 ? 0 : (long long)nvec * dim * nthr;
}

// Bytes rounded up to a multiple of a (a power of two).
__host__ __device__ constexpr size_t round_up(size_t n, size_t a) {
  return (n + a - 1) & ~(a - 1);
}

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

// fn(std::integral_constant<int, DP>) for dim: DP = 3 up to three
// dimensions, DP = 0 (dim at run time) above.
template <typename Fn>
inline int with_dims(int dim, Fn&& fn) {
  if (dim < 1) return (int)cudaErrorInvalidValue;
  if (dim <= 3) return fn(std::integral_constant<int, 3>{});
  return fn(std::integral_constant<int, 0>{});
}

template <typename T>
inline Consts<T> make_consts(const PairParams& p) {
  Consts<T> c;
  c.box = (const T*)p.box;
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
//
// The row passes below come in two sets: these, for dim <= 3 (DP = 3), in
// three registers per vector, and the `_n` set for dim >= 4 (DP = 0).  A
// single set with the dimension as a template parameter computed the same
// values, but ptxas then held kernel A's Aziz instantiations to 64
// registers with 40 bytes of spills, against 86 and none for this code
// (tools/torch_kernel_regs.py; PERF.md, PR 13).
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

// The same for dim >= 4: x and rj read in place (Pt), the displacement
// recomputed for the force, F a thread's vector (Vec<T, 0>).
template <int PK, int JK, typename T, typename X, typename RJ>
__device__ __forceinline__ void pair_side_n(const Consts<T>& c, const X& x,
                                            const RJ& rj, bool notself,
                                            bool need_f2, bool need_wf,
                                            T& pot, const Vec<T, 0>& F,
                                            T& u) {
  T r2 = T(0);
  for (int k = 0; k < c.dim; ++k) {
    const T d = wrap1(x[k] - rj[k], box_L<0>(c, k), box_h<0>(c, k));
    r2 += d * d;
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
    for (int k = 0; k < c.dim; ++k)
      F[k] += fr * wrap1(x[k] - rj[k], box_L<0>(c, k), box_h<0>(c, k));
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
// moved particle's force on both sides (dim <= 3).
template <typename T>
struct RowPart {
  T dpot, du;
  T Fn[3], Fo[3];
};

// The same for dim >= 4, the forces a thread's two vectors.
template <typename T>
struct RowPartN {
  T dpot, du;
  Vec<T, 0> Fn, Fo;
};

// Lane l's partial sums over the partners j = l, l + G, ... < N of the row
// P (partner j's coordinates at P[j * D], D = c.dim, element type E), for
// the positions xn (new) and xo (old) of particle ip.
template <int PK, int JK, typename T, typename E>
__device__ __forceinline__ RowPart<T> row_part(const Consts<T>& c,
                                               const E* P, int N,
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
    for (int k = 0; k < 3; ++k)
      rj[k] = k < c.dim ? to_c<T>(P[j * c.dim + k]) : T(0);
    const bool notself = j != ip;
    pair_side<PK, JK>(c, xn, rj, notself, need_f2, need_wf, pn, r.Fn, un);
    pair_side<PK, JK>(c, xo, rj, notself, need_f2, need_wf, po, r.Fo, uo);
  }
  r.dpot = pn - po;
  r.du = un - uo;
  return r;
}

// The same for dim >= 4, its forces in the thread's vectors 2 i and 2 i + 1
// of the scratch scr ([i][k][t] of nthr threads).
template <int PK, int JK, typename T, typename E, typename XN, typename XO>
__device__ __forceinline__ RowPartN<T> row_part_n(
    const Consts<T>& c, const E* P, int N, long long ip, const XN& xn,
    const XO& xo, bool need_f2, bool need_wf, int l, int G, T* scr, int i,
    int nthr, int t) {
  T pn = T(0), po = T(0), un = T(0), uo = T(0);
  RowPartN<T> r;
  r.Fn = vec_at<T, 0>(scr, 2 * i, c.dim, nthr, t);
  r.Fo = vec_at<T, 0>(scr, 2 * i + 1, c.dim, nthr, t);
  for (int k = 0; k < c.dim; ++k) r.Fn[k] = r.Fo[k] = T(0);
  for (int j = l; j < N; j += G) {
    const Pt<T, E, 0> rj(c, P + j * c.dim);
    const bool notself = j != ip;
    pair_side_n<PK, JK>(c, xn, rj, notself, need_f2, need_wf, pn, r.Fn, un);
    pair_side_n<PK, JK>(c, xo, rj, notself, need_f2, need_wf, po, r.Fo, uo);
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

template <typename T>
__device__ __forceinline__ void group_sum_n(const Consts<T>& c,
                                            RowPartN<T>& r, int width,
                                            unsigned mask, bool need_f2,
                                            bool need_wf) {
  r.dpot = group_sum(r.dpot, width, mask);
  if (need_f2) {
    for (int k = 0; k < c.dim; ++k) {
      r.Fn[k] = group_sum(T(r.Fn[k]), width, mask);
      r.Fo[k] = group_sum(T(r.Fo[k]), width, mask);
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

// The same from the row's sums for dim >= 4: dpot, du and the force
// components at stride s of F2n / F2o (a RowPartN's vectors, or a row's
// entries in shared memory).
template <typename T, typename FV>
__device__ __forceinline__ T row_ds_n(int dim, T dpot, T du, const FV& Fn,
                                      const FV& Fo, T wv, T wf, T wpsi,
                                      bool need_f2, bool need_wf) {
  T dS = wv * dpot;
  if (need_f2) {
    T f2n = T(0), f2o = T(0);
    for (int k = 0; k < dim; ++k) {
      f2n += Fn[k] * Fn[k];
      f2o += Fo[k] * Fo[k];
    }
    dS = dS + wf * (f2n - f2o);
  }
  if (need_wf) dS = dS - wpsi * du;
  return dS;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
