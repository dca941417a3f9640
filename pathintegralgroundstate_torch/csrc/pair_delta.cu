// Kernels 3 and 4: UpdatePot and UpdateWf of the dense delta_action, in one
// source and, for the whole action delta, in one launch.
//
// Replace pathintegralgroundstate_tpu/ops/pallas_kernels.py
// pair_delta_pallas / _delta_kernel (kernel 3) and pair_u_pallas /
// _u_kernel (kernel 4).  For each (walker w, displaced row b) and for BOTH
// Metropolis sides x = xnew[w, b] and x = xold[w, b] against the N partners
// R[w, b, :, :], with the reference's masks (m = notself & r^2 <= rc^2 and
// NO r^2 > 0 coincidence guard, unlike kernel A; r = sqrt(r^2)), one pass
// computes, by its mode:
//   raw    (kernel 3, delta_pot): dpot = sum_m V(new) - sum_m V(old) and,
//          with force, df2 = |F(new)|^2 - |F(old)|^2 with F = sum_m (dV/dr /
//          r) dx from the fused (V, dV/dr); without force V is the plain V(r)
//          and df2 = 0 (the pair model: the template parameters PK and JK
//          of pigs_pair.cuh);
//   u      (kernel 4, delta_wf): du = sum_m u(new) - sum_m u(old);
//   action (kernels 3 and 4, the dense delta_action, the reference's
//          pairwise.py:331-343): given the Chin table tab [3, M], the rows'
//          beads ib ([B] or [W, B]) and the dense F^2 weight wf,
//            dS = wv dpot + wf_b df2 - [wpsi > 0] du,  (wv, _, wpsi) =
//            tab[:, ib], wf_b = wf on odd interior rows (tab[1, ib] > 0),
//          in that order.  u is evaluated only on rows with wpsi > 0 (the
//          chain ends), from the same dx, r^2, r and 1/r as V: the reference
//          adds du by a select, so a row's du reaches dS only there.  wf_b
//          multiplies df2, so with force a coincident partner (non-finite
//          df2) makes dS NaN on any row, as in the reference.
//
// What bounds it on the H100: device-memory bytes in principle (the end
// gate's [1024, 1, 64, 3] float32 partner block is 786 KB, about 0.25 us at
// 3.35 TB/s, against about 5 MFLOP), in practice the launch itself: one
// gate row per walker is far too little work to fill the card.  Hence the
// action mode: kernel 4's pass rides in kernel 3's launch and the partner
// block is read once, not once per kernel.
//
// Design: one warp per (walker, row), 8 rows per block; lane l loads
// partners j = l, l+32, ... once and evaluates both sides from that one
// load; warp shuffles reduce.  (16- and 64-lane teams were timed at the end
// gate's shape and were no faster: PERF.md.)  R is read in place through
// its W/B/N strides.  Float uses expf through the overloaded exp, with no
// fast-math flag, as kernels A, B and 5 do.  For dim >= 4 (DP = 0,
// pigs_pair.cuh) the positions and partners are read in place and a warp's
// two force sums per lane live in dynamic shared memory; bfloat16 is read
// as float32 and each row's result rounded to bfloat16 once.
#include <stdint.h>

#include "pigs_pair.cuh"

// Row layout of one pass, filled by ops/kernels.py (ctypes.Structure
// _RowArgs).  At namespace scope: the extern "C" entry points take it, and a
// type of the unnamed namespace would make them local to this file.
struct RowArgs {
  long long sRw, sRb, sRn, sNw, sNb, sOw, sOb;
  int ip_mode;  // 0 scalar, 1 per walker [W], 2 per row [W, B], 3 [1, B]
  long long ip0;
  int W, B, N;
  int ib_mode;  // action mode: ib 0 [B], 1 [W, B]
  int M;        // action mode: row length of tab [3, M]
  double wf;    // action mode: the F^2 weight of odd interior rows
};

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads
enum Mode { kRaw = 0, kU = 1, kAction = 2 };

// One Metropolis side against one partner rj: V (kPot) with its force
// (kForce) and u (with_u), all from one minimum image dx and r^2.
template <typename T, bool kPot, bool kForce, int PK, int JK, int DP,
          typename X, typename RJ, typename FV>
__device__ __forceinline__ void side(const Consts<T>& c, const X& x,
                                     const RJ& rj, bool notself, bool with_u,
                                     T& pot, FV& F, T& u) {
  T dx[DP > 0 ? DP : 1];
  T r2 = T(0);
  const int nd = vdims<DP>(c.dim);
#pragma unroll
  for (int k = 0; k < nd; ++k) {
    const T d = wrap1(x[k] - rj[k], box_L<DP>(c, k), box_h<DP>(c, k));
    if constexpr (DP > 0) dx[k] = d;
    r2 += d * d;
  }
  const T r2s = notself ? r2 : T(1);
  const T r = sqrt(r2s);
  const bool m = notself && r2 <= c.rcut2;
  if (kPot && kForce) {
    const T rinv = rsqrt(r2s);
    T v, dv;
    pot_v_dv<PK>(c, r, rinv, v, dv);
    if (m) {
      pot += v;
      const T fr = dv * rinv;
#pragma unroll
      for (int k = 0; k < nd; ++k) {
        if constexpr (DP > 0)
          F[k] += fr * dx[k];
        else
          F[k] += fr * wrap1(x[k] - rj[k], box_L<DP>(c, k), box_h<DP>(c, k));
      }
    }
    if (with_u && m) u += jastrow_u_q<JK>(c, r, c.Rm * rinv);
  } else {
    if (kPot) {
      const T v = pot_v<PK>(c, r);
      if (m) pot += v;
    }
    if (with_u) {
      const T uj = jastrow_u<JK>(c, r);
      if (m) u += uj;
    }
  }
}

template <typename S, int kMode, bool kForce, int PK, int JK, int DP>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
pair_delta_kernel(Consts<compute_t<S>> c, RowArgs a, const S* __restrict__ R,
                  const S* __restrict__ xn, const S* __restrict__ xo,
                  const long long* __restrict__ ip,
                  const long long* __restrict__ ib,
                  const S* __restrict__ tab, S* __restrict__ out0,
                  S* __restrict__ out1) {
  using T = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool kPot = kMode != kU;
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)a.W * a.B) return;  // whole warps leave together
  const long long w = row / a.B;
  const long long b = row - w * a.B;
  const long long p = a.ip_mode == 0   ? a.ip0
                      : a.ip_mode == 1 ? ip[w]
                      : a.ip_mode == 2 ? ip[row]
                                       : ip[b];
  bool with_u = kMode == kU;
  long long jb = 0;
  if (kMode == kAction) {
    jb = a.ib_mode ? ib[row] : ib[b];
    with_u = to_c<T>(tab[2 * a.M + jb]) > T(0);  // one value for the warp
  }
  const int nd = vdims<DP>(c.dim);
  const Pt<T, S, DP> xnv(c, xn + w * a.sNw + b * a.sNb);
  const Pt<T, S, DP> xov(c, xo + w * a.sOw + b * a.sOb);
  const S* Rrow = R + w * a.sRw + b * a.sRb;
  T pot_n = T(0), pot_o = T(0), u_n = T(0), u_o = T(0);
  T* scr = reinterpret_cast<T*>(smem_raw);
  Vec<T, DP> Fn = vec_at<T, DP>(scr, 0, c.dim, blockDim.x, threadIdx.x);
  Vec<T, DP> Fo = vec_at<T, DP>(scr, 1, c.dim, blockDim.x, threadIdx.x);
#pragma unroll
  for (int k = 0; k < nd; ++k) Fn[k] = Fo[k] = T(0);
  for (int j = lane; j < a.N; j += 32) {
    const Pt<T, S, DP> rj(c, Rrow + j * a.sRn);
    const bool notself = j != p;
    side<T, kPot, kForce, PK, JK, DP>(c, xnv, rj, notself, with_u, pot_n,
                                      Fn, u_n);
    side<T, kPot, kForce, PK, JK, DP>(c, xov, rj, notself, with_u, pot_o,
                                      Fo, u_o);
  }
  T dp = T(0), d2 = T(0), du = T(0);
  if (kPot) dp = warp_sum(pot_n) - warp_sum(pot_o);
  if (kPot && kForce) {
    T f2n = T(0), f2o = T(0);
#pragma unroll
    for (int k = 0; k < nd; ++k) {
      const T fn = warp_sum(T(Fn[k]));
      const T fo = warp_sum(T(Fo[k]));
      f2n += fn * fn;
      f2o += fo * fo;
    }
    d2 = f2n - f2o;
  }
  // one sum of the lanes' differences, taken on every row so that it issues
  // with the sums above (0 where u was skipped); two sums behind the
  // with_u branch cost the end gate 0.12 us a launch (PERF.md)
  if (kMode != kRaw) du = warp_sum(u_n - u_o);
  if (lane != 0) return;
  if (kMode == kRaw) {
    out0[row] = to_s<S>(dp);
    out1[row] = to_s<S>(d2);
  } else if (kMode == kU) {
    out0[row] = to_s<S>(du);
  } else {
    const T wfb = to_c<T>(tab[a.M + jb]) > T(0) ? T(a.wf) : T(0);
    T dS = to_c<T>(tab[jb]) * dp + wfb * d2;
    if (with_u) dS = dS - du;
    out0[row] = to_s<S>(dS);
  }
}

template <typename S, int kMode, bool kForce, int PK, int JK, int DP>
int launch(const Consts<compute_t<S>>& c, const RowArgs& a, const void* R,
           const void* xn, const void* xo, const void* ip, const void* ib,
           const void* tab, void* out0, void* out1, cudaStream_t s) {
  const long long rows = (long long)a.W * a.B;
  const size_t smem = scratch_elems(DP, c.dim, 2, 32 * kRowsPerBlock) *
                      sizeof(compute_t<S>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_delta_kernel<S, kMode, kForce, PK, JK, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pair_delta_kernel<S, kMode, kForce, PK, JK, DP>
      <<<(unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock),
         32 * kRowsPerBlock, smem, s>>>(
          c, a, (const S*)R, (const S*)xn, (const S*)xo,
          (const long long*)ip, (const long long*)ib, (const S*)tab,
          (S*)out0, (S*)out1);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_delta(const PairParams* p, const RowArgs* a, const void* R,
                 const void* xn, const void* xo, const void* ip, int mode,
                 int with_force, const void* ib, const void* tab, void* out0,
                 void* out1, void* stream) {
  if ((long long)a->W * a->B == 0) return 0;
  const Consts<compute_t<S>> c = make_consts<compute_t<S>>(*p);
  auto s = (cudaStream_t)stream;
  const auto args = [&](auto fn) {
    return fn(c, *a, R, xn, xo, ip, ib, tab, out0, out1, s);
  };
  return with_dims(p->dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    // the raw mode evaluates no Jastrow, kernel 4's u mode no potential:
    // one instantiation of the other kind serves each
    if (mode == kU)
      return with_jas_kind(p->jas_kind, [&](auto jk) {
        return args(launch<S, kU, false, kAziz, decltype(jk)::value, DP>);
      });
    if (mode == kRaw)
      return with_pot_kind(p->pot_kind, [&](auto pk) {
        constexpr int PK = decltype(pk)::value;
        return with_force ? args(launch<S, kRaw, true, PK, kMcMillan, DP>)
                          : args(launch<S, kRaw, false, PK, kMcMillan, DP>);
      });
    if (mode == kAction)
      return with_pair_model(*p, [&](auto pk, auto jk) {
        constexpr int PK = decltype(pk)::value, JK = decltype(jk)::value;
        return with_force ? args(launch<S, kAction, true, PK, JK, DP>)
                          : args(launch<S, kAction, false, PK, JK, DP>);
      });
    return (int)cudaErrorInvalidValue;
  });
}

}  // namespace

#define PIGS_PAIR_DELTA_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const PairParams* p, const RowArgs* a, const void* R,   \
                      const void* xn, const void* xo, const void* ip,           \
                      int mode, int with_force, const void* ib,                 \
                      const void* tab, void* out0, void* out1, void* stream) {  \
    return launch_delta<T>(p, a, R, xn, xo, ip, mode, with_force, ib, tab,     \
                           out0, out1, stream);                                 \
  }

#if PIGS_HAS(0)
PIGS_PAIR_DELTA_ENTRY(pigs_pair_delta_f32, float)
#endif
#if PIGS_HAS(1)
PIGS_PAIR_DELTA_ENTRY(pigs_pair_delta_f64, double)
#endif
#if PIGS_HAS(2)
PIGS_PAIR_DELTA_ENTRY(pigs_pair_delta_bf16, __nv_bfloat16)
#endif
