// Kernels 3 and 4: UpdatePot and UpdateWf of the dense delta_action.
//
// Replace pathintegralgroundstate_tpu/ops/pallas_kernels.py
// pair_delta_pallas / _delta_kernel (kernel 3) and pair_u_pallas /
// _u_kernel (kernel 4).  For each (walker w, displaced row b) and for BOTH
// Metropolis sides x = xnew[w, b] and x = xold[w, b] against the N partners
// R[w, b, :, :], with the reference's masks (m = notself & r^2 <= rc^2 and
// NO r^2 > 0 coincidence guard, unlike kernel A; r = sqrt(r^2)):
//   kernel 3, with_force: dpot = sum_m V(new) - sum_m V(old) from the fused
//             (V, dV/dr), df2 = |F(new)|^2 - |F(old)|^2 with
//             F = sum_m (dV/dr / r) dx;
//   kernel 3, without force: dpot from the plain V(r), df2 = 0;
//   kernel 4: du = sum_m u(new) - sum_m u(old).
// Kernel 3 also closes the dense delta_action (ops/pairwise.delta_action,
// the reference's pairwise.py:331-343) when given kernel 4's du, the Chin
// table tab [3, M], the rows' beads ib ([B] or [W, B]) and the dense F^2
// weight wf: it writes per row
//   dS = wv dpot + wf_b df2 - [wpsi > 0] du,  (wv, _, wpsi) = tab[:, ib],
// wf_b = wf on odd interior rows (tab[1, ib] > 0), else 0, in that order.
// wf_b multiplies df2, so with force a coincident partner (non-finite df2)
// makes dS NaN on any row, as in the reference; du enters by a select.  So the
// dense delta_action is two launches, kernel 4 then kernel 3, and nothing
// after them.  Without du, kernel 3 writes the raw (dpot, df2) of delta_pot.
//
// What bounds it on the H100: device-memory bytes in principle (the end
// gate's [1024, 1, 64, 3] float32 partner block is 786 KB, about 0.25 us at
// 3.35 TB/s, against about 5 MFLOP), in practice the launch itself: one
// gate row per walker is far too little work to fill the card.
//
// Design: one warp per (walker, row); lane l loads partners j = l, l+32, ...
// once and evaluates both sides from that one load; warp shuffles reduce.
// R is read in place through its W/B/N strides.  Float uses expf through
// the overloaded exp, with no fast-math flag, as kernels A, B and 5 do.
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
  int ib_mode;  // kernel 3's epilogue: ib 0 [B], 1 [W, B]
  int M;        // kernel 3's epilogue: row length of tab [3, M]
  double wf;    // kernel 3's epilogue: the F^2 weight of odd interior rows
};

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads

// (w, b, moved particle) of this warp's row; false past the last row.
__device__ __forceinline__ bool row_of(const RowArgs& a,
                                       const long long* __restrict__ ip,
                                       long long& w, long long& b,
                                       long long& p) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)a.W * a.B) return false;
  w = row / a.B;
  b = row - w * a.B;
  p = a.ip_mode == 0   ? a.ip0
      : a.ip_mode == 1 ? ip[w]
      : a.ip_mode == 2 ? ip[row]
                       : ip[b];
  return true;
}

template <typename T>
__device__ __forceinline__ void load3(const Consts<T>& c, const T* x, T* v) {
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = k < c.dim ? x[k] : T(0);
}

// Minimum image dx and r^2 of x against partner rj.
template <typename T>
__device__ __forceinline__ T disp(const Consts<T>& c, const T* x, const T* rj,
                                  T* dx) {
  T r2 = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dx[k] = wrap1(x[k] - rj[k], c.L[k], c.half[k]);
    r2 += dx[k] * dx[k];
  }
  return r2;
}

// One side of kernel 3 against one partner.
template <typename T, bool kForce>
__device__ __forceinline__ void delta_side(const Consts<T>& c, const T* x,
                                           const T* rj, bool notself, T& pot,
                                           T* F) {
  T dx[3];
  const T r2 = disp(c, x, rj, dx);
  const T r2s = notself ? r2 : T(1);
  const T r = sqrt(r2s);
  const bool m = notself && r2 <= c.rcut2;
  if (kForce) {
    const T rinv = rsqrt(r2s);
    T v, dv;
    aziz_v_dv(c, r, rinv, v, dv);
    if (m) {
      pot += v;
      const T fr = dv * rinv;
#pragma unroll
      for (int k = 0; k < 3; ++k) F[k] += fr * dx[k];
    }
  } else {
    const T v = aziz_v(c, r);
    if (m) pot += v;
  }
}

// One side of kernel 4 against one partner.
template <typename T>
__device__ __forceinline__ void u_side(const Consts<T>& c, const T* x,
                                       const T* rj, bool notself, T& u) {
  T dx[3];
  const T r2 = disp(c, x, rj, dx);
  const T uj = jastrow_u(c, sqrt(notself ? r2 : T(1)));
  if (notself && r2 <= c.rcut2) u += uj;
}

template <typename T, bool kForce>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
pair_delta_kernel(Consts<T> c, RowArgs a, const T* __restrict__ R,
                  const T* __restrict__ xn, const T* __restrict__ xo,
                  const long long* __restrict__ ip,
                  const T* __restrict__ du, const long long* __restrict__ ib,
                  const T* __restrict__ tab, T* __restrict__ dpot,
                  T* __restrict__ df2) {
  const int lane = threadIdx.x & 31;
  long long w, b, p;
  if (!row_of(a, ip, w, b, p)) return;  // whole warps leave together
  T xnv[3], xov[3];
  load3(c, xn + w * a.sNw + b * a.sNb, xnv);
  load3(c, xo + w * a.sOw + b * a.sOb, xov);
  const T* Rrow = R + w * a.sRw + b * a.sRb;
  T pot_n = T(0), pot_o = T(0);
  T Fn[3] = {T(0), T(0), T(0)}, Fo[3] = {T(0), T(0), T(0)};
  for (int j = lane; j < a.N; j += 32) {
    T rj[3];
    load3(c, Rrow + j * a.sRn, rj);
    const bool notself = j != p;
    delta_side<T, kForce>(c, xnv, rj, notself, pot_n, Fn);
    delta_side<T, kForce>(c, xov, rj, notself, pot_o, Fo);
  }
  pot_n = warp_sum(pot_n);
  pot_o = warp_sum(pot_o);
  T f2n = T(0), f2o = T(0);
  if (kForce) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T fn = warp_sum(Fn[k]);
      const T fo = warp_sum(Fo[k]);
      f2n += fn * fn;
      f2o += fo * fo;
    }
  }
  if (lane == 0) {
    const long long row = w * a.B + b;
    const T dp = pot_n - pot_o;
    const T d2 = kForce ? f2n - f2o : T(0);
    if (du == nullptr) {
      dpot[row] = dp;
      df2[row] = d2;
    } else {  // dpot holds dS
      const long long jb = a.ib_mode ? ib[row] : ib[b];
      const T wfb = tab[a.M + jb] > T(0) ? T(a.wf) : T(0);
      T dS = tab[jb] * dp + wfb * d2;
      if (tab[2 * a.M + jb] > T(0)) dS = dS - du[row];
      dpot[row] = dS;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
pair_u_kernel(Consts<T> c, RowArgs a, const T* __restrict__ R,
              const T* __restrict__ xn, const T* __restrict__ xo,
              const long long* __restrict__ ip, T* __restrict__ du) {
  const int lane = threadIdx.x & 31;
  long long w, b, p;
  if (!row_of(a, ip, w, b, p)) return;
  T xnv[3], xov[3];
  load3(c, xn + w * a.sNw + b * a.sNb, xnv);
  load3(c, xo + w * a.sOw + b * a.sOb, xov);
  const T* Rrow = R + w * a.sRw + b * a.sRb;
  T u_n = T(0), u_o = T(0);
  for (int j = lane; j < a.N; j += 32) {
    T rj[3];
    load3(c, Rrow + j * a.sRn, rj);
    const bool notself = j != p;
    u_side(c, xnv, rj, notself, u_n);
    u_side(c, xov, rj, notself, u_o);
  }
  u_n = warp_sum(u_n);
  u_o = warp_sum(u_o);
  if (lane == 0) du[w * a.B + b] = u_n - u_o;
}

inline unsigned grid_of(const RowArgs& a) {
  const long long rows = (long long)a.W * a.B;
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <typename T>
int launch_delta(const PairParams* p, const RowArgs* a, const void* R,
                 const void* xn, const void* xo, const void* ip,
                 int with_force, const void* du, const void* ib,
                 const void* tab, void* dpot, void* df2, void* stream) {
  if ((long long)a->W * a->B == 0) return 0;
  const Consts<T> c = make_consts<T>(*p);
  auto s = (cudaStream_t)stream;
  auto kern = with_force ? pair_delta_kernel<T, true>
                         : pair_delta_kernel<T, false>;
  kern<<<grid_of(*a), 32 * kRowsPerBlock, 0, s>>>(
      c, *a, (const T*)R, (const T*)xn, (const T*)xo, (const long long*)ip,
      (const T*)du, (const long long*)ib, (const T*)tab, (T*)dpot, (T*)df2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_u(const PairParams* p, const RowArgs* a, const void* R,
             const void* xn, const void* xo, const void* ip, void* du,
             void* stream) {
  if ((long long)a->W * a->B == 0) return 0;
  pair_u_kernel<T><<<grid_of(*a), 32 * kRowsPerBlock, 0,
                     (cudaStream_t)stream>>>(
      make_consts<T>(*p), *a, (const T*)R, (const T*)xn, (const T*)xo,
      (const long long*)ip, (T*)du);
  return (int)cudaGetLastError();
}

}  // namespace

#define PIGS_PAIR_DELTA_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const PairParams* p, const RowArgs* a, const void* R,  \
                      const void* xn, const void* xo, const void* ip,          \
                      int with_force, const void* du, const void* ib,          \
                      const void* tab, void* dpot, void* df2, void* stream) {  \
    return launch_delta<T>(p, a, R, xn, xo, ip, with_force, du, ib, tab,      \
                           dpot, df2, stream);                                 \
  }

PIGS_PAIR_DELTA_ENTRY(pigs_pair_delta_f32, float)
PIGS_PAIR_DELTA_ENTRY(pigs_pair_delta_f64, double)

extern "C" int pigs_pair_u_f32(const PairParams* p, const RowArgs* a,
                               const void* R, const void* xn, const void* xo,
                               const void* ip, void* du, void* stream) {
  return launch_u<float>(p, a, R, xn, xo, ip, du, stream);
}

extern "C" int pigs_pair_u_f64(const PairParams* p, const RowArgs* a,
                               const void* R, const void* xn, const void* xo,
                               const void* ip, void* du, void* stream) {
  return launch_u<double>(p, a, R, xn, xo, ip, du, stream);
}
