// Kernel A: the window pair pass of every Monte Carlo move.
//
// Replaces pathintegralgroundstate_tpu/ops/pallas_kernels.py
// pair_rows_pallas / _rows_kernel.  For each (walker w, window row b) and
// for BOTH Metropolis sides x = xnew[w, b] and x = xold[w, b] against the N
// partners R[w, b, :, :] it computes the single-image minimum image, r^2,
// the self / rcut / coincidence masks (sum V over m = notself & r^2 <= rc^2;
// force and u over mf = m & r^2 > 0), the fused Aziz (V, dV/dr), and
// returns per row
//     dpot = sum V(new) - sum V(old)
//     df2  = |F(new)|^2 - |F(old)|^2      (0 unless need_f2)
//     du   = sum u(new) - sum u(old)      (only when need_wf)
// The caller folds in the Chin weights (ops/pairwise.delta_action_rows).
//
// What bounds it on the H100: device-memory bytes.  The window is
// W*B*N*D elements (12.6 MB for an end move, 51 MB for a CM move at
// W=1024, f32), each read once; on top comes launch latency, since about
// 1,120 dependent moves run per Monte Carlo step.
//
// Design: one warp per (walker, row).  Lane l loads partners j = l, l+32,
// ... ONCE and evaluates both sides from that one load (the TPU's XLA path
// read the window twice); warp shuffles reduce the ten partial sums.  The
// window is read IN PLACE from `paths` through the W/B/N strides the
// wrapper passes, so no window copy is made.  The wrapper feeds a reversed
// window (the half-1 worm centre buffer, swap, the tail half-chain move)
// through a NEGATIVE bead stride from the window's last row, not through a
// flipped copy.
#include <stdint.h>

#include "pigs_pair.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // 8 warps = 256 threads

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
pair_rows_kernel(Consts<T> c, const T* __restrict__ R, long long sRw,
                 long long sRb, long long sRn, const T* __restrict__ xn,
                 long long sNw, long long sNb, const T* __restrict__ xo,
                 long long sOw, long long sOb,
                 const long long* __restrict__ ip, int ip_mode,
                 long long ip0, int W, int B, int N, int need_wf,
                 int need_f2, T* __restrict__ dpot, T* __restrict__ df2,
                 T* __restrict__ du) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)W * B) return;  // whole warps leave together
  const long long w = row / B;
  const long long b = row - w * B;
  // ip modes: 0 scalar, 1 per walker [W], 2 per row [W, B], 3 per window
  // row shared by every walker [1, B] (the K-slot interior composite)
  const long long p = ip_mode == 0   ? ip0
                      : ip_mode == 1 ? ip[w]
                      : ip_mode == 2 ? ip[row]
                                     : ip[b];

  T xnv[3], xov[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xnv[k] = k < c.dim ? xn[w * sNw + b * sNb + k] : T(0);
    xov[k] = k < c.dim ? xo[w * sOw + b * sOb + k] : T(0);
  }
  const T* Rrow = R + w * sRw + b * sRb;
  T pot_n = T(0), pot_o = T(0), u_n = T(0), u_o = T(0);
  T Fn[3] = {T(0), T(0), T(0)}, Fo[3] = {T(0), T(0), T(0)};
  for (int j = lane; j < N; j += 32) {
    T rj[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rj[k] = k < c.dim ? Rrow[j * sRn + k] : T(0);
    bool notself = j != p;
    pair_side(c, xnv, rj, notself, need_f2, need_wf, pot_n, Fn, u_n);
    pair_side(c, xov, rj, notself, need_f2, need_wf, pot_o, Fo, u_o);
  }
  pot_n = warp_sum(pot_n);
  pot_o = warp_sum(pot_o);
  T f2n = T(0), f2o = T(0);
  if (need_f2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T a = warp_sum(Fn[k]);
      T o = warp_sum(Fo[k]);
      f2n += a * a;
      f2o += o * o;
    }
  }
  if (need_wf) {
    u_n = warp_sum(u_n);
    u_o = warp_sum(u_o);
  }
  if (lane == 0) {
    dpot[row] = pot_n - pot_o;
    df2[row] = need_f2 ? f2n - f2o : T(0);
    if (need_wf) du[row] = u_n - u_o;
  }
}

template <typename T>
int launch(const PairParams* p, const void* R, long long sRw, long long sRb,
           long long sRn, const void* xn, long long sNw, long long sNb,
           const void* xo, long long sOw, long long sOb, const void* ip,
           int ip_mode, long long ip0, int W, int B, int N, int need_wf,
           int need_f2, void* dpot, void* df2, void* du, void* stream) {
  const long long rows = (long long)W * B;
  if (rows == 0) return 0;
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  pair_rows_kernel<T><<<grid, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      make_consts<T>(*p), (const T*)R, sRw, sRb, sRn, (const T*)xn, sNw, sNb,
      (const T*)xo, sOw, sOb, (const long long*)ip, ip_mode, ip0, W, B, N,
      need_wf, need_f2, (T*)dpot, (T*)df2, (T*)du);
  return (int)cudaGetLastError();
}

}  // namespace

#define PIGS_PAIR_ROWS_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const PairParams* p, const void* R, long long sRw,     \
                      long long sRb, long long sRn, const void* xn,          \
                      long long sNw, long long sNb, const void* xo,          \
                      long long sOw, long long sOb, const void* ip,          \
                      int ip_mode, long long ip0, int W, int B, int N,       \
                      int need_wf, int need_f2, void* dpot, void* df2,       \
                      void* du, void* stream) {                              \
    return launch<T>(p, R, sRw, sRb, sRn, xn, sNw, sNb, xo, sOw, sOb, ip,    \
                     ip_mode, ip0, W, B, N, need_wf, need_f2, dpot, df2, du, \
                     stream);                                                \
  }

PIGS_PAIR_ROWS_ENTRY(pigs_pair_rows_f32, float)
PIGS_PAIR_ROWS_ENTRY(pigs_pair_rows_f64, double)
