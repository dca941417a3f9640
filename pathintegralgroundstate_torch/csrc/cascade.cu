// Kernel 5: one whole composite bisection move per launch.
//
// Replaces pathintegralgroundstate_tpu/ops/cascade_kernels.py
// cascade_pallas / _cascade_body, modes `ends` (the head window and the
// bead-reversed tail window of one particle, S = 2, G = nlev + 1 gates)
// and `interior` (K disjoint windows of K distinct particles, S = K,
// G = nlev gates).  For each (walker w, slot s) whose slot is active it
// runs, in order:
//   * ends only: the free-gaussian end guess x0' = wrap(x0 - wrap(x0 - xL)
//     + sqrt(L dt) g_0) and its gate on row 0 (Chin end weights: dt/3 on V
//     and the trial-WF term);
//   * levels 1..nlev: the midpoints p = d2, d2 + delta, .. of the level
//     from the current window (sigma = sqrt(delta dt / 4)), both Metropolis
//     sides of every midpoint row against its N partners, and the level's
//     gate u < exp(-sum dS) (Chin weights static per level: odd rows
//     4dt/3 and 2dt^3/9, even rows 2dt/3);
//   * the final write-back of the displaced rows (ends 0..L-1, interior
//     1..L-1) for a slot that passed every gate.  A slot that fails a gate
//     stops there and writes nothing: that is the dead-walker revert, since
//     paths still holds the old window.
// The numbers are those of the plain form ops/cascade.cascade_ref (the
// counterpart of cascade_jnp) on the same gaussians rg and uniforms ru.
//
// What bounds it on the H100: latency.  A slot's levels are a dependent
// chain (each level's midpoints come from the previous levels' positions),
// so the work is L row passes of N partners in sequence; the bytes are one
// read of the slot's (L+1) x N x D partner window, 52 KB per slot at the
// flagship in float32.
//
// Design: one warp per (walker, slot).  The moved particle's L+1 window
// positions live in shared memory; every lane computes each proposal
// redundantly from them (no broadcast needed), lanes stride over the N
// partners for both sides of a row from one load, and xor shuffles leave
// the row's sums in every lane.  The windows are read IN PLACE from paths
// through a per-slot start bead and bead direction (the tail window is
// head-oriented: start M-1, direction -1), so the TPU's stacked window copy
// [W, S, L+1, N, D] is never made, and accepted windows are written back
// into paths in place.  This is race-free: a warp writes only its own
// particle at its own slot's displaced beads, which no other slot reads.
// The walker-tiling of the TPU kernel (VMEM) has no counterpart here.
#include <stdint.h>

#include "pigs_pair.cuh"

namespace {

constexpr int kMaxSlots = 64;
constexpr int kWarpsPerBlock = 4;

}  // namespace

// Host-side move description, filled by ops/kernels.py (_CascadeArgs):
// the Chin weights in double, and per slot the window's start bead, its
// bead direction (+1 or -1) and the moved particle.
struct CascadeArgs {
  double dt;
  double wv_end, wv_odd, wf_odd, wv_even;
  long long bead0[kMaxSlots];
  int dir[kMaxSlots];
  int ip[kMaxSlots];
};

namespace {

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// dS of one displaced row (position x_new vs x_old) against the partner
// row Rrow [N, D]: wv dpot + wf df2 - wpsi du, as ops/pairwise
// delta_action_rows combines them.  Every lane returns the same value.
template <typename T>
__device__ __forceinline__ T row_ds(const Consts<T>& c,
                                    const T* __restrict__ Rrow, long long sN,
                                    int N, int ip, const T* xn, const T* xo,
                                    T wv, T wf, T wpsi, int lane) {
  const bool need_f2 = wf != T(0);
  const bool need_wf = wpsi != T(0);
  T pot_n = T(0), pot_o = T(0), u_n = T(0), u_o = T(0);
  T Fn[3] = {T(0), T(0), T(0)}, Fo[3] = {T(0), T(0), T(0)};
  for (int j = lane; j < N; j += 32) {
    T rj[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) rj[k] = k < c.dim ? Rrow[j * sN + k] : T(0);
    const bool notself = j != ip;
    pair_side(c, xn, rj, notself, need_f2, need_wf, pot_n, Fn, u_n);
    pair_side(c, xo, rj, notself, need_f2, need_wf, pot_o, Fo, u_o);
  }
  T dS = wv * (warp_sum(pot_n) - warp_sum(pot_o));
  if (need_f2) {
    T f2n = T(0), f2o = T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T a = warp_sum(Fn[k]);
      T o = warp_sum(Fo[k]);
      f2n += a * a;
      f2o += o * o;
    }
    dS = dS + wf * (f2n - f2o);
  }
  if (need_wf) dS = dS - wpsi * (warp_sum(u_n) - warp_sum(u_o));
  return dS;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
cascade_kernel(Consts<T> c, CascadeArgs a, T* __restrict__ paths,
               long long sW, long long sM, long long sN,
               const T* __restrict__ rg, const T* __restrict__ ru,
               const bool* __restrict__ act, long long sAw, long long sAs,
               bool* __restrict__ acc, int W, int S, int N, int L, int nlev,
               int ends) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (long long)W * S) return;  // whole warps leave together
  const long long w = task / S;
  const int s = (int)(task - w * S);
  if (!act[w * sAw + s * sAs]) {
    if (lane == 0) acc[task] = false;
    return;
  }
  const int D = c.dim;
  const int ip = a.ip[s];
  const long long b0 = a.bead0[s];
  const long long dstep = (long long)a.dir[s] * sM;
  T* seg = reinterpret_cast<T*>(smem_raw) + warp * (L + 1) * 3;
  T* walker = paths + w * sW;
  T* mine = walker + (long long)ip * sN;  // the moved particle's column
  const T* rgw = rg + task * (L + 1) * D;
  const T* ruw = ru + task * (nlev + ends);

  for (int p = lane; p <= L; p += 32) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      seg[p * 3 + k] = k < D ? mine[b0 * sM + p * dstep + k] : T(0);
  }
  __syncwarp();

  bool alive = true;
  int gate = 0;
  if (ends) {
    T x0[3], xn0[3];
    const T sig = sqrt(T(double(L) * a.dt));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x0[k] = seg[k];
      T xmid = x0[k] - wrap1(x0[k] - seg[L * 3 + k], c.L[k], c.half[k]);
      xn0[k] = k < D ? wrap1(xmid + sig * rgw[k], c.L[k], c.half[k]) : T(0);
    }
    T dS0 = row_ds(c, walker + b0 * sM, sN, N, ip, xn0, x0, T(a.wv_end),
                   T(0), T(1), lane);
    alive = ruw[0] < exp_t(-dS0);
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) seg[k] = xn0[k];
    }
    __syncwarp();
    gate = 1;
  }

  for (int ilev = 1; alive && ilev <= nlev; ++ilev) {
    const int delta = 1 << (nlev - ilev + 1);
    const int d2 = delta >> 1;
    const T sigma = sqrt(T(0.25 * delta * a.dt));
    const bool odd = d2 & 1;
    const T wv = T(odd ? a.wv_odd : a.wv_even);
    const T wf = odd ? T(a.wf_odd) : T(0);
    T dS = T(0);
    // a level's anchors p +- d2 are multiples of delta, never its own
    // midpoints, so each midpoint is stored as soon as it is drawn
    for (int p = d2; p < L; p += delta) {
      T xo[3], xn[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xo[k] = seg[p * 3 + k];
        T xp = xo[k] + wrap1(seg[(p - d2) * 3 + k] - xo[k], c.L[k], c.half[k]);
        T xq = xo[k] - wrap1(xo[k] - seg[(p + d2) * 3 + k], c.L[k], c.half[k]);
        xn[k] = k < D ? wrap1(T(0.5) * (xp + xq) + sigma * rgw[p * D + k],
                              c.L[k], c.half[k])
                      : T(0);
      }
      dS += row_ds(c, walker + b0 * sM + p * dstep, sN, N, ip, xn, xo, wv, wf,
                   T(0), lane);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) seg[p * 3 + k] = xn[k];
      }
      __syncwarp();
    }
    alive = ruw[gate + ilev - 1] < exp_t(-dS);
  }

  if (lane == 0) acc[task] = alive;
  if (alive) {
    for (int p = ends ? lane : lane + 1; p < L; p += 32) {
      for (int k = 0; k < D; ++k)
        mine[b0 * sM + p * dstep + k] = seg[p * 3 + k];
    }
  }
}

template <typename T>
int launch(const PairParams* p, const CascadeArgs* a, void* paths,
           long long sW, long long sM, long long sN, const void* rg,
           const void* ru, const void* act, long long sAw, long long sAs,
           void* acc, int W, int S, int N, int L, int nlev, int ends,
           void* stream) {
  const long long tasks = (long long)W * S;
  if (tasks == 0) return 0;
  if (S > kMaxSlots) return (int)cudaErrorInvalidValue;
  const unsigned grid =
      (unsigned)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = (size_t)kWarpsPerBlock * (L + 1) * 3 * sizeof(T);
  cascade_kernel<T><<<grid, 32 * kWarpsPerBlock, smem, (cudaStream_t)stream>>>(
      make_consts<T>(*p), *a, (T*)paths, sW, sM, sN, (const T*)rg,
      (const T*)ru, (const bool*)act, sAw, sAs, (bool*)acc, W, S, N, L, nlev,
      ends);
  return (int)cudaGetLastError();
}

}  // namespace

#define PIGS_CASCADE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const PairParams* p, const CascadeArgs* a,             \
                      void* paths, long long sW, long long sM, long long sN, \
                      const void* rg, const void* ru, const void* act,       \
                      long long sAw, long long sAs, void* acc, int W, int S, \
                      int N, int L, int nlev, int ends, void* stream) {      \
    return launch<T>(p, a, paths, sW, sM, sN, rg, ru, act, sAw, sAs, acc, W, \
                     S, N, L, nlev, ends, stream);                           \
  }

PIGS_CASCADE_ENTRY(pigs_cascade_f32, float)
PIGS_CASCADE_ENTRY(pigs_cascade_f64, double)
