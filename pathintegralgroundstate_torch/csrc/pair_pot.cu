// Kernel B: the all-pairs potential (and total force squared) of whole
// configurations, the ThermEnergy estimator's pair sums.
//
// Replaces pathintegralgroundstate_tpu/ops/pallas_kernels.py
// pair_pot_pallas / _pot_kernel.  For each (walker w, bead row b) of
// R[W, B, N, D] it returns
//     pot = 1/2 sum_{i != j} V(r_ij)   over m = notself & r^2 <= rc^2
//     f2  = sum_i |F_i|^2, F_i = sum_j (dV/dr / r) x_ij   (with_force)
// with V from the plain Aziz form without force and from the fused (V, dV)
// form with force, as ops/pairwise.pair_pot.  Like the TPU kernel it has
// NO r^2 > 0 guard: exactly coincident particles give a non-finite f2.
//
// What bounds it on the H100: the arithmetic of the exp.  The main path
// calls it twice per measured step on the strided bead slices
// paths[:, 0:M-1:2] and paths[:, 1:M-1:2]: 1024*32*64^2 = 1.34e8 pair
// evaluations per call at the flagship shape, against 25 MB of input.
//
// Design: one block per (walker, bead) row.  The row's N positions are
// staged once in shared memory; thread i sums over its partners j != i
// from there, so device memory is read once per row.  A warp-shuffle and
// shared-memory block reduction gives the row's two sums.  The strided
// bead slices are read in place through the strides the wrapper passes.
#include <stdint.h>

#include "pigs_pair.cuh"

namespace {

template <typename T>
__global__ void pair_pot_kernel(Consts<T> c, const T* __restrict__ R,
                                long long sRw, long long sRb, long long sRn,
                                int B, int N, int with_force,
                                T* __restrict__ pot, T* __restrict__ f2) {
  extern __shared__ unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [3][N]
  T* red = xs + 3 * N;                     // [2][32]
  const long long row = blockIdx.x;
  const long long w = row / B;
  const long long b = row - w * B;
  const T* Rrow = R + w * sRw + b * sRb;
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      xs[k * N + t] = k < c.dim ? Rrow[t * sRn + k] : T(0);
  }
  __syncthreads();

  T pot_acc = T(0), f2_acc = T(0);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    T xi[3], F[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int k = 0; k < 3; ++k) xi[k] = xs[k * N + i];
    T p = T(0);
    for (int j = 0; j < N; ++j) {
      if (j == i) continue;
      T dx[3];
      T r2 = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dx[k] = wrap1(xi[k] - xs[k * N + j], c.L[k], c.half[k]);
        r2 += dx[k] * dx[k];
      }
      if (!(r2 <= c.rcut2)) continue;
      T r = sqrt(r2);
      if (with_force) {
        T v, dv;
        aziz_v_dv(c, r, T(1) / r, v, dv);
        p += v;
        T fr = dv / r;
#pragma unroll
        for (int k = 0; k < 3; ++k) F[k] += fr * dx[k];
      } else {
        p += aziz_v(c, r);
      }
    }
    pot_acc += p;
    if (with_force) f2_acc += F[0] * F[0] + F[1] * F[1] + F[2] * F[2];
  }

  pot_acc = warp_sum(pot_acc);
  f2_acc = warp_sum(f2_acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = pot_acc;
    red[32 + warp] = f2_acc;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    T a = lane < nw ? red[lane] : T(0);
    T f = lane < nw ? red[32 + lane] : T(0);
    a = warp_sum(a);
    f = warp_sum(f);
    if (lane == 0) {
      pot[row] = T(0.5) * a;
      f2[row] = f;
    }
  }
}

template <typename T>
int launch(const PairParams* p, const void* R, long long sRw, long long sRb,
           long long sRn, int W, int B, int N, int with_force, void* pot,
           void* f2, void* stream) {
  const long long rows = (long long)W * B;
  if (rows == 0) return 0;
  int threads = ((N + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (3 * (size_t)N + 64) * sizeof(T);
  pair_pot_kernel<T><<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      make_consts<T>(*p), (const T*)R, sRw, sRb, sRn, B, N, with_force,
      (T*)pot, (T*)f2);
  return (int)cudaGetLastError();
}

}  // namespace

#define PIGS_PAIR_POT_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const PairParams* p, const void* R, long long sRw,    \
                      long long sRb, long long sRn, int W, int B, int N,    \
                      int with_force, void* pot, void* f2, void* stream) {  \
    return launch<T>(p, R, sRw, sRb, sRn, W, B, N, with_force, pot, f2,     \
                     stream);                                               \
  }

PIGS_PAIR_POT_ENTRY(pigs_pair_pot_f32, float)
PIGS_PAIR_POT_ENTRY(pigs_pair_pot_f64, double)
