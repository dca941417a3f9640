// Kernel B: the all-pairs potential (and total force squared) of whole
// configurations, the ThermEnergy estimator's pair sums.
//
// Replaces pathintegralgroundstate_tpu/ops/pallas_kernels.py
// pair_pot_pallas / _pot_kernel.  For each (walker w, bead row b) of
// R[W, B, N, D] it returns
//     pot = 1/2 sum_{i != j} V(r_ij)   over m = notself & r^2 <= rc^2
//     f2  = sum_i |F_i|^2, F_i = sum_j (dV/dr / r) x_ij   (with_force)
// with V from the potential's plain form (r = sqrt(r^2)) without force and
// from the fused (V, dV) form with force, as ops/kernels.pair_pot_ref; the
// potential is the template parameter PK (pigs_pair.cuh).  Like the
// TPU kernel it has NO r^2 > 0 guard: exactly coincident particles give a
// non-finite f2.
//
// What bounds it on the H100: instruction issue.  The main path calls it
// twice per measured step on the strided bead slices paths[:, 0:M-1:2] (no
// force) and paths[:, 1:M-1:2] (force): 1024*32 rows of 64*63/2 pairs per
// call at the flagship shape, against 25 MB of input.  A pair costs over a
// hundred instructions with force (the minimum image, two exps, the force
// and its shuffled reaction; few of them FMAs) and more without (the plain
// V's four precise divisions and precise sqrt), issued near the schedulers'
// full rate; more resident warps or a deeper unroll moved it little
// (PERF.md).
//
// What bounded the first design (one block of N threads per row, thread i
// over its N-1 partners): every unordered pair was evaluated twice, with a
// precise sqrt and two precise divisions, and two data-dependent branches.
//
// This design evaluates each unordered pair ONCE.  A row's particles are
// cut into C = ceil(N/32) chunks of 32; a team of C warps takes the row,
// warp I holding particle 32 I + lane and its force F_i in registers.  The
// pairs of chunks are dealt out in rounds: round 0 is warp I's own tile
// (I, I), 16 rotations (the 16th on lanes 0-15 only); round k = 1..C/2 is
// the tile (I, I + k mod C), 32 rotations, split 16 and 16 between warps I
// and I + C/2 in the last round when C is even.  At rotation s lane l pairs
// with partner 32 J + (l + s) % 32, read from the row staged in shared
// memory; the partner's reaction -f reaches the lane that owns it by one
// warp shuffle of f from lane (l - s) % 32.  A round's reactions on the
// other chunk go through shared memory to its warp after the round (one
// writer per chunk and round, read in a fixed order), and the row's sums
// are added in warp order: no atomics, so two launches on the same input
// give bitwise the same result.  Masks are selects, never branches.  With
// force, r and 1/r come from one rsqrt (pigs_pair.cuh).  Several rows share
// a block of about 256 threads.  Each row is staged with 16-byte cp.async
// copies where the wrapper has seen that every row is one aligned slab of
// 16-byte multiples (kernels.slabs16), else element by element through the
// strides; the strided bead slices are read in place.  For dim >= 4 (DP =
// 0, pigs_pair.cuh) a lane reads its particle and its partners in place in
// the staged row, recomputes a pair's displacement for its force, and keeps
// its three force vectors (the pair's, its own sum and the round's
// reactions) in shared memory after the per-warp sums; the reaction buffer
// holds dim values per particle.  bfloat16 rows are staged as stored and
// read as float32.
#include <stdint.h>

#include "pigs_pair.cuh"

// Host-side launch description, filled by ops/kernels.py (_PotArgs).
// Strides in elements.
struct PotArgs {
  long long sRw, sRb, sRn;
  int W, B, N;
  int C;      // warps per row: ceil(N / 32)
  int rpb;    // rows per block
  int vec16;  // 1: rows staged by 16-byte copies, 0: element by element
};

namespace {

constexpr int kBlock = 256;  // threads per block, unless one row needs more

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One unordered pair (i, j): adds V(r_ij) to pot and, with force, sets f to
// the pair's force on i (-f on j), both only where valid & r^2 <= rc^2.
template <typename T, bool kForce, int PK, int DP, typename XI, typename XJ,
          typename FV>
__device__ __forceinline__ void pot_pair(const Consts<T>& c, const XI& xi,
                                         const XJ& xj, bool valid, T& pot,
                                         FV& f) {
  T dx[DP > 0 ? DP : 1];
  T r2 = T(0);
  const int nd = vdims<DP>(c.dim);
#pragma unroll
  for (int k = 0; k < nd; ++k) {
    const T d = wrap1(xi[k] - xj[k], box_L<DP>(c, k), box_h<DP>(c, k));
    if constexpr (DP > 0) dx[k] = d;
    r2 += d * d;
  }
  const bool m = valid && r2 <= c.rcut2;
  if (kForce) {
    const T rinv = rsqrt(r2);
    T v, dv;
    pot_v_dv<PK>(c, r2 * rinv, rinv, v, dv);
    pot += m ? v : T(0);
    const T fr = dv * rinv;
#pragma unroll
    for (int k = 0; k < nd; ++k) {
      if constexpr (DP > 0)
        f[k] = m ? fr * dx[k] : T(0);
      else
        f[k] = m ? fr * wrap1(xi[k] - xj[k], box_L<DP>(c, k),
                              box_h<DP>(c, k))
                 : T(0);
    }
  } else {
    const T v = pot_v<PK>(c, sqrt(r2));
    pot += m ? v : T(0);
  }
}

// Lane particle i of the staged row xs: DP > 0 in registers, zero past dim
// and for a lane without a particle (vi false); DP = 0 read in place.
template <int DP, typename T, typename S>
__device__ __forceinline__ auto lane_point(const Consts<T>& c, const S* xs,
                                           int i, bool vi) {
  if constexpr (DP > 0) {
    Vec<T, DP> x;
#pragma unroll
    for (int k = 0; k < DP; ++k)
      x[k] = vi && k < c.dim ? to_c<T>(xs[i * c.dim + k]) : T(0);
    return x;
  } else {
    return Pt<T, S, 0>(c, xs + i * c.dim);
  }
}

// Bytes of the staged rows of a block, rounded up to the alignment of the
// sums that follow them.
template <typename S>
__host__ __device__ inline size_t xs_bytes(const PotArgs& a, int D) {
  return round_up((size_t)a.rpb * 32 * a.C * D * sizeof(S),
                  sizeof(compute_t<S>));
}

template <typename S, int kMaxThreads, bool kForce, int PK, int DP>
__global__ void __launch_bounds__(kMaxThreads)
pair_pot_kernel(Consts<compute_t<S>> c, PotArgs a, const S* __restrict__ R,
                S* __restrict__ pot, S* __restrict__ f2) {
  using T = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(S);
  const int C = a.C, D = c.dim, npad = 32 * C, DB = vdims<DP>(D);
  const int lane = threadIdx.x & 31, I = threadIdx.x >> 5;
  const int team = threadIdx.y;
  const int nteam = blockDim.y;
  const long long row = (long long)blockIdx.x * a.rpb + team;
  const bool live = row < (long long)a.W * a.B;
  S* xs = reinterpret_cast<S*>(smem_raw) + team * npad * D;  // [npad][D]
  T* base = reinterpret_cast<T*>(smem_raw + xs_bytes<S>(a, D));
  T* buf = base + team * npad * DB;                          // [npad][DB]
  T* red = base + nteam * npad * (kForce ? DB : 0) + team * 2 * C;
  T* scr = base + nteam * (npad * (kForce ? DB : 0) + 2 * C);

  if (live) {
    const long long w = row / a.B;
    const S* Rrow = R + w * a.sRw + (row - w * a.B) * a.sRb;
    if (a.vec16) {
      const int nvec = a.N * D / kVec;
      for (int i = threadIdx.x; i < nvec; i += blockDim.x)
        cp_async16(xs + i * kVec, Rrow + i * kVec);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      for (int j = threadIdx.x; j < a.N; j += blockDim.x)
        for (int k = 0; k < D; ++k) xs[j * D + k] = Rrow[j * a.sRn + k];
    }
  }
  __syncthreads();

  const int i = 32 * I + lane;
  const bool vi = live && i < a.N;
  const int nthr = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nd = vdims<DP>(c.dim);
  const auto xi = lane_point<DP>(c, xs, i, vi);
  Vec<T, DP> f = vec_at<T, DP>(scr, 0, D, nthr, tid);
  Vec<T, DP> F = vec_at<T, DP>(scr, 1, D, nthr, tid);
  Vec<T, DP> G = vec_at<T, DP>(scr, 2, D, nthr, tid);
#pragma unroll
  for (int k = 0; k < nd; ++k) f[k] = F[k] = T(0);
  T p = T(0);

  // round 0: the tile (I, I), each pair once
#pragma unroll 4
  for (int s = 1; s <= 16; ++s) {
    const int j = 32 * I + ((lane + s) & 31);
    const Pt<T, S, DP> xj(c, xs + j * D);
    pot_pair<T, kForce, PK, DP>(c, xi, xj,
                                vi && j < a.N && (s < 16 || lane < 16), p, f);
    if (kForce) {
#pragma unroll
      for (int k = 0; k < nd; ++k) {
        const T fk = f[k];
        F[k] += fk - __shfl_sync(0xffffffffu, fk, (lane - s) & 31);
      }
    }
  }

  // rounds 1..C/2: the tile (I, J = I + k mod C)
  for (int k = 1; 2 * k <= C; ++k) {
    const int J = (I + k) % C;
    const bool half = 2 * k == C;
    const int s0 = half && I >= k ? 1 : 0;
    const int s1 = half ? s0 + 16 : 32;
#pragma unroll
    for (int q = 0; q < nd; ++q) G[q] = T(0);
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      const int j = 32 * J + ((lane + s) & 31);
      const Pt<T, S, DP> xj(c, xs + j * D);
      pot_pair<T, kForce, PK, DP>(c, xi, xj, vi && j < a.N, p, f);
      if (kForce) {
#pragma unroll
        for (int q = 0; q < nd; ++q) {
          const T fq = f[q];
          F[q] += fq;
          G[q] -= __shfl_sync(0xffffffffu, fq, (lane - s) & 31);
        }
      }
    }
    if (kForce) {  // the reactions on chunk J to warp J
#pragma unroll
      for (int q = 0; q < nd; ++q) buf[(32 * J + lane) * DB + q] = G[q];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < nd; ++q) F[q] += buf[i * DB + q];
      __syncthreads();
    }
  }

  T f2i = T(0);
  if (kForce) {
    if constexpr (DP == 3) {
      f2i = F[0] * F[0] + F[1] * F[1] + F[2] * F[2];
    } else {
      for (int k = 0; k < nd; ++k) f2i += F[k] * F[k];
    }
  }
  p = warp_sum(p);
  f2i = warp_sum(f2i);
  if (lane == 0) {
    red[I] = p;
    red[C + I] = f2i;
  }
  __syncthreads();
  if (threadIdx.x == 0 && live) {
    T sp = T(0), sf = T(0);
    for (int q = 0; q < C; ++q) {
      sp += red[q];
      sf += red[C + q];
    }
    pot[row] = to_s<S>(sp);
    f2[row] = to_s<S>(sf);
  }
}

// Dynamic shared memory of one block: the rows' partners, with force the
// reaction buffers, the per-warp sums and (DP = 0) the lanes' three force
// vectors.
template <typename S, int DP>
size_t pot_smem(const PotArgs& a, int D, bool force) {
  const size_t npad = 32 * (size_t)a.C;
  return xs_bytes<S>(a, D) +
         ((size_t)a.rpb * (npad * (force ? vdims<DP>(D) : 0) + 2 * a.C) +
          scratch_elems(DP, D, 3, (int)(npad * a.rpb))) *
             sizeof(compute_t<S>);
}

template <typename S, int kMaxThreads, bool kForce, int PK, int DP>
int launch_k(const Consts<compute_t<S>>& c, const PotArgs& a, const S* R,
             S* pot, S* f2, cudaStream_t stream) {
  const size_t smem = pot_smem<S, DP>(a, c.dim, kForce);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_pot_kernel<S, kMaxThreads, kForce, PK, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows = (long long)a.W * a.B;
  const dim3 block(32 * a.C, a.rpb);
  const unsigned grid = (unsigned)((rows + a.rpb - 1) / a.rpb);
  pair_pot_kernel<S, kMaxThreads, kForce, PK, DP>
      <<<grid, block, smem, stream>>>(c, a, R, pot, f2);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const PairParams* p, const PotArgs* args, const void* R,
           int with_force, void* pot, void* f2, void* stream) {
  using T = compute_t<S>;
  PotArgs a = *args;
  if ((long long)a.W * a.B == 0) return 0;
  if (a.N > 1024) return (int)cudaErrorInvalidValue;
  a.C = a.N > 32 ? (a.N + 31) / 32 : 1;
  a.rpb = 32 * a.C >= kBlock ? 1 : kBlock / (32 * a.C);
  const Consts<T> c = make_consts<T>(*p);
  auto s = (cudaStream_t)stream;
  auto Rp = (const S*)R;
  auto po = (S*)pot, fo = (S*)f2;
  return with_dims(p->dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return with_pot_kind(p->pot_kind, [&](auto pk) {
      constexpr int PK = decltype(pk)::value;
      if (32 * a.C * a.rpb <= kBlock)
        return with_force
                   ? launch_k<S, kBlock, true, PK, DP>(c, a, Rp, po, fo, s)
                   : launch_k<S, kBlock, false, PK, DP>(c, a, Rp, po, fo, s);
      return with_force
                 ? launch_k<S, 1024, true, PK, DP>(c, a, Rp, po, fo, s)
                 : launch_k<S, 1024, false, PK, DP>(c, a, Rp, po, fo, s);
    });
  });
}

}  // namespace

#define PIGS_PAIR_POT_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const PairParams* p, const PotArgs* a, const void* R, \
                      int with_force, void* pot, void* f2, void* stream) {  \
    return launch<T>(p, a, R, with_force, pot, f2, stream);                \
  }

#if PIGS_HAS(0)
PIGS_PAIR_POT_ENTRY(pigs_pair_pot_f32, float)
#endif
#if PIGS_HAS(1)
PIGS_PAIR_POT_ENTRY(pigs_pair_pot_f64, double)
#endif
#if PIGS_HAS(2)
PIGS_PAIR_POT_ENTRY(pigs_pair_pot_bf16, __nv_bfloat16)
#endif
