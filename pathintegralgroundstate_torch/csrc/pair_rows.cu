// Kernel A: the window pair pass of every Monte Carlo move, with the action
// epilogue.
//
// Replaces pathintegralgroundstate_tpu/ops/pallas_kernels.py
// pair_rows_pallas / _rows_kernel, and the elementwise work the reference's
// delta_action_rows / delta_action_sum do after it.  For each (walker w,
// window row b) and for BOTH Metropolis sides x = xnew[w, b] and
// x = xold[w, b] against the N partners R[w, b, :, :] it computes the
// single-image minimum image, r^2, the self / rcut / coincidence masks (sum
// V over m = notself & r^2 <= rc^2; force and u over mf = m & r^2 > 0) and
// the fused (V, dV/dr) and u of the pair model (pigs_pair.cuh: the
// potential PK and the Jastrow JK template parameters), and writes the
// row's action delta
//     dS_b = wv dpot + wf (|F(new)|^2 - |F(old)|^2) - wpsi du
// with the Chin weights (wv, wf, wpsi) = tab[:, ib[b]] of the row's bead
// (the force term only when need_f2, the u term only when need_wf), times
// the row weight rw[b] when given; with `reduce`, the walker's sum over its
// rows instead.  The plain form is ops/kernels.pair_rows_ref.
//
// What bounded the first design (one warp per row): at N = 64 a lane
// evaluated two partners and then ran ten five-step shuffle reductions, so
// the per-row reduction cost as much as the pair arithmetic; a level of 1-8
// rows filled at most one wave of the card; every row paid an emulated
// 64-bit division, scalar 4-byte partner loads, and after the kernel the
// caller launched 4-7 elementwise kernels to weight and sum the rows.
//
// This design: a group of G lanes per row (G = 4, 8, 16 or 32, chosen by
// the wrapper from the row count W*B and N: few lanes per row when rows are
// many, many when they are few), so each lane evaluates N/G partners and
// the reductions take log2(G) shuffle steps over eight sums.  A block holds
// `wpb` walkers (threadIdx.y) of `spw` row slots each (threadIdx.x / G), so
// no thread divides and every index is 32-bit.  Each slot stages its row's
// N*D partners into shared memory, padded so that the lanes of a warp read
// distinct banks: with 16-byte cp.async copies where the wrapper has seen
// that the row is one contiguous slab of 16-byte multiples at 16-byte
// aligned addresses (`vec16`), else element by element through the
// particle stride (any N, e.g. N*D*4 not a multiple of 16 in float32).  The
// window is still read IN PLACE from `paths` through its strides, and a
// reversed window (the half-1 worm centre buffer, swap, the tail half-chain
// move) through a NEGATIVE bead stride from its last row.  r and Rm/r come
// from one rsqrt (pigs_pair.cuh).  The epilogue weights the row and writes
// dS, or sums the walker's rows in shared memory and writes one value per
// walker.
//
// Dimensions and dtypes (pigs_pair.cuh): DP = 3 for dim <= 3, DP = 0 for
// dim >= 4, whose moved particle's two positions are read in place from
// xn / xo and whose lanes keep their two force sums in shared memory after
// the walkers' row sums (2 dim values per thread); a bfloat16 window is
// staged as it is stored (half the bytes of float32, so the 16-byte rule
// holds at other N) and converted to float32 as it is read.
//
// What bounds it now: the pair arithmetic, not the bytes.  Each partner
// and row costs a long dependent chain per side (minimum image, rsqrt, two
// exps, the force and u terms) at about 86 registers a thread in float32
// (16 resident warps per SM in blocks of 256); neither smaller blocks (more
// resident warps) nor a register cap measured faster.  Below B = 8 the
// launch itself sets the time.
#include <stdint.h>

#include "pigs_pair.cuh"

// Host-side launch description, filled by ops/kernels.py (_RowsArgs).
// Strides in elements; sRb < 0 reads the window backwards.
struct RowsArgs {
  long long sRw, sRb, sRn, sNw, sNb, sOw, sOb;
  long long ip0;
  int ip_mode;  // ip: 0 scalar ip0, 1 [W], 2 [W, B], 3 [1, B]
  int ib_mode;  // ib: 0 [B], 1 [W, B]
  int M;        // row length of the Chin table tab [3, M]
  int W, B, N;
  int need_wf, need_f2, reduce;
  int G, spw, wpb;  // lanes per row, row slots per walker, walkers per block
  int slab;         // shared-memory elements per row slot (>= N*D, padded)
  int vec16;        // 1: rows staged by 16-byte copies, 0: element by element
};

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bytes of the staged rows of a block, rounded up to the alignment of the
// row sums that follow them (ops/kernels.rows_layout mirrors this layout).
template <typename S>
__host__ __device__ inline size_t slab_bytes(const RowsArgs& a) {
  return round_up((size_t)a.wpb * a.spw * a.slab * sizeof(S),
                  sizeof(compute_t<S>));
}

template <typename S, int G, int PK, int JK, int DP>
__global__ void __launch_bounds__(kMaxThreads)
pair_rows_kernel(Consts<compute_t<S>> c, RowsArgs a, const S* __restrict__ R,
                 const S* __restrict__ xn, const S* __restrict__ xo,
                 const long long* __restrict__ ip,
                 const long long* __restrict__ ib,
                 const S* __restrict__ tab, const S* __restrict__ rw,
                 S* __restrict__ out) {
  using T = compute_t<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(S);
  const int l = threadIdx.x & (G - 1);
  const int slot = threadIdx.x / G;
  const int wl = threadIdx.y;
  const int w = blockIdx.x * a.wpb + wl;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned mask = group_mask(tid & 31, G);
  S* slab = reinterpret_cast<S*>(smem_raw) + (wl * a.spw + slot) * a.slab;
  T* part;
  if constexpr (sizeof(S) == sizeof(T))
    part = reinterpret_cast<T*>(smem_raw) + a.wpb * a.spw * a.slab;
  else
    part = reinterpret_cast<T*>(smem_raw + slab_bytes<S>(a));
  const int D = c.dim;
  const int nvec = a.N * D / kVec;
  const bool need_f2 = a.need_f2, need_wf = a.need_wf;
  T acc = T(0);
  if (w < a.W) {
    for (int b = slot; b < a.B; b += a.spw) {
      const S* row = R + w * a.sRw + b * a.sRb;
      if (a.vec16) {
        for (int i = l; i < nvec; i += G)
          cp_async16(slab + i * kVec, row + i * kVec);
        cp_async_wait_all();
      } else {
        for (int j = l; j < a.N; j += G)
          for (int k = 0; k < D; ++k) slab[j * D + k] = row[j * a.sRn + k];
      }
      __syncwarp(mask);
      const long long p = a.ip_mode == 0   ? a.ip0
                          : a.ip_mode == 1 ? ip[w]
                          : a.ip_mode == 2 ? ip[w * a.B + b]
                                           : ip[b];
      T dS;
      if constexpr (DP > 0) {
        T xnv[3], xov[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xnv[k] = k < c.dim ? to_c<T>(xn[w * a.sNw + b * a.sNb + k]) : T(0);
          xov[k] = k < c.dim ? to_c<T>(xo[w * a.sOw + b * a.sOb + k]) : T(0);
        }
        RowPart<T> r = row_part<PK, JK>(c, slab, a.N, p, xnv, xov, need_f2,
                                        need_wf, l, G);
        group_sum(r, G, mask, need_f2, need_wf);
        const long long jb = a.ib_mode ? ib[w * a.B + b] : ib[b];
        dS = row_ds(r, to_c<T>(tab[jb]), to_c<T>(tab[a.M + jb]),
                    to_c<T>(tab[2 * a.M + jb]), need_f2, need_wf);
      } else {  // positions read in place, forces in the thread's scratch
        RowPartN<T> r = row_part_n<PK, JK>(
            c, slab, a.N, p, Pt<T, S, 0>(c, xn + w * a.sNw + b * a.sNb),
            Pt<T, S, 0>(c, xo + w * a.sOw + b * a.sOb), need_f2, need_wf, l,
            G, part + a.wpb * a.spw, 0, blockDim.x * blockDim.y, tid);
        group_sum_n(c, r, G, mask, need_f2, need_wf);
        const long long jb = a.ib_mode ? ib[w * a.B + b] : ib[b];
        dS = row_ds_n(D, r.dpot, r.du, r.Fn, r.Fo, to_c<T>(tab[jb]),
                      to_c<T>(tab[a.M + jb]), to_c<T>(tab[2 * a.M + jb]),
                      need_f2, need_wf);
      }
      if (rw != nullptr) dS = dS * to_c<T>(rw[b]);
      if (!a.reduce && l == 0) out[w * a.B + b] = to_s<S>(dS);
      acc += dS;
      __syncwarp(mask);  // the slab is read before the next row overwrites it
    }
  }
  if (a.reduce) {
    if (l == 0) part[wl * a.spw + slot] = acc;
    __syncthreads();
    if (threadIdx.x == 0 && w < a.W) {
      T s = T(0);
      const int n = min(a.spw, a.B);
      for (int i = 0; i < n; ++i) s += part[wl * a.spw + i];
      out[w] = to_s<S>(s);
    }
  }
}

template <typename S, int G, int PK, int JK, int DP>
int launch_g(const PairParams* p, const RowsArgs* a, const void* R,
             const void* xn, const void* xo, const void* ip, const void* ib,
             const void* tab, const void* rw, void* out, void* stream) {
  using T = compute_t<S>;
  const int nthr = G * a->spw * a->wpb;
  const size_t smem =
      slab_bytes<S>(*a) +
      ((size_t)a->wpb * a->spw + scratch_elems(DP, p->dim, 2, nthr)) *
          sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_rows_kernel<S, G, PK, JK, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(G * a->spw, a->wpb);
  const dim3 grid((a->W + a->wpb - 1) / a->wpb);
  pair_rows_kernel<S, G, PK, JK, DP>
      <<<grid, block, smem, (cudaStream_t)stream>>>(
      make_consts<T>(*p), *a, (const S*)R, (const S*)xn, (const S*)xo,
      (const long long*)ip, (const long long*)ib, (const S*)tab,
      (const S*)rw, (S*)out);
  return (int)cudaGetLastError();
}

template <typename S>
int launch(const PairParams* p, const RowsArgs* a, const void* R,
           const void* xn, const void* xo, const void* ip, const void* ib,
           const void* tab, const void* rw, void* out, void* stream) {
  if (a->W == 0 || a->B == 0) return 0;
  if (a->G * a->spw * a->wpb > kMaxThreads) return (int)cudaErrorInvalidValue;
  return with_dims(p->dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return with_pair_model(*p, [&](auto pk, auto jk) {
      constexpr int PK = decltype(pk)::value, JK = decltype(jk)::value;
      switch (a->G) {
        case 4:
          return launch_g<S, 4, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab, rw,
                                            out, stream);
        case 8:
          return launch_g<S, 8, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab, rw,
                                            out, stream);
        case 16:
          return launch_g<S, 16, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab,
                                             rw, out, stream);
        case 32:
          return launch_g<S, 32, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab,
                                             rw, out, stream);
        default:
          return (int)cudaErrorInvalidValue;
      }
    });
  });
}

}  // namespace

#define PIGS_PAIR_ROWS_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const PairParams* p, const RowsArgs* a, const void* R, \
                      const void* xn, const void* xo, const void* ip,         \
                      const void* ib, const void* tab, const void* rw,        \
                      void* out, void* stream) {                              \
    return launch<T>(p, a, R, xn, xo, ip, ib, tab, rw, out, stream);          \
  }

#if PIGS_HAS(0)
PIGS_PAIR_ROWS_ENTRY(pigs_pair_rows_f32, float)
#endif
#if PIGS_HAS(1)
PIGS_PAIR_ROWS_ENTRY(pigs_pair_rows_f64, double)
#endif
#if PIGS_HAS(2)
PIGS_PAIR_ROWS_ENTRY(pigs_pair_rows_bf16, __nv_bfloat16)
#endif
