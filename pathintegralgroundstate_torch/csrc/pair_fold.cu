// The exact-F^2 fold: the window pair pass of every move under the Chin
// action's full F^2 term with the odd-bead force-field cache
// (cfg.exact_f2 with cfg.f2_cache), with its action epilogue.
//
// It replaces no TPU kernel: the JAX package takes these window passes off
// its rows kernel (pairwise.py:415) and folds the cache in jnp, which XLA
// fuses into the step's program.  Eager PyTorch ran the same fold
// (ops/pairwise._fold_rows, the plain form) as about a hundred launches a
// call: the two Metropolis sides' pair passes with the pair forces
// materialised as [W, B, N, D] each, the fold's algebra and the Chin
// weighting, so the host's launch calls set the pace of every exact-F^2
// run.  This kernel is the whole call in one launch.
//
// For each (walker w, window row b) and for BOTH Metropolis sides x =
// xnew[w, b] and x = xold[w, b] against the N partners R[w, b, :, :] it
// computes, as kernel A does (pair_rows.cu, pigs_pair.cuh), the single-image
// minimum image, r^2, the masks (sum V over m = notself & r^2 <= rc^2;
// force and u over mf = m & r^2 > 0) and the fused (V, dV/dr) and u of the
// pair model.  On the fold rows b = r0 + s k of fold_sub (r0, s), the
// window's odd beads, and there only, it also forms each partner's pair
// force on both sides in registers, never in memory, and with the cache
// row fold[w, k, j, :] beneath partner j
//     dg_j    = -(fp_j(new) - fp_j(old))
//     dF^2    = |F(new)|^2 - |F(old)|^2 + sum_j (2 fold_j . dg_j + |dg_j|^2)
//     dfield[w, k, j] = dg_j,   dfield[w, k, ip] = F(new) - F(old),
// dfield being the cache increment of an accepted move.  Every other row
// is an even bead, whose F^2 weight is 0: the forces are skipped there.  The
// row's action delta is
//     dS_b = wv dpot + wf dF^2 - wpsi du
// with (wv, wf, wpsi) = tab[:, ib[b]] (u only when need_wf), times the row
// weight rw[b] when given; with `reduce`, the walker's sum over its rows.
// The plain form is ops/kernels.pair_fold_ref (pairwise._fold_rows).
//
// What bounds it: bytes, the window's rows read once, the cache rows read
// and the increments written (an end window of 16 rows over 8 cache rows
// at W=1024 in float32 is about 25 MB, 7.65 us at 3.35 TB/s; measured on
// an H100 24.5 us, PERF.md), and at the few walkers of a host-bound run
// the launch itself.  The design is kernel A's row layout
// (ops/kernels.rows_lanes, rows_layout): G lanes a row, each lane taking
// the partners j = l, l + G, ... of the row staged in padded
// shared memory, so that neighbouring lanes read and write neighbouring
// particles' cache rows and increments in global memory, and log2(G)
// shuffle steps for the row's sums.  R is read in place through its
// strides (a reversed window through a negative bead stride from its last
// row), the cache rows through theirs; dfield is written contiguous.
//
// Kernel A's flagship rows carry no per-partner force and no cache, so the
// fold is a kernel of its own and shares only pigs_pair.cuh's device
// functions.  Dimensions as kernel A (DP = 3 for dim <= 3, DP = 0 with the
// dimension at run time and each lane's two force sums in shared memory);
// float32 and float64 only (kernels.fold_route): bfloat16 runs the plain
// fold.
#include <stdint.h>

#include "pigs_pair.cuh"

// Host-side launch description, filled by ops/kernels.py (_FoldArgs).
// Strides in elements; sRb < 0 reads the window backwards.  Long longs
// first, ints last: no padding.
struct FoldArgs {
  long long sRw, sRb, sRn, sNw, sNb, sOw, sOb;
  long long sFw, sFk, sFn;  // the cache rows fold [W, mo, N, D]
  long long ip0;
  int ip_mode;  // ip: 0 scalar ip0, 1 [W], 2 [W, B], 3 [1, B]
  int ib_mode;  // ib: 0 [B], 1 [W, B]
  int M;        // row length of the Chin table tab [3, M]
  int W, B, N;
  int mo, r0, s;  // cache rows; the fold rows r0, r0 + s, ... of the window
  int need_wf, reduce;
  int G, spw, wpb;  // lanes per row, row slots per walker, walkers per block
  int slab;         // shared-memory elements per row slot (>= N*D, padded)
  int vec16;        // 1: rows staged by 16-byte copies, 0: element by element
};

#if PIGS_HAS(0) || PIGS_HAS(1)
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

// One Metropolis side of one pair at squared separation r2: adds V to pot
// over m and u to u over mf (when need_wf), and returns the pair force's
// scale dV/dr / r over mf, else 0 (pigs_pair.cuh's pair_side, with the
// force left to the caller).
template <int PK, int JK, typename T>
__device__ __forceinline__ T side_terms(const Consts<T>& c, T r2,
                                        bool notself, bool need_wf, T& pot,
                                        T& u) {
  const T r2s = notself ? r2 : T(1);
  const T rinv = rsqrt(r2s);
  const T r = r2s * rinv;
  const bool m = notself && r2 <= c.rcut2;
  const bool mf = m && r2 > T(0);
  T v, dv;
  pot_v_dv<PK>(c, r, rinv, v, dv);
  if (m) pot += v;
  if (need_wf && mf) u += jastrow_u_q<JK>(c, r, c.Rm * rinv);
  return mf ? dv * rinv : T(0);
}

template <typename T, int G, int PK, int JK, int DP>
__global__ void __launch_bounds__(kMaxThreads)
pair_fold_kernel(Consts<T> c, FoldArgs a, const T* __restrict__ R,
                 const T* __restrict__ xn, const T* __restrict__ xo,
                 const long long* __restrict__ ip,
                 const long long* __restrict__ ib,
                 const T* __restrict__ tab, const T* __restrict__ rw,
                 const T* __restrict__ fold, T* __restrict__ out,
                 T* __restrict__ dfield) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kVec = 16 / sizeof(T);
  const int l = threadIdx.x & (G - 1);
  const int slot = threadIdx.x / G;
  const int wl = threadIdx.y;
  const int w = blockIdx.x * a.wpb + wl;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const unsigned mask = group_mask(tid & 31, G);
  T* slab = reinterpret_cast<T*>(smem_raw) + (wl * a.spw + slot) * a.slab;
  // the slots' walker sums, then (DP = 0) each thread's two force sums
  T* part = reinterpret_cast<T*>(smem_raw) + a.wpb * a.spw * a.slab;
  T* scr = part + a.wpb * a.spw;
  const int D = c.dim;
  const int N = a.N;
  const int nvec = N * D / kVec;
  const bool need_wf = a.need_wf;
  T acc = T(0);
  if (w < a.W) {
    for (int b = slot; b < a.B; b += a.spw) {
      const T* row = R + w * a.sRw + b * a.sRb;
      if (a.vec16) {
        for (int i = l; i < nvec; i += G)
          cp_async16(slab + i * kVec, row + i * kVec);
        cp_async_wait_all();
      } else {
        for (int j = l; j < N; j += G)
          for (int k = 0; k < D; ++k) slab[j * D + k] = row[j * a.sRn + k];
      }
      __syncwarp(mask);
      const long long p = a.ip_mode == 0   ? a.ip0
                          : a.ip_mode == 1 ? ip[w]
                          : a.ip_mode == 2 ? ip[w * a.B + b]
                                           : ip[b];
      const bool frow = b >= a.r0 && (b - a.r0) % a.s == 0;
      const int kf = (b - a.r0) / a.s;
      const T* frow_in = fold + w * a.sFw + (long long)kf * a.sFk;
      T* frow_out = dfield + ((long long)w * a.mo + kf) * N * D;
      const T* pn_x = xn + w * a.sNw + b * a.sNb;
      const T* po_x = xo + w * a.sOw + b * a.sOb;
      T pn = T(0), po = T(0), un = T(0), uo = T(0), fsum = T(0);
      T dS;
      const long long jb = a.ib_mode ? ib[w * a.B + b] : ib[b];
      if constexpr (DP > 0) {
        T xnv[3], xov[3], Fn[3], Fo[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xnv[k] = k < D ? pn_x[k] : T(0);
          xov[k] = k < D ? po_x[k] : T(0);
          Fn[k] = Fo[k] = T(0);
        }
        for (int j = l; j < N; j += G) {
          T dxn[3], dxo[3];
          T r2n = T(0), r2o = T(0);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const T rj = k < D ? slab[j * D + k] : T(0);
            dxn[k] = wrap1(xnv[k] - rj, c.L[k], c.half[k]);
            dxo[k] = wrap1(xov[k] - rj, c.L[k], c.half[k]);
            r2n += dxn[k] * dxn[k];
            r2o += dxo[k] * dxo[k];
          }
          const bool notself = j != p;
          const T frn = side_terms<PK, JK>(c, r2n, notself, need_wf, pn, un);
          const T fro = side_terms<PK, JK>(c, r2o, notself, need_wf, po, uo);
          if (frow) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              if (k >= D) break;
              const T fpn = frn * dxn[k], fpo = fro * dxo[k];
              Fn[k] += fpn;
              Fo[k] += fpo;
              const T dg = -(fpn - fpo);
              fsum += T(2) * frow_in[j * a.sFn + k] * dg + dg * dg;
              if (notself) frow_out[j * D + k] = dg;
            }
          }
        }
        T dpot = group_sum(pn - po, G, mask);
        dS = tab[jb] * dpot;
        if (frow) {
          T f2n = T(0), f2o = T(0);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            Fn[k] = group_sum(Fn[k], G, mask);
            Fo[k] = group_sum(Fo[k], G, mask);
            f2n += Fn[k] * Fn[k];
            f2o += Fo[k] * Fo[k];
          }
          fsum = group_sum(fsum, G, mask);
          dS = dS + tab[a.M + jb] * (f2n - f2o + fsum);
          if (l == 0 && p >= 0 && p < N)
            for (int k = 0; k < D; ++k) frow_out[p * D + k] = Fn[k] - Fo[k];
        }
      } else {  // positions read in place, forces in the thread's scratch
        const Pt<T, T, 0> xnv(c, pn_x), xov(c, po_x);
        const Vec<T, 0> Fn = vec_at<T, 0>(scr, 0, D, nthr, tid);
        const Vec<T, 0> Fo = vec_at<T, 0>(scr, 1, D, nthr, tid);
        for (int k = 0; k < D; ++k) Fn[k] = Fo[k] = T(0);
        for (int j = l; j < N; j += G) {
          const T* rj = slab + j * D;
          T r2n = T(0), r2o = T(0);
          for (int k = 0; k < D; ++k) {
            const T dn = wrap1(xnv[k] - rj[k], box_L<0>(c, k), box_h<0>(c, k));
            const T d0 = wrap1(xov[k] - rj[k], box_L<0>(c, k), box_h<0>(c, k));
            r2n += dn * dn;
            r2o += d0 * d0;
          }
          const bool notself = j != p;
          const T frn = side_terms<PK, JK>(c, r2n, notself, need_wf, pn, un);
          const T fro = side_terms<PK, JK>(c, r2o, notself, need_wf, po, uo);
          if (frow) {
            for (int k = 0; k < D; ++k) {
              const T fpn =
                  frn * wrap1(xnv[k] - rj[k], box_L<0>(c, k), box_h<0>(c, k));
              const T fpo =
                  fro * wrap1(xov[k] - rj[k], box_L<0>(c, k), box_h<0>(c, k));
              Fn[k] += fpn;
              Fo[k] += fpo;
              const T dg = -(fpn - fpo);
              fsum += T(2) * frow_in[j * a.sFn + k] * dg + dg * dg;
              if (notself) frow_out[j * D + k] = dg;
            }
          }
        }
        T dpot = group_sum(pn - po, G, mask);
        dS = tab[jb] * dpot;
        if (frow) {
          T f2n = T(0), f2o = T(0);
          for (int k = 0; k < D; ++k) {
            const T fn = group_sum(T(Fn[k]), G, mask);
            const T fo = group_sum(T(Fo[k]), G, mask);
            f2n += fn * fn;
            f2o += fo * fo;
            if (l == 0 && p >= 0 && p < N) frow_out[p * D + k] = fn - fo;
          }
          fsum = group_sum(fsum, G, mask);
          dS = dS + tab[a.M + jb] * (f2n - f2o + fsum);
        }
      }
      if (need_wf) dS = dS - tab[2 * a.M + jb] * group_sum(un - uo, G, mask);
      if (rw != nullptr) dS = dS * rw[b];
      if (!a.reduce && l == 0) out[w * a.B + b] = dS;
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
      out[w] = s;
    }
  }
}

template <typename T, int G, int PK, int JK, int DP>
int launch_g(const PairParams* p, const FoldArgs* a, const void* R,
             const void* xn, const void* xo, const void* ip, const void* ib,
             const void* tab, const void* rw, const void* fold, void* out,
             void* dfield, void* stream) {
  const int nthr = G * a->spw * a->wpb;
  const size_t smem =
      round_up((size_t)a->wpb * a->spw * a->slab * sizeof(T), sizeof(T)) +
      ((size_t)a->wpb * a->spw + scratch_elems(DP, p->dim, 2, nthr)) *
          sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_fold_kernel<T, G, PK, JK, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(G * a->spw, a->wpb);
  const dim3 grid((a->W + a->wpb - 1) / a->wpb);
  pair_fold_kernel<T, G, PK, JK, DP>
      <<<grid, block, smem, (cudaStream_t)stream>>>(
      make_consts<T>(*p), *a, (const T*)R, (const T*)xn, (const T*)xo,
      (const long long*)ip, (const long long*)ib, (const T*)tab,
      (const T*)rw, (const T*)fold, (T*)out, (T*)dfield);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const PairParams* p, const FoldArgs* a, const void* R,
           const void* xn, const void* xo, const void* ip, const void* ib,
           const void* tab, const void* rw, const void* fold, void* out,
           void* dfield, void* stream) {
  if (a->W == 0 || a->B == 0) return 0;
  if (a->G * a->spw * a->wpb > kMaxThreads || (a->s != 1 && a->s != 2))
    return (int)cudaErrorInvalidValue;
  return with_dims(p->dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return with_pair_model(*p, [&](auto pk, auto jk) {
      constexpr int PK = decltype(pk)::value, JK = decltype(jk)::value;
      switch (a->G) {
        case 4:
          return launch_g<T, 4, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab, rw,
                                            fold, out, dfield, stream);
        case 8:
          return launch_g<T, 8, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab, rw,
                                            fold, out, dfield, stream);
        case 16:
          return launch_g<T, 16, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab,
                                             rw, fold, out, dfield, stream);
        case 32:
          return launch_g<T, 32, PK, JK, DP>(p, a, R, xn, xo, ip, ib, tab,
                                             rw, fold, out, dfield, stream);
        default:
          return (int)cudaErrorInvalidValue;
      }
    });
  });
}

}  // namespace

#define PIGS_PAIR_FOLD_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const PairParams* p, const FoldArgs* a, const void* R, \
                      const void* xn, const void* xo, const void* ip,         \
                      const void* ib, const void* tab, const void* rw,        \
                      const void* fold, void* out, void* dfield,              \
                      void* stream) {                                         \
    return launch<T>(p, a, R, xn, xo, ip, ib, tab, rw, fold, out, dfield,    \
                     stream);                                                 \
  }

#if PIGS_HAS(0)
PIGS_PAIR_FOLD_ENTRY(pigs_pair_fold_f32, float)
#endif
#if PIGS_HAS(1)
PIGS_PAIR_FOLD_ENTRY(pigs_pair_fold_f64, double)
#endif
#endif  // PIGS_HAS(0) || PIGS_HAS(1)
