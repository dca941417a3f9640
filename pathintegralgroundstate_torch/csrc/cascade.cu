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
// What bounded the first design (one warp per slot): the warp walked
// the slot's displaced rows one after the other, 16 dependent row passes
// per `ends` slot (the gate, then 1 + 2 + 4 + 8 midpoints), each with ten
// five-step shuffle reductions and two warp barriers, and each waiting for
// its partner row to arrive from memory when the chain reached it.
//
// This design: one block of kThreads = 64 threads per (walker, slot) (128
// and 256 measured slower, PERF.md).  The midpoints of one level do not
// depend on each other (a level's anchors p +- d2 are multiples of delta,
// never its own midpoints), so each level is ONE parallel pass: its
// 2^(ilev-1) rows are spread over the block in lane groups of
// G = kThreads / rows threads (at most the partners' power of two, at
// least 4), reduced over warp shuffles; a group of up to 32 lanes leaves
// its row's dS in shared memory, a row spread over several warps its
// partial sums.  Every thread then adds the level's rows in order and
// takes the same gate decision, so the early exit stays a block-uniform
// return.  The chain is nlev (+1) dependent passes, not L - 1 (+1).  The
// slot's whole partner window, (L+1) bead rows of N*D values (13 KB at the
// flagship in float32), is staged into shared memory at entry: where the
// wrapper has seen that it is one contiguous slab of 16-byte multiples at
// a 16-byte aligned address (`bulk`: paths contiguous, N*D*sizeof(T) a
// multiple of 16) one thread starts a single bulk asynchronous copy (the
// TMA's 1-D cp.async.bulk, completing on an mbarrier); otherwise (any N,
// any layout of paths) the block copies it element by element through the
// bead and particle strides.  The slot's gaussians and gate uniforms are
// staged beside it and the end guess is computed while the bulk copy is in
// flight, so no level waits on a global load.  The moved particle's old
// positions and its proposals live in two separate arrays, so that a
// level's proposals read only what earlier levels wrote.  The windows are
// read and written IN PLACE by start bead and direction (the tail window is
// head-oriented: start M-1, direction -1), so the TPU's stacked window copy
// [W, S, L+1, N, D] is never made.  This is race-free: a block writes only
// its own particle at its own slot's displaced beads, which no other slot
// reads.
//
// What bounds it now: the chain of an accepted slot.  At W = 1024 most
// blocks of a launch are resident at once (2 warps, 66 registers and 14 KB
// in float32: 14 blocks per SM, 1,848 on the card for the 2,048 slots of an
// `ends` launch), so the launch lasts about as long as its busiest SM takes
// over its slots, and an accepted slot runs 16 row evaluations per
// thread, each a long dependent chain of pair arithmetic, and five
// block-wide gates.  Wider blocks shorten the chain but leave lanes idle at
// the one-row levels and hold fewer slots per SM: slower.  Bytes do not
// bound it (13 KB per slot).
//
// Dimensions and dtypes (pigs_pair.cuh): the moved particle's positions
// and gaussians are kept with DV components per window position, DV = 3
// for dim <= 3 (DP = 3) and DV = dim above (DP = 0, whose threads keep a
// proposal and two force sums in shared memory after the row sums).  A
// bfloat16 window is staged as stored and read as float32; each proposal
// is rounded to bfloat16 when it is made, so that later levels, the gates
// and the write-back all see the position the tensor will hold.
#include <stdint.h>

#include "pigs_pair.cuh"

namespace {

constexpr int kMaxSlots = 64;
constexpr int kThreads = 64;  // a block's threads (ops/kernels.CASCADE_BLOCK)

// Row-sum entries of one gate: a level's rows (at most L/2), or the
// 2 + 2 DV partial sums of each warp chunk of the rows of a gate whose rows
// span several warps (kThreads/32 chunks).  ops/kernels.cascade_smem
// mirrors this.
__host__ __device__ constexpr int cascade_buf(int L, int DV) {
  return L / 2 > (kThreads / 32) * (2 + 2 * DV) ? L / 2
                                                : (kThreads / 32) *
                                                      (2 + 2 * DV);
}

// Shared memory of one block: the window's L+1 partner rows (as stored),
// then in the arithmetic type the moved particle's old and proposed
// positions and the slot's gaussians (DV each per position), its gate
// uniforms, two sets of row sums and (DP = 0) three vectors per thread.
template <typename S, int DP>
size_t cascade_smem_bytes(int L, int N, int D, int ngate) {
  const int DV = vdims<DP>(D);
  return round_up((size_t)(L + 1) * N * D * sizeof(S),
                  sizeof(compute_t<S>)) +
         (3 * (size_t)(L + 1) * DV + ngate + 2 * (size_t)cascade_buf(L, DV) +
          scratch_elems(DP, D, 3, kThreads)) *
             sizeof(compute_t<S>);
}

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

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arm the barrier for `bytes` and copy them from global src to shared dst
// in one bulk asynchronous copy that completes on the barrier.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The summed dS of one gate's m rows at window positions p0 + q dp.  With
// d2 > 0 the rows are a bisection level's midpoints: each row group builds
// its proposal from the current window (segn) and the gaussians (rgs) and
// stores it in segn, which no row of this level reads.  With d2 == 0 the
// row is the end gate and its proposal is already in segn.  Row groups of
// G of the kThreads threads; a group of up to 32 lanes leaves its row's dS
// in buf[q], a row of more lanes (cpr warp chunks of 32) its 2 + 2 DV
// partial sums per chunk.  Every thread returns the same sum, the rows
// added in order.  scr: the DP = 0 threads' vectors.
template <int PK, int JK, int DP, typename S, typename T>
__device__ __forceinline__ T gate_ds(const Consts<T>& c, const S* slab,
                                     int N, int L, int dir, int ip,
                                     const T* seg, T* segn, const T* rgs,
                                     T* buf, int m, int p0, int dp, int d2,
                                     T sigma, T wv, T wf, T wpsi,
                                     bool need_f2, bool need_wf, int gmax,
                                     T* scr) {
  const int t = threadIdx.x;
  const int D = c.dim;
  const int DV = vdims<DP>(D), ES = 2 + 2 * DV;
  const int G = max(4, min(kThreads / m, gmax));
  const int width = min(G, 32);
  const int cpr = max(1, G / 32);  // warp chunks per row
  const int l = t & (G - 1);
  const unsigned mask = group_mask(t & 31, width);
  for (int q0 = 0; q0 < m; q0 += kThreads / G) {
    const int q = q0 + t / G;
    if constexpr (DP > 0) {
      RowPart<T> r = {};
      if (q < m) {
        const int p = p0 + q * dp;
        T xo[3], xn[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xo[k] = seg[p * 3 + k];
          xn[k] = d2 ? T(0) : segn[p * 3 + k];
        }
        if (d2) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const T xp = xo[k] + wrap1(segn[(p - d2) * 3 + k] - xo[k],
                                       c.L[k], c.half[k]);
            const T xq = xo[k] - wrap1(xo[k] - segn[(p + d2) * 3 + k],
                                       c.L[k], c.half[k]);
            xn[k] = k < D ? round_s<S>(wrap1(T(0.5) * (xp + xq) +
                                                 sigma * rgs[p * 3 + k],
                                             c.L[k], c.half[k]))
                          : T(0);
          }
          if (l == 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) segn[p * 3 + k] = xn[k];
          }
        }
        const int row = dir > 0 ? p : L - p;
        r = row_part<PK, JK>(c, slab + row * N * D, N, ip, xn, xo, need_f2,
                             need_wf, l, G);
      }
      group_sum(r, width, mask, need_f2, need_wf);
      if (q < m && (l & (width - 1)) == 0) {
        if (cpr == 1) {
          buf[q] = row_ds(r, wv, wf, wpsi, need_f2, need_wf);
        } else {
          T* e = buf + (q * cpr + l / 32) * 8;
          e[0] = r.dpot;
          e[1] = r.du;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            e[2 + k] = r.Fn[k];
            e[5 + k] = r.Fo[k];
          }
        }
      }
    } else {  // the proposal and the forces in the thread's vectors
      const int p = p0 + q * dp;
      const int row = dir > 0 ? p : L - p;
      const Vec<T, 0> xn = vec_at<T, 0>(scr, 2, D, kThreads, t);
      const Pt<T, T, 0> xo(c, seg + p * D);
      if (q < m) {
        for (int k = 0; k < D; ++k) {
          const T Lk = box_L<0>(c, k), hk = box_h<0>(c, k);
          if (d2) {
            const T xp = xo[k] + wrap1(segn[(p - d2) * D + k] - xo[k], Lk, hk);
            const T xq = xo[k] - wrap1(xo[k] - segn[(p + d2) * D + k], Lk, hk);
            xn[k] = round_s<S>(
                wrap1(T(0.5) * (xp + xq) + sigma * rgs[p * D + k], Lk, hk));
          } else {
            xn[k] = segn[p * D + k];
          }
        }
        if (d2 && l == 0)
          for (int k = 0; k < D; ++k) segn[p * D + k] = xn[k];
      }
      // rows past m sum nothing (N = 0) but join the group's shuffles
      RowPartN<T> r = row_part_n<PK, JK>(
          c, slab + (q < m ? row : 0) * N * D, q < m ? N : 0, ip, xn, xo,
          need_f2, need_wf, l, G, scr, 0, kThreads, t);
      group_sum_n(c, r, width, mask, need_f2, need_wf);
      if (q < m && (l & (width - 1)) == 0) {
        if (cpr == 1) {
          buf[q] = row_ds_n(D, r.dpot, r.du, r.Fn, r.Fo, wv, wf, wpsi,
                            need_f2, need_wf);
        } else {
          T* e = buf + (q * cpr + l / 32) * ES;
          e[0] = r.dpot;
          e[1] = r.du;
          for (int k = 0; k < D; ++k) {
            e[2 + k] = r.Fn[k];
            e[2 + DV + k] = r.Fo[k];
          }
        }
      }
    }
  }
  __syncthreads();
  T dS = T(0);
  if (cpr == 1) {
    for (int q = 0; q < m; ++q) dS += buf[q];
    return dS;
  }
  for (int q = 0; q < m; ++q) {
    if constexpr (DP > 0) {
      RowPart<T> r = {};
      for (int i = 0; i < cpr; ++i) {
        const T* e = buf + (q * cpr + i) * 8;
        r.dpot += e[0];
        r.du += e[1];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          r.Fn[k] += e[2 + k];
          r.Fo[k] += e[5 + k];
        }
      }
      dS += row_ds(r, wv, wf, wpsi, need_f2, need_wf);
    } else {  // the same sums, component by component
      T dpot = T(0), du = T(0), f2n = T(0), f2o = T(0);
      for (int i = 0; i < cpr; ++i) {
        dpot += buf[(q * cpr + i) * ES];
        du += buf[(q * cpr + i) * ES + 1];
      }
      for (int k = 0; k < D; ++k) {
        T fn = T(0), fo = T(0);
        for (int i = 0; i < cpr; ++i) {
          fn += buf[(q * cpr + i) * ES + 2 + k];
          fo += buf[(q * cpr + i) * ES + 2 + DV + k];
        }
        f2n += fn * fn;
        f2o += fo * fo;
      }
      T d = wv * dpot;
      if (need_f2) d = d + wf * (f2n - f2o);
      if (need_wf) d = d - wpsi * du;
      dS += d;
    }
  }
  return dS;
}

// paths [W, M, N, D] with strides sW, sM, sN (elements; the coordinate
// axis contiguous); bulk: the window is one aligned contiguous slab.
template <typename S, int PK, int JK, int DP>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(Consts<compute_t<S>> c, CascadeArgs a, S* __restrict__ paths,
               long long sW, long long sM, long long sN,
               const S* __restrict__ rg, const S* __restrict__ ru,
               const bool* __restrict__ act, long long sAw, long long sAs,
               bool* __restrict__ acc, int S_, int N, int L, int nlev,
               int ends, int bulk, int gmax) {
  using T = compute_t<S>;
  __shared__ __align__(8) unsigned long long bar;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int w = blockIdx.x, s = blockIdx.y;
  const long long task = (long long)w * S_ + s;
  const int t = threadIdx.x;
  if (!act[w * sAw + s * sAs]) {
    if (t == 0) acc[task] = false;
    return;
  }
  const int D = c.dim;
  const int DV = vdims<DP>(D);
  const int ND = N * D;
  const int ip = a.ip[s];
  const int dir = a.dir[s];
  const long long b0 = a.bead0[s];
  const long long lo = dir > 0 ? b0 : b0 - L;  // the window's first bead
  const int ngate = nlev + ends;
  const int E = cascade_buf(L, DV);
  S* slab = reinterpret_cast<S*>(smem_raw);  // [L+1][N][D], forward beads
  T* seg = reinterpret_cast<T*>(             // [L+1][DV] old positions
      smem_raw + round_up((size_t)(L + 1) * ND * sizeof(S), sizeof(T)));
  T* segn = seg + (L + 1) * DV;              // [L+1][DV] proposed positions
  T* rgs = segn + (L + 1) * DV;              // [L+1][DV] the slot's gaussians
  T* rus = rgs + (L + 1) * DV;               // [ngate] its gate uniforms
  T* buf = rus + ngate;                      // [2][E] row sums
  T* scr = buf + 2 * E;                      // DP = 0: threads' vectors
  S* walker = paths + w * sW;
  const S* rgw = rg + task * (L + 1) * D;
  const S* ruw = ru + task * ngate;

  const unsigned bar_s = smem_u32(&bar);
  if (bulk) {
    if (t == 0) {
      mbar_init(bar_s, 1);
      bulk_load(smem_u32(slab), walker + lo * ND,
                (unsigned)((L + 1) * ND * sizeof(S)), bar_s);
    }
  } else {
    for (int i = t; i < (L + 1) * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      const S* src = walker + (lo + j) * sM + n * sN;
      for (int k = 0; k < D; ++k) slab[i * D + k] = src[k];
    }
  }
  // while the window is in flight: the slot's draws into shared memory,
  // and the end guess
  for (int i = t; i < (L + 1) * DV; i += kThreads) {
    const int p = i / DV, k = i - DV * p;
    rgs[i] = k < D ? to_c<T>(rgw[p * D + k]) : T(0);
  }
  if (t < ngate) rus[t] = to_c<T>(ruw[t]);
  const S* x0 = walker + b0 * sM + ip * sN;
  const S* xL = walker + (b0 + dir * L) * sM + ip * sN;
  const T sig = sqrt(T(double(L) * a.dt));
  // component k of the free-gaussian end guess
  const auto guess = [&](int k) {
    const T xmid = to_c<T>(x0[k]) -
                   wrap1(to_c<T>(x0[k]) - to_c<T>(xL[k]), box_L<DP>(c, k),
                         box_h<DP>(c, k));
    return round_s<S>(wrap1(xmid + sig * to_c<T>(rgw[k]), box_L<DP>(c, k),
                            box_h<DP>(c, k)));
  };
  T xn0[DP > 0 ? DP : 1] = {};
  if constexpr (DP > 0) {
    if (ends) {
#pragma unroll
      for (int k = 0; k < DP; ++k) {
        if (k < D) xn0[k] = guess(k);
      }
    }
  }
  __syncthreads();  // the barrier's initialisation (or the copy) is visible
  if (bulk) mbar_wait(bar_s, 0);
  for (int i = t; i < (L + 1) * DV; i += kThreads) {
    const int p = i / DV, k = i - DV * p;
    const T v =
        k < D ? to_c<T>(slab[(dir > 0 ? p : L - p) * ND + ip * D + k]) : T(0);
    seg[i] = v;
    if constexpr (DP > 0)
      segn[i] = ends && p == 0 ? xn0[k] : v;
    else
      segn[i] = ends && p == 0 ? guess(k) : v;
  }
  __syncthreads();

  int gate = 0;
  if (ends) {
    const T dS0 = gate_ds<PK, JK, DP, S, T>(
        c, slab, N, L, dir, ip, seg, segn, rgs, buf, 1, 0, 1, 0, T(0),
        T(a.wv_end), T(0), T(1), false, true, gmax, scr);
    if (!(rus[0] < exp_t(-dS0))) {
      if (t == 0) acc[task] = false;
      return;
    }
    gate = 1;
  }
  for (int ilev = 1; ilev <= nlev; ++ilev) {
    const int delta = 1 << (nlev - ilev + 1);
    const int d2 = delta >> 1;
    const bool odd = d2 & 1;
    const T dS = gate_ds<PK, JK, DP, S, T>(
        c, slab, N, L, dir, ip, seg, segn, rgs, buf + (ilev & 1) * E,
        1 << (ilev - 1), d2, delta, d2, sqrt(T(0.25 * delta * a.dt)),
        T(odd ? a.wv_odd : a.wv_even), odd ? T(a.wf_odd) : T(0), T(0), odd,
        false, gmax, scr);
    if (!(rus[gate + ilev - 1] < exp_t(-dS))) {
      if (t == 0) acc[task] = false;
      return;
    }
  }

  if (t == 0) acc[task] = true;
  S* mine = walker + ip * sN;  // the moved particle's column
  const int p_lo = ends ? 0 : 1;
  for (int i = t; i < (L - p_lo) * D; i += kThreads) {
    const int p = p_lo + i / D, k = i - (i / D) * D;
    mine[(b0 + p * dir) * sM + k] = to_s<S>(segn[p * DV + k]);
  }
}

template <typename S>
int launch(const PairParams* p, const CascadeArgs* a, void* paths,
           long long sW, long long sM, long long sN, const void* rg,
           const void* ru, const void* act, long long sAw, long long sAs,
           void* acc, int W, int S_, int N, int L, int nlev, int ends,
           int bulk, void* stream) {
  using T = compute_t<S>;
  if ((long long)W * S_ == 0) return 0;
  if (S_ > kMaxSlots || S_ > 65535) return (int)cudaErrorInvalidValue;
  int gmax = 4;
  while (gmax < N && gmax < kThreads) gmax <<= 1;
  return with_dims(p->dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const size_t smem =
        cascade_smem_bytes<S, DP>(L, N, p->dim, nlev + ends);
    return with_pair_model(*p, [&](auto pk, auto jk) {
      constexpr int PK = decltype(pk)::value, JK = decltype(jk)::value;
      if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cascade_kernel<S, PK, JK, DP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
      }
      cascade_kernel<S, PK, JK, DP>
          <<<dim3(W, S_), kThreads, smem, (cudaStream_t)stream>>>(
              make_consts<T>(*p), *a, (S*)paths, sW, sM, sN, (const S*)rg,
              (const S*)ru, (const bool*)act, sAw, sAs, (bool*)acc, S_, N, L,
              nlev, ends, bulk, gmax);
      return (int)cudaGetLastError();
    });
  });
}

}  // namespace

#define PIGS_CASCADE_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const PairParams* p, const CascadeArgs* a,              \
                      void* paths, long long sW, long long sM, long long sN,  \
                      const void* rg, const void* ru, const void* act,        \
                      long long sAw, long long sAs, void* acc, int W, int S,  \
                      int N, int L, int nlev, int ends, int bulk,             \
                      void* stream) {                                         \
    return launch<T>(p, a, paths, sW, sM, sN, rg, ru, act, sAw, sAs, acc, W,  \
                     S, N, L, nlev, ends, bulk, stream);                      \
  }

#if PIGS_HAS(0)
PIGS_CASCADE_ENTRY(pigs_cascade_f32, float)
#endif
#if PIGS_HAS(1)
PIGS_CASCADE_ENTRY(pigs_cascade_f64, double)
#endif
#if PIGS_HAS(2)
PIGS_CASCADE_ENTRY(pigs_cascade_bf16, __nv_bfloat16)
#endif
