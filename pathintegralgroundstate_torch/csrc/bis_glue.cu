// The glue of the unfused monoshot bisection moves (ops/bisection.py:
// bisection, move_head_bisection, move_tail_bisection) around the window
// pair pass (kernel A, or under exact F^2 with the odd-bead force-field
// cache the fold kernel, csrc/pair_fold.cu), in two launches per move:
//   * bis_propose: every level's proposal of the moved particle's window at
//     once, y_p = c_p u_L + sum_q T[p, q] g_q (the dyadic tables of
//     ops/bisection.dyadic_tables), from the window's first bead (for an
//     end move first its free-gaussian guess x0' = wrap(x0 - wrap(x0 - xL)
//     + sqrt(L dt) g_0)), with the far anchor unwrapped, u_L = -wrap(x0 -
//     xL), and one wrap at the end.  It writes the new window [W, L+1, D]
//     in forward bead order, the order in which the pair pass reads it;
//   * bis_accept: from the pair pass's rows [W, B], each accept group's row
//     sum (level ilev holds the positions p with p = 2^(nlev-ilev) times an
//     odd number; an end move's terminal gate, position 0, is group 0),
//     alive = active AND_k u_k < exp(-sum_k), and the accepted walkers'
//     displaced positions (the interior 1..L-1, an end 0..L-1) written into
//     paths in place.  With the cache (its own instantiation, kCache) the
//     same launch adds each accepted walker's field increments dfield [W,
//     mo, N, D] from the fold into the cache rows k0..k0+mo-1 beneath the
//     window's odd beads, one rounding an element: the cache's numbers are
//     those of the plain write f + where(alive, dfield, 0)
//     (ops/moves._cache_win_write), and a rejected walker's rows are left
//     as they were.
// The numbers are those of the plain forms ops/kernels.bis_propose_ref and
// bis_accept_ref on the same gaussians and uniforms, up to the order of
// the tables' and the groups' sums: every other operation is rounded one
// at a time, as the plain forms' separate PyTorch operations round it.
//
// It replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it into the step's program.  Eager PyTorch runs it as some forty
// launches per move (some fifty with the cache), each a pass over [W, L+1,
// D]; in the cells with few walkers the host's launch calls set the pace
// (PERF.md).  Both kernels move a few bytes per element and do a few
// operations on each, so they are bound by bytes, and at small W by their
// launch latency; the design is one launch each, every element's
// arithmetic in registers and paths read and written in place through its
// strides.  The cache's write-back is the bulk of a cached accept's bytes
// (mo N D elements a walker against L D positions), so its elements are
// spread over the grid's y axis, each block deciding its walkers again.
//
// The window of L = 2^nlev links of particle ip lies at beads bead0 + dir
// p, p = 0..L: dir +1 for the interior and the head, -1 for the tail,
// whose window is read backwards in place.  The route (kernels.bis_route)
// runs these kernels under PBC only, so every wrap is the minimum image.
// Only float32 and float64 are instantiated: bfloat16 runs the plain forms,
// whose per-operation rounding in bfloat16 this design does not repeat.

#include <cuda_runtime.h>

#ifndef PIGS_STORAGE
#define PIGS_STORAGE -1  // every type
#endif
#define PIGS_HAS(n) (PIGS_STORAGE < 0 || PIGS_STORAGE == (n))

constexpr int kProposeThreads = 256;
constexpr int kAcceptThreads = 128;
constexpr int kAcceptWalkers = 32;   // walkers a block decides
constexpr int kCacheElems = 8;       // cache elements a thread adds

// Host-side move description, filled by ops/kernels.py (_GlueArgs).  The
// gaussians g [W, L, D], the proposal [W, L+1, D], the pair pass's rows
// [W, B], the uniforms u [W, nlev+1] and the field increments dfield [W,
// mo, N, D] are contiguous; paths, active and the cache go by their
// strides, in elements.  Long longs and the double first, ints last.
struct GlueArgs {
  long long sPw, sPm, sPn;   // paths [W, M, N, D]
  long long sA;              // active [W] (bool)
  long long bead0;           // bead of window position 0
  long long rbead0;          // bead of the rows' row 0
  long long sCw, sCk, sCn;   // the cache codd [W, Nb, N, D] (kCache)
  long long k0;              // cache row of dfield's row 0 (kCache)
  double sig;                // the end guess's sigma sqrt(2^nlev dt)
  int dir, ip, W, nlev, D, B, gate;
  int mo, N;                 // dfield [W, mo, N, D] (kCache)
};

#if PIGS_HAS(0) || PIGS_HAS(1)
namespace {

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// Single-image wrap (utils/pbc.wrap).
template <typename T>
__device__ __forceinline__ T wrap(T d, T L, T half) {
  if (d > half) d -= L;
  if (d < -half) d += L;
  return d;
}

// One thread per element (w, r, k) of the proposal.  Row r is window
// position p = r (dir +1) or L - r (dir -1).
template <typename T>
__global__ void __launch_bounds__(kProposeThreads)
bis_propose_kernel(GlueArgs a, const T* __restrict__ paths,
                   const T* __restrict__ g, const T* __restrict__ tab_T,
                   const T* __restrict__ tab_c, const T* __restrict__ box_L,
                   const T* __restrict__ box_h, T* __restrict__ out) {
  const int L = 1 << a.nlev, D = a.D;
  const long long n = (long long)a.W * (L + 1) * D;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i % D);
    const long long t = i / D;
    const int r = (int)(t % (L + 1));
    const long long w = t / (L + 1);
    const int p = a.dir > 0 ? r : L - r;
    const T Lk = box_L[k], hk = box_h[k];
    const T* col = paths + w * a.sPw + (long long)a.ip * a.sPn + k;
    T x0 = col[a.bead0 * a.sPm];
    const T xL = col[(a.bead0 + (long long)a.dir * L) * a.sPm];
    const T* gw = g + w * L * D + k;
    if (a.gate) {
      const T xmid = x0 - wrap(x0 - xL, Lk, hk);
      x0 = wrap(add_rn(xmid, mul_rn(T(a.sig), gw[0])), Lk, hk);
    }
    T x;
    if (p == 0) {
      x = x0;
    } else if (p == L) {
      x = xL;
    } else {
      const T uL = -wrap(x0 - xL, Lk, hk);
      const T* Trow = tab_T + (long long)(p - 1) * (L - 1);
      T acc = T(0);
      for (int q = 1; q < L; ++q) acc += Trow[q - 1] * gw[q * D];
      const T y = add_rn(mul_rn(tab_c[p - 1], uL), acc);
      x = wrap(add_rn(x0, y), Lk, hk);
    }
    out[i] = x;
  }
}

// Accept group of window position p: the terminal gate 0 for p = 0, else
// its level nlev - ctz(p).
__device__ __forceinline__ int group_of(int p, int nlev) {
  return p == 0 ? 0 : nlev - (__ffs(p) - 1);
}

// One thread per walker decides, kAcceptWalkers walkers a block (few
// enough that a launch at W = 4,096 spreads over the SMs); then the block
// writes its accepted walkers' displaced positions, one thread per
// element.  With kCache the blocks along y (each deciding the same walkers)
// share the cache's write-back, one thread per element; the first of them
// writes alive and the positions.
template <typename T, bool kCache>
__global__ void __launch_bounds__(kAcceptThreads)
bis_accept_kernel(GlueArgs a, const T* __restrict__ rows,
                  const T* __restrict__ u, const bool* __restrict__ active,
                  const T* __restrict__ prop, T* __restrict__ paths,
                  bool* __restrict__ alive, const T* __restrict__ dfield,
                  T* __restrict__ codd) {
  __shared__ bool ok[kAcceptWalkers];
  const int L = 1 << a.nlev, D = a.D;
  const bool first = !kCache || blockIdx.y == 0;
  const long long w0 = (long long)blockIdx.x * kAcceptWalkers;
  const long long w = w0 + threadIdx.x;
  if (threadIdx.x < kAcceptWalkers && w < a.W) {
    const T* rw = rows + w * a.B;
    const T* uw = u + w * (a.nlev + 1);
    bool acc = active[w * a.sA];
    for (int grp = a.gate ? 0 : 1; grp <= a.nlev && acc; ++grp) {
      T sum = T(0);
      for (int b = 0; b < a.B; ++b) {
        const int p = (int)((a.rbead0 + b - a.bead0) * a.dir);
        if (group_of(p, a.nlev) == grp) sum += rw[b];
      }
      acc = uw[grp] < exp_t(-sum);
    }
    ok[threadIdx.x] = acc;
    if (first) alive[w] = acc;
  }
  __syncthreads();
  const long long left = a.W - w0;
  const int nw = left < kAcceptWalkers ? (int)left : kAcceptWalkers;
  if (first) {
    const int p_lo = a.gate ? 0 : 1, npos = L - p_lo;
    for (int i = threadIdx.x; i < nw * npos * D; i += kAcceptThreads) {
      const int k = i % D, j = i / D;
      const int wl = j / npos, p = p_lo + j % npos;
      if (!ok[wl]) continue;
      const long long ww = w0 + wl;
      const int r = a.dir > 0 ? p : L - p;
      paths[ww * a.sPw + (a.bead0 + (long long)a.dir * p) * a.sPm +
            (long long)a.ip * a.sPn + k] =
          prop[(ww * (L + 1) + r) * D + k];
    }
  }
  if (kCache) {
    // element e = (t, k) of a walker's dfield [mo, N, D]: t = j N + n
    const int per = a.mo * a.N * D;
    for (long long i = (long long)blockIdx.y * kAcceptThreads + threadIdx.x;
         i < (long long)nw * per; i += (long long)gridDim.y * kAcceptThreads) {
      const int wl = (int)(i / per);
      if (!ok[wl]) continue;
      const int e = (int)(i % per);
      const int k = e % D, t = e / D;
      const long long ww = w0 + wl;
      T* c = codd + ww * a.sCw + (a.k0 + t / a.N) * a.sCk +
             (long long)(t % a.N) * a.sCn + k;
      *c = add_rn(*c, dfield[ww * per + e]);
    }
  }
}

template <typename T>
int propose(const GlueArgs* a, const void* paths, const void* g,
            const void* tab_T, const void* tab_c, const void* box_L,
            const void* box_h, void* out, void* stream) {
  const long long n = (long long)a->W * ((1 << a->nlev) + 1) * a->D;
  if (n == 0) return 0;
  long long blocks = (n + kProposeThreads - 1) / kProposeThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  bis_propose_kernel<T><<<(unsigned)blocks, kProposeThreads, 0,
                          (cudaStream_t)stream>>>(
      *a, (const T*)paths, (const T*)g, (const T*)tab_T, (const T*)tab_c,
      (const T*)box_L, (const T*)box_h, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int accept(const GlueArgs* a, const void* rows, const void* u,
           const void* active, const void* prop, void* paths, void* alive,
           const void* dfield, void* codd, void* stream) {
  if (a->W == 0) return 0;
  const long long blocks = ((long long)a->W + kAcceptWalkers - 1) /
                           kAcceptWalkers;
  if (codd == nullptr) {
    bis_accept_kernel<T, false><<<(unsigned)blocks, kAcceptThreads, 0,
                                  (cudaStream_t)stream>>>(
        *a, (const T*)rows, (const T*)u, (const bool*)active, (const T*)prop,
        (T*)paths, (bool*)alive, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  // the y blocks that give each thread about kCacheElems of a block's
  // walkers' cache elements
  const long long nw = a->W < kAcceptWalkers ? a->W : kAcceptWalkers;
  const long long elems = nw * a->mo * a->N * a->D;
  long long ny = (elems + kAcceptThreads * kCacheElems - 1) /
                 (kAcceptThreads * kCacheElems);
  if (ny < 1) ny = 1;
  if (ny > 65535) ny = 65535;
  bis_accept_kernel<T, true><<<dim3((unsigned)blocks, (unsigned)ny),
                               kAcceptThreads, 0, (cudaStream_t)stream>>>(
      *a, (const T*)rows, (const T*)u, (const bool*)active, (const T*)prop,
      (T*)paths, (bool*)alive, (const T*)dfield, (T*)codd);
  return (int)cudaGetLastError();
}

}  // namespace

#define PIGS_GLUE_ENTRY(SUFFIX, T)                                           \
  extern "C" int pigs_bis_propose_##SUFFIX(                                  \
      const GlueArgs* a, const void* paths, const void* g,                   \
      const void* tab_T, const void* tab_c, const void* box_L,               \
      const void* box_h, void* out, void* stream) {                          \
    return propose<T>(a, paths, g, tab_T, tab_c, box_L, box_h, out, stream); \
  }                                                                          \
  extern "C" int pigs_bis_accept_##SUFFIX(                                   \
      const GlueArgs* a, const void* rows, const void* u,                    \
      const void* active, const void* prop, void* paths, void* alive,        \
      const void* dfield, void* codd, void* stream) {                        \
    return accept<T>(a, rows, u, active, prop, paths, alive, dfield, codd,   \
                     stream);                                                \
  }

#if PIGS_HAS(0)
PIGS_GLUE_ENTRY(f32, float)
#endif
#if PIGS_HAS(1)
PIGS_GLUE_ENTRY(f64, double)
#endif
#endif  // PIGS_HAS(0) || PIGS_HAS(1)
