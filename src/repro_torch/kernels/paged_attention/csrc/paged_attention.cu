// Paged decode attention for Hopper (sm_90a): one new token per lane
// attends over that lane's KV pages, found through its block table.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py (paged_attention_kernel
// / _kernel) and computes the function of its oracle ref.py
// (paged_attention_ref): positions seq_len - window < pos <= seq_len are
// valid, a NO_BLOCK (< 0) table slot is read as page 0, G = H / KV query
// heads share each KV head, softmax in f32, output in q's dtype.
//
// Self mode (k_self != nullptr) is the serving decode's convention: the
// token's own K/V is not in the cache yet, so cached positions are
// pos < seq_len, the position seq_len is read from k_self / v_self
// [B, KV, hd], and a lane with active[b] == 0 gives zeros.
//
// Bound: bytes.  Each live token's K and V row is read once
// (2 * hd * element size per KV head) and there are G query rows per row
// read, far below the card's ~295 operations per byte; at the serving
// shapes the bytes take a few microseconds at 3.35 TB/s.  What keeps a
// kernel from that is parallelism: one block per (lane, KV head) streams
// a lane's whole context through one SM, and gemma3-1b's decode has
// B x KV = 4 such blocks on 132 SMs.  Head dims 16, 32, 64, 96, 128 and 256
// (phi-3-vision's 96 splits a token over 8 or 16 threads, see Tiling).
//
// Design: flash-decoding over pages.  The lane's live positions (the cached
// [lo, hi], then in self mode the position seq_len) are cut into n_splits
// chunks of `chunk` positions; the host's planner picks both from the
// shapes alone (ops.py: plan_splits, one wave of blocks, chunks of at least
// 32 tokens, no split when the unsplit grid fills half the card), never
// from seq_lens, so the step stays free of host syncs.  Pass 1, grid (B, KV,
// n_splits * ceil(G / 8)): a block takes one chunk of one lane for up to 8
// query heads.  The Pallas grid walks every page slot because its grid is
// static; here the block loops over its chunk's live positions only.  A
// token is read by TPT threads with 16-byte loads along hd (8-byte ones at
// hd 96, where TPT stays a power of two: Tiling); the block's 8
// warps work on 8 * 32 / TPT tokens at a time, UNROLL deep, each thread
// group keeping its own running max m, denominator l and accumulator in f32
// (registers).  The groups merge in a fixed order (shuffles inside a warp,
// then shared memory across warps) into the chunk's partial (m, l, acc),
// written in f32 to scratch the wrapper allocates; a chunk past the lane's
// live range writes m = -inf (NEG_INF) and l = 0.  Pass 2, grid (B, H):
// merges a lane's partials in split order with the same formula and writes
// the output in q's dtype.  With one split, pass 1 writes the output itself
// and pass 2 is not launched.  Both passes are launched by the one C entry
// point, pass 2 as a programmatic dependent launch: it is scheduled while
// pass 1 runs and waits for it (griddepcontrol) before reading the
// partials.  No atomics anywhere: the result is deterministic, and a page
// aliased by two block tables reads bit-identically to a private
// copy.  Positions outside the valid range are never loaded, so a NaN in an
// unused page cannot reach the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 8;       // query heads per block; grid.z covers G > 8
constexpr int UNROLL = 4;     // tokens each thread group has in flight
constexpr float NEG_INF = -1e30f;

// one vector load of B bytes (16, 8 or 4) into B / sizeof(T) floats
template <int B>
__device__ __forceinline__ void load_vec(const float* p, float* dst) {
  if constexpr (B == 16) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (B == 8) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = *p;
  }
}

template <int B>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* dst) {
  using V = std::conditional_t<B == 16, uint4,
                               std::conditional_t<B == 8, uint2, unsigned>>;
  const V v = *reinterpret_cast<const V*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < B / 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// A token's hd elements split over TPT threads, a power of two so that
// the shuffles that reduce a score stay inside the group and a warp holds
// whole groups: HD / (16 / sizeof(T)) 16-byte loads where that count is a
// power of two (at most 32), else the next power of two below it, each
// thread then reading its ELEMS with the widest load that divides them
// (hd 96: 8 threads x 12 bf16 in three 8-byte loads, 16 threads x 6 f32
// in three 8-byte loads).
template <typename T, int HD>
struct Tiling {
  static constexpr int TPT = pow2_floor(
      HD * static_cast<int>(sizeof(T)) / 16 < 32
          ? HD * static_cast<int>(sizeof(T)) / 16 : 32);  // threads per token
  static constexpr int ELEMS = HD / TPT;                    // per thread
  static constexpr int ROW_BYTES = ELEMS * static_cast<int>(sizeof(T));
  static constexpr int LOAD = ROW_BYTES % 16 == 0 ? 16
                              : ROW_BYTES % 8 == 0 ? 8 : 4;  // bytes a load
  static constexpr int VEC = LOAD / static_cast<int>(sizeof(T));
  static constexpr int GPW = 32 / TPT;                      // groups per warp
  static constexpr int GROUPS = WARPS * GPW;
  static_assert(TPT * ELEMS == HD && ELEMS % VEC == 0, "head dim tiling");
};

// NG: the power of two >= min(G, MAXG) query heads a block holds state
// for (1 at deepseek-7b, 4 at gemma3-1b), so registers follow G
template <typename T, int HD, int NG>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ seq_lens, const T* __restrict__ k_self,
    const T* __restrict__ v_self, const unsigned char* __restrict__ active,
    T* __restrict__ out, float* __restrict__ part, int H, int KV, int G,
    int ps, int P, long long page_stride, long long tok_stride,
    long long head_stride, int window, int chunk, int n_splits, float scale) {
  using C = Tiling<T, HD>;
  extern __shared__ float smem[];
  const int n_gz = (G + NG - 1) / NG;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int split = blockIdx.z / n_gz, g0 = (blockIdx.z % n_gz) * NG;
  const int ng = min(NG, G - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d0 = (lane % C::TPT) * C::ELEMS;
  const int h0 = kvh * G + g0;               // first query head of the block
  const long long row0 = (static_cast<long long>(b) * H + h0) * HD;
  const bool self_mode = k_self != nullptr;
  // let pass 2 be launched now; it waits for this grid before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  if (active != nullptr && !active[b]) {      // pass 2 writes the zeros
    if (n_splits == 1)
      for (int i = tid; i < ng * HD; i += THREADS) store(out + row0 + i, 0.f);
    return;
  }

  // live positions: [lo, hi] from the pages, then (self mode) seq_len
  const int seq = seq_lens[b];
  const long long lo_w = static_cast<long long>(seq) - window + 1;
  const int lo = lo_w > 0 ? static_cast<int>(lo_w) : 0;
  const int hi = min(self_mode ? seq - 1 : seq, P * ps - 1);
  const int n_cache = max(0, hi - lo + 1);
  const int n_total = n_cache + (self_mode && window > 0 ? 1 : 0);
  // this block's chunk of the live index t (t < n_cache: position lo + t;
  // t == n_cache: the self position)
  const int t_lo = split * chunk;
  const int t_hi = min(n_total, t_lo + chunk);
  // partials of (lane b, head h, split): m, l, then acc [HD]
  const long long n_rows = static_cast<long long>(gridDim.x) * H * n_splits;
  float* part_m = part;
  float* part_l = part + n_rows;
  float* part_acc = part + 2 * n_rows;
  const long long prow0 = (static_cast<long long>(b) * H + h0) * n_splits +
                          split;
  if (n_splits > 1 && t_lo >= t_hi) {         // nothing live in this chunk
    if (tid < ng) {
      part_m[prow0 + tid * n_splits] = NEG_INF;
      part_l[prow0 + tid * n_splits] = 0.f;
    }
    return;
  }

  float* q_s = smem;                       // [ng][HD], pre-scaled
  float* w_ml = q_s + ng * HD;             // [WARPS][2][ng]
  float* w_acc = w_ml + WARPS * 2 * ng;    // [WARPS][ng][HD]
  for (int i = tid; i < ng * HD; i += THREADS)
    q_s[i] = to_float(q[row0 + i]) * scale;
  __syncthreads();

  float m[NG], l[NG], acc[NG][C::ELEMS];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < C::ELEMS; ++e) acc[g][e] = 0.f;
  }

  const int grp = warp * C::GPW + lane / C::TPT;
  for (int base = t_lo; base < t_hi; base += C::GROUPS * UNROLL) {
    float kf[UNROLL][C::ELEMS], vf[UNROLL][C::ELEMS];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = base + u * C::GROUPS + grp;
      ok[u] = t < t_hi;
      if (!ok[u]) {
#pragma unroll
        for (int e = 0; e < C::ELEMS; ++e) kf[u][e] = vf[u][e] = 0.f;
        continue;
      }
      const T* kp;
      const T* vp;
      if (t < n_cache) {
        const int pos = lo + t;
        int page = tables[static_cast<long long>(b) * P + pos / ps];
        page = page < 0 ? 0 : page;
        const long long off = static_cast<long long>(page) * page_stride +
                              static_cast<long long>(pos % ps) * tok_stride +
                              static_cast<long long>(kvh) * head_stride + d0;
        kp = k_pages + off;
        vp = v_pages + off;
      } else {
        const long long off =
            (static_cast<long long>(b) * KV + kvh) * HD + d0;
        kp = k_self + off;
        vp = v_self + off;
      }
#pragma unroll
      for (int e = 0; e < C::ELEMS; e += C::VEC) {
        load_vec<C::LOAD>(kp + e, &kf[u][e]);
        load_vec<C::LOAD>(vp + e, &vf[u][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (g >= ng) break;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < C::ELEMS; ++e)
          s = fmaf(q_s[g * HD + d0 + e], kf[u][e], s);
#pragma unroll
        for (int o = C::TPT / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (!ok[u]) continue;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < C::ELEMS; ++e)
          acc[g][e] = fmaf(p, vf[u][e], acc[g][e] * alpha);
        m[g] = m_new;
      }
    }
  }

  // merge the thread groups of a warp (lanes TPT apart hold the same slice)
#pragma unroll
  for (int o = C::TPT; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g >= ng) break;
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m_o);
      const float a = expf(m[g] - m_new), c = expf(m_o - m_new);
      l[g] = l[g] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < C::ELEMS; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + acc_o * c;
      }
      m[g] = m_new;
    }
  }
  if (lane < C::TPT) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g >= ng) break;
#pragma unroll
      for (int e = 0; e < C::ELEMS; ++e)
        w_acc[(warp * ng + g) * HD + d0 + e] = acc[g][e];
      if (lane == 0) {
        w_ml[(warp * 2) * ng + g] = m[g];
        w_ml[(warp * 2 + 1) * ng + g] = l[g];
      }
    }
  }
  __syncthreads();
  // merge the warps, in warp order
  for (int i = tid; i < ng * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, w_ml[(w * 2) * ng + g]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(w_ml[(w * 2) * ng + g] - mx);
      den += w_ml[(w * 2 + 1) * ng + g] * f;
      num += w_acc[(w * ng + g) * HD + d] * f;
    }
    if (n_splits == 1) {
      store(out + row0 + i, num / fmaxf(den, 1e-30f));
    } else {
      const long long pr = prow0 + static_cast<long long>(g) * n_splits;
      part_acc[pr * HD + d] = num;
      if (d == 0) {
        part_m[pr] = mx;
        part_l[pr] = den;
      }
    }
  }
}

// Pass 2: one block per (lane, query head), one thread per element of hd;
// merges the lane's split partials in split order, as the warps merge.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) paged_combine_kernel(
    const float* __restrict__ part, const unsigned char* __restrict__ active,
    T* __restrict__ out, int H, int n_splits) {
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const long long row = static_cast<long long>(b) * H + h;
  asm volatile("griddepcontrol.wait;" ::: "memory");   // pass 1 is done
  if (active != nullptr && !active[b]) {
    store(out + row * HD + d, 0.f);
    return;
  }
  const long long n_rows = static_cast<long long>(gridDim.x) * H * n_splits;
  const float* pm = part + row * n_splits;
  const float* pl = part + n_rows + row * n_splits;
  const float* pa = part + 2 * n_rows + row * n_splits * HD + d;
  float mx = NEG_INF;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, pm[s]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    if (pl[s] == 0.f) continue;               // an empty chunk; acc unset
    const float f = expf(pm[s] - mx);
    den += pl[s] * f;
    num += pa[static_cast<long long>(s) * HD] * f;
  }
  store(out + row * HD + d, num / fmaxf(den, 1e-30f));
}

template <typename T, int HD, int NG>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* tables, const int* seq_lens, const void* k_self,
           const void* v_self, const unsigned char* active, void* out,
           float* part, int B, int H, int KV, int ps, int P,
           long long page_stride, long long tok_stride, long long head_stride,
           int window, int chunk, int n_splits, cudaStream_t stream) {
  const int G = H / KV;
  const int ng = G < NG ? G : NG;
  const size_t bytes =
      sizeof(float) * (ng * HD + WARPS * 2 * ng + WARPS * ng * HD);
  auto kernel = paged_attention_kernel<T, HD, NG>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, KV, n_splits * ((G + NG - 1) / NG));
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, seq_lens,
      static_cast<const T*>(k_self), static_cast<const T*>(v_self), active,
      static_cast<T*>(out), part, H, KV, G, ps, P, page_stride, tok_stride,
      head_stride, window, chunk, n_splits,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  // programmatic dependent launch: pass 2's launch overlaps pass 1's run
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, H);
  cfg.blockDim = dim3(HD);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, HD>,
                           static_cast<const float*>(part), active,
                           static_cast<T*>(out), H, n_splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kp, const void* vp,
              const int* tables, const int* seq_lens, const void* ks,
              const void* vs, const unsigned char* active, void* out,
              float* part, int B, int H, int KV, int ps, int P,
              long long page_stride, long long tok_stride,
              long long head_stride, int window, int chunk, int n_splits,
              cudaStream_t stream) {
  const int G = H / KV;
#define PAGED_NG(N, NG)                                                      \
  return launch<T, N, NG>(q, kp, vp, tables, seq_lens, ks, vs, active, out,   \
                          part, B, H, KV, ps, P, page_stride, tok_stride,     \
                          head_stride, window, chunk, n_splits, stream);
#define PAGED_HD(N)                                                          \
  case N:                                                                    \
    if (G == 1) PAGED_NG(N, 1)                                               \
    if (G == 2) PAGED_NG(N, 2)                                               \
    if (G <= 4) PAGED_NG(N, 4)                                               \
    PAGED_NG(N, MAXG)
  switch (hd) {
    PAGED_HD(16)
    PAGED_HD(32)
    PAGED_HD(64)
    PAGED_HD(96)
    PAGED_HD(128)
    PAGED_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PAGED_HD
#undef PAGED_NG
}

}  // namespace

extern "C" {

// One decode-attention op on `stream` (pass 1, then pass 2 when
// n_splits > 1); returns cudaGetLastError() (0 = launched).  dtype: 0 =
// float32, 1 = bfloat16.  k_self / v_self / active may be null (the JAX
// op's contract: every lane active, the token already in the cache).
// Strides are in elements; the last dim is contiguous.  `part` is f32
// scratch of B * H * n_splits * (hd + 2) elements (null when n_splits is
// 1); n_splits * chunk must cover min(window, P * ps) + 1 positions.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const int* tables,
                           const int* seq_lens, const void* k_self,
                           const void* v_self, const unsigned char* active,
                           void* out, void* part, int B, int H, int KV, int hd,
                           int ps, int P, long long page_stride,
                           long long tok_stride, long long head_stride,
                           int window, int chunk, int n_splits, int dtype,
                           void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || ps <= 0 || P <= 0 ||
      (k_self == nullptr) != (v_self == nullptr) || chunk <= 0 ||
      n_splits <= 0 || (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_pages, v_pages, tables, seq_lens, k_self,
                            v_self, active, out, pf, B, H, KV, ps, P,
                            page_stride, tok_stride, head_stride, window,
                            chunk, n_splits, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, tables, seq_lens,
                                    k_self, v_self, active, out, pf, B, H, KV,
                                    ps, P, page_stride, tok_stride,
                                    head_stride, window, chunk, n_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
