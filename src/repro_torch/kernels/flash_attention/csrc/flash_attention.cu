// Flash prefill attention for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel / _kernel) and computes the function of its
// oracle ref.py (flash_attention_ref -> models/attention.py
// naive_attention): q [B, Tq, H, hd], k / v [B, Tk, KV, hd], query head h
// reads KV head h / G; causal keeps k_pos <= q_pos, the window keeps
// k_pos > q_pos - window; online softmax in f32; output in q's dtype.
// Unlike the Pallas kernel, Tq and Tk need not be multiples of a tile: the
// ragged tail is masked (and its rows are zero-filled, never loaded).
//
// Design.  One block of 256 threads per (64-row q tile, query head,
// batch).  The q tile (pre-scaled) and each 64-row K and V tile are
// staged in shared memory as f32, rows padded by one word so that neither
// product hits a bank twice; with hd 256 that is 209 KB, opted in above
// the 48 KB default.  Thread (ty, tx) of the 16 x 16 grid owns q rows
// ty + 16 i and key columns tx + 16 j (i, j < 4) of the score tile, and
// output columns tx + 16 j (j < hd / 16) of the same rows, so the row max
// and sum reduce over the 16 tx lanes with shuffles and the rescale of
// its accumulators needs nothing from other threads.  The K loop starts
// at the first key the window lets the tile's first row see and stops
// after the last key causality lets its last row see, the tile-skipping
// of flash_attention.py:50-57.  Masked scores are selected out, never
// multiplied by 0.  Products are plain f32 FMAs.
//
// Bound: operations.  4 * hd flops per reachable (q, k) pair and head
// against ~2 * hd * element-size bytes per key row; at the prefill shapes
// the tensor-core rate bounds it (989 TFLOP/s bf16).  This kernel runs on
// the CUDA cores (67 TFLOP/s f32) and is bound in practice by its shared
// memory traffic: moving the products to mma / wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// rows [row0, row0 + 64) of a [T, heads, hd] slab into dst[64][HD + 1],
// times `scale`; rows at or past T are zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, long long row_stride,
                                          float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < 64 * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * VEC;
    float f[VEC];
    if (row0 + r < n_rows) {
      load16(src + static_cast<long long>(row0 + r) * row_stride + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * (HD + 1) + c + e] = f[e] * scale;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Tq, int Tk, int H,
    int KV, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                // [BQ][LD]
  float* k_s = q_s + BQ * LD;       // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* p_s = v_s + BK * LD;       // [BQ][LDP]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long q_rs = static_cast<long long>(H) * HD;
  const long long kv_rs = static_cast<long long>(KV) * HD;
  const T* qb = q + (static_cast<long long>(b) * Tq * H + h) * HD;
  const T* kb = k + (static_cast<long long>(b) * Tk * KV + kvh) * HD;
  const T* vb = v + (static_cast<long long>(b) * Tk * KV + kvh) * HD;
  T* ob = out + (static_cast<long long>(b) * Tq * H + h) * HD;

  load_tile<T, HD>(q_s, qb, q0, Tq, q_rs, scale);

  const int q_last = min(q0 + BQ, Tq) - 1;
  const long long lo_w = static_cast<long long>(q0) - window + 1;
  const int k_begin = lo_w > 0 ? static_cast<int>(lo_w) : 0;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the last tile's readers are done
    load_tile<T, HD>(k_s, kb, k0, Tk, kv_rs, 1.f);
    load_tile<T, HD>(v_s, vb, k0, Tk, kv_rs, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < Tk && (!causal || kp <= qp) &&
                   static_cast<long long>(kp) >
                       static_cast<long long>(qp) - window;
        s[i][j] = valid[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      store(ob + static_cast<long long>(r) * q_rs + tx + 16 * j,
            acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int Tk, int H, int KV, int causal, int window,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (3 * BQ * (HD + 1) + BQ * LDP);
  auto kernel = flash_attention_kernel<T, HD>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, H, KV, causal,
      window, static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int Tq, int Tk, int H, int KV, int causal, int window,
              cudaStream_t stream) {
#define FLASH_HD(N) \
  case N:           \
    return launch<T, N>(q, k, v, out, B, Tq, Tk, H, KV, causal, window, stream);
  switch (hd) {
    FLASH_HD(16)
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(128)
    FLASH_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_HD
}

}  // namespace

extern "C" {

// One prefill-attention launch on `stream`; returns cudaGetLastError()
// (0 = launched).  dtype: 0 = float32, 1 = bfloat16.  All tensors are
// contiguous.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Tq, int Tk, int H, int KV,
                           int hd, int causal, int window, int dtype,
                           void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, B, Tq, Tk, H, KV, causal, window,
                            s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Tq, Tk, H, KV, causal,
                                    window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
