// Flash prefill attention for Hopper (sm_90a), forward only.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_kernel / _kernel) and computes the function of its
// oracle ref.py (flash_attention_ref -> models/attention.py
// naive_attention): q [B, Tq, H, hd], k / v [B, Tk, KV, hd], query head h
// reads KV head h / G; query row i sits at absolute position
// q_pos = q_offset + i and key j at j; causal keeps k_pos <= q_pos, the
// window keeps k_pos > q_pos - window; online softmax in f32; output in
// q's dtype.  Unlike the Pallas kernel, Tq and Tk need not be multiples
// of a tile: the ragged tail is masked (and its rows are zero-filled,
// never loaded); and queries may start past key 0 (q_offset: a prefill of
// an uncached suffix over a cached prefix, Tk = q_offset + Tq).  Every
// reachability test compares query and key positions on one axis
// (absolute in the tensor-core kernel, shifted by -q_offset in the
// CUDA-core kernel), so a q_offset that is not a multiple of a tile moves
// the diagonal inside tiles; q_offset = 0 computes exactly what the
// kernel computed without it.
//
// Bound: operations.  4 * hd flops per reachable (q, k) pair and head
// against ~2 * hd * 2 bytes per key row; at the prefill shapes the bf16
// tensor-core rate bounds it (989 TFLOP/s dense).  Two kernels, chosen by
// the dtype inside the one C entry point (no fallback between them):
//
// bf16 (serving): FlashAttention-2's design on the tensor cores.  One
// block of 4 warps per (64-row q tile, query head, lane); each warp owns
// 16 q rows.  Q and a ring of two stages of K and V tiles (64 keys each;
// 32 at hd 256, where a 64-key S tile beside O's 128 accumulator
// registers spills) sit in shared memory as bf16, rows of 16-byte chunks
// XOR-swizzled by the row so that ldmatrix reads 8 rows without a bank
// conflict (96 KB at hd 256, 80 KB at hd 128).  Tiles arrive by
// cp.async.cg: tile j + 1's K and V are in flight while tile j is
// computed, with one barrier per tile.  Both products are mma.sync
// m16n8k16 (bf16 in, f32 accumulate); A and B fragments come from
// ldmatrix, V's through ldmatrix.trans, so no transpose is stored, each
// loaded one mma ahead of its use.  Q's fragments are reloaded per k-step
// (the O accumulator alone is hd / 2 f32 registers a thread).  The online
// softmax runs on the S registers: row max and sum over the 4 threads of
// a quad by shuffles, exp2f with log2(e) * scale folded into one
// multiply.  P is rounded to bf16 in registers and is directly the A
// operand of P V (the accumulator layout of m16n8k16 is its A-fragment
// layout), so it never touches shared memory; that rounding is the path's
// extra error against the plain version (relative 2^-9 per probability).
// The K loop runs over the tiles the window and causality leave (the tile
// skipping of flash_attention.py:50-57); a warp skips a tile none of its
// rows can see, and masks elements only on tiles that straddle the
// diagonal, the window's edge or the ragged tail.  q tiles nearest the
// end (the most keys under causality) are launched first.
//
// f32: the CUDA-core kernel of the first port, kept as it was so the f32
// runs stay exact to f32 rounding: 64-row q and K/V tiles staged as f32
// in padded shared memory (209 KB at hd 256), 4 x 4 score micro-tiles per
// thread, plain FMAs.

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// Key positions here are relative to query row 0: key j sits at
// j - q_offset, so row r and key j compare as in the kernel without an
// offset.  `Tk` counts keys from there (the launcher passes the key count
// less q_offset) and keys run from -q_offset; k and v start q_offset rows
// into their slabs.  The offset then costs no register in the K loop.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Tq, int Tk, int H,
    int KV, int causal, int window, int q_offset, float scale) {
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
  const long long kv_row0 =
      static_cast<long long>(b) * (Tk + q_offset) + q_offset;
  const T* kb = k + (kv_row0 * KV + kvh) * HD;
  const T* vb = v + (kv_row0 * KV + kvh) * HD;
  T* ob = out + (static_cast<long long>(b) * Tq * H + h) * HD;

  load_tile<T, HD>(q_s, qb, q0, Tq, q_rs, scale);

  const int q_last = min(q0 + BQ, Tq) - 1;
  const long long lo_w = static_cast<long long>(q0) - window + 1;
  const int k_begin = lo_w > -q_offset ? static_cast<int>(lo_w) : -q_offset;
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
           int q_offset, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk - q_offset, H,
      KV, causal, window, q_offset,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;   // q rows per block, 16 per warp

// keys per K / V tile: 32 at hd 256, where O's accumulator alone takes
// 128 registers a thread and a 64-key S tile would spill
template <int HD>
struct BlockK {
  static constexpr int value = HD >= 256 ? 32 : 64;
};

// A [rows][HD] bf16 tile as rows of HD / 8 chunks of 16 bytes; chunk c of
// row r is stored at chunk c ^ (r & MASK), so the 8 rows one ldmatrix
// reads at one chunk column land on 8 different 16-byte bank groups
// (for HD >= 64; narrower rows share groups, which costs time only).
template <int HD>
struct Tile {
  static constexpr int CH = HD / 8;
  static constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  __device__ static __forceinline__ int at(int r, int c) {
    return (r * CH + (c ^ (r & MASK))) * 8;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// rows [row0, row0 + ROWS) of a [T, heads, HD] slab into a swizzled tile;
// rows at or past n_rows are zero-filled (their source is never read)
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int n_rows,
                                          long long row_stride) {
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = row0 + r < n_rows;
    const bf16* g =
        src + static_cast<long long>(ok ? row0 + r : 0) * row_stride + c * 8;
    cp_async16(dst + Tile<HD>::at(r, c), g, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int Tq, int Tk, int H,
    int KV, int causal, int window, int q_offset, float scale_log2) {
  constexpr int BK = BlockK<HD>::value;
  constexpr int NT = BK / 8;    // 8-key column tiles of S
  constexpr int NO = HD / 8;    // 8-wide column tiles of O
  using L = Tile<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [BQ][HD]
  bf16* kv_s = q_s + BQ * HD;                       // [2 stages][K, V][BK][HD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // last q tiles first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long q_rs = static_cast<long long>(H) * HD;
  const long long kv_rs = static_cast<long long>(KV) * HD;
  const bf16* qb = q + (static_cast<long long>(b) * Tq * H + h) * HD;
  const bf16* kb = k + (static_cast<long long>(b) * Tk * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<long long>(b) * Tk * KV + kvh) * HD;

  const int q_last = min(q0 + BQ, Tq) - 1;
  const long long lo_w = static_cast<long long>(q_offset) + q0 - window + 1;
  const int k_begin = lo_w > 0 ? static_cast<int>(lo_w) : 0;
  const int k_end = causal ? min(Tk, q_offset + q_last + 1) : Tk;
  const int qw0 = q0 + 16 * warp;              // this warp's first row
  const int pw0 = q_offset + qw0;              // ... and its position

  load_tile<HD, BQ>(q_s, qb, q0, Tq, q_rs);
  if (k_begin < k_end) {
    load_tile<HD, BK>(kv_s, kb, k_begin, Tk, kv_rs);
    load_tile<HD, BK>(kv_s + BK * HD, vb, k_begin, Tk, kv_rs);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max (raw score units),
  // this thread's share of the row sum, and O's accumulator fragments
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();   // this tile landed; all warps are done with the other
    if (k0 + BK < k_end) {
      bf16* next = kv_s + (stage ^ 1) * 2 * BK * HD;
      load_tile<HD, BK>(next, kb, k0 + BK, Tk, kv_rs);
      load_tile<HD, BK>(next + BK * HD, vb, k0 + BK, Tk, kv_rs);
      cp_async_commit();
    }
    const bf16* k_s = kv_s + stage * 2 * BK * HD;
    const bf16* v_s = k_s + BK * HD;

    // can any row of this warp see any key of this tile?
    const bool live =
        qw0 < Tq && !(causal && k0 > pw0 + 15) &&
        static_cast<long long>(k0) + BK - 1 >
            static_cast<long long>(pw0) - window;
    if (!live) continue;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // S = Q K^T over (k-step, key pair) steps; each step's fragments are
    // loaded one step ahead so ldmatrix overlaps the previous mma
    constexpr int SP = NT / 2;                  // key-tile pairs per k-step
    unsigned a[2][4], bk[2][4];
    ldsm_x4(a[0], q_s + L::at(16 * warp + lane % 16, lane / 16));
    ldsm_x4(bk[0], k_s + L::at(lane % 8 + (lane / 16) * 8, (lane / 8) % 2));
#pragma unroll
    for (int st = 0; st < HD / 16 * SP; ++st) {
      const int kk = st / SP, jp = st % SP;
      if (st + 1 < HD / 16 * SP) {
        const int kn = (st + 1) / SP, jn = (st + 1) % SP;
        if (jn == 0)
          ldsm_x4(a[kn & 1], q_s + L::at(16 * warp + lane % 16,
                                         2 * kn + lane / 16));
        ldsm_x4(bk[(st + 1) & 1],
                k_s + L::at(16 * jn + lane % 8 + (lane / 16) * 8,
                            2 * kn + (lane / 8) % 2));
      }
      mma16816(s[2 * jp], a[kk & 1], bk[st & 1][0], bk[st & 1][1]);
      mma16816(s[2 * jp + 1], a[kk & 1], bk[st & 1][2], bk[st & 1][3]);
    }
    // elementwise mask only where the tile straddles an edge
    const bool edge =
        k0 + BK > Tk || (causal && k0 + BK - 1 > pw0) ||
        static_cast<long long>(k0) <=
            static_cast<long long>(pw0) + 15 - window;
    if (edge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = pw0 + g + (e / 2) * 8;
          const int col = k0 + 8 * j + 2 * t4 + (e % 2);
          const bool ok = col < Tk && (!causal || col <= row) &&
                          static_cast<long long>(col) >
                              static_cast<long long>(row) - window;
          if (!ok) s[j][e] = -INFINITY;
        }
    }
    // online softmax on the registers; a quad holds one row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with nothing visible yet keeps m = -inf: use 0 as its
      // reference so that exp2 gives 0, never NaN
      const float ref = (mx == -INFINITY ? 0.f : mx) * scale_log2;
      const float alpha = exp2f(fmaf(m[i], scale_log2, -ref));
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -ref));
          sum += s[j][e];
        }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }
    // O += P V; P's accumulator fragments are the A fragments, in bf16;
    // V's fragments are loaded one step ahead, as K's
    constexpr int VP = NO / 2;                  // hd column-tile pairs
    unsigned bv[2][4];
    ldsm_x4_trans(bv[0], v_s + L::at(lane % 8 + ((lane / 8) % 2) * 8,
                                     lane / 16));
#pragma unroll
    for (int st = 0; st < BK / 16 * VP; ++st) {
      const int kk = st / VP, jp = st % VP;
      if (st + 1 < BK / 16 * VP) {
        const int kn = (st + 1) / VP, jn = (st + 1) % VP;
        ldsm_x4_trans(bv[(st + 1) & 1],
                      v_s + L::at(16 * kn + lane % 8 + ((lane / 8) % 2) * 8,
                                  2 * jn + lane / 16));
      }
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma16816(o[2 * jp], pa, bv[st & 1][0], bv[st & 1][1]);
      mma16816(o[2 * jp + 1], pa, bv[st & 1][2], bv[st & 1][3]);
    }
  }
  cp_async_wait_all();

  bf16* ob = out + (static_cast<long long>(b) * Tq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;   // no visible key: 0
    const int r = qw0 + g + 8 * i;
    if (r >= Tq) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<unsigned*>(ob + static_cast<long long>(r) * q_rs +
                                   8 * j + 2 * t4) =
          pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Tq, int Tk, int H, int KV, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t bytes = sizeof(bf16) * (BQ + 4 * BlockK<HD>::value) * HD;
  auto kernel = flash_mma_kernel<HD>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, B, (Tq + BQ - 1) / BQ);
  const double log2e = 1.4426950408889634;
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Tq, Tk, H, KV,
      causal, window, q_offset,
      static_cast<float>(log2e / std::sqrt(static_cast<double>(HD))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// f32 -> the CUDA-core kernel, bf16 -> the tensor-core kernel
int launch_hd(bool f32, int hd, const void* q, const void* k, const void* v,
              void* out, int B, int Tq, int Tk, int H, int KV, int causal,
              int window, int q_offset, cudaStream_t stream) {
#define FLASH_HD(N)                                                         \
  case N:                                                                   \
    return f32 ? launch<float, N>(q, k, v, out, B, Tq, Tk, H, KV, causal,   \
                                  window, q_offset, stream)                 \
               : tc::launch<N>(q, k, v, out, B, Tq, Tk, H, KV, causal,      \
                               window, q_offset, stream);
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
// contiguous.  q_offset: absolute position of query row 0, in [0, 2^30).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Tq, int Tk, int H, int KV,
                           int hd, int causal, int window, int q_offset,
                           int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || KV <= 0 || H % KV != 0 ||
      q_offset < 0 || q_offset >= (1 << 30) || Tq >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hd(dtype == 0, hd, q, k, v, out, B, Tq, Tk, H, KV, causal,
                   window, q_offset, s);
}

}  // extern "C"
