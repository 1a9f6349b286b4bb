// Fused support-core burst for Hopper (sm_90a): one launch per scheduled
// HMQ burst.
//
// Replaces the TPU kernel src/repro/kernels/support_core/support_core_kernel.py
// (fused_step_kernel / _kernel) and computes the same function as its oracle
// src/repro/core/support_core.py::_step_scheduled_jnp -- including
// OP_MALLOC_RUN, which the oracle grants like a malloc.
//
// Design.  One thread block per size class: classes are independent in
// every phase.  The block stages its class's rows of free stack, owner map
// and refcount, plus a per-block free count, in dynamic shared memory
// (16 bytes per block id: up to N of about 14k ids in the 227 KB a block
// may opt into) -- the card's nearest analogue of the paper's metadata
// living in the support core's private L1.  Larger N runs the same code on
// the output rows in global memory, with the free counts in a scratch
// buffer the wrapper allocates.
//
//   1. one thread runs the sequential-skip grant scan over the Q requests
//      of its class (a prefix recurrence: a failed request consumes
//      nothing), recording each grant's count and stack offset;
//   2. all threads gather granted ids from the stack top (LIFO), set
//      owner := lane and refcount := 1, and scatter-add single frees;
//   3. all threads sweep the class's blocks: references dropped = single
//      frees + one if the (post-alloc) owner issued a FREE_ALL, counted
//      only for owned blocks; refcount decrements, and a block returns at 0;
//   4. returned ids are appended to the stack in ascending id order by a
//      block-wide prefix sum, so the stack is bit-identical to the
//      oracle's cumsum compaction.  The gather of phase 2 reads stack
//      positions this append overwrites; a barrier separates them.
//
// The kernel is out of place: it reads the old state and writes a new one,
// so the caller's pre-burst counters stay intact (AllocService computes
// blocks_freed as new.free_count - old.free_count).  With `gated` set and
// no live packet in the whole queue, each block copies its rows and
// answers NO_BLOCK / 0: the skip branch of AllocService.commit(gated=True),
// decided on the card, with no host sync.
//
// Bound: the work is a few integer operations per metadata word, so it is
// bound by bytes -- 3*C*N int32 rows read and written once -- and at the
// serving shape (C=2, N=512) those take a few nanoseconds at 3.35 TB/s,
// far below the launch latency, which is what the launch really costs.

#include <cuda_runtime.h>

namespace {

constexpr int OP_NOP = 0;
constexpr int OP_MALLOC = 1;
constexpr int OP_FREE = 2;
constexpr int OP_REFILL = 3;
constexpr int OP_MALLOC_RUN = 4;
constexpr int FREE_ALL = -1;
constexpr int NO_BLOCK = -1;
constexpr int LANE_PAD = 0x7fffffff;  // reserved lane id (FREE_ALL list pad)
constexpr int THREADS = 512;

__device__ __forceinline__ int clip_class(int c, int C) {
  return c < 0 ? 0 : (c >= C ? C - 1 : c);
}

__global__ void __launch_bounds__(THREADS) support_core_burst_kernel(
    const int* __restrict__ op, const int* __restrict__ lane,
    const int* __restrict__ size_class, const int* __restrict__ arg,
    const int* __restrict__ stack, const int* __restrict__ top,
    const int* __restrict__ owner, const int* __restrict__ refcount,
    const int* __restrict__ alloc_cnt, const int* __restrict__ free_cnt,
    const int* __restrict__ fail_cnt, const int* __restrict__ used,
    const int* __restrict__ peak,
    int* __restrict__ new_stack, int* __restrict__ new_top,
    int* __restrict__ new_owner, int* __restrict__ new_refcount,
    int* __restrict__ new_alloc, int* __restrict__ new_free,
    int* __restrict__ new_fail, int* __restrict__ new_used,
    int* __restrict__ new_peak, int* __restrict__ blocks,
    int* __restrict__ ok, int* __restrict__ scratch,
    int Q, int C, int N, int R, int gated, int in_smem) {
  extern __shared__ int smem[];
  __shared__ int s_taken, s_fail, s_nfa;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(c) * N;

  int* s_gw = smem;             // [Q] blocks granted to request i (0 = none)
  int* s_goff = s_gw + Q;       // [Q] its offset below the stack top
  int* s_fa = s_goff + Q;       // [Q] lanes of this class's FREE_ALL packets
  int* s_part = s_fa + Q;       // [THREADS + 1] scan partials
  int *st, *ow, *rf, *cnt;      // working rows: shared or global
  if (in_smem) {
    st = s_part + THREADS + 1;
    ow = st + N;
    rf = ow + N;
    cnt = rf + N;
  } else {
    st = new_stack + row;
    ow = new_owner + row;
    rf = new_refcount + row;
    cnt = scratch + row;
  }

  int mine = 0;
  for (int i = tid; i < Q; i += THREADS) mine |= (op[i] != OP_NOP);
  const int live = __syncthreads_or(mine);

  if (gated && !live) {         // the gate's skip branch: state unchanged
    for (int b = tid; b < N; b += THREADS) {
      new_stack[row + b] = stack[row + b];
      new_owner[row + b] = owner[row + b];
      new_refcount[row + b] = refcount[row + b];
    }
    for (int idx = tid; idx < Q * R; idx += THREADS)
      if (clip_class(size_class[idx / R], C) == c) blocks[idx] = NO_BLOCK;
    for (int i = tid; i < Q; i += THREADS)
      if (clip_class(size_class[i], C) == c) ok[i] = 0;
    if (tid == 0) {
      new_top[c] = top[c];
      new_alloc[c] = alloc_cnt[c];
      new_free[c] = free_cnt[c];
      new_fail[c] = fail_cnt[c];
      new_used[c] = used[c];
      new_peak[c] = peak[c];
    }
    return;
  }

  for (int b = tid; b < N; b += THREADS) {
    st[b] = stack[row + b];
    ow[b] = owner[row + b];
    rf[b] = refcount[row + b];
    cnt[b] = 0;
  }
  const int top_c = top[c];

  // ---- 1. grant scan (sequential skip) over this class's requests ----
  if (tid == 0) {
    int consumed = 0, fails = 0, nfa = 0;
    for (int i = 0; i < Q; ++i) {
      if (clip_class(size_class[i], C) != c) continue;
      const int o = op[i], a = arg[i];
      const bool is_malloc =
          o == OP_MALLOC || o == OP_REFILL || o == OP_MALLOC_RUN;
      int want = is_malloc ? (a > 0 ? a : 0) : 0;
      if (want > R) want = 0;                     // overwide -> fail
      const bool granted = is_malloc && want > 0 && consumed + want <= top_c;
      s_goff[i] = consumed;
      s_gw[i] = granted ? want : 0;
      ok[i] = granted ? 1 : 0;
      if (granted) consumed += want;
      else if (is_malloc) ++fails;
      if (o == OP_FREE && a == FREE_ALL) s_fa[nfa++] = lane[i];
    }
    s_taken = consumed;
    s_fail = fails;
    s_nfa = nfa;
  }
  __syncthreads();

  // ---- 2. LIFO gather + owner map; single-free reference drops ----
  for (int idx = tid; idx < Q * R; idx += THREADS) {
    const int i = idx / R, j = idx % R;
    if (clip_class(size_class[i], C) != c) continue;
    if (j < s_gw[i]) {
      const int b = st[top_c - 1 - s_goff[i] - j];
      blocks[idx] = b;
      if (b >= 0 && b < N) {
        ow[b] = lane[i];
        rf[b] = 1;
      }
    } else {
      blocks[idx] = NO_BLOCK;
    }
  }
  for (int i = tid; i < Q; i += THREADS) {
    const int a = arg[i];
    if (op[i] == OP_FREE && a >= 0 && a < N &&
        clip_class(size_class[i], C) == c)
      atomicAdd(&cnt[a], 1);
  }
  __syncthreads();

  // ---- 3. refcounted frees over the post-alloc owner map ----
  const int nfa = s_nfa;
  for (int b = tid; b < N; b += THREADS) {
    const int o = ow[b];
    int drop = 0;
    if (o >= 0) {
      int whole = 0;
      if (o != LANE_PAD)
        for (int k = 0; k < nfa; ++k)
          if (s_fa[k] == o) { whole = 1; break; }
      drop = cnt[b] + whole;
    }
    const int dec = rf[b] - drop;
    const int ret = drop > 0 && dec <= 0;
    rf[b] = dec > 0 ? dec : 0;
    ow[b] = ret ? -1 : o;
    cnt[b] = ret;
  }
  __syncthreads();

  // ---- 4. append returned ids in ascending order (block prefix sum) ----
  const int chunk = (N + THREADS - 1) / THREADS;
  const int lo = min(N, tid * chunk), hi = min(N, lo + chunk);
  int local = 0;
  for (int b = lo; b < hi; ++b) local += cnt[b];
  s_part[tid] = local;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int t = 0; t < THREADS; ++t) {
      const int v = s_part[t];
      s_part[t] = run;
      run += v;
    }
    s_part[THREADS] = run;
  }
  __syncthreads();
  const int top_after = top_c - s_taken;
  int dest = top_after + s_part[tid];
  for (int b = lo; b < hi; ++b) {
    if (cnt[b]) {
      if (dest >= 0 && dest < N) st[dest] = b;
      ++dest;
    }
  }
  __syncthreads();

  if (in_smem) {
    for (int b = tid; b < N; b += THREADS) {
      new_stack[row + b] = st[b];
      new_owner[row + b] = ow[b];
      new_refcount[row + b] = rf[b];
    }
  }
  if (tid == 0) {
    const int freed = s_part[THREADS];
    const int used_after = used[c] + s_taken;
    new_top[c] = top_after + freed;
    new_alloc[c] = alloc_cnt[c] + s_taken;
    new_free[c] = free_cnt[c] + freed;
    new_fail[c] = fail_cnt[c] + s_fail;
    new_used[c] = used_after - freed;
    new_peak[c] = max(peak[c], used_after);
  }
}

// Dynamic shared memory of one launch, plus room for the kernel's few
// static shared words, which count against the same per-block limit.
size_t smem_bytes(int Q, int N, bool in_smem) {
  size_t words = 3 * static_cast<size_t>(Q) + THREADS + 1;
  if (in_smem) words += 4 * static_cast<size_t>(N);
  return words * sizeof(int);
}
constexpr size_t STATIC_SMEM = 64;

int max_smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

}  // namespace

extern "C" {

// 1 if a burst of Q requests over N-id rows runs with its rows in shared
// memory; 0 if it needs the global-memory path (and a [C, N] scratch).
int support_core_in_smem(int Q, int N) {
  return smem_bytes(Q, N, true) + STATIC_SMEM <=
         static_cast<size_t>(max_smem_optin());
}

// Launches one burst on `stream`; returns cudaGetLastError() (0 = launched).
int support_core_burst_launch(
    const int* op, const int* lane, const int* size_class, const int* arg,
    const int* stack, const int* top, const int* owner, const int* refcount,
    const int* alloc_cnt, const int* free_cnt, const int* fail_cnt,
    const int* used, const int* peak, int* new_stack, int* new_top,
    int* new_owner, int* new_refcount, int* new_alloc, int* new_free,
    int* new_fail, int* new_used, int* new_peak, int* blocks, int* ok,
    int* scratch, int Q, int C, int N, int R, int gated, int in_smem,
    void* stream) {
  if (Q <= 0 || C <= 0 || N <= 0 || R <= 0 || (!in_smem && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(Q, N, in_smem != 0);
  if (bytes + STATIC_SMEM > static_cast<size_t>(max_smem_optin()))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        support_core_burst_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  support_core_burst_kernel<<<C, THREADS, bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      op, lane, size_class, arg, stack, top, owner, refcount, alloc_cnt,
      free_cnt, fail_cnt, used, peak, new_stack, new_top, new_owner,
      new_refcount, new_alloc, new_free, new_fail, new_used, new_peak, blocks,
      ok, scratch, Q, C, N, R, gated, in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
