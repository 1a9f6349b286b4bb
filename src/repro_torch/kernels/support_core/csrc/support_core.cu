// Fused support-core burst for Hopper (sm_90a): one launch per scheduled
// HMQ burst.
//
// Replaces the TPU kernel src/repro/kernels/support_core/support_core_kernel.py
// (fused_step_kernel, pallas_call at :256) and computes the same function as
// its oracle src/repro/core/support_core.py::_step_scheduled_jnp -- including
// OP_MALLOC_RUN, which the oracle grants like a malloc -- bit for bit against
// the port's plain version core/support_core.py::_step_scheduled_torch.
//
// What bounds it.  The work is a few integer operations per metadata word, so
// the least time is bytes: 3*C*N int32 rows read and written once (the kernel
// is out of place).  Below N of a few thousand ids those take nanoseconds,
// and the launch and the chain of dependent steps over the queue (the grant
// recurrence, the scans between barriers) are what a burst costs; above it
// the bytes dominate, and they move at the card's rate only if many SMs move
// them -- the global-memory version of this kernel ran a class on one SM.
//
// Design.  Size classes are independent, so a class is one block or one
// thread-block cluster (grid = cluster x C), on the path ops.py::plan_burst
// picks from the shapes alone and passes in:
//
//   block    the class's rows of stack, owner map and refcount plus a count
//            row (16 bytes per id) fit one block's 227 KB of shared memory
//            -- the card's nearest analogue of the paper's metadata in the
//            support core's private L1;
//   cluster  the id range is cut into contiguous slices in rank order, one
//            per block of a cluster of up to 8, each in its block's shared
//            memory; the steps that cross slices use distributed shared
//            memory, with a cluster barrier (split into arrive and wait
//            where work can go between) after each;
//   global   beyond what a cluster holds: the same steps on the output rows
//            in device memory, the counts in a scratch row.
//
//   0. the queue is staged in shared memory by all threads (the TPU kernel's
//      scalar prefetch) while the bulk copy engine loads the slice's rows
//      (cp.async where a row is not 16-byte aligned), so the burst waits
//      for one round trip to memory, not one per phase;
//   1. grants: one pass over the queue computes the exclusive prefix sum of
//      want in scheduled order (warp shuffles, each warp adding the totals
//      of the warps before it), the class's FREE_ALL lanes and this slice's
//      single frees.  When the class's total want fits under top, every
//      malloc with want > 0 is granted at its prefix (the fast path);
//      otherwise warp 0 runs the sequential skip 32 requests at a time:
//      requests wanting more than what is left fail at once (what is left
//      only shrinks), a shuffle scan grants the run before the first misfit,
//      and that misfit fails.  Every block of a cluster computes its class's
//      grants itself;
//   2. stack position top-1-k holds the id granted at offset k: the block
//      holding the position finds the request by a binary search of the
//      grant ends, answers it, and writes the id's owner and refcount into
//      the slice that holds the id;
//   3. each slice sweeps its ids, 4 consecutive ids a lane (16-byte shared
//      loads): references dropped = single frees + one if the post-alloc
//      owner's lane issued a FREE_ALL (a lane bitmap when lane ids are below
//      32 Q, else a binary search of the sorted lanes); an id returns at
//      refcount 0.  A class with no free skips steps 3's returns and 4;
//   4. returned ids are listed per slice in ascending order (flags kept in
//      registers, ranks from warp scans), and stack position top_after + g
//      takes the g-th returned id of the class: each slice pulls those of
//      its own positions from the slices' lists, so the stack is
//      bit-identical to the oracle's cumsum compaction.  Rows go back by
//      the bulk copy engine as soon as they are final.
//
// The kernel is out of place: it reads the old state and writes a new one,
// so the caller's pre-burst counters stay intact (AllocService computes
// blocks_freed as new.free_count - old.free_count).  With `gated` set and no
// live packet in the whole queue, every block copies its slice's rows and
// answers NO_BLOCK / 0: the skip branch of AllocService.commit(gated=True),
// decided on the card, with no host sync.  Out-of-range block ids and
// append positions are never written (the JAX package's mode="drop").

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int OP_NOP = 0;
constexpr int OP_MALLOC = 1;
constexpr int OP_FREE = 2;
constexpr int OP_REFILL = 3;
constexpr int OP_MALLOC_RUN = 4;
constexpr int FREE_ALL = -1;
constexpr int NO_BLOCK = -1;
constexpr int LANE_PAD = 0x7fffffff;  // reserved lane id (FREE_ALL list pad)
constexpr unsigned FULL = 0xffffffffu;

// Shared with ops.py (plan_burst); a change here is a change there.
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;          // portable cluster size
constexpr size_t STATIC_SMEM = 256;     // room for the static shared words
enum Path { PATH_BLOCK = 0, PATH_CLUSTER = 1, PATH_GLOBAL = 2 };

// Queue staging: op, lane, class, arg, granted count, offset, FREE_ALL lanes
// (as listed, and as a bitmap or sorted): 8 words per request, padded to 16
// bytes.
__host__ __device__ constexpr size_t head_words(int Q) {
  return (8 * static_cast<size_t>(Q) + 3) / 4 * 4;
}
size_t smem_bytes(int path, int Q, int slice) {
  size_t words = head_words(Q);
  if (path != PATH_GLOBAL) words += 4 * static_cast<size_t>(slice);
  return words * sizeof(int);
}

struct Args {
  const int *op, *lane, *size_class, *arg;
  const int *stack, *top, *owner, *refcount;
  const int *alloc_cnt, *free_cnt, *fail_cnt, *used, *peak;
  int *new_stack, *new_top, *new_owner, *new_refcount;
  int *new_alloc, *new_free, *new_fail, *new_used, *new_peak;
  int *blocks, *ok, *scratch;
  int Q, C, N, R, gated, slice;
};

// scalars kept in static shared memory
enum Misc { M_TAKEN, M_FAILS, M_NFA, M_FREES, M_FA_WIDE, M_COUNT, M_WORDS };

__device__ __forceinline__ int clip_class(int c, int C) {
  return c < 0 ? 0 : (c >= C ? C - 1 : c);
}

__device__ __forceinline__ bool is_malloc_op(int o) {
  return o == OP_MALLOC || o == OP_REFILL || o == OP_MALLOC_RUN;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// Copies n words from up to three source rows to their destinations, 16
// bytes at a time when every pointer allows it; threads t0, t0 + stride, ...
__device__ __forceinline__ void copy_rows(
    int* __restrict__ d0, const int* __restrict__ s0, int* __restrict__ d1,
    const int* __restrict__ s1, int* __restrict__ d2,
    const int* __restrict__ s2, int n, int t0, int stride) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(d0) |
                          reinterpret_cast<uintptr_t>(s0) |
                          reinterpret_cast<uintptr_t>(d1) |
                          reinterpret_cast<uintptr_t>(s1) |
                          reinterpret_cast<uintptr_t>(d2) |
                          reinterpret_cast<uintptr_t>(s2);
  int done = 0;
  if ((align & 15) == 0) {
    const int n4 = n >> 2;
    const int4* a = reinterpret_cast<const int4*>(s0);
    const int4* b = reinterpret_cast<const int4*>(s1);
    const int4* c = reinterpret_cast<const int4*>(s2);
    int4* x = reinterpret_cast<int4*>(d0);
    int4* y = reinterpret_cast<int4*>(d1);
    int4* z = reinterpret_cast<int4*>(d2);
    for (int v = t0; v < n4; v += 2 * stride) {
      const int v2 = v + stride;
      const int4 a0 = a[v], b0 = b[v], c0 = c[v];
      int4 a1 = a0, b1 = b0, c1 = c0;
      if (v2 < n4) { a1 = a[v2]; b1 = b[v2]; c1 = c[v2]; }
      x[v] = a0; y[v] = b0; z[v] = c0;
      if (v2 < n4) { x[v2] = a1; y[v2] = b1; z[v2] = c1; }
    }
    done = n4 << 2;
  }
  for (int w = done + t0; w < n; w += stride) {
    d0[w] = s0[w];
    d1[w] = s1[w];
    d2[w] = s2[w];
  }
}

// Starts copying n words of three rows from device memory into shared
// memory with cp.async (16 bytes at a time when every pointer allows it), so
// the rows' loads are in flight with the queue's; cp_async_wait() ends them.
__device__ __forceinline__ void cp_async(int* dst, const int* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void load_rows_async(
    int* d0, const int* s0, int* d1, const int* s1, int* d2, const int* s2,
    int n, int t0, int stride) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(d0) |
                          reinterpret_cast<uintptr_t>(s0) |
                          reinterpret_cast<uintptr_t>(d1) |
                          reinterpret_cast<uintptr_t>(s1) |
                          reinterpret_cast<uintptr_t>(d2) |
                          reinterpret_cast<uintptr_t>(s2);
  int done = 0;
  if ((align & 15) == 0) {
    for (int w = 4 * t0; w + 3 < n; w += 4 * stride) {
      cp_async(d0 + w, s0 + w, 16);
      cp_async(d1 + w, s1 + w, 16);
      cp_async(d2 + w, s2 + w, 16);
    }
    done = n & ~3;
  }
  for (int w = done + t0; w < n; w += stride) {
    cp_async(d0 + w, s0 + w, 4);
    cp_async(d1 + w, s1 + w, 4);
    cp_async(d2 + w, s2 + w, 4);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d,
                                          const void* e, const void* f) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
           reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(f)) &
          15) == 0;
}

// One thread hands three rows of n words (n * 4 a multiple of 16) to the
// bulk copy engine, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load_rows(
    int* d0, const int* s0, int* d1, const int* s1, int* d2, const int* s2,
    int n, unsigned long long* bar) {
  const unsigned b = smem_addr(bar), bytes = 4u * n;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(3 * bytes) : "memory");
  int* dst[3] = {d0, d1, d2};
  const int* src[3] = {s0, s1, s2};
#pragma unroll
  for (int r = 0; r < 3; ++r)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst[r])), "l"(src[r]),
        "r"(bytes), "r"(b) : "memory");
}

__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b) : "memory");
  } while (!done);
}

// Makes this thread's shared-memory writes visible to the bulk copy engine.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One row of n words from shared to device memory by the bulk copy engine;
// bulk_commit() closes the group that bulk_store_wait() waits for.
__device__ __forceinline__ void bulk_store_row(int* dst, const int* src,
                                               int n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(4u * n) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Before the block exits: its bulk stores have read their shared memory
// (the writes themselves are complete when the grid is).
__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Position of id or stack slot b in the rows of the slice that holds it.
// `mine` points at this block's slice (shared memory, or the global row at
// the slice's first id).
template <int MODE>
__device__ __forceinline__ int* slot(int* mine, int b, int lo, int S) {
  if constexpr (MODE == PATH_CLUSTER) {
    const int r = b / S;
    return cg::this_cluster().map_shared_rank(mine, r) + (b - r * S);
  } else {
    return mine + (b - lo);
  }
}

template <int MODE>
__device__ __forceinline__ void sync_all() {
  if constexpr (MODE == PATH_BLOCK) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// V consecutive words of a row at `base`: one 16-byte shared access for
// V = 4 (rows padded to whole tiles), else one word, `fill` past n.
template <int V>
__device__ __forceinline__ void load_v(const int* row, int base, int n,
                                       int (&x)[V], int fill) {
  if constexpr (V == 4) {
    const int4 v = *reinterpret_cast<const int4*>(row + base);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = base < n ? row[base] : fill;
  }
}

template <int V>
__device__ __forceinline__ void store_v(int* row, int base, int n,
                                        const int (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(row + base) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
    if (base < n) row[base] = x[0];
  }
}

// The two halves of a cluster barrier: arrive (release this thread's
// accesses, or only mark the arrival) and wait (acquire everyone's).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Whether x is in the sorted list fa[0, n): a lower bound in a fixed number
// of steps (`top` is the largest power of two <= n, 0 for an empty list), so
// a warp can run several searches side by side.
__device__ __forceinline__ bool fa_has(const int* fa, int n, int top, int x) {
  int pos = 0;
  for (int step = top; step > 0; step >>= 1)
    if (pos + step <= n && fa[pos + step - 1] < x) pos += step;
  return pos < n && fa[pos] == x;
}

// The request whose grant covers stack offset `off`: the first whose end
// (offset + ids granted, nondecreasing in scheduled order) exceeds it.
__device__ __forceinline__ int grant_of(const int* goff, const int* gw, int Q,
                                        int off) {
  int i = 0;
  for (int n = Q; n > 0;) {
    const int half = n >> 1;
    if (goff[i + half] + gw[i + half] <= off) {
      i += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return i;
}

// Whether owner x >= 0 issued a FREE_ALL of this class: a bit of the lane
// bitmap, or a binary search of the sorted lanes (never the pad lane).
__device__ __forceinline__ bool fa_member(const int* fa, int nfa, int fa_top,
                                          bool bitmap, int Q, int x) {
  if (!nfa) return false;
  if (bitmap)
    return x < 32 * Q &&
           ((reinterpret_cast<const unsigned*>(fa)[x >> 5] >> (x & 31)) & 1u);
  return x != LANE_PAD && fa_has(fa, nfa, fa_top, x);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1) support_core_burst_kernel(
    const Args a) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_warp[WARPS];      // warp totals, then their exclusive scan
  __shared__ int s_misc[M_WORDS];
  __shared__ int s_before[MAX_CLUSTER + 1];  // slices' exclusive list offsets
  __shared__ __align__(8) unsigned long long s_bar;  // the rows' bulk load
  const int Q = a.Q, C = a.C, N = a.N, R = a.R, S = a.slice;
  const int c = blockIdx.y;
  const int rank = blockIdx.x;       // == the cluster rank: cluster = (k,1,1)
  const int k = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = rank * S;
  const int L = max(0, min(N, lo + S) - lo);   // ids in this slice
  const size_t row = static_cast<size_t>(c) * N + lo;
  const int gt = rank * THREADS + tid, gthreads = k * THREADS;

  int* q_op = smem;
  int* q_lane = q_op + Q;
  int* q_cls = q_lane + Q;
  int* q_arg = q_cls + Q;
  int* s_gw = q_arg + Q;             // [Q] ids granted to request i
  int* s_goff = s_gw + Q;            // [Q] its offset below the stack top
  int* s_fa_raw = s_goff + Q;        // [Q] this class's FREE_ALL lanes
  int* s_fa = s_fa_raw + Q;          // [Q] the same as a bitmap, or sorted
  int *st, *ow, *rf, *cnt;           // this slice's rows
  if constexpr (MODE == PATH_GLOBAL) {
    st = a.new_stack + row;
    ow = a.new_owner + row;
    rf = a.new_refcount + row;
    cnt = a.scratch + row;
  } else {
    st = smem + head_words(Q);
    ow = st + S;
    rf = ow + S;
    cnt = rf + S;
  }
  // rows that the bulk copy engine can move: 16-byte aligned, whole words
  const bool bulk = MODE != PATH_GLOBAL && (L & 3) == 0 &&
                    aligned16(a.stack + row, a.owner + row, a.refcount + row,
                              a.new_stack + row, a.new_owner + row,
                              a.new_refcount + row);

  // ---- 0. stage the queue and the slice's rows; the gate.  Every load is
  //         issued before the first barrier: the rows by the bulk copy
  //         engine (or cp.async), the counters by the thread that writes
  //         them back ----
  const int top_c = a.top[c];
  const bool writer = rank == 0 && tid == 0;
  int used_c = 0, alloc_c = 0, free_c = 0, fail_c = 0, peak_c = 0;
  if (writer) {
    used_c = a.used[c];
    alloc_c = a.alloc_cnt[c];
    free_c = a.free_cnt[c];
    fail_c = a.fail_cnt[c];
    peak_c = a.peak[c];
  }
  if constexpr (MODE != PATH_GLOBAL) {
    if (bulk) {
      if (tid == 0)
        bulk_load_rows(st, a.stack + row, ow, a.owner + row, rf,
                       a.refcount + row, L, &s_bar);
    } else {
      load_rows_async(st, a.stack + row, ow, a.owner + row, rf,
                      a.refcount + row, L, tid, THREADS);
    }
  }
  int mine = 0;
  for (int i = tid; i < Q; i += THREADS) {
    const int o = a.op[i];
    q_op[i] = o;
    q_lane[i] = a.lane[i];
    q_cls[i] = clip_class(a.size_class[i], C);
    q_arg[i] = a.arg[i];
    s_fa[i] = 0;                     // the FREE_ALL lane bitmap
    mine |= o != OP_NOP;
  }
  if (tid < M_WORDS) s_misc[tid] = 0;
  if constexpr (MODE == PATH_GLOBAL) {
    for (int li = tid; li < L; li += THREADS) cnt[li] = 0;
  } else {                           // the tail of the last tile: never owned
    const int Lp = (L + 127) / 128 * 128;
    for (int li = tid; li < Lp; li += THREADS) {
      cnt[li] = 0;
      if (li >= L) {
        ow[li] = -1;
        rf[li] = 0;
      }
    }
  }
  const int live = __syncthreads_or(mine);

  if (a.gated && !live) {            // the gate's skip branch: state unchanged
    if constexpr (MODE == PATH_GLOBAL) {
      copy_rows(st, a.stack + row, ow, a.owner + row, rf, a.refcount + row, L,
                tid, THREADS);
    } else if (bulk) {
      if (tid == 0) {
        bulk_wait(&s_bar);
        fence_async_smem();
        bulk_store_row(a.new_stack + row, st, L);
        bulk_store_row(a.new_owner + row, ow, L);
        bulk_store_row(a.new_refcount + row, rf, L);
        bulk_commit();
      }
    } else {
      cp_async_wait();
      __syncthreads();
      copy_rows(a.new_stack + row, st, a.new_owner + row, ow,
                a.new_refcount + row, rf, L, tid, THREADS);
    }
    for (int idx = gt; idx < Q * R; idx += gthreads)
      if (q_cls[idx / R] == c) a.blocks[idx] = NO_BLOCK;
    for (int i = gt; i < Q; i += gthreads)
      if (q_cls[i] == c) a.ok[i] = 0;
    if (writer) {
      a.new_top[c] = top_c;
      a.new_alloc[c] = alloc_c;
      a.new_free[c] = free_c;
      a.new_fail[c] = fail_c;
      a.new_used[c] = used_c;
      a.new_peak[c] = peak_c;
    }
    if (bulk && tid == 0) bulk_store_wait();
    return;
  }
  if constexpr (MODE == PATH_GLOBAL) {   // worked in place on the output rows
    copy_rows(st, a.stack + row, ow, a.owner + row, rf, a.refcount + row, L,
              tid, THREADS);
  } else if (bulk) {
    bulk_wait(&s_bar);
  } else {
    cp_async_wait();
  }
  // A (first half): this slice's stack is in place for the other slices'
  // gathers; the grant below needs nothing of theirs
  if constexpr (MODE != PATH_BLOCK) cluster_arrive();

  // ---- 1. grant scan, one pass over the queue in scheduled order: the
  //         exclusive prefix sum of want (fast path), the class's FREE_ALL
  //         lanes, and this slice's single frees (one reference each) ----
  int carry = 0;
  for (int base = 0; base < Q; base += THREADS) {
    const int i = base + tid;
    int w = 0;
    bool fail = false;
    if (i < Q && q_cls[i] == c) {
      const int o = q_op[i], x = q_arg[i];
      if (is_malloc_op(o)) {
        w = (x > 0 && x <= R) ? x : 0;
        fail = w == 0;
      } else if (o == OP_FREE && x == FREE_ALL) {
        const int ln = q_lane[i];
        s_fa_raw[atomicAdd(&s_misc[M_NFA], 1)] = ln;
        if (ln >= 0 && ln < 32 * Q)
          atomicOr(reinterpret_cast<unsigned*>(&s_fa[ln >> 5]),
                   1u << (ln & 31));
        else
          s_misc[M_FA_WIDE] = 1;
        s_misc[M_FREES] = 1;
      } else if (o == OP_FREE && x >= 0 && x < N) {
        if (x >= lo && x < lo + L) atomicAdd(&cnt[x - lo], 1);
        s_misc[M_FREES] = 1;
      }
    }
    const int nfail = __popc(__ballot_sync(FULL, fail));
    if (lane == 0 && nfail) atomicAdd(&s_misc[M_FAILS], nfail);
    const int incl = warp_incl_scan(w, lane);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    // each warp adds up the totals of the warps before it itself
    int before = 0, chunk = 0;
#pragma unroll
    for (int v = 0; v < WARPS; ++v) {
      const int x = s_warp[v];
      before += v < warp ? x : 0;
      chunk += x;
    }
    if (i < Q) {
      s_gw[i] = w;
      s_goff[i] = carry + before + incl - w;
    }
    carry += chunk;
    if (base + THREADS < Q) __syncthreads();   // s_warp is reused
  }
  // fast path when the class's total want fits under top: every malloc
  // with want > 0 is granted at its prefix sum (computed above).  Otherwise
  // warp 0 runs the sequential skip -- a failed request consumes nothing --
  // 32 requests at a time.
  if (carry > top_c && warp == 0) {
    int consumed = 0, fails = 0;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + lane;
      const bool m = i < Q && q_cls[i] == c && is_malloc_op(q_op[i]);
      int w = 0;
      if (m) {
        const int x = q_arg[i];
        w = (x > 0 && x <= R) ? x : 0;
      }
      int g = 0;
      unsigned und = __ballot_sync(FULL, m && w > 0);
      fails += __popc(__ballot_sync(FULL, m && w == 0));
      while (und) {
        const int left = top_c - consumed;
        const unsigned over =
            __ballot_sync(FULL, ((und >> lane) & 1) && w > left);
        fails += __popc(over);
        und &= ~over;
        if (!und) break;
        const int v = ((und >> lane) & 1) ? w : 0;
        const int incl = warp_incl_scan(v, lane);
        const unsigned bad = __ballot_sync(FULL, v > 0 && incl > left);
        unsigned take = und;
        if (bad) {
          const int f = __ffs(bad) - 1;
          take = und & ((1u << f) - 1u);
          und &= ~((2u << f) - 1u);  // lanes up to f are decided
          ++fails;                   // lane f misfits after the run before it
        } else {
          und = 0;
        }
        if ((take >> lane) & 1) g = w;
        if (take) consumed += __shfl_sync(FULL, incl, 31 - __clz(take));
      }
      // every request gets the offset of its place in scheduled order (a
      // request granted nothing takes no room), as on the fast path
      const int gi = warp_incl_scan(g, lane);
      const int start = consumed - __shfl_sync(FULL, gi, 31);
      if (i < Q) {
        s_gw[i] = g;
        s_goff[i] = start + gi - g;
      }
    }
    if (lane == 0) {
      s_misc[M_TAKEN] = consumed;
      s_misc[M_FAILS] = fails;
    }
  } else if (carry <= top_c && tid == 0) {
    s_misc[M_TAKEN] = carry;
  }
  __syncthreads();
  // the class's FREE_ALL lanes: a bitmap when every lane id is below 32 Q
  // (one shared load an owned id), else sorted for a binary search (rank
  // sort: the list is at most Q)
  const int nfa = s_misc[M_NFA];
  const bool fa_bitmap = s_misc[M_FA_WIDE] == 0;
  for (int t = fa_bitmap ? nfa : tid; t < nfa; t += THREADS) {
    const int x = s_fa_raw[t];
    int r = 0;
    for (int j = 0; j < nfa; ++j) {
      const int y = s_fa_raw[j];
      r += y < x || (y == x && j < t);
    }
    s_fa[r] = x;
  }
  const int taken = s_misc[M_TAKEN];
  const bool frees = s_misc[M_FREES] != 0;   // the same in every slice
  // A (second half): every slice's stack is in place
  if constexpr (MODE != PATH_BLOCK) cluster_wait();
  __syncthreads();

  // ---- 2. LIFO gather + owner map.  Stack position top-1-k holds the
  //         id granted at offset k (k < taken); the block holding the
  //         position answers the grant and sets the id's owner and refcount
  //         in the slice holding the id ----
  const int g_lo = max(lo, top_c - taken), g_hi = min(lo + L, top_c);
  for (int p = g_lo + tid; p < g_hi; p += THREADS) {
    const int b = st[p - lo];
    if (b >= 0 && b < N) {
      const int i = grant_of(s_goff, s_gw, Q, top_c - 1 - p);
      *slot<MODE>(ow, b, lo, S) = q_lane[i];
      *slot<MODE>(rf, b, lo, S) = 1;
    }
  }
  // B (first half): the owner map's writes are released; the answers go to
  // device memory after it, so that the release does not wait for them
  if constexpr (MODE != PATH_BLOCK) cluster_arrive();
  for (int p = g_lo + tid; p < g_hi; p += THREADS) {
    const int off = top_c - 1 - p;
    const int i = grant_of(s_goff, s_gw, Q, off);
    a.blocks[static_cast<size_t>(i) * R + off - s_goff[i]] = st[p - lo];
  }
  if (rank == 0) {
    for (int idx = tid; idx < Q * R; idx += THREADS) {
      const int i = idx / R;
      if (q_cls[i] == c && idx - i * R >= s_gw[i]) a.blocks[idx] = NO_BLOCK;
    }
    for (int i = tid; i < Q; i += THREADS)
      if (q_cls[i] == c) a.ok[i] = s_gw[i] > 0;
  }
  if constexpr (MODE != PATH_BLOCK) {
    cluster_wait();                  // B: every slice's owner map is final
  } else {
    __syncthreads();
  }

  // ---- 3. refcounted frees over the post-alloc owner map.  A lane sweeps V
  //         consecutive ids of a tile (16-byte shared loads on the shared-
  //         memory paths) and keeps its returned flags in a register; the
  //         returned ids are then listed in ascending order over the count
  //         row (every count of the round has been read by then) ----
  constexpr int V = MODE == PATH_GLOBAL ? 1 : 4;
  constexpr int TILE = 32 * V;
  constexpr int ROUND = WARPS * (32 / V) * TILE;   // 32 flag bits a lane
  const int Lp = (L + TILE - 1) / TILE * TILE;     // the padding never returns
  const int fa_top = nfa ? 1 << (31 - __clz(nfa)) : 0;
  int listed = 0, freed = 0;
  if (frees) {
    for (int r0 = 0; r0 < Lp; r0 += ROUND) {
      const int ntiles = min(Lp - r0, ROUND) / TILE;
      const int per_warp = (ntiles + WARPS - 1) / WARPS;
      const int t0 = min(ntiles, warp * per_warp);
      const int t1 = min(ntiles, t0 + per_warp);
      unsigned flags = 0;
      for (int t = t0; t < t1; ++t) {
        const int base = r0 + t * TILE + lane * V;
        int o[V], d[V], rc[V];
        load_v<V>(ow, base, L, o, -1);
        load_v<V>(cnt, base, L, d, 0);
        load_v<V>(rf, base, L, rc, 0);
        unsigned bits = 0;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          int drop = 0;
          if (o[e] >= 0)
            drop = d[e] + fa_member(s_fa, nfa, fa_top, fa_bitmap, Q, o[e]);
          const int dec = rc[e] - drop;
          const unsigned ret = drop > 0 && dec <= 0;
          rc[e] = dec > 0 ? dec : 0;
          if (ret) o[e] = -1;
          bits |= ret << e;
        }
        store_v<V>(rf, base, L, rc);
        store_v<V>(ow, base, L, o);
        flags |= bits << ((t - t0) * V);
      }
      if (bulk) fence_async_smem();
      const int wsum = warp_sum(__popc(flags));
      if (lane == 0) s_warp[warp] = wsum;
      __syncthreads();               // the list may overwrite the counts now
      // the owner and refcount rows are final: their stores overlap the rest
      if (bulk && tid == 0 && r0 + ROUND >= Lp) {
        bulk_store_row(a.new_owner + row, ow, L);
        bulk_store_row(a.new_refcount + row, rf, L);
        bulk_commit();
      }
      int before = 0, round = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) {
        const int x = s_warp[v];
        before += v < warp ? x : 0;
        round += x;
      }
      if (wsum) {
        int at = listed + before;
        for (int t = t0; t < t1; ++t) {
          const unsigned bits = (flags >> ((t - t0) * V)) & ((1u << V) - 1u);
          if (!__any_sync(FULL, bits)) continue;
          const int n = __popc(bits);
          const int incl = warp_incl_scan(n, lane);
          int q = at + incl - n;
          const int base = r0 + t * TILE + lane * V;
#pragma unroll
          for (int e = 0; e < V; ++e)
            if ((bits >> e) & 1u) cnt[q++] = lo + base + e;
          at += __shfl_sync(FULL, incl, 31);
        }
      }
      listed += round;
      if (r0 + ROUND < Lp) __syncthreads();   // s_warp is reused
    }
    if (tid == 0) s_misc[M_COUNT] = listed;
    sync_all<MODE>();                // C: every slice's list is published

    // ---- 4. append: stack position top_after + g, g < freed, takes the
    //         g-th returned id in ascending order; each slice pulls those of
    //         its own positions from the slices' lists ----
    if (warp == 0) {
      int v = 0;
      if (lane < k) {
        if constexpr (MODE == PATH_BLOCK) {
          v = listed;
        } else {                     // the cluster's slices, in rank order
          v = *cg::this_cluster().map_shared_rank(&s_misc[M_COUNT], lane);
        }
      }
      const int incl = warp_incl_scan(v, lane);
      if (lane < k) s_before[lane] = incl - v;
      if (lane == k - 1) s_before[k] = incl;
    }
    __syncthreads();
    freed = s_before[k];
    const int base0 = top_c - taken;
    const int p_hi = min(lo + L, base0 + freed);
    constexpr int PULL = 8;          // remote reads a thread keeps in flight
    for (int p0 = max(lo, base0) + tid; p0 < p_hi; p0 += PULL * THREADS) {
      int id[PULL];
#pragma unroll
      for (int u = 0; u < PULL; ++u) {
        const int p = p0 + u * THREADS;
        if (p < p_hi) {
          const int g = p - base0;
          int r = 0;
          while (r + 1 < k && s_before[r + 1] <= g) ++r;
          id[u] = *slot<MODE>(cnt, r * S + g - s_before[r], lo, S);
        }
      }
#pragma unroll
      for (int u = 0; u < PULL; ++u)
        if (p0 + u * THREADS < p_hi) st[p0 + u * THREADS - lo] = id[u];
    }
  } else {
    // no free of this class: nothing returns, refcounts only clamp at 0
    for (int base = tid * V; base < Lp; base += THREADS * V) {
      int rc[V];
      load_v<V>(rf, base, L, rc, 0);
#pragma unroll
      for (int e = 0; e < V; ++e) rc[e] = rc[e] > 0 ? rc[e] : 0;
      store_v<V>(rf, base, L, rc);
    }
  }
  const int base0 = top_c - taken;
  // D (first half): no slice reads this block's shared memory past here
  // (its arrival publishes nothing)
  if constexpr (MODE != PATH_BLOCK) cluster_arrive_relaxed();
  if constexpr (MODE != PATH_GLOBAL) {
    if (bulk) {
      fence_async_smem();
      __syncthreads();
      if (tid == 0) {
        bulk_store_row(a.new_stack + row, st, L);
        if (!frees) {
          bulk_store_row(a.new_owner + row, ow, L);
          bulk_store_row(a.new_refcount + row, rf, L);
        }
        bulk_commit();
      }
    } else {
      __syncthreads();
      copy_rows(a.new_stack + row, st, a.new_owner + row, ow,
                a.new_refcount + row, rf, L, tid, THREADS);
    }
  }
  if (writer) {
    const int used_after = used_c + taken;
    a.new_top[c] = base0 + freed;
    a.new_alloc[c] = alloc_c + taken;
    a.new_free[c] = free_c + freed;
    a.new_fail[c] = fail_c + s_misc[M_FAILS];
    a.new_used[c] = used_after - freed;
    a.new_peak[c] = max(peak_c, used_after);
  }
  if (bulk && tid == 0) bulk_store_wait();
  // D (second half): the other slices are done with this one
  if constexpr (MODE != PATH_BLOCK) cluster_wait();
}

int max_smem_optin() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    bytes = v;
  }
  return bytes;
}

template <int MODE>
cudaError_t ensure_smem(size_t bytes) {
  static size_t high = 48 * 1024;    // the default every kernel may use
  if (bytes <= high) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      support_core_burst_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) high = bytes;
  return err;
}

cudaError_t ensure_smem_for(int path, size_t bytes) {
  switch (path) {
    case PATH_BLOCK: return ensure_smem<PATH_BLOCK>(bytes);
    case PATH_CLUSTER: return ensure_smem<PATH_CLUSTER>(bytes);
    default: return ensure_smem<PATH_GLOBAL>(bytes);
  }
}

cudaLaunchConfig_t cluster_config(int k, int C, size_t bytes,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, C, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The rules every plan must keep (ops.py::plan_burst makes them).
bool plan_ok(int path, int k, int slice, int Q, int C, int N) {
  if (Q <= 0 || C <= 0 || N <= 0 || k < 1 || k > MAX_CLUSTER) return false;
  if (path < PATH_BLOCK || path > PATH_GLOBAL) return false;
  if (path == PATH_BLOCK && k != 1) return false;
  if (slice <= 0 || slice % (path == PATH_GLOBAL ? 32 : 128) != 0)
    return false;                    // whole tiles of the sweep
  if (static_cast<long long>(slice) * k < N) return false;        // covers N
  if (static_cast<long long>(slice) * (k - 1) >= N) return false; // none empty
  return smem_bytes(path, Q, slice) + STATIC_SMEM <=
         static_cast<size_t>(max_smem_optin());
}

}  // namespace

extern "C" {

// The shared memory one block may opt into (bytes), read once.
int support_core_smem_optin() { return max_smem_optin(); }

// How many clusters of `k` blocks of a plan can be resident at once (0: the
// cluster cannot be scheduled); a negative value is -(CUDA error).
int support_core_max_active_clusters(int path, int k, int slice, int Q, int C,
                                     int N) {
  if (!plan_ok(path, k, slice, Q, C, N) || path == PATH_BLOCK)
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(path, Q, slice);
  cudaError_t err = ensure_smem_for(path, bytes);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(k, C, bytes, nullptr, attr);
  int n = 0;
  err = path == PATH_CLUSTER
            ? cudaOccupancyMaxActiveClusters(
                  &n, support_core_burst_kernel<PATH_CLUSTER>, &cfg)
            : cudaOccupancyMaxActiveClusters(
                  &n, support_core_burst_kernel<PATH_GLOBAL>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Launches one burst on `stream` along the plan (path, cluster size k, ids
// per slice); returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a plan that breaks the rules.
int support_core_burst_launch(
    const int* op, const int* lane, const int* size_class, const int* arg,
    const int* stack, const int* top, const int* owner, const int* refcount,
    const int* alloc_cnt, const int* free_cnt, const int* fail_cnt,
    const int* used, const int* peak, int* new_stack, int* new_top,
    int* new_owner, int* new_refcount, int* new_alloc, int* new_free,
    int* new_fail, int* new_used, int* new_peak, int* blocks, int* ok,
    int* scratch, int Q, int C, int N, int R, int gated, int path, int k,
    int slice, void* stream) {
  if (R <= 0 || !plan_ok(path, k, slice, Q, C, N) ||
      (path == PATH_GLOBAL && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{op, lane, size_class, arg, stack, top, owner, refcount,
                  alloc_cnt, free_cnt, fail_cnt, used, peak, new_stack,
                  new_top, new_owner, new_refcount, new_alloc, new_free,
                  new_fail, new_used, new_peak, blocks, ok, scratch,
                  Q, C, N, R, gated, slice};
  const size_t bytes = smem_bytes(path, Q, slice);
  cudaError_t err = ensure_smem_for(path, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == PATH_BLOCK) {
    support_core_burst_kernel<PATH_BLOCK><<<dim3(1, C, 1), THREADS, bytes, s>>>(
        args);
  } else {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = cluster_config(k, C, bytes, s, attr);
    if (path == PATH_CLUSTER)
      err = cudaLaunchKernelEx(&cfg, support_core_burst_kernel<PATH_CLUSTER>,
                               args);
    else
      err = cudaLaunchKernelEx(&cfg, support_core_burst_kernel<PATH_GLOBAL>,
                               args);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
