// Allocator-simulator trace scan for Hopper (sm_90a): one launch runs one
// whole trace.
//
// Replaces the JAX package's src/repro/sim/engine.py::_run_trace, a
// jax.lax.scan over the events (no Pallas kernel: XLA compiles the scan into
// one device program per trace), and computes the same function bit for bit
// against the port's plain version kernels/sim_trace/ref.py::run_trace_plain.
//
// What bounds it.  Each event reads the (thread, class) entries of the local
// and accelerator tiers and the class's shared count, updates them and the
// live / cached / peak bytes, and adds to seven float32 counters; the next
// event may read what this one wrote, so the scan is one chain of dependent
// steps.  The bytes (16 per event, read once) take nanoseconds; the chain's
// latency is the cost, so more threads buy nothing for one trace.
//
// Design.  One block of THREADS threads.  All of them zero the state and
// stage the events CHUNK at a time into shared memory with coalesced loads;
// thread 0 alone runs the scan over each staged chunk, the others wait at
// the barrier.  Thread 0 reads the next event's four fields before it works
// on the current one, so those loads leave the chain.  The [T, C] local and
// accelerator counts live in shared memory when they fit beside the staging
// buffer (kSmem, chosen by ops.py::state_path from the shapes), else in a
// device scratch buffer the wrapper allocates; the kernel is instantiated
// for each, so the shared-memory scan compiles to shared loads and stores.
// `cached` is a running sum of each event's deltas, which equals the JAX
// scan's full [T, C] reduction modulo 2^32; all byte arithmetic is unsigned
// so it wraps as JAX's int32 does.  Counters are float32 adds of 1.0f (no
// fast math), so past 2^24 events a count stops growing where JAX's stops.
//
// Each read is the JAX scan's: accel_push compares the event's original
// accel, `over` reads the updated local; an op other than 1 or 2 still
// subtracts its size from the live bytes.  Output: out[0..6] the counters'
// float32 bits, out[7] peak bytes, out[8] cached bytes (int32).  An event
// outside [0, T) x [0, C) is skipped so a bad call never writes outside the
// state; the wrapper's caller (sim/engine.py) raises on such a trace on the
// host before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;     // events staged per round (ops.py: CHUNK)

struct Policy {
  int refill_batch, local_cap, flush_keep, accel_cap, stash_cap;
  int central, stash_on;
};

template <bool kSmem>
__global__ void __launch_bounds__(THREADS)
sim_trace_kernel(const int* __restrict__ ev, long long E, int T, int C,
                 const int* __restrict__ sizes, Policy p,
                 int* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* stage = smem;                      // [4][CHUNK]
  int* size_s = smem + 4 * CHUNK;         // [C]
  int* shared_s = size_s + C;             // [C]
  const long long TC = (long long)T * C;
  int* local = kSmem ? shared_s + C : scratch;     // [T*C]
  int* accel = local + TC;                          // [T*C]

  for (long long i = threadIdx.x; i < 2 * TC; i += THREADS) local[i] = 0;
  for (int i = threadIdx.x; i < C; i += THREADS) {
    size_s[i] = sizes[i];
    shared_s[i] = 64;
  }

  const bool has_accel = p.accel_cap > 0;
  const int accel_refill = p.accel_cap < 4 ? p.accel_cap : 4;
  float n_m = 0.f, n_f = 0.f, n_fast = 0.f, n_accel = 0.f, n_trip = 0.f,
        n_foreign = 0.f, n_mmap = 0.f;
  uint32_t live = 0, cached = 0;
  int32_t peak = 0;

  for (long long base = 0; base < E; base += CHUNK) {
    const int n = (int)(E - base < CHUNK ? E - base : CHUNK);
    __syncthreads();            // the state is zeroed, the last chunk read
    for (int i = threadIdx.x; i < n; i += THREADS) {
#pragma unroll
      for (int k = 0; k < 4; ++k) stage[k * CHUNK + i] = ev[k * E + base + i];
    }
    __syncthreads();
    if (threadIdx.x != 0) continue;
    int t_next = stage[0], op_next = stage[CHUNK];
    int c_next = stage[2 * CHUNK], fgn_next = stage[3 * CHUNK];
    for (int j = 0; j < n; ++j) {
      const int t = t_next, op = op_next, c = c_next, fgn = fgn_next;
      const int jn = j + 1 < n ? j + 1 : j;
      t_next = stage[jn];
      op_next = stage[CHUNK + jn];
      c_next = stage[2 * CHUNK + jn];
      fgn_next = stage[3 * CHUNK + jn];
      if ((unsigned)t >= (unsigned)T || (unsigned)c >= (unsigned)C) continue;
      const long long i = (long long)t * C + c;
      const int lo = local[i], ac = accel[i], sh = shared_s[c], sz = size_s[c];
      const bool is_m = op == 1, is_f = op == 2;
      bool local_hit, miss, need_mmap = false, accel_hit = false, over,
           foreign_f;
      int nlo, nac = ac, nsh = sh;
      if (p.stash_on) {
        // stash front-end over the central server
        local_hit = is_m && lo > 0;
        miss = is_m && !local_hit;
        nlo = local_hit ? lo - 1 : (miss ? lo + p.refill_batch - 1 : lo);
        foreign_f = is_f && fgn == 1;
        const bool own_f = is_f && !foreign_f;
        const bool push_ok = own_f && nlo < p.stash_cap;
        over = own_f && !push_ok;
        if (push_ok) nlo += 1;
      } else {
        const bool dist = !p.central;
        accel_hit = is_m && has_accel && ac > 0 && dist;
        local_hit = is_m && !accel_hit && lo > 0 && dist;
        miss = is_m && !accel_hit && !local_hit && dist;
        need_mmap = miss && sh < p.refill_batch;
        if (need_mmap) nsh += 4 * p.refill_batch;
        if (miss) nsh -= p.refill_batch;
        nlo = local_hit ? lo - 1 : (miss ? lo + p.refill_batch - 1 : lo);
        nac = accel_hit ? ac - 1 : ((miss && has_accel) ? accel_refill : ac);
        foreign_f = is_f && fgn == 1 && dist;
        const bool local_f = is_f && !foreign_f && dist;
        const bool accel_push = local_f && has_accel && ac < p.accel_cap;
        if (accel_push) nac += 1;
        else if (local_f) nlo += 1;
        over = local_f && nlo > p.local_cap;
        if (over) {
          const int flushed = nlo - p.flush_keep;
          nsh += flushed > 0 ? flushed : 0;
        }
        if (foreign_f) nsh += 1;
        if (over) nlo = p.flush_keep;
      }
      local[i] = nlo;
      accel[i] = nac;
      shared_s[c] = nsh;
      live += is_m ? (uint32_t)sz : (uint32_t)(-sz);
      cached += (uint32_t)(nlo - lo + nac - ac) * (uint32_t)sz;
      const int32_t total = (int32_t)(live + cached);
      peak = total > peak ? total : peak;
      if (is_m) n_m += 1.f;
      if (is_f) n_f += 1.f;
      if (local_hit) n_fast += 1.f;
      if (accel_hit) n_accel += 1.f;
      if (miss || over) n_trip += 1.f;
      if (foreign_f) n_foreign += 1.f;
      if (need_mmap) n_mmap += 1.f;
    }
  }
  if (threadIdx.x == 0) {
    out[0] = __float_as_int(n_m);
    out[1] = __float_as_int(n_f);
    out[2] = __float_as_int(n_fast);
    out[3] = __float_as_int(n_accel);
    out[4] = __float_as_int(n_trip);
    out[5] = __float_as_int(n_foreign);
    out[6] = __float_as_int(n_mmap);
    out[7] = peak;
    out[8] = (int32_t)cached;
  }
}

}  // namespace

extern "C" int sim_trace_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

extern "C" int sim_trace_launch(const int* ev, long long E, int T, int C,
                                const int* sizes, int refill_batch,
                                int local_cap, int flush_keep, int accel_cap,
                                int stash_cap, int central, int stash_on,
                                int in_smem, int* scratch, int* out,
                                void* stream) {
  const Policy p{refill_batch, local_cap, flush_keep, accel_cap, stash_cap,
                 central, stash_on};
  const size_t words = 4 * (size_t)CHUNK + 2 * (size_t)C +
                       (in_smem ? 2 * (size_t)T * C : 0);
  const size_t smem = words * sizeof(int);
  auto kernel = in_smem ? sim_trace_kernel<true> : sim_trace_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(ev, E, T, C, sizes, p,
                                                     scratch, out);
  return (int)cudaGetLastError();
}
