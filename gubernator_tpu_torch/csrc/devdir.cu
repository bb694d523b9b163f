// The device-resident key directory's probe and vacancy sweep, written by
// hand for Hopper (sm_90a).
//
// Replace the XLA programs that gubernator_tpu/ops/devdir.py compiles:
// probe_assign_evict (:131) with its in-batch priority pass _claim_winners
// (:65), as fused into models/devdir_engine.py _devdir_decide (:47, jitted
// at :59); probe_assign (:83), the same probe without eviction; and
// refresh_vacancies (:196), jitted at devdir_engine.py:65. Their plain
// PyTorch versions are in ops/devdir.py of this package; the kernels must
// agree with them bit for bit on every output and on both columns.
//
// The probe, for lane i of B with h = hashes[i] and now = seq: the lane is
// active when h != 0; its candidates are pos_d = (|h| mod C + d) mod C for
// d = 0..15, read as they stood before the batch. It takes the first d whose
// fingerprint is h (a match) and the first whose fingerprint is 0 (an empty).
// Every matched position is stamped `now` before any lane picks a victim: the
// first d of least stamp, eligible when older than `now`. A lane that did
// not match claims its first empty, else its victim; among the lanes that
// claim one position, only the highest lane index wins. Winners write their
// fingerprint and stamp; losers and lanes with nothing to claim are retry
// lanes.
//
// Each ordering above is a barrier across every lane of the batch. The probe
// is ONE cooperative launch (cudaLaunchCooperativeKernel) of probe_kernel,
// whose three phases are parted by two barriers across the launch:
//
// - match: half a warp a lane, one candidate a thread (the 16 candidates are
//   128 contiguous bytes unless they wrap). __ballot_sync over the half warp
//   and __ffs give the first match and the first empty; the thread of the
//   match stamps it. The lane's match and empty positions go to a per-lane
//   scratch (i64[3, B], the caller's). With eviction, a lane with neither
//   prefetches its candidates' stamps into L2 for the claim.
// - barrier: every match stamp lands before any lane picks a victim.
// - claim: half a warp a lane again. A lane with no match and no empty reads
//   its candidates' stamps, and a shuffle minimum over (stamp, d) gives the
//   victim, ties to the lower d. The claim goes into the card's claim
//   scratch, one u64 word a directory position, by atomicMax of
//   (tag << 20 | lane): the highest lane of a position wins,
//   deterministically. The caller owns the scratch and its tag together
//   (ops/devdir.py): it zeroes the words once, when it allocates them, and
//   passes a tag larger than any earlier launch's on them, so a word left
//   by an earlier launch is smaller than any of this one's and no launch
//   has to clear the scratch. That costs 8 bytes a directory position (80
//   MB at C = 10M); an argsort, as the JAX program does, would need no
//   scratch but a sort.
// - barrier: every claim lands in the scratch before any lane reads
//   whether it won.
// - resolve: one thread a lane. A claiming lane won when the word of its
//   position holds its own tag; winners write fingerprint and stamp. Every
//   lane writes retry, and slot and fresh where the caller asks for them;
//   when the caller passes the device directory's wide i64[9, B] staging,
//   its slot goes into row 0 and its fresh flag into row 8, where decide
//   reads them: the slot never goes to the host.
//
// Every phase is a loop over the same grid (probe_grid): when B * 16
// threads fit one block (B <= 64), one block, whose barriers are
// __syncthreads(); else blocks of the smallest size (256, 512, 1024) whose
// count is at most the SMs, and cooperative_groups::this_grid().sync()
// between the phases; never more blocks than can be co-resident (the
// kernel's occupancy times the SM count, read once a card). Every thread
// of a block runs the same iterations, so the ballots and shuffles always
// take whole warps. A cooperative launch the card refuses is an error the
// caller raises: there is no fallback to separate launches. Values a phase
// reads that another block wrote in an earlier phase are loaded through L2
// (__ldcg).
//
// On an H100 at 700 W, L2 flushed before every launch, C = 10,000,001
// (ab_rows.py --parts probe, PERF.md §6), with eviction at W = 64 / 1024 /
// 8192 (1 block of 1024 / 64 of 256 / 128 of 1024): 4.86 / 6.55-6.59 /
// 10.40-10.58 us of device time, against 5.75-5.77 / 6.63-6.64 /
// 9.59-10.17 for the former three launches (match, claim, resolve; their
// device times summed) whose span on the device, the gaps between the
// launches counted, was 8.08-8.55 / 9.71-9.89 / 11.97-12.06 us against
// 4.39-4.43 / 6.23-6.30 / 9.27-9.28 here. A grid barrier costs about 1.2
// us (an empty kernel with the two barriers 3.2-3.5 us against 0.9-1.0
// without; the block's own two add 0.1 us), about what a launch boundary
// cost.
// Tried and left: one thread-block cluster (cluster.sync()) of up to 16
// blocks of 1024 for W <= 1024 (5.83-5.92 / 7.37-7.38 us: a one-block
// cluster's barrier costs 0.7 us, and 16 blocks read from fewer SMs than
// 64), 256 threads a block at every W (6.15-6.22 / 6.68-6.73 /
// 10.89-10.95 us: 512 blocks at a barrier), and the stamps prefetched for
// every lane (12.22-12.36 us at W = 8192).
//
// Probes on one card must run in stream order (the engine holds its lock
// and launches on the current stream): two probes in flight at once on one
// card could mix claims in the shared scratch.
//
// The sweep is one elementwise pass: fps[i] = 0 where the bucket row is
// vacant (algorithm < 0) or expired (now > expire). Only the fingerprints it
// clears are written.
//
// What bounds them on an H100: the probe at B <= 8192 moves ~2 MB (16
// candidates of 8 bytes a lane from each column), microseconds of latency
// more than bandwidth; the sweep reads both 32-byte sectors of every table
// row (640 MB at C = 10M) and writes 8 bytes a cleared fingerprint, bandwidth.

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDepth = 16;      // PROBE_DEPTH: one half warp a lane
constexpr int kThreads = 256;   // the sweep's blocks
// the probe's block sizes, half a warp a lane: the smallest whose blocks
// fit one an SM is taken (probe_grid)
constexpr int kProbeBlockSizes[] = {256, 512, 1024};
constexpr int kProbeMaxThreads = 1024;
constexpr int kTagShift = 20;   // lanes < 2^20 (ops/devdir.py checks)
constexpr int kRowFields = 8;
constexpr int kRowAlgo = 0;
constexpr int kRowExpire = 5;

// |h| mod C with a floor modulo, as JAX's `jnp.abs(h) % C`: |INT64_MIN|
// wraps to INT64_MIN, whose remainder is then taken into [0, C).
__device__ __forceinline__ int64_t probe_base(int64_t h, int64_t C) {
  const int64_t a = h < 0 ? static_cast<int64_t>(0ull - static_cast<uint64_t>(h)) : h;
  int64_t r = a % C;
  return r < 0 ? r + C : r;
}

__device__ __forceinline__ int64_t probe_pos(int64_t base, int d, int64_t C) {
  const int64_t p = base + d;  // base < C: no overflow
  return p < C ? p : p % C;
}

// A load through L2 alone (not L1): for a word another block wrote before
// the last grid-wide barrier.
__device__ __forceinline__ int64_t load_l2(const int64_t* p) {
  return static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(p)));
}

// The 16 bits of a full-warp ballot that belong to this thread's half warp.
__device__ __forceinline__ unsigned half_ballot(bool pred) {
  const unsigned all = __ballot_sync(0xffffffffu, pred);
  return (threadIdx.x & 16) ? all >> 16 : all & 0xffffu;
}

// The barrier across every block of the launch: the block's own when the
// grid is one block, else the cooperative grid's. Both order every write
// before it before every read after it, across the threads they join.
__device__ __forceinline__ void launch_barrier() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cg::this_grid().sync();
  }
}

// The probe, one launch: match, barrier, claim, barrier, resolve. No
// pointer the kernel writes is declared __restrict__ const: a later phase
// reads what an earlier one wrote.
template <bool EVICT>
__global__ void __launch_bounds__(kProbeMaxThreads)
probe_kernel(int64_t* fps, int64_t* touch, int64_t C, const int64_t* __restrict__ hashes, int B,
             int64_t now, unsigned long long tag, unsigned long long* scratch, int64_t* lanes,
             int32_t* __restrict__ slot_out, uint8_t* __restrict__ fresh_out,
             uint8_t* __restrict__ retry_out, int64_t* __restrict__ packed) {
  const int threads = static_cast<int>(blockDim.x);
  const int stride = static_cast<int>(gridDim.x) * threads;
  const int total = B * kDepth;  // B < 2^20: fits an int
  // match: the loop bound depends on the block alone, so every ballot
  // takes the whole warp
  for (int t0 = static_cast<int>(blockIdx.x) * threads; t0 < total; t0 += stride) {
    const int t = t0 + static_cast<int>(threadIdx.x);
    const int i = t >> 4, d = t & (kDepth - 1);
    const bool in = t < total;
    const int64_t h = in ? hashes[i] : 0;
    int64_t p = 0, cand = -1;
    if (in) {
      p = probe_pos(probe_base(h, C), d, C);
      cand = fps[p];
    }
    const unsigned mm = half_ballot(in && h != 0 && cand == h);
    const unsigned em = half_ballot(in && cand == 0);
    if constexpr (EVICT) {
      // a lane with neither match nor empty reads its candidates' stamps
      // after the barrier: start their DRAM reads now, so that those reads
      // find them in L2
      if (in && h != 0 && mm == 0 && em == 0) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(touch + p));
      }
    }
    if (in) {
      const int fm = mm ? __ffs(mm) - 1 : -1;
      const int fe = em ? __ffs(em) - 1 : -1;
      if (fm == d) {
        if constexpr (EVICT) touch[p] = now;  // before any victim is chosen
        lanes[i] = p;
      } else if (fm < 0 && d == 0) {
        lanes[i] = -1;
      }
      if (fe == d) {
        lanes[B + i] = p;
      } else if (fe < 0 && d == 0) {
        lanes[B + i] = -1;
      }
    }
  }
  launch_barrier();
  // claim
  for (int t0 = static_cast<int>(blockIdx.x) * threads; t0 < total; t0 += stride) {
    const int t = t0 + static_cast<int>(threadIdx.x);
    const int i = t >> 4, d = t & (kDepth - 1);
    const bool in = t < total;
    const int64_t h = in ? hashes[i] : 0;
    const int64_t mp = in ? load_l2(lanes + i) : -1;
    const int64_t ep = in ? load_l2(lanes + B + i) : -1;
    const bool want = in && h != 0 && mp < 0;
    int64_t cslot = want ? ep : -1;
    if constexpr (EVICT) {
      // the victim: the least stamp over the candidates, ties to the lower d
      const bool need = want && ep < 0;
      const int64_t base = need ? probe_base(h, C) : 0;
      int64_t v = need ? load_l2(touch + probe_pos(base, d, C)) : INT64_MAX;
      int vd = d;
#pragma unroll
      for (int off = kDepth / 2; off > 0; off >>= 1) {
        const int64_t ov = __shfl_xor_sync(0xffffffffu, v, off, kDepth);
        const int od = __shfl_xor_sync(0xffffffffu, vd, off, kDepth);
        if (ov < v || (ov == v && od < vd)) {
          v = ov;
          vd = od;
        }
      }
      if (need && v < now) cslot = probe_pos(base, vd, C);
    }
    if (in && d == 0) {
      lanes[2 * B + i] = cslot;
      if (cslot >= 0) atomicMax(scratch + cslot, tag | static_cast<unsigned long long>(i));
    }
  }
  launch_barrier();
  // resolve: a thread a lane
  for (int i = static_cast<int>(blockIdx.x) * threads + static_cast<int>(threadIdx.x); i < B;
       i += stride) {
    const int64_t h = hashes[i];
    const int64_t mp = load_l2(lanes + i);
    const int64_t cs = load_l2(lanes + 2 * B + i);
    const bool won = cs >= 0 && __ldcg(scratch + cs) == (tag | static_cast<unsigned long long>(i));
    const int64_t slot = mp >= 0 ? mp : (won ? cs : -1);
    if (won) {
      fps[cs] = h;
      if constexpr (EVICT) touch[cs] = now;
    }
    if (slot_out != nullptr) slot_out[i] = static_cast<int32_t>(slot);
    if (fresh_out != nullptr) fresh_out[i] = won;
    retry_out[i] = h != 0 && slot < 0;
    if (packed != nullptr) {
      packed[i] = static_cast<int32_t>(slot);  // the i32 slot, widened, as decide reads it
      packed[8 * static_cast<int64_t>(B) + i] = won;
    }
  }
}

// Nothing, launched as the probe is (the same cooperative grid): the floor
// under its device time; with `barriers`, the probe's two barriers alone.
__global__ void __launch_bounds__(kProbeMaxThreads) probe_empty_kernel(int barriers) {
  if (barriers) {
    launch_barrier();
    launch_barrier();
  }
}

__global__ void refresh_kernel(int64_t* __restrict__ fps, const int64_t* __restrict__ table,
                               int64_t C, int64_t now) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < C;
       i += stride) {
    const int64_t* row = table + i * kRowFields;
    if (row[kRowAlgo] < 0 || now > row[kRowExpire]) fps[i] = 0;
  }
}

// cudaSetDevice costs a runtime call; the card is almost always current already.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

// The kernels a probe launch may take: the probe without eviction (`which`
// 0), with it (1), or the empty kernel (2).
const void* kernel_of(int which) {
  return which == 0   ? reinterpret_cast<const void*>(probe_kernel<false>)
         : which == 1 ? reinterpret_cast<const void*>(probe_kernel<true>)
                      : reinterpret_cast<const void*>(probe_empty_kernel);
}

// Per card, kernel and block size, read once (0 = not read yet): the
// blocks that can be co-resident (occupancy times SMs), or a negative CUDA
// error (cudaErrorNotSupported: the card takes no cooperative launch;
// cudaErrorCooperativeLaunchTooLarge: no block fits an SM). And per card
// its SM count.
constexpr int kMaxDevices = 64;
constexpr int kSizes = sizeof(kProbeBlockSizes) / sizeof(kProbeBlockSizes[0]);
std::atomic<int> g_coresident[3][kSizes][kMaxDevices];
std::atomic<int> g_sms[kMaxDevices];

// The card's SM count, read once (0 when it cannot be read).
int sm_count(int device) {
  int v = g_sms[device].load(std::memory_order_relaxed);
  if (v == 0 && cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) == cudaSuccess) {
    g_sms[device].store(v, std::memory_order_relaxed);
  } else if (v == 0) {
    cudaGetLastError();
  }
  return v;
}

int coresident_blocks(int device, int which, int size) {
  int v = g_coresident[which][size][device].load(std::memory_order_relaxed);
  if (v != 0) return v;
  int coop = 0, per_sm = 0;
  const int sms = sm_count(device);
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(which),
                                                      kProbeBlockSizes[size], 0);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);  // not cached: read again at the next launch
  }
  v = !coop ? -static_cast<int>(cudaErrorNotSupported)
      : per_sm > 0 ? sms * per_sm : -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  g_coresident[which][size][device].store(v, std::memory_order_relaxed);
  return v;
}

// How the probe of B lanes launches on `device`, B * 16 threads in all: one
// block when they fit one (the smallest size that holds them; its barriers
// are the block's), else blocks of the smallest size whose blocks are no
// more than the SMs (one an SM: the most SMs reading at once, the fewest
// blocks at each barrier), else of the largest size; never more blocks
// than can be co-resident. Returns the blocks and sets `threads`, or a
// negative CUDA error when the card cannot run the grid cooperatively.
int probe_grid(int device, int B, int evict, int* threads) {
  if (device < 0 || device >= kMaxDevices) return -static_cast<int>(cudaErrorInvalidDevice);
  const int which = evict ? 1 : 0;
  const int64_t total = (B < 1 ? 1 : static_cast<int64_t>(B)) * kDepth;
  int size = kSizes - 1;
  for (int k = 0; k < kSizes; ++k) {
    if (total <= kProbeBlockSizes[k]) {  // one block
      size = k;
      break;
    }
  }
  if (total > kProbeMaxThreads) {
    const int sms = sm_count(device);
    for (int k = 0; k < kSizes; ++k) {
      if (sms > 0 && (total + kProbeBlockSizes[k] - 1) / kProbeBlockSizes[k] <= sms) {
        size = k;
        break;
      }
    }
  }
  const int most = coresident_blocks(device, which, size);
  if (most < 0) return most;
  *threads = kProbeBlockSizes[size];
  const int64_t need = (total + *threads - 1) / *threads;
  return static_cast<int>(need < most ? need : most);
}

// One cooperative launch of `fn` on `grid` blocks of `threads`. A refused
// launch's error is returned and cleared.
int launch_probe(const void* fn, int grid, int threads, void** args, void* stream) {
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // reported here; leave none behind
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The probe's grid at B lanes on `device`, with eviction or without: the
// blocks it launches, and in `threads` their size. A negative CUDA error
// when the card cannot run it cooperatively.
extern "C" int devdir_probe_grid(int device, int B, int evict, int* threads) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int t = 0;
  const int grid = probe_grid(device, B, evict, &t);
  if (threads != nullptr) *threads = t;
  return grid;
}

// The probe over B lanes on `stream`, one cooperative launch:
// probe_assign_evict when `evict` is nonzero (`touch` an i64[C] stamp
// column, `seq` the epoch), else probe_assign (`touch` unused). `scratch` is
// the card's claim scratch, at least C zeroed-once u64 words, and `tag` (in
// [1, 2^44)) is larger than the tag of any earlier launch on it; `lanes` an
// i64[3, B] per-lane scratch; retry u8[B] an output, and slot i32[B] and
// fresh u8[B] outputs that may be null when `packed` is not: a wide i64[9, B]
// staging whose rows 0 and 8 take slot and fresh. Returns
// cudaErrorInvalidValue for a shape or tag it does not take; before any
// launch, cudaErrorNotSupported when the card takes no cooperative launch
// and cudaErrorCooperativeLaunchTooLarge when no block of the grid could be
// co-resident; else the launch's own error (a refused cooperative launch),
// or cudaGetLastError() after it (0 when it was accepted).
extern "C" int devdir_probe_launch(int device, void* fps, void* touch, long long C,
                                   const void* hashes, int B, long long seq, int evict,
                                   void* scratch, long long tag, void* lanes, void* slot,
                                   void* fresh, void* retry, void* packed, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C <= 0 || B < 0 || B >= (1 << kTagShift) || tag <= 0 ||
      tag >= (1LL << (64 - kTagShift)) || retry == nullptr ||
      (packed == nullptr && (slot == nullptr || fresh == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  int threads = 0;
  const int grid = probe_grid(device, B, evict, &threads);
  if (grid <= 0) return -grid;
  auto* f = static_cast<int64_t*>(fps);
  auto* tc = static_cast<int64_t*>(touch);
  auto* h = static_cast<const int64_t*>(hashes);
  int64_t cap = C;
  int64_t now = seq;
  unsigned long long t = static_cast<unsigned long long>(tag) << kTagShift;
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* ln = static_cast<int64_t*>(lanes);
  auto* so = static_cast<int32_t*>(slot);
  auto* fo = static_cast<uint8_t*>(fresh);
  auto* ro = static_cast<uint8_t*>(retry);
  auto* pk = static_cast<int64_t*>(packed);
  void* args[] = {&f, &tc, &cap, &h, &B, &now, &t, &sc, &ln, &so, &fo, &ro, &pk};
  return launch_probe(kernel_of(evict ? 1 : 0), grid, threads, args, stream);
}

// An empty kernel launched as the probe of B lanes would be (the same
// cooperative grid; devdir_probe_grid): the floor under the probe's device
// time; with `barriers` nonzero it runs the probe's two barriers and
// nothing else. Errors as devdir_probe_launch's.
extern "C" int devdir_probe_floor_launch(int device, int B, int evict, int barriers,
                                         void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = 0;
  const int grid = probe_grid(device, B, evict, &threads);
  if (grid <= 0) return -grid;
  void* args[] = {&barriers};
  return launch_probe(kernel_of(2), grid, threads, args, stream);
}

// The text of a CUDA error code, for the wrapper's message.
extern "C" const char* devdir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The vacancy sweep over an i64[C] fingerprint column and its i64[C, 8]
// table on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int devdir_refresh_launch(int device, void* fps, const void* table, long long C,
                                     long long now, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (C <= 0) return 0;
  const long long blocks = (C + kThreads - 1) / kThreads;
  refresh_kernel<<<static_cast<int>(blocks < 16384 ? blocks : 16384), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(fps), static_cast<const int64_t*>(table), C, now);
  return static_cast<int>(cudaGetLastError());
}
