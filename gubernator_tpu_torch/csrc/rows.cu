// Row access kernels over the key table, written by hand for Hopper (sm_90a).
// Their plain PyTorch versions are in ops/rows.py of this package; each pair
// must agree bit for bit.
//
// inject_rows: replaces the XLA program gubernator_tpu/models/engine.py
//   `_inject_rows` (:74, jitted at :132) together with the column casts of
//   `_apply_inject_rows` (:1123). Scatters m host rows i64[m, 8] (slot, algo,
//   limit, remaining, duration, stamp, expire_at, status) into the i64[C, 8]
//   table IN PLACE: algo and status are truncated through int32, field 7 is
//   zeroed, and a slot outside [0, C) is dropped. The rows of one call target
//   distinct slots (the key directory clears a mirror's dirty flag as it
//   emits the row), so no atomics are needed.
//   Bound: memory, m * 128 bytes; at the engine's m <= a few dozen rows the
//   launch dominates, and the engine's rows lie in page-locked host memory
//   (inject_rows_pinned_launch), where each read crosses the host link. So
//   every input word is read exactly once, in one coalesced load: one thread
//   per row field, eight neighbouring threads on one 64-byte row; the slot
//   and the next field come from the row's lane 0 and the next lane by
//   shuffle, not by second reads (on an H100 the pinned launch takes
//   2.3-2.6 us at m <= 64 this way, against 3.5-4.1 us with the second read
//   and 3.5-4.3 us with one thread per row and four 16-byte loads).
//
// gather_rows: replaces `_gather_rows` (:86, jitted at :137). Reads the 7
//   row fields at each slot, clamped to [0, C-1] (jnp.maximum(slot, 0) and
//   XLA's clamping gather), into i64[7, m]. One thread per slot: it reads its
//   56 bytes and writes one element of each output row, so the stores of a
//   warp are contiguous, in blocks of kGatherThreads = 64 (on an H100 as
//   fast as 256 at m = 1 and 64, and a quarter faster at m = 8192: more
//   blocks, more SMs). Bound: memory, m * (4 + 56 + 56) bytes. The slots
//   and the result may also lie in page-locked host memory
//   (gather_rows_pinned_launch): the card reads the slots and writes the
//   rows through their mapped addresses, so the engine's lone path
//   (Engine.seed_mirror) needs no copy up and no copy back around the
//   launch, only one wait on the stream.
//
// row_bump: replaces the Pallas kernel scripts/bench_pallas_rows.py `kernel`
//   (:36, pallas_call at :89), the row-access probe: +1 to every element of
//   B distinct rows of an int32[N, 128] table, in place, returning slots[0]
//   (written by exactly one thread). A slot outside [0, N) is dropped. Adds
//   wrap, as uint32_t. Bound: memory, B * 512 * 2 bytes (8.39 MB at
//   B = 8192, 2.50 us at 3.35 TB/s), plus the slots. The Pallas kernel keeps
//   DEPTH = 16 row DMAs in flight because one TPU core issues them in order;
//   here one warp owns one 512-byte row, each lane loading and storing one
//   16-byte int4, and all B rows are in flight at once in one wave of warps.
//   What holds it near 5.3 us instead, on an H100 at B = 8192 on the 5.12 GB
//   table: the launch of its warps 1.4-1.5 us, the slot reads +0.3, the
//   random 512-byte row reads +2.1, the stores +1.3 (device time of the
//   kernel with parts dropped). Rows drawn from 512 MB instead of 5.12 GB
//   save 2-3%, so address translation is not it; on 4 MB of rows that stay
//   in L2 it takes 2.3 us, so the DRAM side of random rows is. More rows in
//   flight per warp (2-32, their slots read in one load and shuffled out),
//   a grid sized to the SMs that loops, or the Pallas design itself (whole
//   rows into shared memory by 1-D bulk copies on an mbarrier, DEPTH 4-32,
//   and bulk stores) all took 5.26-5.70 us with L2 flushed before each
//   measurement, against 5.27-5.43 us for this one: none beat it by more
//   than the spread, so it stays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowFields = 8;
constexpr int kGatherFields = 7;
constexpr int kBumpRowInt4 = 32;  // 128 int32 = 32 int4 = one per lane
constexpr int kGatherThreads = 64;
constexpr int kInjectThreads = 256;  // whole warps: a row's lanes share one

__global__ void inject_kernel(int64_t* __restrict__ state, int64_t C,
                              const int64_t* __restrict__ inject, int m) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = t < static_cast<int64_t>(m) * kRowFields;
  const int64_t v = live ? inject[t] : 0;
  // blocks are whole warps, so a row's eight fields share a warp
  const int lane = threadIdx.x & 31;
  const int64_t slot = __shfl_sync(0xffffffffu, v, lane & ~(kRowFields - 1));
  const int64_t next = __shfl_down_sync(0xffffffffu, v, 1);
  if (!live || slot < 0 || slot >= C) return;
  const int f = lane & (kRowFields - 1);
  int64_t w;
  if (f == 7) {
    w = 0;
  } else if (f == 0 || f == 6) {
    w = static_cast<int64_t>(static_cast<int32_t>(static_cast<uint32_t>(next)));
  } else {
    w = next;
  }
  state[slot * kRowFields + f] = w;
}

__global__ void gather_kernel(const int64_t* __restrict__ state, int64_t C,
                              const int32_t* __restrict__ slot, int m,
                              int64_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  int64_t s = slot[j];
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  const int64_t* row = state + s * kRowFields;
#pragma unroll
  for (int f = 0; f < kGatherFields; ++f) {
    out[static_cast<int64_t>(f) * m + j] = row[f];
  }
}

__global__ void row_bump_kernel(int4* __restrict__ table, int64_t N,
                                const int32_t* __restrict__ slots, int B,
                                int32_t* __restrict__ out) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0 && lane == 0) out[0] = slots[0];
  if (warp >= B) return;
  const int64_t s = slots[warp];
  if (s < 0 || s >= N) return;
  int4* p = table + s * kBumpRowInt4 + lane;
  int4 v = *p;
  v.x = static_cast<int32_t>(static_cast<uint32_t>(v.x) + 1u);
  v.y = static_cast<int32_t>(static_cast<uint32_t>(v.y) + 1u);
  v.z = static_cast<int32_t>(static_cast<uint32_t>(v.z) + 1u);
  v.w = static_cast<int32_t>(static_cast<uint32_t>(v.w) + 1u);
  *p = v;
}

// cudaSetDevice costs a runtime call; the card is almost always current already.
int set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

// Launch the inject on `stream`, then record `done` there when it is given.
int launch_inject(void* state, long long C, const void* inject, int m, void* stream,
                  void* done) {
  const long long total = static_cast<long long>(m) * kRowFields;
  inject_kernel<<<static_cast<int>((total + kInjectThreads - 1) / kInjectThreads),
                  kInjectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), C, static_cast<const int64_t*>(inject), m);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && done != nullptr) {
    err = cudaEventRecord(static_cast<cudaEvent_t>(done), static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(err);
}

void launch_gather(const void* state, long long C, const void* slot, int m, void* out,
                   void* stream) {
  gather_kernel<<<(m + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(state), C, static_cast<const int32_t*>(slot), m,
      static_cast<int64_t*>(out));
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (0 when it was accepted). Shapes are checked by the wrappers.

extern "C" int inject_rows_launch(int device, void* state, long long C,
                                  const void* inject, int m, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  return launch_inject(state, C, inject, m, stream, nullptr);
}

// The same inject with `inject` (i64[m, 8]) in page-locked host memory,
// passed to the kernel as the device address cudaHostGetDevicePointer gives
// for it; `done`, when not null, is a cudaEvent_t recorded on `stream` after
// the launch (the engine waits on it before it rewrites those rows).
// Returns cudaHostGetDevicePointer's error when the address does not
// resolve (memory that is not page-locked), else as inject_rows_launch.
extern "C" int inject_rows_pinned_launch(int device, void* state, long long C,
                                         void* inject, int m, void* stream, void* done) {
  int err = set_device(device);
  if (err != 0) return err;
  void* inject_dev = nullptr;
  const cudaError_t e = cudaHostGetDevicePointer(&inject_dev, inject, 0);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not a launch error: leave no stale error behind
    return static_cast<int>(e);
  }
  return launch_inject(state, C, inject_dev, m, stream, done);
}

extern "C" int gather_rows_launch(int device, const void* state, long long C,
                                  const void* slot, int m, void* out, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  launch_gather(state, C, slot, m, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// The same gather with `slot` (i32[m]) and `out` (i64[7, m]) in page-locked
// host memory: each is passed to the kernel as the device address
// cudaHostGetDevicePointer gives for it. Returns that call's error when an
// address does not resolve (memory that is not page-locked), else
// cudaGetLastError() after the launch. The caller waits on `stream` before
// it reads `out`.
extern "C" int gather_rows_pinned_launch(int device, const void* state, long long C,
                                         void* slot, int m, void* out, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  void* slot_dev = nullptr;
  void* out_dev = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&slot_dev, slot, 0);
  if (e == cudaSuccess) e = cudaHostGetDevicePointer(&out_dev, out, 0);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not a launch error: leave no stale error behind
    return static_cast<int>(e);
  }
  launch_gather(state, C, slot_dev, m, out_dev, stream);
  return static_cast<int>(cudaGetLastError());
}

// Wait for the work queued on `stream` (one stream, never the whole card).
extern "C" int rows_stream_synchronize(void* stream) {
  return static_cast<int>(cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}

extern "C" int row_bump_launch(int device, void* table, long long N,
                               const void* slots, int B, void* out, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  const int threads = 256;  // 8 rows per block
  const long long total = static_cast<long long>(B) * 32;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  row_bump_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(table), N, static_cast<const int32_t*>(slots), B,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
