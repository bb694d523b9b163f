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
//   launch dominates. The engine's rows lie in page-locked host memory
//   (inject_rows_pinned_launch), and there the inject has three forms, chosen
//   by m alone (the wrapper picks it against rows_by_value_max and
//   rows_inject_copy_min, ops/rows.py):
//   - by value, m <= 448: the launcher copies the m rows on the host into
//     the launch's parameter block (a __grid_constant__ struct of a size
//     class: 16, 64 or 448 rows, 1, 4 or 28 KB; the block holds up to
//     32,764 bytes on CUDA 12.1+), which reaches the card with the launch,
//     so the kernel reads nothing over the host link and only stores. The
//     host rows are consumed when the launch call returns. The kernel reads
//     the block through the constant cache, which serves one address a
//     cycle to a warp, so each row gets a warp of its own: lanes 0-3 each
//     read one whole 16-byte word of it (the slot and the next field by
//     shuffle) and store one 16-byte word of the table row, so a warp's
//     loads touch 4 addresses. On an H100 with L2 flushed before every
//     launch it took 1.15-1.17 / 1.19 / 1.60-1.65 us at m = 16 / 64 / 448,
//     against 1.68 / 2.25 / 2.76-2.78 with 8 rows a warp (32 addresses a
//     load) and 1.83 / 3.49 / 6.99 with a thread a row; 1.10-1.15 us for
//     all three at m = 1 (PERF.md §6). An empty kernel with the same
//     parameter block takes 0.83-0.87 us at every class: the block's way
//     to the card costs nothing that shows.
//   - mapped, 448 < m < kInjectCopyMin (inject_kernel): the kernel reads the
//     rows through their mapped address, so each read crosses the host
//     link as a small read from the SMs. Every input word is read exactly
//     once, in one coalesced load: one thread per row field, eight
//     neighbouring threads on one 64-byte row; the slot and the next field
//     come from the row's lane 0 and the next lane by shuffle, not by
//     second reads (on an H100 the mapped launch took 2.3-2.6 us at m <= 64
//     this way, against 3.5-4.1 us with the second read and 3.5-4.3 us with
//     one thread per row and four 16-byte loads).
//   - copy, m >= kInjectCopyMin: one cudaMemcpyAsync of the m rows into the
//     caller's device scratch (a DMA over the link in large transfers),
//     the caller's event recorded right after it (the host rows are free
//     once they are on the card), then the same inject_kernel over the
//     scratch, on the same stream. The scratch is reused in stream order
//     only: a later copy into it queues behind every kernel that reads it.
//   Mapped reads beat the copy's fixed cost at a few hundred rows and lose
//   to the DMA's rate at thousands. On an H100 at 700 W, all device time
//   with L2 flushed before every launch (ab_rows.py --parts cold_rows, two
//   children, PERF.md §6), mapped / copy: m = 449 3.38-3.50 / 4.46-4.53 us,
//   1024 4.91-4.95 / 5.57-5.67, 2048 7.27-7.48 / 7.27-7.28, 3072
//   9.66-9.97 / 8.66-8.73, 4096 11.85-12.19 / 9.94-10.23, 8192
//   20.89-21.73 / 15.09-15.20 (the copy up alone 13.45-13.62 of it);
//   kInjectCopyMin is the least m at which the copy measured below the
//   mapped read in both children: 3072 (at 2048 one child read them level).
//   The same inject_kernel serves rows on the card (inject_rows_launch).
//
// gather_rows: replaces `_gather_rows` (:86, jitted at :137). Reads the 7
//   row fields at each slot, clamped to [0, C-1] (jnp.maximum(slot, 0) and
//   XLA's clamping gather), into i64[7, m]. Bound: memory, m * (4 + 56 + 56)
//   bytes. On the card's own memory the kernel is the sharded gather's
//   (below) with one owner. The slots and the result may also lie in
//   page-locked host memory (gather_rows_pinned_launch): the card writes the
//   rows through the result's mapped address, so the engine's lone path
//   (Engine.seed_mirror) and its Store path need no copy up and no copy
//   back around the launch, only one wait on the stream. Two forms, chosen
//   by m alone (the wrapper picks it against rows_by_value_max):
//   - by value, m <= 64 (gather_kernel_value): the launcher reads the m
//     slots on the host into the launch's parameter block (a
//     __grid_constant__ struct of 1 or 64 slots), so the kernel's only
//     dependent read is the row in HBM, and no slot read waits on the link.
//     The kept mapping is a thread a slot, as the mapped kernel's (a warp's
//     stores of one field are contiguous): 2.29-2.33 / 2.60-2.61 /
//     2.88-2.95 us cold at m = 1 / 16 / 64 against 2.36-2.41 / 2.69-2.74 /
//     2.91-2.96 with a thread an output element, whose warps read the
//     slots 7 times over (PERF.md §6; the mapped form 3.68-3.75 /
//     3.64-3.87 / 4.04-4.09).
//   - mapped, m > 64 (gather_kernel_pinned): the kernel reads the slots
//     through their mapped address too, one thread a slot in blocks of 64:
//     it reads its 56 bytes and writes one element of each output row, so a
//     warp's stores over the host link are contiguous. With four threads a
//     slot its device time was the same, but the median round trip
//     (launch, wait, rows read) was 3.5 and 4.3 us longer at m = 1 and 64,
//     six runs a tree (ab_rows.py, PERF.md).
//   Where the card's unified addressing makes a page-locked host address its
//   device address (checked once a card), a caller that vouches for its
//   buffers (checked = 1: the engine's own page-locked buffers) skips the
//   per-call cudaHostGetDevicePointer lookups.
//
// gather_sharded / inject_sharded: replace the JAX package's shard_map
//   programs make_gather_sharded (parallel/sharded.py:216) and
//   make_inject_sharded (:243), the sharded engine's Store path. The R x S
//   owner shards are slices of one i64[R, S, C, 8] table, and one launch
//   serves every owner (blockIdx.y): owner o's slots index its own C rows.
//   The gather clamps each slot to [0, C-1] of its own shard. The inject
//   writes all seven fields of each lane AS GIVEN (unlike inject_rows, which
//   truncates algo and status through int32, as the single-table engine's
//   caller does) and zeroes field 7; a lane with slot < 0 or >= C is dropped
//   (pad_to_drop), never wrapped into the shard's last row. Bound: memory,
//   W * (4 + 56 + 56) bytes an owner for the gather and W * (4 + 56 + 64)
//   for the inject, the rows at random slots of a table far larger than L2.
//   Both run four threads a lane, kRowThreads = 128 to a block: thread q of
//   lane w moves the 16 bytes of fields 2q and 2q + 1 of its row, so a warp
//   reads or writes 8 whole 64-byte rows in one instruction, and on the
//   field-major side its 32 threads touch 4 runs of 8 lanes (64 bytes each,
//   two full sectors). Every thread loads its slot itself (the row's four
//   threads share one broadcast load); the inject issues its slot and field
//   loads together, so a lane costs one DRAM round trip before its store,
//   and the gather two (the row's address comes from the slot). Against
//   one thread a lane (seven 8-byte loads, or four 16-byte stores from one
//   thread, so that each instruction touched 32 rows), on an H100 at 700 W
//   with L2 flushed before every launch (ab_rows.py, 8 owners of 1,250,000
//   rows, m = 1 / 64 / 4096 an owner): the inject 1.33-1.36 / 1.53-1.58 /
//   3.76-3.85 us against 1.68-1.69 / 2.02-2.08 / 5.22-5.29; the gather
//   1.76-1.83 / 2.04-2.12 / 5.16-5.23 us against 1.79-1.96 / 2.17-2.21 /
//   5.12-5.18, no gain at m = 4096, where two dependent DRAM round trips
//   and the random row reads are the time. A shared-memory transpose of
//   the field-major side (a tile of lanes loaded coalesced, then written as
//   rows), and 64 or 128 lanes a block, or 2-8 lanes a thread, were no
//   faster. The single-table device form takes the same gather kernel. An
//   empty kernel on the same grid (rows_floor_launch) is the floor under
//   both, 0.82-0.83 us at m <= 64 and 1.42-1.43 us at m = 4096 (1024
//   blocks). Rows of 64 bytes at scattered slots are too small for the
//   tensor memory accelerator (TMA) to help, and there is no arithmetic for
//   tensor cores.
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

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kRowFields = 8;
constexpr int kGatherFields = 7;
constexpr int kBumpRowInt4 = 32;  // 128 int32 = 32 int4 = one per lane
constexpr int kRowThreads = 128;  // the gather and inject_sharded: 4 a lane, 32 lanes a block
constexpr int kRowLanes = kRowThreads / 4;
constexpr int kPinnedThreads = 64;  // gather_kernel_pinned: a lane each
constexpr int kInjectThreads = 256;  // whole warps: a row's lanes share one
constexpr int kValueThreads = 256;  // the by-value kernels' blocks: whole warps

// The by-value size classes: the largest of each bounds the pinned form that
// takes its operands in the launch's parameter block (rows_by_value_max
// gives it to the wrapper, which picks the form by m).
constexpr int kGatherValueSmall = 1, kGatherValueMax = 64;  // slots
constexpr int kInjectValueSmall = 16, kInjectValueMid = 64, kInjectValueMax = 448;  // rows
// The least m the pinned inject copies up instead of reading mapped
// (rows_inject_copy_min gives it to the wrapper): measured, see above.
constexpr int kInjectCopyMin = 3072;  // rows

// The pinned inject's forms, as inject_rows_pinned_launch takes them.
constexpr int kFormMapped = 0, kFormByValue = 1, kFormCopy = 2;

template <int N>
struct SlotBlock {
  int32_t slot[N];
};

template <int N>
struct alignas(16) RowBlock {
  int64_t row[N * kRowFields];
};

__device__ __forceinline__ int64_t trunc32(int64_t v) {
  return static_cast<int64_t>(static_cast<int32_t>(static_cast<uint32_t>(v)));
}

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

// The inject of m <= N rows passed by value: a warp a row r, whose lane q
// < 4 loads the row's q-th 16-byte word (fields 2q, 2q + 1) and stores the
// table row's q-th word, fields 2q + 1 and 2q + 2 of the inject row (the
// second from the next lane, by shuffle; the slot from lane 0), so a warp's
// loads touch 4 addresses of the parameter block.
template <int N>
__global__ void inject_kernel_value(int64_t* __restrict__ state, int64_t C,
                                    const __grid_constant__ RowBlock<N> rows, int m) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = t >> 5;
  const int q = t & 31;
  const bool live = r < m && q < 4;
  const longlong2 w = live ? reinterpret_cast<const longlong2*>(rows.row)[4 * r + q]
                           : make_longlong2(0, 0);
  const int64_t slot = __shfl_sync(0xffffffffu, w.x, 0, 4);
  const int64_t next = __shfl_down_sync(0xffffffffu, w.x, 1, 4);
  if (!live || slot < 0 || slot >= C) return;
  const int64_t a = (q == 0 || q == 3) ? trunc32(w.y) : w.y;
  reinterpret_cast<longlong2*>(state + slot * kRowFields)[q] =
      make_longlong2(a, q < 3 ? next : 0);
}

// The gather of m <= N slots passed by value into out, i64[7, m] (written
// through its mapped address): one thread a slot writes one element of
// each output row, so a warp's stores of one field are contiguous.
template <int N>
__global__ void gather_kernel_value(const int64_t* __restrict__ state, int64_t C,
                                    const __grid_constant__ SlotBlock<N> slots, int m,
                                    int64_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m) return;
  int64_t s = slots.slot[t];
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  const int64_t* row = state + s * kRowFields;
#pragma unroll
  for (int f = 0; f < kGatherFields; ++f) out[f * m + t] = row[f];
}

// Owner shard blockIdx.y (0 for one table) gathers from its own C rows at
// y * C, its own W slots and into its own i64[7, W] block. Thread q of lane
// w loads fields 2q and 2q + 1 of the row (16 bytes) and stores them into
// output rows 2q and 2q + 1 (field 7 is not stored).
__global__ void gather_kernel(const int64_t* __restrict__ state, int64_t C,
                              const int32_t* __restrict__ slot, int W,
                              int64_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t w = t >> 2;
  const int q = static_cast<int>(t & 3);
  if (w >= W) return;
  const int64_t o = blockIdx.y;
  int64_t s = slot[o * W + w];
  s = s < 0 ? 0 : (s >= C ? C - 1 : s);
  const longlong2 v = reinterpret_cast<const longlong2*>(state + (o * C + s) * kRowFields)[q];
  int64_t* dst = out + (o * kGatherFields + 2 * q) * W + w;
  dst[0] = v.x;
  if (q < 3) dst[W] = v.y;
}

// The gather of slots in page-locked host memory into rows there, one
// thread a slot: it reads its 56 bytes and writes one element of each
// output row.
__global__ void gather_kernel_pinned(const int64_t* __restrict__ state, int64_t C,
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

// Rows i64[7, W] of owner blockIdx.y in field order, written whole with
// field 7 zeroed: thread q of lane w reads fields 2q and 2q + 1 and stores
// them as the row's q-th 16 bytes.
__global__ void inject_sharded_kernel(int64_t* __restrict__ state, int64_t C,
                                      const int32_t* __restrict__ slot,
                                      const int64_t* __restrict__ rows, int W) {
  const int q = threadIdx.x & 3;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kRowLanes + (threadIdx.x >> 2);
  const int64_t o = blockIdx.y;
  int64_t s = -1, a = 0, b = 0;
  if (w < W) {
    s = slot[o * W + w];
    const int64_t* r = rows + (o * kGatherFields + 2 * q) * W + w;
    a = r[0];
    b = q < 3 ? r[W] : 0;
  }
  if (s < 0 || s >= C) return;
  reinterpret_cast<longlong2*>(state + (o * C + s) * kRowFields)[q] = make_longlong2(a, b);
}

// Nothing: launched on the row kernels' grid, it times the launch alone.
__global__ void empty_kernel() {}

// Nothing, with a by-value kernel's parameter block: the launch and the
// block's way to the card alone.
template <typename Block>
__global__ void empty_value_kernel(const __grid_constant__ Block block) {}

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

// The grid of the gather and the sharded inject: 4 threads a lane, owners on y.
dim3 row_grid(int W, int owners) { return dim3((W + kRowLanes - 1) / kRowLanes, owners); }

void launch_gather(const void* state, long long C, const void* slot, int m, void* out,
                   void* stream, int owners = 1) {
  gather_kernel<<<row_grid(m, owners), kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(state), C, static_cast<const int32_t*>(slot), m,
      static_cast<int64_t*>(out));
}

// Whether a page-locked host address is the card's device address for it:
// unified addressing, and registered memory usable at its host address (so
// both cudaHostAlloc's and cudaHostRegister's page-locked memory), read
// once a card. 0 = not read yet, 1 = yes, 2 = no.
constexpr int kMaxDevices = 64;
std::atomic<int> g_host_is_device[kMaxDevices];

bool host_is_device(int device) {
  if (device < 0 || device >= kMaxDevices) return false;
  int v = g_host_is_device[device].load(std::memory_order_relaxed);
  if (v == 0) {
    int unified = 0, registered = 0;
    if (cudaDeviceGetAttribute(&unified, cudaDevAttrUnifiedAddressing, device) != cudaSuccess ||
        cudaDeviceGetAttribute(&registered, cudaDevAttrCanUseHostPointerForRegisteredMem,
                               device) != cudaSuccess) {
      cudaGetLastError();
      unified = 0;
    }
    v = unified && registered ? 1 : 2;
    g_host_is_device[device].store(v, std::memory_order_relaxed);
  }
  return v == 1;
}

// The device address of page-locked host memory at `host`: the address
// itself where the caller vouches for the memory (`checked`) and the card's
// unified addressing allows, else cudaHostGetDevicePointer's, whose error
// (memory that is not page-locked) is returned and cleared.
cudaError_t device_address(int device, int checked, void* host, void** dev) {
  if (checked && host_is_device(device)) {
    *dev = host;
    return cudaSuccess;
  }
  const cudaError_t e = cudaHostGetDevicePointer(dev, host, 0);
  if (e != cudaSuccess) cudaGetLastError();  // not a launch error: leave none behind
  return e;
}

int value_blocks(long long threads) {
  return static_cast<int>((threads + kValueThreads - 1) / kValueThreads);
}

// The by-value inject: the m host rows copied into a RowBlock<N> here, on
// the host; the launch takes them with it. A warp a row.
template <int N>
void launch_inject_value(int64_t* state, long long C, const int64_t* rows, int m,
                         cudaStream_t stream) {
  RowBlock<N> block;
  std::memcpy(block.row, rows, static_cast<size_t>(m) * kRowFields * sizeof(int64_t));
  inject_kernel_value<N><<<value_blocks(32LL * m), kValueThreads, 0, stream>>>(state, C, block,
                                                                               m);
}

// The empty kernel with the parameter block of size class N, on `blocks`.
template <typename Block>
void launch_empty_value(int blocks, cudaStream_t stream) {
  Block block;
  std::memset(&block, 0, sizeof(block));
  empty_value_kernel<Block><<<blocks, kValueThreads, 0, stream>>>(block);
}

template <int N>
void launch_gather_value(const int64_t* state, long long C, const int32_t* slots, int m,
                         int64_t* out, cudaStream_t stream) {
  SlotBlock<N> block;
  std::memcpy(block.slot, slots, static_cast<size_t>(m) * sizeof(int32_t));
  gather_kernel_value<N><<<value_blocks(m), kValueThreads, 0, stream>>>(state, C, block, m, out);
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

// The same inject with `inject` (i64[m, 8]) in page-locked host memory, in
// the `form` the caller picks by m: kFormByValue (m <= 448) copies the rows
// into the launch's parameters, so they are consumed when this call
// returns; kFormMapped has the kernel read them through their device
// address; kFormCopy copies them into `scratch` (at least m rows of i64[R, 8]
// on the card) with one cudaMemcpyAsync and runs the kernel there. `done`,
// when not null, is a cudaEvent_t recorded on `stream` after the mapped
// launch or after the copy (the engine waits on it before it rewrites those
// rows). `checked`: the caller vouches that `inject` is page-locked (see
// device_address); with 0 the address is looked up, in every form, and a
// lookup's error (memory that is not page-locked) is returned before any
// launch. Else as inject_rows_launch; cudaErrorInvalidValue for an unknown
// form, a by-value m above 448 or a copy without a scratch.
extern "C" int inject_rows_pinned_launch(int device, void* state, long long C, void* inject,
                                         int m, void* stream, void* done, int form, int checked,
                                         void* scratch) {
  int err = set_device(device);
  if (err != 0) return err;
  if (form < kFormMapped || form > kFormCopy || (form == kFormByValue && m > kInjectValueMax) ||
      (form == kFormCopy && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* inject_dev = nullptr;
  if (form == kFormMapped || !checked) {
    const cudaError_t e = device_address(device, checked, inject, &inject_dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (form == kFormMapped) return launch_inject(state, C, inject_dev, m, stream, done);
  if (form == kFormCopy) {
    cudaError_t e = cudaMemcpyAsync(scratch, inject, static_cast<size_t>(m) * kRowFields *
                                    sizeof(int64_t), cudaMemcpyHostToDevice, s);
    if (e == cudaSuccess && done != nullptr) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return launch_inject(state, C, scratch, m, stream, nullptr);
  }
  auto* table = static_cast<int64_t*>(state);
  const auto* rows = static_cast<const int64_t*>(inject);
  if (m <= kInjectValueSmall) {
    launch_inject_value<kInjectValueSmall>(table, C, rows, m, s);
  } else if (m <= kInjectValueMid) {
    launch_inject_value<kInjectValueMid>(table, C, rows, m, s);
  } else {
    launch_inject_value<kInjectValueMax>(table, C, rows, m, s);
  }
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess && done != nullptr) e = cudaEventRecord(static_cast<cudaEvent_t>(done), s);
  return static_cast<int>(e);
}

extern "C" int gather_rows_launch(int device, const void* state, long long C,
                                  const void* slot, int m, void* out, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  launch_gather(state, C, slot, m, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// The same gather with `slot` (i32[m]) and `out` (i64[7, m]) in page-locked
// host memory, in the form the caller picks by m: `by_value` (m <= 64)
// reads the slots here, on the host, into the launch's parameters;
// otherwise the kernel reads them through their device address. The rows
// are written through out's device address in both. `checked`: the caller
// vouches that both are page-locked (see device_address); with 0 both
// addresses are looked up, and a lookup's error (memory that is not
// page-locked) is returned before any launch. Else cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a by-value m above 64. The
// caller waits on `stream` before it reads `out`.
extern "C" int gather_rows_pinned_launch(int device, const void* state, long long C,
                                         void* slot, int m, void* out, void* stream,
                                         int by_value, int checked) {
  int err = set_device(device);
  if (err != 0) return err;
  if (by_value && m > kGatherValueMax) return static_cast<int>(cudaErrorInvalidValue);
  void* slot_dev = nullptr;
  void* out_dev = nullptr;
  cudaError_t e = cudaSuccess;
  if (!(by_value && checked)) e = device_address(device, checked, slot, &slot_dev);
  if (e == cudaSuccess) e = device_address(device, checked, out, &out_dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* table = static_cast<const int64_t*>(state);
  auto* rows = static_cast<int64_t*>(out_dev);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!by_value) {
    gather_kernel_pinned<<<(m + kPinnedThreads - 1) / kPinnedThreads, kPinnedThreads, 0, s>>>(
        table, C, static_cast<const int32_t*>(slot_dev), m, rows);
  } else if (m <= kGatherValueSmall) {
    launch_gather_value<kGatherValueSmall>(table, C, static_cast<const int32_t*>(slot), m,
                                           rows, s);
  } else {
    launch_gather_value<kGatherValueMax>(table, C, static_cast<const int32_t*>(slot), m, rows,
                                         s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The largest m a pinned launch takes by value: slots of the gather
// (`inject` 0) or rows of the inject (`inject` 1). The wrapper picks the
// form by m against it.
extern "C" int rows_by_value_max(int inject) {
  return inject ? kInjectValueMax : kGatherValueMax;
}

// The least m a pinned inject copies up (kFormCopy); the wrapper picks the
// form by m against it and rows_by_value_max.
extern "C" int rows_inject_copy_min() { return kInjectCopyMin; }

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

// The sharded gather: `state` is i64[owners, C, 8], `slot` i32[owners, W],
// `out` i64[owners, 7, W], all on the card; one launch for every owner.
extern "C" int gather_sharded_launch(int device, const void* state, long long C, int owners,
                                     const void* slot, int W, void* out, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  launch_gather(state, C, slot, W, out, stream, owners);
  return static_cast<int>(cudaGetLastError());
}

// The sharded inject: `slot` i32[owners, W] and `rows` i64[owners, 7, W] on
// the card into the i64[owners, C, 8] `state`; one launch for every owner.
extern "C" int inject_sharded_launch(int device, void* state, long long C, int owners,
                                     const void* slot, const void* rows, int W, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  inject_sharded_kernel<<<row_grid(W, owners), kRowThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), C, static_cast<const int32_t*>(slot),
      static_cast<const int64_t*>(rows), W);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid the gather and the sharded inject take at W
// lanes for `owners` owners: the floor under their device times.
extern "C" int rows_floor_launch(int device, int W, int owners, void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  empty_kernel<<<row_grid(W, owners), kRowThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid, and with the parameter block, that a pinned
// launch of m slots (`inject` 0: the gather) or rows (`inject` 1: the
// inject) takes in the form `by_value` picks: the floor under its device
// time. The mapped forms pass no block.
extern "C" int rows_pinned_floor_launch(int device, int inject, int m, int by_value,
                                        void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (!by_value) {
    if (inject) {
      const long long total = static_cast<long long>(m) * kRowFields;
      empty_kernel<<<static_cast<int>((total + kInjectThreads - 1) / kInjectThreads),
                     kInjectThreads, 0, s>>>();
    } else {
      empty_kernel<<<(m + kPinnedThreads - 1) / kPinnedThreads, kPinnedThreads, 0, s>>>();
    }
  } else if (inject) {
    if (m > kInjectValueMax) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = value_blocks(32LL * m);
    if (m <= kInjectValueSmall) {
      launch_empty_value<RowBlock<kInjectValueSmall>>(blocks, s);
    } else if (m <= kInjectValueMid) {
      launch_empty_value<RowBlock<kInjectValueMid>>(blocks, s);
    } else {
      launch_empty_value<RowBlock<kInjectValueMax>>(blocks, s);
    }
  } else {
    if (m > kGatherValueMax) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = value_blocks(m);
    if (m <= kGatherValueSmall) {
      launch_empty_value<SlotBlock<kGatherValueSmall>>(blocks, s);
    } else {
      launch_empty_value<SlotBlock<kGatherValueMax>>(blocks, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
