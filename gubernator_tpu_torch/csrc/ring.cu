// Ring all-reduce-sum of S int64 shards held on ONE card, written by hand
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gubernator_tpu/ops/ring.py `_ring_kernel`
// (:39), reached through make_ring_all_reduce (:81, pallas_call at :104) by
// the GLOBAL sync step's collectives="ring" option
// (gubernator_tpu/parallel/global_sync.py:110, :146). Its plain PyTorch
// version is ring_all_reduce_plain() in ops/ring.py of this package.
//
// x is int64[S, L]: row s is shard s's local value; every output row is the
// sum of all rows. As in the Pallas kernel, the sum is built in S-1
// rotate-and-accumulate hops: on each hop every shard takes the value its
// left-hand neighbour forwarded on the previous hop (a 2-slot double buffer)
// and adds it to its accumulator. The TPU moves each hop between chips over
// ICI; here all S shards sit in one card's memory, so one thread owns one
// column and carries the S-slot double buffer and the S accumulators in
// registers (S is a template parameter, so every index is static). No
// barrier crosses threads or blocks. Adds wrap, as uint64_t.
//
// What bounds it on an H100: memory. It reads S*L*8 bytes and writes as
// many; the (S-1)*L adds are negligible. At the GLOBAL sync's sizes
// (L = G or 4G, G = 1024) it moves tens of kilobytes, so the launch
// dominates, on the host (the wrapper and this entry point) more than on
// the device. The entry point therefore makes the card current only when it
// is not already. Blocks are kThreads = 64 threads: small blocks spread the
// few thousand columns over more SMs, and on an H100 they ran about a tenth
// faster than blocks of 256 at L = 1024 and 4096 (PERF.md, Findings). The
// cross-card form (peer-mapped buffers over NVLink) is not here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <int S>
__global__ void ring_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint64_t comm[2][S];
  uint64_t acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    acc[s] = comm[0][s] = static_cast<uint64_t>(x[static_cast<int64_t>(s) * L + l]);
  }
#pragma unroll
  for (int step = 0; step < S - 1; ++step) {
    const int send = step % 2, recv = (step + 1) % 2;
    // shard s receives what shard s-1 forwarded (the Pallas kernel sends
    // to my_id + 1)
#pragma unroll
    for (int s = 0; s < S; ++s) comm[recv][s] = comm[send][(s + S - 1) % S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] += comm[recv][s];
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[static_cast<int64_t>(s) * L + l] = static_cast<int64_t>(acc[s]);
}

template <int S>
void launch(const int64_t* x, int64_t* out, int L, cudaStream_t stream) {
  ring_kernel<S><<<(L + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, out, L);
}

// cudaSetDevice costs a runtime call; the card is almost always current already.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// The largest S this file instantiates; ops/ring.py reads it once, at load.
extern "C" int ring_max_shards() { return 16; }

// out[s, :] = sum over s' of x[s', :] for int64 x[S, L], on `stream`.
// Returns cudaErrorInvalidValue for a shape it does not take, else
// cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int ring_all_reduce_launch(int device, const void* x, void* out, int S, int L,
                                      void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xi = static_cast<const int64_t*>(x);
  auto* o = static_cast<int64_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define RING_CASE(n)        \
  case n:                   \
    launch<n>(xi, o, L, st); \
    break;
    RING_CASE(1) RING_CASE(2) RING_CASE(3) RING_CASE(4)
    RING_CASE(5) RING_CASE(6) RING_CASE(7) RING_CASE(8)
    RING_CASE(9) RING_CASE(10) RING_CASE(11) RING_CASE(12)
    RING_CASE(13) RING_CASE(14) RING_CASE(15) RING_CASE(16)
#undef RING_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
