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
// faster than blocks of 256 at L = 1024 and 4096 (PERF.md, Findings).
//
// The cross-card form (ring_mesh_launch, below) is the same Pallas kernel as
// it runs on each device of a mesh axis: one int64[L] value an entry, each on
// its entry's card, every entry ending with the sum of all.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
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

// ------------------------------------------------------- the cross-card ring
//
// Replaces the same Pallas kernel, `_ring_kernel` (gubernator_tpu/ops/ring.py
// :39, pallas_call :104), as it runs once on EACH device of the ring axis
// (the sharded GLOBAL sync's collectives="ring", parallel/global_sync.py
// :94-100 and :139-148 of the JAX package). Entry d of an n-entry mesh holds
// x[d] (int64[L]) on its own card and its own stream; every entry ends with
// the (wrapping) sum of all x. The plain PyTorch version is
// ring_all_reduce_mesh_plain() in ops/ring.py.
//
// The Pallas kernel builds the sum in n - 1 rotate-and-accumulate hops, the
// schedule that suits ICI, where a chip talks to its neighbours. Two facts of
// an H100 host change that: entries that share a card are summed by one
// thread a column in one pass, and cards joined by NVLink are all to all, so
// a card reads every other card's value in one round of loads. Adds mod 2^64
// do not depend on order, so the one-pass sum is bit-equal to the ring's.
//
// Design: ONE launch of ring_mesh_kernel a card. The wrapper groups the
// entries by card (cards in order of first appearance, c of them); card k's
// launch goes on the stream of its first entry. Before the launch that
// stream waits on an event recorded on each of the card's other entry
// streams (their inputs are ready); after it, each of those streams waits on
// one event recorded behind the launch (their sums are ready). A thread owns
// two columns (16-byte loads; one column when L is odd or a pointer is not
// 16-byte aligned), loads them from every entry in entry order (local
// pointers for the card's own entries, peer pointers for the other cards':
// one address space), adds them as uint64_t and stores the sum into the out
// of each of the card's own entries. Every store stays on the writer's card;
// only loads cross NVLink, one round of them. The n inputs and the card's
// outputs go in a __grid_constant__ parameter block.
//
// Across cards (c >= 2), flags in peer memory take the place of events, as in
// NCCL's single-launch collectives. Each card of a card set has one flag
// buffer in its own memory, u64[2][kMeshMaxBlocks] (ready, done), zeroed once
// when the wrapper makes it; each call takes a fresh epoch (the card set's
// counter, incremented under g_mesh_mu with the launches). Block j of card k
//   1. publishes ready[k][j] = epoch (st.release.sys);
//   2. spins (ld.acquire.sys) until ready[k'][j] >= epoch on every other
//      card k': their inputs are ready;
//   3. reads its columns and writes its sums, with coherent loads
//      (ld.global.cg), never the non-coherent path, which could serve a line
//      of a buffer the caller has rewritten since an earlier epoch;
//   4. publishes done[k][j] = epoch and waits for done[k'][j] >= epoch before
//      it exits: no card's stream may reuse or free its inputs while a peer
//      still reads them (the caching allocator reuses freed memory on the
//      same stream, and the GLOBAL step frees its deltas right after).
// Epochs only grow, so the flags are never reset. A spin that waits longer
// than kSpinTimeoutNs traps: a peer that never arrives is a fault, and a
// trapped kernel ends with an error where a spin would hold the card.
//
// Progress needs no co-residency: block j waits only on block j of OTHER
// cards, never on a block of its own grid, and every card runs the same grid
// (at most kMeshMaxBlocks blocks, each striding over the columns past them).
// Across cards it needs one thing: each card's stream reaches its launch.
// That holds as long as no entry stream waits on work that another entry
// queues after its ring launch. No caller does: the mesh engine and its
// GLOBAL step queue each entry's work on the entry's own stream. The wrapper
// refuses an all-reduce on other streams than the card set's own, so a card
// set's launches on a card, and the epochs they carry, keep stream order.
//
// What bounds it on an H100: on one card, memory, 16nL bytes in HBM (each
// input read once, each sum written once); on distinct cards, (c - 1) 8L
// bytes over NVLink a card and one NVLink round trip of latency for the
// flags. At the sync's L = 1024 and 4096 all of these are well under a
// microsecond, so the launch and its host work bound a call. The design
// issues c launches where the hop form issued n (n - 1) (56 at n = 8), with
// n - c event records and 2 (n - c) waits beside them. A CUDA graph of the
// hops was not the route: it still runs n (n - 1) kernel nodes, and its fixed
// pointers do not fit a wrapper that allocates each call's outputs.

namespace {

constexpr int kMeshThreads = 64;      // blocks as small as the single-card kernel's
constexpr int kMeshMaxBlocks = 256;   // the grid's cap, and a flag buffer's words a kind
constexpr int kMeshMaxEntries = 64;   // the parameter block's entries
constexpr unsigned long long kSpinTimeoutNs = 10ull * 1000 * 1000 * 1000;

struct MeshArgs {
  const int64_t* x[kMeshMaxEntries];           // every entry's input, entry order
  int64_t* out[kMeshMaxEntries];               // this card's entries' sums
  unsigned long long* flags[kMeshMaxEntries];  // every card's flag buffer, card order
  unsigned long long epoch;
  int n, n_out, c, me, L;
};

__device__ __forceinline__ void publish(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long observe(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Block j's handshake on flag word `word` (ready: j; done: kMeshMaxBlocks +
// j): publish this card's word at the call's epoch, then wait until every
// other card's word has reached it. One thread spins; the barrier passes its
// acquire on to the block.
__device__ void handshake(const MeshArgs& a, int word) {
  if (threadIdx.x == 0) {
    publish(a.flags[a.me] + word, a.epoch);
    for (int k = 0; k < a.c; ++k) {
      if (k == a.me) continue;
      const unsigned long long* f = a.flags[k] + word;
      if (observe(f) >= a.epoch) continue;
      const unsigned long long t0 = now_ns();
      while (observe(f) < a.epoch) {
        if (now_ns() - t0 > kSpinTimeoutNs) __trap();
      }
    }
  }
  __syncthreads();
}

template <bool kPairs>
__global__ void __launch_bounds__(kMeshThreads)
    ring_mesh_kernel(const __grid_constant__ MeshArgs a) {
  const int j = blockIdx.x;
  if (a.c > 1) handshake(a, j);
  const int stride = gridDim.x * kMeshThreads;
  if (kPairs) {
    const int units = a.L / 2;
    for (int u = j * kMeshThreads + threadIdx.x; u < units; u += stride) {
      uint64_t s0 = 0, s1 = 0;
#pragma unroll 8
      for (int e = 0; e < a.n; ++e) {
        const longlong2 v = __ldcg(reinterpret_cast<const longlong2*>(a.x[e]) + u);
        s0 += static_cast<uint64_t>(v.x);
        s1 += static_cast<uint64_t>(v.y);
      }
      const longlong2 r = make_longlong2(static_cast<long long>(s0), static_cast<long long>(s1));
      for (int o = 0; o < a.n_out; ++o) reinterpret_cast<longlong2*>(a.out[o])[u] = r;
    }
  } else {
    for (int l = j * kMeshThreads + threadIdx.x; l < a.L; l += stride) {
      uint64_t s = 0;
#pragma unroll 8
      for (int e = 0; e < a.n; ++e) {
        s += static_cast<uint64_t>(__ldcg(reinterpret_cast<const long long*>(a.x[e]) + l));
      }
      for (int o = 0; o < a.n_out; ++o) a.out[o][l] = static_cast<int64_t>(s);
    }
  }
  if (a.c > 1) {
    __syncthreads();  // every load of this block is done before `done`
    handshake(a, kMeshMaxBlocks + j);
  }
}

// One mutex serialises whole all-reduces: an epoch and the launches that
// carry it are queued together, and no two calls interleave their event
// records.
std::mutex g_mesh_mu;
// One event a stream, created on the stream's card at first use (an event is
// recorded on its own card's streams only) and reused by every later call.
std::map<cudaStream_t, cudaEvent_t> g_events;

// The caller's current card, made current again when the entry point
// returns: the loop below visits every card, and the caller (and PyTorch,
// which reads the current card) must not find itself on the last.
struct KeepDevice {
  int device = -1;
  KeepDevice() { cudaGetDevice(&device); }
  ~KeepDevice() {
    if (device >= 0) cudaSetDevice(device);
  }
};

cudaError_t stream_event(cudaStream_t st, cudaEvent_t* ev) {
  auto it = g_events.find(st);
  if (it == g_events.end()) {
    cudaEvent_t e;
    const cudaError_t err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    if (err != cudaSuccess) return err;
    it = g_events.emplace(st, e).first;
  }
  *ev = it->second;
  return cudaSuccess;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Whether card `device` can read card `peer`'s memory (*can 1 or 0).
extern "C" int ring_can_access_peer(int device, int peer, int* can) {
  return static_cast<int>(cudaDeviceCanAccessPeer(can, device, peer));
}

// Let kernels on card `device` read card `peer`'s memory. Access enabled
// before is success.
extern "C" int ring_enable_peer(int device, int peer) {
  KeepDevice keep;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // not sticky: clear it
    return 0;
  }
  return static_cast<int>(err);
}

// The most entries an all-reduce takes, and the u64 words of a card's flag
// buffer; ops/ring.py reads both once, at load.
extern "C" int ring_mesh_max_entries() { return kMeshMaxEntries; }
extern "C" int ring_mesh_flag_words() { return 2 * kMeshMaxBlocks; }

// All-reduce-sum of x[e] (int64[L] on its card) over 2 <= n <= 64 entries
// into out[e] (int64[L] on the same card), entry e's work on streams[e]. The
// entries lie on c cards, devices[k] for k = card_of[e], numbered in order of
// first appearance; flags[k] is card k's zeroed flag buffer of
// ring_mesh_flag_words() words (unused, and may be null, when c == 1); *epoch
// is the card set's counter, incremented here. One launch of
// ring_mesh_kernel a card, on the stream of its first entry, ordered by
// events and flags as the note above says. x[e] must be ready on streams[e];
// out[e] is ready there when the call's work on it is done. Returns
// cudaErrorInvalidValue for arguments it does not take, else the first CUDA
// error of a record, a wait or a launch (0 when every one was accepted).
extern "C" int ring_mesh_launch(int n, const void* const* x, void* const* out,
                                void* const* streams, int c, const int* devices,
                                const int* card_of, void* const* flags, int L,
                                unsigned long long* epoch) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 2 || n > kMeshMaxEntries || c < 1 || c > n || L < 0 || epoch == nullptr) return bad;
  if (c > 1 && flags == nullptr) return bad;
  int first[kMeshMaxEntries];
  for (int k = 0; k < c; ++k) first[k] = -1;
  bool pairs = L % 2 == 0;
  for (int e = 0; e < n; ++e) {
    const int k = card_of[e];
    if (k < 0 || k >= c || (first[k] < 0 && (k > 0 && first[k - 1] < 0))) return bad;
    if (first[k] < 0) first[k] = e;
    pairs = pairs && aligned16(x[e]) && aligned16(out[e]);
  }
  if (first[c - 1] < 0) return bad;
  if (L == 0) return 0;
  const int units = pairs ? L / 2 : L;
  const int blocks = std::min((units + kMeshThreads - 1) / kMeshThreads, kMeshMaxBlocks);
  MeshArgs a{};
  for (int e = 0; e < n; ++e) a.x[e] = static_cast<const int64_t*>(x[e]);
  for (int k = 0; k < c; ++k) {
    a.flags[k] = c > 1 ? static_cast<unsigned long long*>(flags[k]) : nullptr;
  }
  a.n = n;
  a.c = c;
  a.L = L;
  std::lock_guard<std::mutex> guard(g_mesh_mu);
  KeepDevice keep;
  a.epoch = ++*epoch;
  cudaError_t err;
  for (int k = 0; k < c; ++k) {
    if ((err = use_device(devices[k])) != cudaSuccess) return static_cast<int>(err);
    auto launch_st = static_cast<cudaStream_t>(streams[first[k]]);
    cudaEvent_t ev;
    a.me = k;
    a.n_out = 0;
    for (int e = first[k]; e < n; ++e) {
      if (card_of[e] != k) continue;
      a.out[a.n_out++] = static_cast<int64_t*>(out[e]);
      if (e == first[k]) continue;
      // entry e's input is ready on its own stream
      auto st = static_cast<cudaStream_t>(streams[e]);
      if ((err = stream_event(st, &ev)) != cudaSuccess) return static_cast<int>(err);
      if ((err = cudaEventRecord(ev, st)) != cudaSuccess) return static_cast<int>(err);
      if ((err = cudaStreamWaitEvent(launch_st, ev, 0)) != cudaSuccess)
        return static_cast<int>(err);
    }
    if (pairs) {
      ring_mesh_kernel<true><<<blocks, kMeshThreads, 0, launch_st>>>(a);
    } else {
      ring_mesh_kernel<false><<<blocks, kMeshThreads, 0, launch_st>>>(a);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    if (a.n_out == 1) continue;
    // the card's other entries: their sums (and their inputs' last reader)
    // are behind the launch
    if ((err = stream_event(launch_st, &ev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaEventRecord(ev, launch_st)) != cudaSuccess) return static_cast<int>(err);
    for (int e = first[k] + 1; e < n; ++e) {
      if (card_of[e] != k) continue;
      err = cudaStreamWaitEvent(static_cast<cudaStream_t>(streams[e]), ev, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
