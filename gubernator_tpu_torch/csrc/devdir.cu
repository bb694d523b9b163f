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
// Each ordering above is a barrier across every lane of the batch, so the
// probe is three launches on one stream, each a grid-wide barrier:
//
// - match: half a warp a lane, one candidate a thread (the 16 candidates are
//   128 contiguous bytes unless they wrap). __ballot_sync over the half warp
//   and __ffs give the first match and the first empty; the thread of the
//   match stamps it. The lane's match and empty positions go to a per-lane
//   scratch (i64[3, B], the caller's).
// - claim: half a warp a lane again. A lane with no match and no empty reads
//   its candidates' stamps, which every match stamp now precedes, and a
//   shuffle minimum over (stamp, d) gives the victim, ties to the lower d.
//   The claim goes into the card's claim scratch, one u64 word a directory
//   position, by atomicMax of (tag << 20 | lane): the highest lane of a
//   position wins, deterministically. The caller owns the scratch and its
//   tag together (ops/devdir.py): it zeroes the words once, when it
//   allocates them, and passes a tag larger than any earlier launch's on
//   them, so a word left by an earlier launch is smaller than any of this
//   one's and no launch has to clear the scratch.
//   That costs 8 bytes a directory position (80 MB at C = 10M); an
//   argsort, as the JAX program does, would need no scratch but a sort.
// - resolve: one thread a lane. A claiming lane won when the word of its
//   position holds its own tag; winners write fingerprint and stamp. Every
//   lane writes retry, and slot and fresh where the caller asks for them;
//   when the caller passes the device directory's wide i64[9, B] staging,
//   its slot goes into row 0 and its fresh flag into row 8, where decide
//   reads them: the slot never goes to the host.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 16;      // PROBE_DEPTH: one half warp a lane
constexpr int kThreads = 256;   // 16 lanes a block in the half-warp kernels
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

// The 16 bits of a full-warp ballot that belong to this thread's half warp.
__device__ __forceinline__ unsigned half_ballot(bool pred) {
  const unsigned all = __ballot_sync(0xffffffffu, pred);
  return (threadIdx.x & 16) ? all >> 16 : all & 0xffffu;
}

template <bool EVICT>
__global__ void __launch_bounds__(kThreads)
probe_match_kernel(const int64_t* __restrict__ fps, int64_t* touch, int64_t C,
                   const int64_t* __restrict__ hashes, int B, int64_t now,
                   int64_t* __restrict__ lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> 4, d = t & (kDepth - 1);
  const bool in = i < B;  // no thread returns early: the ballots take the whole warp
  const int64_t h = in ? hashes[i] : 0;
  int64_t p = 0, cand = -1;
  if (in) {
    p = probe_pos(probe_base(h, C), d, C);
    cand = fps[p];
  }
  const unsigned mm = half_ballot(in && h != 0 && cand == h);
  const unsigned em = half_ballot(in && cand == 0);
  if (!in) return;
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

template <bool EVICT>
__global__ void __launch_bounds__(kThreads)
probe_claim_kernel(const int64_t* __restrict__ touch, int64_t C,
                   const int64_t* __restrict__ hashes, int B, int64_t now,
                   unsigned long long tag, unsigned long long* scratch,
                   int64_t* __restrict__ lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> 4, d = t & (kDepth - 1);
  const bool in = i < B;
  const int64_t h = in ? hashes[i] : 0;
  const int64_t mp = in ? lanes[i] : -1;
  const int64_t ep = in ? lanes[B + i] : -1;
  const bool want = in && h != 0 && mp < 0;
  int64_t cslot = want ? ep : -1;
  if constexpr (EVICT) {
    // the victim: the least stamp over the candidates, ties to the lower d
    const bool need = want && ep < 0;
    const int64_t base = need ? probe_base(h, C) : 0;
    int64_t v = need ? touch[probe_pos(base, d, C)] : INT64_MAX;
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

template <bool EVICT>
__global__ void __launch_bounds__(kThreads)
probe_resolve_kernel(int64_t* fps, int64_t* touch, const int64_t* __restrict__ hashes,
                     int B, int64_t now, unsigned long long tag,
                     const unsigned long long* __restrict__ scratch,
                     const int64_t* __restrict__ lanes, int32_t* __restrict__ slot_out,
                     uint8_t* __restrict__ fresh_out, uint8_t* __restrict__ retry_out,
                     int64_t* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int64_t h = hashes[i];
  const int64_t mp = lanes[i];
  const int64_t cs = lanes[2 * B + i];
  const bool won = cs >= 0 && scratch[cs] == (tag | static_cast<unsigned long long>(i));
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

template <bool EVICT>
void launch_probe(int64_t* fps, int64_t* touch, int64_t C, const int64_t* hashes, int B,
                  int64_t now, unsigned long long* scratch, unsigned long long tag,
                  int64_t* lanes, int32_t* slot, uint8_t* fresh, uint8_t* retry,
                  int64_t* packed, cudaStream_t s) {
  const int half_blocks = static_cast<int>((static_cast<int64_t>(B) * kDepth + kThreads - 1) / kThreads);
  probe_match_kernel<EVICT><<<half_blocks, kThreads, 0, s>>>(fps, touch, C, hashes, B, now, lanes);
  probe_claim_kernel<EVICT><<<half_blocks, kThreads, 0, s>>>(touch, C, hashes, B, now, tag,
                                                             scratch, lanes);
  probe_resolve_kernel<EVICT><<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      fps, touch, hashes, B, now, tag, scratch, lanes, slot, fresh, retry, packed);
}

}  // namespace

// The probe over B lanes on `stream`: probe_assign_evict when `evict` is
// nonzero (`touch` an i64[C] stamp column, `seq` the epoch), else
// probe_assign (`touch` unused). `scratch` is the card's claim scratch, at
// least C zeroed-once u64 words, and `tag` (in [1, 2^44)) is larger than the
// tag of any earlier launch on it; `lanes` an i64[3, B] per-lane scratch;
// retry u8[B] an output, and slot i32[B] and fresh u8[B] outputs that may be
// null when `packed` is not: a wide i64[9, B] staging whose rows 0 and 8
// take slot and fresh. Returns cudaErrorInvalidValue for a shape or tag it
// does not take, else cudaGetLastError() after the launches (0 when they
// were accepted).
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
  auto* f = static_cast<int64_t*>(fps);
  auto* tc = static_cast<int64_t*>(touch);
  const auto* h = static_cast<const int64_t*>(hashes);
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* ln = static_cast<int64_t*>(lanes);
  auto* so = static_cast<int32_t*>(slot);
  auto* fo = static_cast<uint8_t*>(fresh);
  auto* ro = static_cast<uint8_t*>(retry);
  auto* pk = static_cast<int64_t*>(packed);
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned long long t = static_cast<unsigned long long>(tag) << kTagShift;
  if (evict) {
    launch_probe<true>(f, tc, C, h, B, seq, sc, t, ln, so, fo, ro, pk, s);
  } else {
    launch_probe<false>(f, tc, C, h, B, seq, sc, t, ln, so, fo, ro, pk, s);
  }
  return static_cast<int>(cudaGetLastError());
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
