// The rate-limit decision kernels, written by hand for Hopper (sm_90a).
//
// Replace the XLA program that gubernator_tpu/ops/decide.py `decide` (:277)
// compiles to, as reached through decide_packed (:464), decide_packed_compact
// (:536), decide_packed_lean (:844) and their scan forms decide_scan_packed
// (:495), decide_scan_packed_compact (:575) and decide_scan_packed_lean
// (:872), and the interned format's decide_packed_interned (:650) and
// decide_scan_packed_interned (:675). Their plain PyTorch version is decide()
// in ops/decide.py of this package; they must agree with it bit for bit on
// responses and on the table. The four staging formats differ only in how a
// lane is decoded (decode_slot and decode below).
//
// What bounds them on an H100: latency, not bytes or operations. Per live
// lane the work reads one 64-byte row and writes it back, plus the staging
// (72 B wide, 20 B compact, 8 B interned, 4 B lean) and the response (32 B
// wide, 16 B otherwise): under a microsecond at 3.35 TB/s for 8192 lanes, and ~100
// integer operations a lane. What a launch pays instead is a dependent chain
// of misses (the staging word, then the random row it names), and in a scan
// the lanes of one row, which must run one after another.
//
// decide_kernel_window (one window): one thread a lane, in blocks of
// kWindowThreads (64 beat 128 at W = 1024 and 8192 in a sweep on the card:
// more blocks spread a window over more SMs). The lane reads its slot first
// and issues its row's four 16-byte loads before the rest of its request, so
// the lattice waits on one miss after the staging word. The leaky lattice's
// floor divisions take one 32-bit divide when both operands lie in [0, 2^31)
// (and none when the dividend is below the divisor): the engine's traffic
// always does, since its durations, limits and elapsed milliseconds are far
// below 2^31; negative or huge durations take the 64-bit routine. The
// quotient is the same either way.
//
// The owner axis (decide_launch's `owners`): the R x S owner shards of the
// sharded engine are slices of one i64[R, S, C, 8] table, and one launch
// decides a window (or a scan) for all of them, as the JAX package's
// shard_map program is one dispatch (parallel/sharded.py:95-213). Owner o is
// blockIdx.y: its blocks read its own staging and write its own response,
// and its table is the C rows at o * C, so slot s of owner 0 and slot s of
// owner 1 are different rows and every clamp is to the owner's own row C-1.
// Each (window, owner) takes its own sequence number, hence its own scratch
// slot for row C-1's published copy. The single-table engines launch one
// owner.
//
// decide_kernel_scan (K windows in order, one launch): the order a scan group
// needs is only each row's own order across windows, since a lane reads and
// writes its own row alone and the live slots of one window are distinct. So
// the kernel resolves that order on chip instead of walking window by window
// with a barrier and a DRAM round trip each. A block copies a chunk of up to
// kMaxChunk windows of staging into shared memory in one asynchronous copy
// (cp.async), then in passes separated by barriers on shared memory only:
// (b) keys each live lane by its row in a shared hash holding a bitmask of
// the windows that touch the row, listing the live lanes (padding answers at
// once), and starts each row toward L2; (c) gives each row's chain a
// contiguous run; (d) lays every live lane into its chain's run in window
// order (compact, interned and lean as a 48-byte record with the leaky rates
// worked out, wide as its position in the staging); (e) one thread a chain loads the
// row once, runs the lattice for each lane of its run with the row in
// registers and stores it once, so a group pays one row miss deep, not K.
// A run of plain requests on a live row (a herd) takes a loop that moves
// only the fields that change. Responses go straight to the output.
// A staging larger than shared memory runs in chunks of whole windows, each
// chunk's stores before the next chunk's loads; a single window larger than
// shared memory runs as one window launch a window, in stream order. The
// rows are spread over kScanBlocks blocks (row % blocks; 8 beat 1, 2 and 4
// on full windows in a sweep on the card, and tie on herds): each block
// reads the whole staging and runs the rows it owns, so blocks share no row.
// What still bounds the scan is one SM's shared-memory passes over a chunk's
// live lanes and the longest chain, whose lanes run one after another.
//
// Semantics kept from the XLA program:
// - padding lanes (slot < 0, lean slot 0xFFFFFF) load and store nothing and
//   answer status 0, limit 0, remaining 0, reset 0 (compact delta -1);
// - a gather index >= capacity clamps to the last row C-1, and the store
//   there is dropped (pad_to_drop, decide.py:268). Such a lane reads row C-1
//   as it stood BEFORE its own window, even when a lane of the same window
//   writes C-1. The scan kernel keeps a snapshot of row C-1 before each
//   window. The window kernel, whose lanes may sit in other blocks, uses a
//   published copy: the lane that writes C-1 first stores the old row into a
//   scratch slot, then (after a fence) the launch's sequence number as its
//   flag, then (after a fence) the new row; a lane past the table reads the
//   row, fences, reads the flag, and takes the scratch copy when the flag
//   holds this launch's number. The wrapper allocates the scratch once per
//   card (kScratchSlots slots, the launch's sequence number picks one, plus
//   the owner's index in a sharded launch);
// - int64 adds and subtracts wrap (done as uint64_t, where signed overflow
//   would be undefined); divisions floor, as JAX's `//` does;
// - narrowing casts (i64 -> i32) truncate.

#include <atomic>
#include <type_traits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Format : int { WIDE = 0, COMPACT = 1, LEAN = 2, INTERNED = 3 };

constexpr int kBehaviorGregorian = 4;
constexpr int kBehaviorResetRemaining = 8;
constexpr int kMetaBehaviorMask = 0x3F;
constexpr int kMetaFresh = 1 << 7;
constexpr int kLeanSlotMask = (1 << 24) - 1;
constexpr int kLeanFreshShift = 24;
constexpr int kLeanCfgShift = 25;
constexpr int kLeanMaxCfg = 128;
// the interned meta word (decide.py:628-633): hits in bits 0-14, algorithm
// in 15, behavior in 16-21, fresh in 22, the config id from 23
constexpr int kIntHitsMask = (1 << 15) - 1;
constexpr int kIntAlgoShift = 15;
constexpr int kIntBehaviorShift = 16;
constexpr int kIntFreshShift = 22;
constexpr int kIntCfgShift = 23;
constexpr int kInternMaxCfg = 256;
constexpr int kNumFormats = 4;
constexpr int kRowFields = 8;

constexpr int kWindowThreads = 64;   // one-window block size (the sweep's winner)
constexpr int kScanThreads = 1024;   // scan block size
constexpr int kScanBlocks = 8;       // blocks a scan group's rows are spread over (the sweep's)
constexpr int kMaxScanBlocks = 32;
constexpr int kMaxChunk = 32;        // windows a chunk: one bit each in a uint32 mask
constexpr int kMaxChunkLanes = 16384;  // lane and hash indices fit uint16 (H <= 32768)
constexpr int kScratchSlots = 64;
constexpr int kScratchWords = 16;    // the old row, the flag, padding to 128 B
constexpr int kFlag = 8;

struct Req {
  int32_t slot;
  int64_t hits, limit, duration;
  int32_t algorithm, behavior;
  int64_t greg_expire, greg_interval;
  bool fresh;
};

struct Row {
  int64_t v[kRowFields];  // algo, limit, remaining, duration, stamp, expire, status, hits
};

struct Resp {
  int32_t status;
  int64_t limit, remaining, reset;
};

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}

__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}

// Floor division, as JAX's `//`; b >= 1 at every call site. Both operands in
// [0, 2^31) (the engine's traffic): one 32-bit divide, the same quotient.
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  if (static_cast<uint64_t>(a) < static_cast<uint64_t>(b)) return 0;  // 0 <= a < b
  if ((static_cast<uint64_t>(a) | static_cast<uint64_t>(b)) < (1ull << 31)) {
    return static_cast<int64_t>(static_cast<uint32_t>(a) / static_cast<uint32_t>(b));
  }
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// Staging bytes of one window of B lanes.
__host__ __device__ __forceinline__ size_t window_bytes(int fmt, int B) {
  return static_cast<size_t>(B) * (fmt == WIDE ? 72 : fmt == COMPACT ? 20 : fmt == INTERNED ? 8 : 4);
}

// The rows of one window's staging.
template <int FMT>
__host__ __device__ constexpr int staging_rows() {
  return FMT == WIDE ? 9 : FMT == COMPACT ? 5 : FMT == INTERNED ? 2 : 1;
}

// The slot of lane b of window k (lean padding -> -1).
template <int FMT>
__device__ __forceinline__ int32_t decode_slot(const void* packed, int k, int B, int b) {
  const int64_t i = static_cast<int64_t>(k) * staging_rows<FMT>() * B + b;
  if constexpr (FMT == WIDE) {
    return static_cast<int32_t>(static_cast<const int64_t*>(packed)[i]);
  } else if constexpr (FMT == COMPACT || FMT == INTERNED) {
    return static_cast<const int32_t*>(packed)[i];
  } else {
    const int32_t s = static_cast<const int32_t*>(packed)[i] & kLeanSlotMask;
    return s == kLeanSlotMask ? -1 : s;
  }
}

template <int FMT>
__device__ __forceinline__ Req decode(const void* packed, const int64_t* cfg,
                                      int k, int B, int b) {
  Req r;
  if constexpr (FMT == WIDE) {
    // i64[K, 9, B]: slot, hits, limit, duration, algorithm, behavior,
    // greg_expire, greg_interval, fresh (decide.py:477-487)
    const int64_t* p = static_cast<const int64_t*>(packed) + static_cast<int64_t>(k) * 9 * B + b;
    r.slot = static_cast<int32_t>(p[0]);
    r.hits = p[B];
    r.limit = p[2 * B];
    r.duration = p[3 * B];
    r.algorithm = static_cast<int32_t>(p[4 * B]);
    r.behavior = static_cast<int32_t>(p[5 * B]);
    r.greg_expire = p[6 * B];
    r.greg_interval = p[7 * B];
    r.fresh = p[8 * B] != 0;
  } else if constexpr (FMT == COMPACT) {
    // i32[K, 5, B]: slot, hits, limit, duration, meta (decide.py:543-555)
    const int32_t* p = static_cast<const int32_t*>(packed) + static_cast<int64_t>(k) * 5 * B + b;
    const int32_t meta = p[4 * B];
    r.slot = p[0];
    r.hits = p[B];
    r.limit = p[2 * B];
    r.duration = p[3 * B];
    r.algorithm = meta & 1;
    r.behavior = (meta >> 1) & kMetaBehaviorMask;
    r.greg_expire = 0;
    r.greg_interval = 0;
    r.fresh = (meta & kMetaFresh) != 0;
  } else if constexpr (FMT == INTERNED) {
    // i32[K, 2, B]: slot, meta + i64[256, 2] config rows of (limit,
    // duration) (decide.py:650-671); the config id includes the sign bit:
    // shift, then mask
    const int32_t* p = static_cast<const int32_t*>(packed) + static_cast<int64_t>(k) * 2 * B + b;
    const int32_t meta = p[B];
    const int64_t* c = cfg + ((meta >> kIntCfgShift) & (kInternMaxCfg - 1)) * 2;
    r.slot = p[0];
    r.hits = meta & kIntHitsMask;
    r.limit = c[0];
    r.duration = c[1];
    r.algorithm = (meta >> kIntAlgoShift) & 1;
    r.behavior = (meta >> kIntBehaviorShift) & kMetaBehaviorMask;
    r.greg_expire = 0;
    r.greg_interval = 0;
    r.fresh = ((meta >> kIntFreshShift) & 1) != 0;
  } else {
    // i32[K, B] lane words + i64[128, 4] config rows (decide.py:852-867);
    // the config id includes the sign bit: shift, then mask
    const int32_t lane = static_cast<const int32_t*>(packed)[static_cast<int64_t>(k) * B + b];
    const int32_t slot24 = lane & kLeanSlotMask;
    const int cfgid = (lane >> kLeanCfgShift) & (kLeanMaxCfg - 1);
    const int64_t* c = cfg + cfgid * 4;
    r.slot = slot24 == kLeanSlotMask ? -1 : slot24;
    r.hits = 1;
    r.limit = c[0];
    r.duration = c[1];
    r.algorithm = static_cast<int32_t>(c[2]);
    r.behavior = static_cast<int32_t>(c[3]);
    r.greg_expire = 0;
    r.greg_interval = 0;
    r.fresh = ((lane >> kLeanFreshShift) & 1) != 0;
  }
  return r;
}

__device__ __forceinline__ Row load_row(const int64_t* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  const longlong2 a = q[0], b = q[1], c = q[2], d = q[3];
  return Row{{a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y}};
}

__device__ __forceinline__ void store_row(int64_t* p, const Row& r) {
  longlong2* q = reinterpret_cast<longlong2*>(p);
  q[0] = make_longlong2(r.v[0], r.v[1]);
  q[1] = make_longlong2(r.v[2], r.v[3]);
  q[2] = make_longlong2(r.v[4], r.v[5]);
  q[3] = make_longlong2(r.v[6], r.v[7]);
}

// The leaky bucket's two rates, which depend on the request alone: ms a
// token on a live row (l_rate) and on a vacant one (lm_rate).
struct Rates {
  int64_t live, vacant;
};

__device__ __forceinline__ Rates rates(const Req& r, int64_t now) {
  const int64_t lim = imax(r.limit, 1);
  const bool greg = (r.behavior & kBehaviorGregorian) != 0;
  return Rates{imax(floordiv(greg ? r.greg_interval : r.duration, lim), 1),
               imax(floordiv(greg ? wsub(r.greg_expire, now) : r.duration, lim), 1)};
}

// One lane of decide.py:284-460 on a row held in registers: returns the
// response and leaves the new row in `row` (field 7 grows by `hits`).
__device__ __forceinline__ Resp lattice(Row& row, const Req& r, const Rates& q, int64_t now) {
  const int64_t st_algo = row.v[0], st_limit = row.v[1], st_rem = row.v[2], st_dur = row.v[3];
  const int64_t st_stamp = row.v[4], st_exp = row.v[5], st_status = row.v[6], st_hits = row.v[7];
  Resp out{0, 0, 0, 0};
  const bool peek = r.hits == 0;

  // The engine's common cases, a live row of the request's algorithm with
  // no reset and no calendar (and, for a token bucket, the same limit and
  // duration): the existing-row branches below with every test they cannot
  // take left out. The scan runs a row's lanes one after another, so each
  // instruction here is on its path.
  if (!r.fresh && now <= st_exp &&
      (r.behavior & (kBehaviorGregorian | kBehaviorResetRemaining)) == 0) {
    if (r.algorithm == 0 && st_algo == 0 && st_limit == r.limit && st_dur == r.duration) {
      const bool rem_zero = st_rem == 0;
      const bool over = r.hits > st_rem;
      const bool deduct = !peek && !rem_zero && !over;
      const int64_t rem = deduct ? wsub(st_rem, r.hits) : st_rem;
      out.status = static_cast<int32_t>((!peek && (rem_zero || over)) ? 1 : st_status);
      out.limit = r.limit;
      out.remaining = rem;
      out.reset = st_exp;
      row.v[2] = rem;
      row.v[6] = (!peek && rem_zero) ? 1 : st_status;
      row.v[7] = wadd(st_hits, r.hits);
      return out;
    }
    if (r.algorithm == 1 && st_algo == 1) {
      const int64_t elapsed = imax(wsub(now, st_stamp), 0);
      const int64_t rem1 = imin(r.limit, wadd(st_rem, floordiv(elapsed, q.live)));
      const bool rem_zero = rem1 == 0;
      const bool over = r.hits > rem1;
      const bool deduct = !peek && !rem_zero && !over;
      const int64_t rem = deduct ? wsub(rem1, r.hits) : rem1;
      out.status = (rem_zero || (!peek && over)) ? 1 : 0;
      out.limit = r.limit;
      out.remaining = rem;
      out.reset = wadd(now, q.live);
      row = Row{{1, r.limit, rem, r.duration, (!rem_zero && !peek) ? now : st_stamp,
                 deduct ? wadd(now, r.duration) : st_exp, st_status, wadd(st_hits, r.hits)}};
      return out;
    }
  }

  const bool is_tok = r.algorithm == 0;
  const bool greg = (r.behavior & kBehaviorGregorian) != 0;
  const bool reset_rem = (r.behavior & kBehaviorResetRemaining) != 0;
  const bool alive = !r.fresh && st_algo >= 0 && now <= st_exp &&
                     st_algo == static_cast<int64_t>(r.algorithm);

  // new row, starting from the old one
  int64_t n_algo = st_algo, n_limit = st_limit, n_rem = st_rem, n_dur = st_dur;
  int64_t n_stamp = st_stamp, n_exp = st_exp, n_status = st_status;
  int64_t resp_status = 0;
  out.limit = r.limit;

  if (is_tok) {
    if (alive && reset_rem) {
      // token RESET_REMAINING: the bucket is expired entirely (algorithms.go:37-39)
      n_algo = -1;
      resp_status = 0;
      out.remaining = r.limit;
      out.reset = 0;
    } else {
      const int64_t t_rem0 = st_limit != r.limit ? imin(st_rem, r.limit) : st_rem;
      const bool dur_changed = st_dur != r.duration;
      const int64_t t_new_exp = greg ? r.greg_expire : wadd(st_stamp, r.duration);
      const bool recreate = alive && dur_changed && t_new_exp < now;
      n_algo = 0;
      n_limit = r.limit;
      n_dur = r.duration;
      if (alive && !recreate) {
        // token bucket, existing row (algorithms.go:35-134)
        const int64_t te_exp = dur_changed ? t_new_exp : st_exp;
        const bool rem_zero = t_rem0 == 0;
        const bool over = r.hits > t_rem0;
        const bool deduct = !peek && !rem_zero && !over;
        const int64_t te_rem = deduct ? wsub(t_rem0, r.hits) : t_rem0;
        resp_status = (!peek && (rem_zero || over)) ? 1 : st_status;
        n_status = (!peek && rem_zero) ? 1 : st_status;
        n_rem = te_rem;
        n_exp = te_exp;
        out.remaining = te_rem;
        out.reset = te_exp;
      } else {
        // token bucket, vacant or recreated (algorithms.go:136-178)
        const int64_t m_exp = greg ? r.greg_expire : wadd(now, r.duration);
        const bool m_over = r.hits > r.limit;
        const int64_t m_rem = m_over ? r.limit : wsub(r.limit, r.hits);
        resp_status = m_over ? 1 : 0;
        n_rem = m_rem;
        n_stamp = now;
        n_exp = m_exp;
        n_status = 0;
        out.remaining = m_rem;
        out.reset = m_exp;
      }
    }
  } else {
    n_algo = 1;
    n_limit = r.limit;
    if (alive) {
      // leaky bucket, existing row (algorithms.go:194-289)
      const int64_t l_rem0 = reset_rem ? r.limit : st_rem;
      const int64_t l_dur = greg ? wsub(r.greg_expire, now) : r.duration;
      const int64_t l_rate = q.live;
      const int64_t elapsed = imax(wsub(now, st_stamp), 0);
      const int64_t l_rem1 = imin(r.limit, wadd(l_rem0, floordiv(elapsed, l_rate)));
      const bool rem_zero = l_rem1 == 0;
      const bool over = r.hits > l_rem1;
      const bool deduct = !peek && !rem_zero && !over;
      const int64_t le_rem = deduct ? wsub(l_rem1, r.hits) : l_rem1;
      resp_status = (rem_zero || (!peek && over)) ? 1 : 0;
      n_rem = le_rem;
      n_dur = l_dur;
      n_stamp = (!rem_zero && !peek) ? now : st_stamp;
      n_exp = deduct ? wadd(now, l_dur) : st_exp;
      out.remaining = le_rem;
      out.reset = wadd(now, l_rate);
    } else {
      // leaky bucket, vacant (algorithms.go:291-336)
      const int64_t lm_dur = greg ? wsub(r.greg_expire, now) : r.duration;
      const int64_t lm_rate = q.vacant;
      const bool lm_over = r.hits > r.limit;
      const int64_t lm_rem = lm_over ? 0 : wsub(r.limit, r.hits);
      resp_status = lm_over ? 1 : 0;
      n_rem = lm_rem;
      n_dur = lm_dur;
      n_stamp = now;
      n_exp = wadd(now, lm_dur);
      n_status = 0;
      out.remaining = lm_rem;
      out.reset = wadd(now, lm_rate);
    }
  }
  out.status = static_cast<int32_t>(resp_status);
  row = Row{{n_algo, n_limit, n_rem, n_dur, n_stamp, n_exp, n_status, wadd(st_hits, r.hits)}};
  return out;
}

// The response of one lane, its four fields `stride` elements apart:
// i64 wide (decide.py:489-491), else i32 with reset as a delta from now and
// -1 for an absolute 0 (:560-572).
template <int FMT>
__device__ __forceinline__ void put_resp(void* base, int stride, const Resp& o, int64_t now) {
  if constexpr (FMT == WIDE) {
    int64_t* w = static_cast<int64_t*>(base);
    w[0] = o.status;
    w[stride] = o.limit;
    w[2 * stride] = o.remaining;
    w[3 * stride] = o.reset;
  } else {
    int32_t* c = static_cast<int32_t*>(base);
    c[0] = o.status;
    c[stride] = static_cast<int32_t>(o.limit);
    c[2 * stride] = static_cast<int32_t>(o.remaining);
    c[3 * stride] = static_cast<int32_t>(o.reset == 0 ? -1 : wsub(o.reset, now));
  }
}

// ------------------------------------------------- the published copy of C-1

__device__ __forceinline__ int64_t ld_relaxed(const int64_t* p) {
  int64_t v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int64_t ld_acquire(const int64_t* p) {
  int64_t v;
  asm volatile("ld.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int64_t* p, int64_t v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void fence_gpu() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

// Row C-1 as it stood before this launch, for a lane past the table: if the
// row read saw any word of this launch's new row, the flag store that was
// fenced before it is visible after the fence here, and so is the scratch.
__device__ __forceinline__ Row read_last_row(const int64_t* row, const int64_t* scratch,
                                             int64_t seq) {
  Row r;
#pragma unroll
  for (int f = 0; f < kRowFields; ++f) r.v[f] = ld_relaxed(row + f);
  fence_gpu();
  if (ld_acquire(scratch + kFlag) == seq) {
#pragma unroll
    for (int f = 0; f < kRowFields; ++f) r.v[f] = ld_relaxed(scratch + f);
  }
  return r;
}

// The store of row C-1 by the lane that owns it: the old row and the flag
// published first, each behind a fence.
__device__ __forceinline__ void store_last_row(int64_t* row, int64_t* scratch, int64_t seq,
                                               const Row& old, const Row& now_row) {
#pragma unroll
  for (int f = 0; f < kRowFields; ++f) st_relaxed(scratch + f, old.v[f]);
  fence_gpu();
  st_relaxed(scratch + kFlag, seq);
  fence_gpu();
#pragma unroll
  for (int f = 0; f < kRowFields; ++f) st_relaxed(row + f, now_row.v[f]);
}

// ------------------------------------------------------------- one window

template <int FMT>
__global__ void decide_kernel_window(int64_t* table, int64_t C,
                                     const void* __restrict__ packed,
                                     const int64_t* __restrict__ cfg,
                                     void* __restrict__ out, int B, int64_t now,
                                     int64_t* scratch, int64_t seq,
                                     size_t packed_stride, size_t out_stride) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // owner shard blockIdx.y: its own table, staging, response and number
  const int owner = blockIdx.y;
  table += static_cast<int64_t>(owner) * C * kRowFields;
  packed = static_cast<const char*>(packed) + owner * packed_stride;
  out = static_cast<char*>(out) + owner * out_stride;
  seq += owner;
  const int32_t slot = decode_slot<FMT>(packed, 0, B, b);
  Resp o{0, 0, 0, 0};
  if (slot >= 0) {
    const int64_t last = C - 1;
    int64_t* pub = scratch + (seq % kScratchSlots) * kScratchWords;
    // the row's loads go out before the rest of the request is decoded
    Row row = slot <= last ? load_row(table + static_cast<int64_t>(slot) * kRowFields)
                           : read_last_row(table + last * kRowFields, pub, seq);
    const Req r = decode<FMT>(packed, cfg, 0, B, b);
    const Row old = row;
    o = lattice(row, r, rates(r, now), now);
    if (slot < last) {
      store_row(table + static_cast<int64_t>(slot) * kRowFields, row);
    } else if (slot == last) {
      store_last_row(table + last * kRowFields, pub, seq, old, row);
    }  // past the table: the store is dropped
  }
  if constexpr (FMT == WIDE) {
    put_resp<FMT>(static_cast<int64_t*>(out) + b, B, o, now);
  } else {
    put_resp<FMT>(static_cast<int32_t*>(out) + b, B, o, now);
  }
}

// ------------------------------------------------------------------- scan

// A live lane of a compact, interned or lean chunk, laid out in its chain's run with
// its leaky rates worked out: the chain's thread reads its run in order and
// no load depends on another. (Wide lanes keep only `at` in the run and read
// their request from the on-chip staging: a wide record would not fit beside
// it.)
struct Rec {
  int64_t hits, limit, duration;
  Rates q;
  int32_t algorithm;
  uint32_t at;  // b | kk << kAtWindow | the fresh, gregorian and reset bits
};
constexpr int kAtWindow = 14;  // b < kMaxChunkLanes = 2^14; kk < 32 above it
constexpr uint32_t kAtLane = (1u << kAtWindow) - 1;
constexpr uint32_t kAtFresh = 1u << 19, kAtGreg = 1u << 20, kAtReset = 1u << 21;
constexpr uint16_t kReader = 0xFFFF;  // a live entry past the table, not a hash slot

// The config table a format ships beside its staging: lean's i64[128, 4],
// interned's i64[256, 2]; none for wide and compact.
__host__ __device__ __forceinline__ size_t cfg_bytes(int fmt) {
  return fmt == LEAN ? kLeanMaxCfg * 4 * sizeof(int64_t)
                     : fmt == INTERNED ? kInternMaxCfg * 2 * sizeof(int64_t) : 0;
}

// Offsets into a scan block's dynamic shared memory for chunks of `kc`
// windows of B lanes; every section starts 16-byte aligned.
struct ScanLayout {
  size_t stage, cfg, keys, mask, val, live, lh, run, chain, start, snap, total;
  int H;  // hash slots: a power of two >= 2 lanes

  __host__ __device__ static size_t up16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

  __host__ __device__ static ScanLayout make(int fmt, int kc, int B) {
    ScanLayout L;
    const size_t lanes = static_cast<size_t>(kc) * B;
    int H = 64;
    while (H < 2 * static_cast<int>(lanes)) H <<= 1;
    L.H = H;
    size_t o = 0;
    L.stage = o; o += up16(kc * window_bytes(fmt, B));
    L.cfg = o; o += cfg_bytes(fmt);
    L.keys = o; o += up16(H * sizeof(int32_t));
    L.mask = o; o += up16(H * sizeof(uint32_t));
    L.val = o; o += up16(H * sizeof(uint16_t));
    L.live = o; o += up16(lanes * sizeof(uint32_t));
    L.lh = o; o += up16(lanes * sizeof(uint16_t));
    L.run = o; o += up16(lanes * (fmt == WIDE ? sizeof(uint32_t) : sizeof(Rec)));
    L.chain = o; o += up16(lanes * sizeof(uint16_t));
    L.start = o; o += up16(lanes * sizeof(uint16_t));
    L.snap = o; o += kMaxChunk * sizeof(Row);
    L.total = o;
    return L;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// Start copying n bytes (a multiple of 4) from global to shared memory, all
// threads of the block taking part; cp_async_wait_all() + a barrier finish it.
__device__ __forceinline__ void copy_in(void* dst, const void* src, size_t n) {
  const bool v16 = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) | n) & 15) == 0;
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  const size_t step = v16 ? 16 : 4;
  for (size_t i = threadIdx.x * step; i < n; i += blockDim.x * step) {
    if (v16) {
      cp_async16(d + i, s + i);
    } else {
      cp_async4(d + i, s + i);
    }
  }
}

__device__ __forceinline__ void prefetch_row_l2(const int64_t* row) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], 64;" ::"l"(row) : "memory");
}

__device__ __forceinline__ uint32_t hash_slot(int32_t key, int H) {
  return (static_cast<uint32_t>(key) * 0x9E3779B1u) >> (33 - __ffs(H));
}

// Append to the live list: one shared atomic for the lanes of a warp that
// append in this step.
__device__ __forceinline__ void append_live(bool take, uint32_t at, uint16_t h, int* n,
                                            uint32_t* live, uint16_t* lh) {
  const unsigned act = __activemask();
  const unsigned who = __ballot_sync(act, take);
  if (who == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(who) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(n, __popc(who));
  base = __shfl_sync(act, base, leader);
  if (take) {
    const int i = base + __popc(who & ((1u << lane) - 1u));
    live[i] = at;
    lh[i] = h;
  }
}

__device__ __forceinline__ Req unrec(const Rec& c) {
  Req r;
  r.slot = 0;
  r.hits = c.hits;
  r.limit = c.limit;
  r.duration = c.duration;
  r.algorithm = c.algorithm;
  r.behavior = ((c.at & kAtGreg) ? kBehaviorGregorian : 0) |
               ((c.at & kAtReset) ? kBehaviorResetRemaining : 0);
  r.greg_expire = 0;  // compact, interned and lean carry none
  r.greg_interval = 0;
  r.fresh = (c.at & kAtFresh) != 0;
  return r;
}

template <int FMT>
__device__ __forceinline__ void* out_at(void* out, int k, int B, int b) {
  const size_t i = static_cast<size_t>(k) * 4 * B + b;
  if constexpr (FMT == WIDE) {
    return static_cast<int64_t*>(out) + i;
  } else {
    return static_cast<int32_t*>(out) + i;
  }
}

template <int FMT>
__global__ void __launch_bounds__(kScanThreads, 1)
decide_kernel_scan(int64_t* table, int64_t C, const void* __restrict__ packed,
                   const int64_t* __restrict__ cfg, void* __restrict__ out,
                   int K, int B, int kc_max, int64_t now) {
  extern __shared__ __align__(16) unsigned char smem[];
  // owner shard blockIdx.y: its own table, its K windows of staging and of
  // response; its rows spread over the gridDim.x blocks of its row
  {
    const int o = blockIdx.y;
    table += static_cast<int64_t>(o) * C * kRowFields;
    packed = static_cast<const char*>(packed) + o * K * window_bytes(FMT, B);
    out = static_cast<char*>(out) + o * static_cast<size_t>(K) * 4 * B * (FMT == WIDE ? 8 : 4);
  }
  __shared__ int s_chains, s_cursor, s_live, s_reader, s_c1;
  const ScanLayout L = ScanLayout::make(FMT, kc_max, B);
  void* stage = smem + L.stage;
  int64_t* scfg = reinterpret_cast<int64_t*>(smem + L.cfg);
  int32_t* keys = reinterpret_cast<int32_t*>(smem + L.keys);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + L.mask);  // windows that touch the row
  uint16_t* val = reinterpret_cast<uint16_t*>(smem + L.val);     // hash slot -> chain id
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + L.live);   // live lanes, as `at`
  uint16_t* lh = reinterpret_cast<uint16_t*>(smem + L.lh);       // their hash slot / kReader
  Rec* rec = reinterpret_cast<Rec*>(smem + L.run);               // chains' runs (not wide)
  uint32_t* order = reinterpret_cast<uint32_t*>(smem + L.run);   // chains' runs (wide)
  uint16_t* chain = reinterpret_cast<uint16_t*>(smem + L.chain); // chain id -> hash slot
  uint16_t* start = reinterpret_cast<uint16_t*>(smem + L.start); // chain id -> its run
  Row* snap = reinterpret_cast<Row*>(smem + L.snap);             // row C-1 before each window
  const int tid = threadIdx.x, T = blockDim.x, lane32 = tid & 31;
  const int H = L.H;
  const int nb = gridDim.x, me = blockIdx.x;
  const int64_t last = C - 1;
  const size_t wbytes = window_bytes(FMT, B);
  const int owner_last = nb == 1 ? 0 : static_cast<int>(last % nb);
  // lane = kk * B + b, stepped by T without a division a step
  const int dK = T / B, dB = T - dK * B, kk0 = tid / B, b0 = tid - kk0 * B;

  if constexpr (FMT == LEAN || FMT == INTERNED) copy_in(scfg, cfg, cfg_bytes(FMT));
  for (int k0 = 0; k0 < K; k0 += kc_max) {
    const int kc = min(kc_max, K - k0);
    const int lanes = kc * B;
    // (a) the chunk's staging onto the chip in one asynchronous copy; an
    // empty hash
    copy_in(stage, static_cast<const char*>(packed) + k0 * wbytes, kc * wbytes);
    for (int i = tid; i < H; i += T) {
      keys[i] = -1;
      mask[i] = 0;
    }
    if (tid == 0) {
      s_chains = 0;
      s_cursor = 0;
      s_live = 0;
      s_reader = 0;
      s_c1 = 0;
    }
    cp_async_wait_all();
    __syncthreads();

    // (b) padding lanes answer at once (block 0); each live lane of a row this
    // block owns finds the row's hash slot and sets its window's bit; the lane
    // that makes a slot gives its chain an id and starts the row toward L2
    for (int lane = tid, kk = kk0, b = b0; lane < lanes; lane += T, kk += dK, b += dB) {
      if (b >= B) {
        b -= B;
        ++kk;
      }
      const int32_t slot = decode_slot<FMT>(stage, kk, B, b);
      bool take = false;
      uint16_t h16 = kReader;
      if (slot < 0) {
        if (me == 0) put_resp<FMT>(out_at<FMT>(out, k0 + kk, B, b), B, Resp{0, 0, 0, 0}, now);
      } else if (slot > last) {  // reads row C-1, stores nothing
        take = owner_last == me;
        s_reader = 1;
      } else if (nb == 1 || slot % nb == me) {  // rows this block owns
        uint32_t h = hash_slot(slot, H);
        while (true) {
          const int32_t prev = atomicCAS(&keys[h], -1, slot);
          if (prev == -1) {
            const int id = atomicAdd(&s_chains, 1);
            chain[id] = static_cast<uint16_t>(h);
            val[h] = static_cast<uint16_t>(id);
            prefetch_row_l2(table + static_cast<int64_t>(slot) * kRowFields);
            break;
          }
          if (prev == slot) break;
          h = (h + 1) & (H - 1);
        }
        atomicOr(&mask[h], 1u << kk);
        take = true;
        h16 = static_cast<uint16_t>(h);
      }
      append_live(take, static_cast<uint32_t>(b) | static_cast<uint32_t>(kk) << kAtWindow,
                  h16, &s_live, live, lh);
    }
    __syncthreads();

    // (c) each chain a contiguous run, one shared atomic a warp
    const int E = s_chains;
    for (int base = 0; base < E; base += T) {
      const int id = base + tid;
      const int cnt = id < E ? __popc(mask[chain[id]]) : 0;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane32 >= o) incl += v;
      }
      int wbase = 0;
      if (lane32 == 31) wbase = atomicAdd(&s_cursor, incl);
      wbase = __shfl_sync(0xffffffffu, wbase, 31);
      if (id < E) start[id] = static_cast<uint16_t>(wbase + incl - cnt);
    }
    __syncthreads();

    // (d) each live lane takes its place in its chain's run (the run's start
    // plus the number of the chain's windows before its own), decoded there
    const int n_live = s_live;
    for (int i = tid; i < n_live; i += T) {
      const uint16_t h = lh[i];
      if (h == kReader) continue;
      const uint32_t at = live[i];
      const int kk = at >> kAtWindow, b = at & kAtLane;
      const int pos = start[val[h]] + __popc(mask[h] & ((1u << kk) - 1u));
      if constexpr (FMT == WIDE) {
        order[pos] = at;
      } else {
        const Req r = decode<FMT>(stage, scfg, kk, B, b);
        rec[pos] = Rec{r.hits, r.limit, r.duration, rates(r, now), r.algorithm,
                       at | (r.fresh ? kAtFresh : 0u) |
                           ((r.behavior & kBehaviorGregorian) ? kAtGreg : 0u) |
                           ((r.behavior & kBehaviorResetRemaining) ? kAtReset : 0u)};
      }
    }
    __syncthreads();

    // (e) one thread a chain: the row loaded once, each lane of its run on it
    // in registers, stored once. While the row is live and the next lanes
    // are plain requests of its algorithm on its limit and duration (a
    // herd), a tight loop runs them on the fields that move. The chain of
    // row C-1 also keeps the row as it stood before each window, for the
    // lanes past the table.
    const bool readers = s_reader != 0;
    for (int id = tid; id < E; id += T) {
      const int h = chain[id];
      const int32_t key = keys[h];
      const int n = __popc(mask[h]);
      const int s = start[id];
      int64_t* rowp = table + static_cast<int64_t>(key) * kRowFields;
      Row row = load_row(rowp);
      const bool keep = readers && key == last;
      if (keep) s_c1 = 1;
      int snapped = 0;
      auto member = [&](int j, uint32_t& at, Rates& q) {
        if constexpr (FMT == WIDE) {
          at = order[s + j];
          const Req r = decode<FMT>(stage, scfg, at >> kAtWindow, B, at & kAtLane);
          q = rates(r, now);
          return r;
        } else {
          const Rec c = rec[s + j];
          at = c.at;
          q = c.q;
          return unrec(c);
        }
      };
      // A run of plain requests on a live row (LEAKY: of a leaky bucket, else
      // of a token bucket): the fields that stay put, then the ones that move.
      int j = 0;
      auto run = [&](auto leaky_t) {
        constexpr bool LEAKY = decltype(leaky_t)::value;
        const int64_t lim = row.v[1], dur = row.v[3];
        int64_t rem = row.v[2], stamp = row.v[4], exp = row.v[5], status = row.v[6];
        int64_t hits = row.v[7];
        const int64_t rate = imax(floordiv(dur, imax(lim, 1)), 1);  // Rates::live
        for (; j < n; ++j) {
          uint32_t at;
          Rates q;
          const Req r = member(j, at, q);
          if (r.algorithm != (LEAKY ? 1 : 0) || r.fresh || r.limit != lim || r.duration != dur ||
              now > exp || (r.behavior & (kBehaviorGregorian | kBehaviorResetRemaining)) != 0) {
            break;
          }
          const bool peek = r.hits == 0;
          Resp o;
          if constexpr (!LEAKY) {  // lattice()'s live token branch
            const bool rem_zero = rem == 0, over = r.hits > rem;
            o.status = static_cast<int32_t>((!peek && (rem_zero || over)) ? 1 : status);
            if (!peek && rem_zero) status = 1;
            if (!peek && !rem_zero && !over) rem = wsub(rem, r.hits);
            o.reset = exp;
          } else {  // its live leaky branch
            const int64_t rem1 = imin(lim, wadd(rem, floordiv(imax(wsub(now, stamp), 0), rate)));
            const bool rem_zero = rem1 == 0, over = r.hits > rem1;
            const bool deduct = !peek && !rem_zero && !over;
            o.status = (rem_zero || (!peek && over)) ? 1 : 0;
            rem = deduct ? wsub(rem1, r.hits) : rem1;
            if (!rem_zero && !peek) stamp = now;
            if (deduct) exp = wadd(now, dur);
            o.reset = wadd(now, rate);
          }
          o.limit = lim;
          o.remaining = rem;
          hits = wadd(hits, r.hits);
          put_resp<FMT>(out_at<FMT>(out, k0 + ((at >> kAtWindow) & (kMaxChunk - 1)), B, at & kAtLane),
                        B, o, now);
        }
        row = Row{{LEAKY ? 1 : 0, lim, rem, dur, stamp, exp, status, hits}};
      };
      while (j < n) {
        if (!keep && now <= row.v[5]) {
          if (row.v[0] == 0) {
            run(std::false_type{});
          } else if (row.v[0] == 1) {
            run(std::true_type{});
          }
          if (j == n) break;
        }
        uint32_t at;
        Rates q;
        const Req r = member(j, at, q);
        const int kk = (at >> kAtWindow) & (kMaxChunk - 1);
        if (keep) {
          for (; snapped <= kk; ++snapped) snap[snapped] = row;
        }
        const Resp o = lattice(row, r, q, now);
        put_resp<FMT>(out_at<FMT>(out, k0 + kk, B, at & kAtLane), B, o, now);
        ++j;
      }
      if (keep) {
        for (; snapped < kc; ++snapped) snap[snapped] = row;
      }
      store_row(rowp, row);
    }

    // (f) lanes past the table: row C-1 as it stood before their window
    if (readers) {
      __syncthreads();
      const bool c1 = s_c1 != 0;
      for (int i = tid; i < n_live; i += T) {
        if (lh[i] != kReader) continue;
        const uint32_t at = live[i];
        const int kk = at >> kAtWindow, b = at & kAtLane;
        Row row = c1 ? snap[kk] : load_row(table + last * kRowFields);
        const Req r = decode<FMT>(stage, scfg, kk, B, b);
        const Resp o = lattice(row, r, rates(r, now), now);
        put_resp<FMT>(out_at<FMT>(out, k0 + kk, B, b), B, o, now);
      }
    }
    if (k0 + kc < K) __syncthreads();  // the next chunk reuses the staging and the hash
  }
}

// ------------------------------------------------------------------- launch

int g_window_threads = kWindowThreads;
int g_scan_blocks = kScanBlocks;
std::atomic<long long> g_seq{0};  // launches so far: each takes its own number

constexpr int kMaxDevices = 64;
size_t g_scan_smem[kNumFormats][kMaxDevices];  // dynamic shared memory a scan block may take

// cudaSetDevice costs a runtime call; the card is almost always current already.
int set_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  return current == device ? 0 : static_cast<int>(cudaSetDevice(device));
}

template <int FMT>
int scan_smem_limit(int device, size_t* limit) {
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  size_t& cached = g_scan_smem[FMT][device];
  if (cached == 0) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, decide_kernel_scan<FMT>);
    const size_t dyn = static_cast<size_t>(optin) - attr.sharedSizeBytes;
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(decide_kernel_scan<FMT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    cached = dyn;
  }
  *limit = cached;
  return 0;
}

// Windows a scan chunk of B lanes a window can hold in `limit` bytes: at
// most kMaxChunk and K, 0 when not even one fits.
int scan_chunk(int fmt, int K, int B, size_t limit) {
  for (int kc = K < kMaxChunk ? K : kMaxChunk; kc > 0; --kc) {
    if (static_cast<long long>(kc) * B <= kMaxChunkLanes &&
        ScanLayout::make(fmt, kc, B).total <= limit) {
      return kc;
    }
  }
  return 0;
}

template <int FMT>
int launch(int64_t* table, long long C, int owners, const void* packed, const int64_t* cfg,
           void* out, int K, int B, long long now, int scan, int device, int64_t* scratch,
           cudaStream_t s) {
  if (owners < 1 || owners > kScratchSlots) return static_cast<int>(cudaErrorInvalidValue);
  // each (window, owner) takes its own number, so one launch's owners
  // publish row C-1 into distinct scratch slots
  long long seq = g_seq.fetch_add(static_cast<long long>(K) * owners) + 1;
  const size_t out_window = static_cast<size_t>(4) * B * (FMT == WIDE ? 8 : 4);
  if (scan) {
    size_t limit = 0;
    const int err = scan_smem_limit<FMT>(device, &limit);
    if (err != 0) return err;
    const int kc = scan_chunk(FMT, K, B, limit);
    if (kc > 0) {
      const int lanes = kc * B;
      const int threads = lanes < kScanThreads ? ((lanes + 31) / 32) * 32 : kScanThreads;
      const dim3 grid(g_scan_blocks, owners);
      decide_kernel_scan<FMT><<<grid, threads, ScanLayout::make(FMT, kc, B).total, s>>>(
          table, C, packed, cfg, out, K, B, kc, now);
      return static_cast<int>(cudaGetLastError());
    }
  }
  // one window, or a scan whose single window does not fit on chip: one
  // launch a window over every owner, in stream order
  const int threads = g_window_threads;
  const dim3 grid((B + threads - 1) / threads, owners);
  for (int k = 0; k < K; ++k, seq += owners) {
    decide_kernel_window<FMT><<<grid, threads, 0, s>>>(
        table, C, static_cast<const char*>(packed) + k * window_bytes(FMT, B), cfg,
        static_cast<char*>(out) + k * out_window, B, now, scratch, seq,
        K * window_bytes(FMT, B), K * out_window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one decision over `K` windows of `B` lanes on `stream`, for each of
// `owners` shards of one table in ONE launch (a second grid dimension; the
// single-table engines pass 1). scan == 0: one window (K must be 1).
// scan != 0: K windows in order. `table` is i64[owners, capacity, 8]; the
// staging and the response hold each owner's K windows one owner after
// another, and `cfg` is one config table for all of them. Each owner clamps
// to its own row capacity - 1 and publishes that row into its own slot of
// `scratch`, the card's i64[kScratchSlots * kScratchWords] published-copy
// area (zeroed once by the caller, never written by it again). owners must
// lie in [1, kScratchSlots].
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int decide_launch(int device, int fmt, void* table, long long capacity,
                             int owners, const void* packed, const void* cfg, void* out,
                             int K, int B, long long now, int scan, void* scratch,
                             void* stream) {
  int err = set_device(device);
  if (err != 0) return err;
  if ((!scan && K != 1) || owners < 1 || owners > kScratchSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* t = static_cast<int64_t*>(table);
  auto* c = static_cast<const int64_t*>(cfg);
  auto* sc = static_cast<int64_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case WIDE:
      return launch<WIDE>(t, capacity, owners, packed, c, out, K, B, now, scan, device, sc, s);
    case COMPACT:
      return launch<COMPACT>(t, capacity, owners, packed, c, out, K, B, now, scan, device, sc, s);
    case LEAN:
      return launch<LEAN>(t, capacity, owners, packed, c, out, K, B, now, scan, device, sc, s);
    case INTERNED:
      return launch<INTERNED>(t, capacity, owners, packed, c, out, K, B, now, scan, device, sc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The owners one sharded launch may take.
extern "C" int decide_max_owners() { return kScratchSlots; }

// Words of the published-copy scratch the caller allocates per card.
extern "C" int decide_scratch_words() { return kScratchSlots * kScratchWords; }

// How decide_launch runs a scan of K windows of B lanes in format `fmt` on
// `device`: *kc is the windows a chunk of the scan kernel takes (scan_chunk's
// rule), 0 when not one window fits on chip and each window gets a launch of
// its own. Launches nothing. Returns a CUDA error code (0 on success).
extern "C" int decide_scan_chunk(int device, int fmt, int K, int B, int* kc) {
  int err = set_device(device);
  if (err != 0) return err;
  size_t limit = 0;
  switch (fmt) {
    case WIDE: err = scan_smem_limit<WIDE>(device, &limit); break;
    case COMPACT: err = scan_smem_limit<COMPACT>(device, &limit); break;
    case LEAN: err = scan_smem_limit<LEAN>(device, &limit); break;
    case INTERNED: err = scan_smem_limit<INTERNED>(device, &limit); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  *kc = scan_chunk(fmt, K, B, limit);
  return 0;
}

// For a sweep on the card: the one-window block size and the blocks a scan
// group's rows are spread over, for later launches; 0 restores the
// constant. Returns cudaErrorInvalidValue (and changes nothing) for a block
// that is not a multiple of 32 in [32, 1024] or a spread outside [1, 32].
extern "C" int decide_tune(int window_threads, int scan_blocks) {
  const int w = window_threads ? window_threads : kWindowThreads;
  const int n = scan_blocks ? scan_blocks : kScanBlocks;
  if (w < 32 || w > 1024 || w % 32 != 0 || n < 1 || n > kMaxScanBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g_window_threads = w;
  g_scan_blocks = n;
  return 0;
}
