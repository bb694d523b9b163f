// The rate-limit decision kernel, written by hand for Hopper (sm_90a).
//
// Replaces the XLA program that gubernator_tpu/ops/decide.py `decide` (:277)
// compiles to, as reached through decide_packed (:464), decide_packed_compact
// (:536), decide_packed_lean (:844) and their scan forms decide_scan_packed
// (:495), decide_scan_packed_compact (:575) and decide_scan_packed_lean
// (:872). Its plain PyTorch version is decide() in ops/decide.py of this
// package; the two must agree bit for bit on responses and on the table.
//
// What bounds it on an H100: memory. Per live lane it reads one 64-byte row
// and writes one back, and every lane reads its staging (72 B wide, 20 B
// compact, 4 B lean) and writes its response (32 B wide, 16 B compact): at
// 3.35 TB/s an 8192-lane window needs well under a microsecond, so at the
// engine's widths the launch itself dominates. The lattice is ~100 integer
// operations per lane, far below the card's integer rate.
//
// Design: one thread per lane. The lane decodes its request from whichever
// staging format the template names, loads its row as four 16-byte vectors,
// runs the token/leaky lattice in registers and stores the row (field 7 grows
// by `hits`), then writes its response. Lanes of one window target distinct
// slots (the engine splits duplicate keys into rounds), so no atomics are
// needed. The scan form runs K windows in ONE block, in order, with a
// __syncthreads() between windows: window k+1 reads what window k wrote, and
// the barrier makes those global writes visible to the whole block.
//
// Semantics kept from the XLA program:
// - padding lanes (slot < 0, lean slot 0xFFFFFF) load and store nothing and
//   answer status 0, limit 0, remaining 0, reset 0 (compact delta -1);
// - a gather index >= capacity clamps to the last row, and the store there
//   is dropped (pad_to_drop, decide.py:268);
// - int64 adds and subtracts wrap (done as uint64_t, where signed overflow
//   would be undefined); divisions floor, as JAX's `//` does;
// - narrowing casts (i64 -> i32) truncate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Format : int { WIDE = 0, COMPACT = 1, LEAN = 2 };

constexpr int kBehaviorGregorian = 4;
constexpr int kBehaviorResetRemaining = 8;
constexpr int kMetaBehaviorMask = 0x3F;
constexpr int kMetaFresh = 1 << 7;
constexpr int kLeanSlotMask = (1 << 24) - 1;
constexpr int kLeanFreshShift = 24;
constexpr int kLeanCfgShift = 25;
constexpr int kLeanMaxCfg = 128;

struct Req {
  int32_t slot;
  int64_t hits, limit, duration;
  int32_t algorithm, behavior;
  int64_t greg_expire, greg_interval;
  bool fresh;
};

__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}

__device__ __forceinline__ int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}

// Floor division, as JAX's `//`; b >= 1 at every call site.
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

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

struct Resp {
  int32_t status;
  int64_t limit, remaining, reset;
};

// One lane of decide.py:284-460: read the row, run the lattice, store it.
__device__ __forceinline__ Resp decide_lane(int64_t* table, int64_t capacity,
                                            const Req& r, int64_t now) {
  Resp out{0, 0, 0, 0};
  if (r.slot < 0) return out;  // padding lane: no load, no store
  const int64_t slot = r.slot;
  const int64_t gslot = slot < capacity ? slot : capacity - 1;  // XLA clamps
  longlong2* row = reinterpret_cast<longlong2*>(table + gslot * 8);
  const longlong2 v0 = row[0], v1 = row[1], v2 = row[2], v3 = row[3];
  const int64_t st_algo = v0.x, st_limit = v0.y, st_rem = v1.x, st_dur = v1.y;
  const int64_t st_stamp = v2.x, st_exp = v2.y, st_status = v3.x, st_hits = v3.y;

  const bool is_tok = r.algorithm == 0;
  const bool greg = (r.behavior & kBehaviorGregorian) != 0;
  const bool reset_rem = (r.behavior & kBehaviorResetRemaining) != 0;
  const bool peek = r.hits == 0;
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
      const int64_t l_rate = imax(
          floordiv(greg ? r.greg_interval : r.duration, imax(r.limit, 1)), 1);
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
      const int64_t lm_rate = imax(floordiv(lm_dur, imax(r.limit, 1)), 1);
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

  if (slot < capacity) {  // an out-of-range store is dropped
    row[0] = make_longlong2(n_algo, n_limit);
    row[1] = make_longlong2(n_rem, n_dur);
    row[2] = make_longlong2(n_stamp, n_exp);
    row[3] = make_longlong2(n_status, wadd(st_hits, r.hits));
  }
  return out;
}

template <int FMT>
__global__ void decide_kernel(int64_t* table, int64_t capacity,
                              const void* __restrict__ packed,
                              const int64_t* __restrict__ cfg,
                              void* __restrict__ out, int K, int B, int64_t now) {
  const int stride = gridDim.x * blockDim.x;
  for (int k = 0; k < K; ++k) {
    for (int b = blockIdx.x * blockDim.x + threadIdx.x; b < B; b += stride) {
      const Req r = decode<FMT>(packed, cfg, k, B, b);
      const Resp o = decide_lane(table, capacity, r, now);
      const int64_t base = static_cast<int64_t>(k) * 4 * B + b;
      if constexpr (FMT == WIDE) {
        // i64[K, 4, B] (decide.py:489-491)
        int64_t* w = static_cast<int64_t*>(out) + base;
        w[0] = o.status;
        w[B] = o.limit;
        w[2 * B] = o.remaining;
        w[3 * B] = o.reset;
      } else {
        // i32[K, 4, B]: reset as a delta from now, -1 for absolute 0 (:560-572)
        int32_t* c = static_cast<int32_t*>(out) + base;
        c[0] = o.status;
        c[B] = static_cast<int32_t>(o.limit);
        c[2 * B] = static_cast<int32_t>(o.remaining);
        c[3 * B] = static_cast<int32_t>(o.reset == 0 ? -1 : wsub(o.reset, now));
      }
    }
    // scan: the next window reads this one's writes (one block only)
    if (k + 1 < K) __syncthreads();
  }
}

}  // namespace

// Launch one decision over `K` windows of `B` lanes on `stream`.
// scan == 0: one window (K must be 1), one thread per lane over many blocks.
// scan != 0: K windows in order, in one block that strides over the lanes.
// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int decide_launch(int device, int fmt, void* table, long long capacity,
                             const void* packed, const void* cfg, void* out,
                             int K, int B, long long now, int scan, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads, blocks;
  if (scan) {
    threads = ((B + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    blocks = 1;
  } else {
    if (K != 1) return static_cast<int>(cudaErrorInvalidValue);
    threads = 256;
    blocks = (B + threads - 1) / threads;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int64_t*>(table);
  auto* c = static_cast<const int64_t*>(cfg);
  switch (fmt) {
    case WIDE:
      decide_kernel<WIDE><<<blocks, threads, 0, s>>>(t, capacity, packed, c, out, K, B, now);
      break;
    case COMPACT:
      decide_kernel<COMPACT><<<blocks, threads, 0, s>>>(t, capacity, packed, c, out, K, B, now);
      break;
    case LEAN:
      decide_kernel<LEAN><<<blocks, threads, 0, s>>>(t, capacity, packed, c, out, K, B, now);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
