// Per-node top-k degree-slab merge for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_merge.py::topk_merge
// (body _topk_merge_kernel).  Per row: join the k slab entries and the kin
// incoming entries, drop repeated neighbours keeping the heaviest instance
// (the earlier position on an exact tie), rank the survivors by (weight
// desc, nbr asc) and write the top k, with a -1 / -inf tail.  The output
// is kernels/ref.py::topk_merge_ref's bit for bit, weights included, for
// any k and kin and any input.
//
// What bounds it on the H100: a row reads (k + kin) 8-byte entries and
// writes k, so the main path's merge (n = 2**20, k = kin = 250) moves 6.3
// GB, 1.9 ms at 3.35 TB/s; its comparisons are few next to that, so bytes
// bound the function.
//
// The design: a warp a row, walking the rows grid-stride, its scratch in
// shared memory (as many warps a block as keep the most warps on an SM),
// or in a global buffer the wrapper allocates when two warps' scratch
// would not fit a block.  The lanes read the row once, coalesced, 16
// entries a lane in flight, and issue the next row's loads before merging
// this one; each live entry (nbr >= 0, w > -inf) is keyed as the 64-bit
// (f32 key of -w) << 32 | nbr, the order of ref.f32_sort_key.
// Cross-input duplicates are found through an open-addressing table of
// the row's positions (16-bit slots, linear probing, at most half full)
// filled without atomics: in each round every lane reads its slot, the
// warp synchronises, the lanes that found it free store, the warp
// synchronises again and reads back whose store stayed (so no lane's read
// can see a store of the same round); the lighter instance is dropped,
// the slab's staying on an exact tie.  An input that lost entries is
// compacted by ballots, and a merge path over the two sorted lists gives
// each lane a run of the first k outputs, found by one binary search; the
// weights are copied by position, so every bit is the input's.  What
// bounds it: instruction issue, some 1,500 warp instructions a row
// (staging, table, merge) beside its 4 KB of device traffic.
//
// The preconditions of the merge, which the accumulator's traffic meets by
// construction: each input's live entries are a prefix of its row,
// strictly increasing in that 64-bit key, with no neighbour twice, and no
// NaN weight on a live id.  The kernel checks them as it goes (one
// comparison an entry, and the table's inserts).  A row that breaks one
// is counted in the device counter the wrapper passes (no host
// synchronisation) and merged in the same launch, by its warp, through
// two bitonic sorts that assume nothing of the row: keyed (nbr, -w,
// position) to keep the first instance of each neighbour, then re-keyed
// (-w, nbr) for the top k.  The scratch is sized for that too (12 bytes
// each of next_pow2(k + kin) keys).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;     // most rows (warps) a block
constexpr uint32_t kBig = 0x7FFFFFFFu;    // empty-slot neighbour key
constexpr uint32_t kFirst = 0x80000000u;  // survivor flag on a position
constexpr uint64_t kDead = ~0ull;         // key of an entry that is not live
constexpr int kU = 16;                    // entries a lane stages at once

struct Args {
  const int32_t* slab_nbr;  // (n, k)
  const float* slab_w;
  const int32_t* inc_nbr;   // (n, kin)
  const float* inc_w;
  int32_t* out_nbr;         // (n, k)
  float* out_w;
  long long n;
  int k, kin;
};

// Orders like the float values, as lax.sort compares them: -0.0 equals
// 0.0 and NaN sorts after +inf.
__device__ __forceinline__ uint32_t f32_key(float x) {
  if (x == 0.f) x = 0.f;
  uint32_t b = __float_as_uint(x);
  if (isnan(x)) b = 0x7FC00000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Sorts P (a power of two) keys with their positions by (key, position),
// by one warp.
__device__ void bitonic_sort(uint64_t* key, uint32_t* pos, int P) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const uint64_t a = key[lo], b = key[hi];
        const uint32_t pa = pos[lo], pb = pos[hi];
        const bool a_after_b = a > b || (a == b && pa > pb);
        if (a_after_b == up) {
          key[lo] = b;
          key[hi] = a;
          pos[lo] = pb;
          pos[hi] = pa;
        }
      }
      __syncwarp();
    }
  }
}

// Merge row `row` by one warp through two bitonic sorts, in scratch of P
// keys and positions: the fallback for a row that breaks the merge's
// preconditions.
__device__ void bitonic_row(const Args& a, long long row, uint64_t* key,
                            uint32_t* pos, int P) {
  const int lane = threadIdx.x & 31, k = a.k, K = a.k + a.kin;
  const uint32_t inf_key = f32_key(INFINITY);
  const int32_t* snbr = a.slab_nbr + row * k;
  const float* sw = a.slab_w + row * k;
  const int32_t* inbr = a.inc_nbr + row * a.kin;
  const float* iw = a.inc_w + row * a.kin;
  auto weight = [&](int i) { return i < k ? sw[i] : iw[i - k]; };

  for (int i = lane; i < P; i += 32) {
    uint32_t nk = kBig, wk = inf_key;
    if (i < K) {
      const int nb = i < k ? snbr[i] : inbr[i - k];
      if (nb >= 0) {
        nk = static_cast<uint32_t>(nb);
        wk = f32_key(-weight(i));
      }
    }
    key[i] = (static_cast<uint64_t>(nk) << 32) | wk;
    pos[i] = static_cast<uint32_t>(i);
  }
  __syncwarp();
  bitonic_sort(key, pos, P);

  // flag the first (heaviest) instance of each neighbour, then re-key the
  // survivors as (-w, nbr) so that they rank by weight desc, nbr asc
  for (int i = lane; i < P; i += 32) {
    const uint32_t nk = static_cast<uint32_t>(key[i] >> 32);
    const bool first = i == 0
        || nk != static_cast<uint32_t>(key[i - 1] >> 32);
    if (first && nk != kBig) pos[i] |= kFirst;
  }
  __syncwarp();
  for (int i = lane; i < P; i += 32) {
    const uint64_t kk = key[i];
    key[i] = (pos[i] & kFirst)
        ? (static_cast<uint64_t>(static_cast<uint32_t>(kk)) << 32) | (kk >> 32)
        : (static_cast<uint64_t>(inf_key) << 32) | kBig;
    pos[i] &= ~kFirst;
  }
  __syncwarp();
  bitonic_sort(key, pos, P);

  for (int i = lane; i < k; i += 32) {
    const uint32_t wk = static_cast<uint32_t>(key[i] >> 32);
    const bool valid = wk != inf_key;
    a.out_nbr[row * k + i] = valid
        ? static_cast<int32_t>(static_cast<uint32_t>(key[i])) : -1;
    a.out_w[row * k + i] = valid ? weight(pos[i]) : -INFINITY;
  }
  __syncwarp();                       // the scratch is free for the next row
}

// Scratch of one warp (bytes): the row's keys (8 K), weight bits (4 K) and
// drop flags (K), then the id table (H slots of positions in the row, 2
// bytes each below 65,535 entries a row, else 4; H >= 2 K and >= 32, the
// most a row's table takes), whose space holds the staged output (8 k)
// once the table is done.  The bitonic fallback
// takes keys and positions of P entries (12 P) from the start.  The table
// and each warp's scratch start on 16 bytes (the table is cleared by
// 16-byte stores).
struct Layout {
  int K, H, P;
  long long table_off, bytes;
};

inline int pow2_at_least(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// An empty table slot (a slot holds a position in the row).
template <class Slot>
__host__ __device__ constexpr uint32_t free_slot() {
  return static_cast<Slot>(~0u);
}

inline bool narrow_slots(int k, int kin) { return k + kin < 65535; }

inline Layout merge_layout(int k, int kin) {
  Layout L;
  L.K = k + kin;
  L.H = pow2_at_least(2ll * L.K < 32 ? 32 : 2ll * L.K);  // a row's table
  L.P = pow2_at_least(L.K < 2 ? 2 : L.K);
  L.table_off = (13ll * L.K + 15) / 16 * 16;
  const long long slots = (narrow_slots(k, kin) ? 2ll : 4ll) * L.H;
  const long long merge = L.table_off + (slots > 8ll * k ? slots : 8ll * k);
  const long long sort = 12ll * L.P;
  L.bytes = ((merge > sort ? merge : sort) + 15) / 16 * 16;
  return L;
}

// kU entries of a row a lane: entries b0 + 32 u + lane, u < kU, of the
// row's slab entries followed by its incoming ones (-1 past the end).
struct Batch {
  int nbr[kU];
  float w[kU];
};

__device__ __forceinline__ void load_batch(const Args& a, long long row,
                                           int b0, Batch& x) {
  const int lane = threadIdx.x & 31, k = a.k, K = a.k + a.kin;
  const int32_t* snbr = a.slab_nbr + row * k;
  const float* sw = a.slab_w + row * k;
  const int32_t* inbr = a.inc_nbr + row * a.kin;
  const float* iw = a.inc_w + row * a.kin;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = b0 + 32 * u + lane;
    x.nbr[u] = -1;
    x.w[u] = 0.f;
    if (i < k) {
      x.nbr[u] = snbr[i];
      x.w[u] = sw[i];
    } else if (i < K) {
      x.nbr[u] = inbr[i - k];
      x.w[u] = iw[i - k];
    }
  }
}

// Merge row `row` by one warp, its first batch already in `x`; before it
// checks the row, it loads the first batch of row `next` (if any) into
// `x`, so that those loads land while this row merges.  Returns false if
// the row breaks the preconditions (nothing written then).
template <class Slot>
__device__ __forceinline__ bool merge_row(const Args& a, const Layout& L,
                                          long long row, long long next,
                                          unsigned char* base, Batch& x) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1;
  const int k = a.k, K = L.K;
  const uint32_t inf_key = f32_key(INFINITY);
  uint64_t* key = reinterpret_cast<uint64_t*>(base);
  uint32_t* wbits = reinterpret_cast<uint32_t*>(base + 8ll * K);
  uint8_t* drop = base + 12ll * K;
  Slot* table = reinterpret_cast<Slot*>(base + L.table_off);
  constexpr uint32_t kFree = free_slot<Slot>();
  bool bad = false;

  // 1) stage the row's keys and weight bits, kU entries a lane at a time
  //    (all their loads in flight together), checking on the way that each
  //    input's live entries are a strictly increasing prefix: an entry's
  //    predecessor is the lane below's, or the last batch's lane 31's
  int na = 0, nb = 0;
  uint64_t carry = kDead;
  for (int b0 = 0; b0 < K; b0 += 32 * kU) {
    if (b0 > 0) load_batch(a, row, b0, x);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = b0 + 32 * u + lane;
      const uint32_t wk = f32_key(-x.w[u]);
      const bool live = x.nbr[u] >= 0 && wk < inf_key;
      bad |= x.nbr[u] >= 0 && isnan(x.w[u]);
      const uint64_t cur = live
          ? (static_cast<uint64_t>(wk) << 32) | static_cast<uint32_t>(x.nbr[u])
          : kDead;
      uint64_t prev = __shfl_up_sync(~0u, cur, 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(~0u, cur, 31);
      if (live && i != 0 && i != k) bad |= !(prev < cur);
      if (i < K) {
        key[i] = cur;
        wbits[i] = __float_as_uint(x.w[u]);
        drop[i] = 0;
      }
      na += __popc(__ballot_sync(~0u, live && i < k));
      nb += __popc(__ballot_sync(~0u, live && i >= k));
    }
  }
  if (next < a.n) load_batch(a, next, 0, x);
  if (__any_sync(~0u, bad)) return false;

  // 2) cross-input duplicates through a table of the live ids, sized to
  //    the row (at most half full), without atomics: the slab's entries
  //    first, then the incoming ones, each lane taking its entries (lane,
  //    lane + 32, ...) one after another; an entry takes the first free
  //    slot from h(id) on by a plain store, and the warp reads its slots
  //    back after each round (a lane whose store lost goes on to the next
  //    slot).  An entry passes every earlier-placed entry of its id, and
  //    two entries of one id never overtake one another (each moves one
  //    slot a round from the same start), so an incoming entry meets the
  //    slab's instance (a cross-input duplicate: the lighter instance is
  //    dropped, the slab's on an exact tie) and a second instance within
  //    one input meets the first (a broken row).  Each round reads the
  //    slots, then stores into the free ones, then reads back, with a
  //    warp barrier between, so the order holds without a converged warp.
  const int live = na + nb;
  bool drops_a = false, drops_b = false;    // the lane dropped an entry
  int log_h = 5;
  while ((1 << log_h) < 2 * live) ++log_h;
  const uint32_t hmask = (1u << log_h) - 1;
  for (int j = lane; j < (1 << log_h) * static_cast<int>(sizeof(Slot)) / 16;
       j += 32)
    reinterpret_cast<uint4*>(table)[j] = make_uint4(~0u, ~0u, ~0u, ~0u);
  __syncwarp();
  for (int pass = 0; pass < 2; ++pass) {
    const int off = pass == 0 ? 0 : k, cnt = pass == 0 ? na : nb;
    int e = lane;
    uint32_t idx = 0, id = 0, h = 0;
    auto take = [&]() {
      idx = off + e;
      id = static_cast<uint32_t>(key[idx]);
      h = (id * 0x9E3779B1u) >> (32 - log_h);
    };
    bool todo = e < cnt;
    if (todo) take();
    while (__any_sync(~0u, todo)) {
      // every lane reads before any lane stores, so that a lane finds a
      // slot free only if no entry of an earlier round holds it
      uint32_t occ = todo ? table[h] : kFree;
      __syncwarp();
      if (todo && occ == kFree) table[h] = static_cast<Slot>(idx);
      __syncwarp();
      if (todo) {
        if (occ == kFree) occ = table[h];       // whose store stayed
        if (occ == idx) {
          e += 32;                              // placed: the lane's next
          todo = e < cnt;
          if (todo) take();
        } else {
          if (static_cast<uint32_t>(key[occ]) == id) {
            if (pass == 0 || occ >= static_cast<uint32_t>(k)) {
              bad = true;                       // twice in one input
            } else {
              // the heavier instance stays; the slab's on an exact tie
              const bool slab_stays = (key[occ] >> 32) <= (key[idx] >> 32);
              drop[slab_stays ? idx : occ] = 1;
              (slab_stays ? drops_b : drops_a) = true;
            }
          }
          h = (h + 1) & hmask;
        }
      }
      __syncwarp();
    }
  }
  if (__any_sync(~0u, bad)) return false;

  // 3) compact each input's survivors in place (a survivor moves down
  //    only, past entries already read); an input that lost nothing stays
  //    as it is (the slab, mostly: a pair found again ties exactly)
  int ra = na, rb = nb;
  for (int pass = 0; pass < 2; ++pass) {
    if (!__any_sync(~0u, pass == 0 ? drops_a : drops_b)) continue;
    const int off = pass == 0 ? 0 : k, cnt = pass == 0 ? na : nb;
    int r = 0;
    for (int b0 = 0; b0 < cnt; b0 += 32) {
      const int i = off + b0 + lane;
      const bool keep = b0 + lane < cnt && !drop[i];
      uint64_t kv = 0;
      uint32_t wv = 0;
      if (keep) {
        kv = key[i];
        wv = wbits[i];
      }
      const unsigned m = __ballot_sync(~0u, keep);
      if (keep) {
        const int to = off + r + __popc(m & lt);
        key[to] = kv;
        wbits[to] = wv;
      }
      r += __popc(m);
    }
    (pass == 0 ? ra : rb) = r;
  }
  __syncwarp();

  // 4) merge path: lane l writes outputs [l * per, (l + 1) * per) of the
  //    first m, staged in the table's space, then the warp stores the row
  const uint64_t* A = key;
  const uint64_t* B = key + k;
  const int m = min(k, ra + rb);
  const int per = (m + 31) / 32;
  uint32_t* s_nbr = reinterpret_cast<uint32_t*>(table);
  uint32_t* s_w = s_nbr + k;
  const int d0 = min(lane * per, m), d1 = min(d0 + per, m);
  if (d0 < d1) {
    int lo = max(0, d0 - rb), hi = min(d0, ra);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (A[mid] < B[d0 - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    // the two lists' heads in registers (kDead past an end)
    int i = lo, j = d0 - lo;
    uint64_t ha = i < ra ? A[i] : kDead, hb = j < rb ? B[j] : kDead;
    for (int d = d0; d < d1; ++d) {
      const bool take_a = ha < hb;
      const uint64_t kv = take_a ? ha : hb;
      s_nbr[d] = static_cast<uint32_t>(kv);
      s_w[d] = wbits[take_a ? i : k + j];
      if (take_a) {
        ++i;
        ha = i < ra ? A[i] : kDead;
      } else {
        ++j;
        hb = j < rb ? B[j] : kDead;
      }
    }
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    a.out_nbr[row * k + i] = i < m ? static_cast<int32_t>(s_nbr[i]) : -1;
    a.out_w[row * k + i] = i < m ? __uint_as_float(s_w[i]) : -INFINITY;
  }
  __syncwarp();                       // the scratch is free for the next row
  return true;
}

template <bool kGlobal, class Slot>
__global__ void __launch_bounds__(kThreads, 3)
topk_merge_kernel(Args a, Layout L, unsigned char* scratch,
                  unsigned long long* violations) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  unsigned char* base = kGlobal ? scratch + gw * L.bytes
                                : s_raw + warp * L.bytes;
  Batch x;
  if (gw < a.n) load_batch(a, gw, 0, x);
  for (long long row = gw; row < a.n; row += stride) {
    if (merge_row<Slot>(a, L, row, row + stride, base, x)) continue;
    if ((threadIdx.x & 31) == 0) atomicAdd(violations, 1ull);
    __syncwarp();
    bitonic_row(a, row, reinterpret_cast<uint64_t*>(base),
                reinterpret_cast<uint32_t*>(base + 8ll * L.P), L.P);
  }
}

// How a launch is laid out: its grid, dynamic shared memory, and the
// global scratch it needs (0 when the scratch is shared memory).
struct Plan {
  bool global;
  int threads;
  long long grid, smem, scratch;
};

int plan(long long n, int k, int kin, Plan* out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(
              &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(
              &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
             != cudaSuccess)
    return static_cast<int>(err);
  // a warp a row, up to kWarps a block; shared scratch where at least two
  // warps' worth fits a block, else a global buffer for one block of
  // kWarps an SM
  Plan p{};
  const Layout L = merge_layout(k, kin);
  p.global = 2 * L.bytes > optin;
  int warps = kWarps, per_sm = 1;
  if (!p.global) {
    // the block size (up to kWarps warps) that keeps the most warps on an SM
    auto kernel = narrow_slots(k, kin)
        ? topk_merge_kernel<false, uint16_t>
        : topk_merge_kernel<false, uint32_t>;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
        != cudaSuccess)
      return static_cast<int>(err);
    int best = 0;
    for (int w = kWarps; w >= 1; --w) {
      if (w * L.bytes > optin) continue;
      int blocks = 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, kernel, 32 * w, w * L.bytes)) != cudaSuccess)
        return static_cast<int>(err);
      if (w * blocks > best) {
        best = w * blocks;
        warps = w;
        per_sm = blocks;
      }
    }
  }
  p.threads = 32 * warps;
  const long long blocks = (n + warps - 1) / warps;
  const long long fill = static_cast<long long>(sms) * per_sm;
  p.grid = blocks < fill ? blocks : fill;
  p.smem = p.global ? 0 : warps * L.bytes;
  p.scratch = p.global ? p.grid * warps * L.bytes : 0;
  *out = p;
  return 0;
}

}  // namespace

// Bytes of global scratch that a launch at (n, k, kin) needs on the
// current device; negative: a CUDA error.
extern "C" long long topk_merge_scratch_bytes(long long n, int k, int kin) {
  Plan p;
  const int err = plan(n, k, kin, &p);
  return err ? -static_cast<long long>(err) : p.scratch;
}

// Launch on `stream` with `scratch` of `scratch_bytes` (as
// topk_merge_scratch_bytes asks) and the counter of rows that break the
// merge's preconditions; returns cudaGetLastError() (0 on success).
extern "C" int topk_merge_launch(const int32_t* slab_nbr, const float* slab_w,
                                 const int32_t* inc_nbr, const float* inc_w,
                                 int32_t* out_nbr, float* out_w, long long n,
                                 int k, int kin, void* scratch,
                                 long long scratch_bytes,
                                 unsigned long long* violations,
                                 void* stream) {
  if (n == 0 || k == 0) return 0;
  Plan p;
  int err = plan(n, k, kin, &p);
  if (err) return err;
  if (scratch_bytes < p.scratch || (p.scratch > 0 && scratch == nullptr)
      || violations == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{slab_nbr, slab_w, inc_nbr, inc_w, out_nbr, out_w, n, k, kin};
  const Layout L = merge_layout(k, kin);
  const bool narrow = narrow_slots(k, kin);
  auto kernel = p.global
      ? (narrow ? topk_merge_kernel<true, uint16_t>
                : topk_merge_kernel<true, uint32_t>)
      : (narrow ? topk_merge_kernel<false, uint16_t>
                : topk_merge_kernel<false, uint32_t>);
  kernel<<<static_cast<unsigned>(p.grid), p.threads, p.smem,
           static_cast<cudaStream_t>(stream)>>>(
      a, L, static_cast<unsigned char*>(scratch), violations);
  return static_cast<int>(cudaGetLastError());
}
