// CRUSH placement for the bulk evaluator (sm_90a): crush_do_rule for one
// take, one choose step and an emit, over a batch of inputs x.
//
// Replaces no TPU kernel: the JAX package's bulk evaluator
// (ceph_tpu/crush/bulk.py) is vmapped XLA, and so is the port's eager torch
// tier (crush/bulk.py), which stays as the CPU twin and as the deeper rungs
// of the ladder.  It was added because that tier builds, for every lane, a
// (tries x replicas x bucket width) grid of straw2 draws before it knows
// which try succeeds: 14,300 draws a lane on the remap cell's first rung
// (13 tries, 11 wide, 100 hosts), each an eager chain of int32/int64
// kernels, where mapper.c makes ~1,250 when nothing collides.
//
// Design: mapper.c's own control flow, one warp per input.
//   - crush_choose_indep (choose_indep / chooseleaf_indep) and
//     crush_choose_firstn (choose_firstn / chooseleaf_firstn) under the
//     jewel tunables: the rounds or reps in C's order, each try's descent
//     from the take bucket, collisions, the leaf recursion (indep: left 1 at
//     position rep, r = rep + parent_r + numrep * ftotal, no leaf dedup
//     across positions; firstn: numrep 1, r = sub_r + ftotal with sub_r = r,
//     leaves deduplicated against out2[0, outpos)), is_out against the
//     reweight vector, C's NONE holes where the indep budget runs out.  The
//     budgets are the rule's own (choose_total_tries + 1 or
//     set_choose_tries; set_chooseleaf_tries or 1), so every lane the
//     kernel places is C's answer and nothing is left to a deeper rung.
//   - A bucket's straw2 draws are spread over the warp's 32 threads, slot
//     i on thread i % 32: hash32_3(x, id, r) & 0xffff, the numerator
//     2^48 - crush_ln(u) from the 64 Ki-entry table (`negln`, 512 KB,
//     read through the read-only path and L2-resident), its quotient by
//     the weight.  C keeps the first maximal draw; that is the first
//     minimal quotient, so each thread folds its slots into the key
//     (quotient << 15 | slot) and a shuffle butterfly takes the minimum:
//     the lowest slot wins a tie.  A weight of 0 draws the largest
//     quotient (C's S64_MIN).  Buckets are below 2^15 slots (the scope).
//   - Everything else is warp-uniform: every thread computes the same
//     descent, collision test and try count.  The output vectors out /
//     out2 live one slot per thread (result_max <= 32), so a collision
//     test is one __any_sync and a write is the owning thread's.
//   - The tables are the CompiledCrushMap's, flattened once per map
//     (CompiledCrushMap.kernel_tables): one int32 buffer of the bucket rows
//     (first slot, size, type), the id -> row map, the items, the hash ids
//     (choose_args ids) and the weights per choose_args position.
// The wrapper (ops/crush_kernels.py) decides the scope before dispatch from
// the map and the rule: straw2 buckets below the take, one take, one choose,
// an emit, jewel tunables; a descent deeper than CRUSH_MAX_DEPTH (a map
// with a cycle) flags the lane's need_host and leaves it to the ladder.
//
// What bounds it: operations.  A draw is ~150 INT32 operations (the three
// hashmix rounds of hash32_3, a 64-bit division, the key); the remap cell
// (16384 inputs, 11 wide over 100 hosts x 12) needs ~16384 x 11 x 112
// draws when nothing collides, ~3 G operations, ~0.18 ms at 16.7 T INT32
// operations a second.  Bytes are small: 8 B of x and 48 B of output a
// lane, the tables (~100 KB) and negln in L2.  One warp a lane fills the
// card's thread slots at 16384 lanes, where one thread a lane would fill
// about 6 % of them.

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define CRUSH_WARPS 4
#define CRUSH_THREADS (CRUSH_WARPS * 32)
#define CRUSH_MAX_DEPTH 16
#define CRUSH_MAX_RESULT 32
#define CRUSH_SLOT_BITS 15

static constexpr unsigned FULL = 0xffffffffu;
static constexpr int ITEM_NONE = 0x7fffffff;
static constexpr int ITEM_UNDEF = 0x7ffffffe;
static constexpr uint32_t HASH_SEED = 1315423911u;
// the quotient of a weight-0 slot: above every real one (<= 2^48)
static constexpr unsigned long long ZERO_WEIGHT_Q = (1ull << 49) - 1;

enum Pick { PICK_OK = 0, PICK_EMPTY = 1, PICK_BAD = 2, PICK_DEEP = 3 };

struct Tables {
  const int* hdr;           // rows x 3: first slot, size, type
  const int* id_row;        // bucket id -1-i -> its row
  const int* items;         // the flat slots
  const int* ids;           // their hash ids (choose_args ids)
  const uint32_t* weights;  // positions x n_items
  const long long* negln;   // 2^48 - crush_ln(u), u < 2^16
  int n_items;
  int positions;
};

struct Rule {
  int take_row;
  int numrep;      // the step's numrep (result_max added when <= 0)
  int slots;       // indep: min(numrep, result_max); firstn: result_max
  int type;
  int recurse;     // chooseleaf
  int firstn;
  int tries;
  int leaf_tries;
  int max_devices;
  int result_max;
};

__device__ __forceinline__ void hashmix(uint32_t& a, uint32_t& b,
                                        uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

// hash.c -> crush_hash32_rjenkins1_2
__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = HASH_SEED ^ a ^ b, x = 231232u, y = 1232u;
  hashmix(a, b, h);
  hashmix(x, a, h);
  hashmix(b, y, h);
  return h;
}

// hash.c -> crush_hash32_rjenkins1_3
__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b,
                                             uint32_t c) {
  uint32_t h = HASH_SEED ^ a ^ b ^ c, x = 231232u, y = 1232u;
  hashmix(a, b, h);
  hashmix(c, x, h);
  hashmix(y, a, h);
  hashmix(b, x, h);
  hashmix(y, c, h);
  return h;
}

__device__ __forceinline__ int row_of(const Tables& t, int item) {
  return t.id_row[-1 - item];
}

// mapper.c -> bucket_straw2_choose over bucket row `row`; every thread of
// the warp returns the winner.
__device__ int straw2(const Tables& t, int row, uint32_t x, uint32_t r,
                      int pos, int lane) {
  const int first = t.hdr[3 * row], size = t.hdr[3 * row + 1];
  const uint32_t* w =
      t.weights +
      static_cast<long long>(min(pos, t.positions - 1)) * t.n_items + first;
  unsigned long long best = ~0ull;
  for (int i = lane; i < size; i += 32) {
    const uint32_t wi = __ldg(w + i);
    unsigned long long q = ZERO_WEIGHT_Q;
    if (wi) {
      const uint32_t u =
          hash32_3(x, static_cast<uint32_t>(__ldg(t.ids + first + i)), r) &
          0xffffu;
      q = static_cast<unsigned long long>(__ldg(t.negln + u)) / wi;
    }
    const unsigned long long key =
        (q << CRUSH_SLOT_BITS) | static_cast<unsigned>(i);
    best = key < best ? key : best;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, best, off);
    best = o < best ? o : best;
  }
  return __ldg(t.items + first +
               static_cast<int>(best & ((1u << CRUSH_SLOT_BITS) - 1)));
}

// The descent of one try from bucket row `row` to an item of `type`, at the
// same r on every level (no uniform bucket is in scope): PICK_OK with the
// item, PICK_EMPTY at an empty bucket, PICK_BAD where C gives up the slot
// (an item at or past max_devices, a device of the wrong type), PICK_DEEP
// past CRUSH_MAX_DEPTH picks.
__device__ int descend(const Tables& t, const Rule& rule, int row, int type,
                       uint32_t x, int r, int pos, int lane, int* out) {
  for (int depth = 0; depth < CRUSH_MAX_DEPTH; ++depth) {
    if (t.hdr[3 * row + 1] == 0) return PICK_EMPTY;
    const int item = straw2(t, row, x, static_cast<uint32_t>(r), pos, lane);
    if (item >= rule.max_devices) return PICK_BAD;
    const int itype = item < 0 ? t.hdr[3 * row_of(t, item) + 2] : 0;
    if (itype != type) {
      if (item >= 0) return PICK_BAD;
      row = row_of(t, item);
      continue;
    }
    *out = item;
    return PICK_OK;
  }
  return PICK_DEEP;
}

// mapper.c -> is_out (devices only)
__device__ __forceinline__ bool is_out(const long long* weight, int n_weight,
                                       int item, uint32_t x) {
  if (item >= n_weight) return true;
  const long long w = weight[item];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return !(static_cast<long long>(hash32_2(x, static_cast<uint32_t>(item)) &
                                  0xffffu) < w);
}

// crush_choose_indep's leaf recursion: left 1 at position `rep`, type 0,
// the parent's numrep stride, r = rep + parent_r + numrep * ftotal.
__device__ int indep_leaf(const Tables& t, const Rule& rule, int row,
                          uint32_t x, int rep, int parent_r,
                          const long long* weight, int n_weight, int lane,
                          bool* deep) {
  for (int ftotal = 0; ftotal < rule.leaf_tries; ++ftotal) {
    int item;
    const int s = descend(t, rule, row, 0, x,
                          rep + parent_r + rule.numrep * ftotal, rep, lane,
                          &item);
    if (s == PICK_DEEP) *deep = true;
    if (s == PICK_DEEP || s == PICK_BAD) return ITEM_NONE;
    if (s == PICK_EMPTY || is_out(weight, n_weight, item, x)) continue;
    return item;
  }
  return ITEM_NONE;
}

// crush_choose_firstn's leaf recursion: numrep 1 (stable), position
// `outpos`, r = sub_r + ftotal, leaves deduplicated against out2[0, outpos).
// ITEM_NONE where it places nothing.
__device__ int firstn_leaf(const Tables& t, const Rule& rule, int row,
                           uint32_t x, int outpos, int sub_r, int o2,
                           const long long* weight, int n_weight, int lane,
                           bool* deep) {
  for (int ftotal = 0; ftotal < rule.leaf_tries; ++ftotal) {
    int item;
    const int s = descend(t, rule, row, 0, x, sub_r + ftotal, outpos, lane,
                          &item);
    if (s == PICK_DEEP) *deep = true;
    if (s == PICK_DEEP || s == PICK_BAD) return ITEM_NONE;
    if (s == PICK_EMPTY) continue;
    if (__any_sync(FULL, lane < outpos && o2 == item)) continue;
    if (is_out(weight, n_weight, item, x)) continue;
    return item;
  }
  return ITEM_NONE;
}

__global__ void __launch_bounds__(CRUSH_THREADS)
crush_rule_kernel(const Tables t, const Rule rule,
                  const long long* __restrict__ xs, long long n,
                  const long long* __restrict__ weight, int n_weight,
                  int* __restrict__ out, long long* __restrict__ count,
                  bool* __restrict__ need) {
  const long long pg =
      static_cast<long long>(blockIdx.x) * CRUSH_WARPS + threadIdx.x / 32;
  if (pg >= n) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const uint32_t x = static_cast<uint32_t>(xs[pg]);
  bool deep = false;
  // out[lane] and out2[lane] of C's vectors
  int o = ITEM_UNDEF, o2 = ITEM_UNDEF;
  int placed;
  if (rule.firstn) {
    int outpos = 0;
    for (int rep = 0; rep < rule.numrep && outpos < rule.slots && !deep;
         ++rep) {
      for (int ftotal = 0; ftotal < rule.tries; ++ftotal) {
        const int r = rep + ftotal;
        int item;
        const int s = descend(t, rule, rule.take_row, rule.type, x, r,
                              outpos, lane, &item);
        if (s == PICK_DEEP) deep = true;
        if (s == PICK_DEEP || s == PICK_BAD) break;  // skip the rep
        if (s == PICK_EMPTY) continue;               // reject
        if (__any_sync(FULL, lane < outpos && o == item)) continue;
        if (rule.recurse) {
          int leaf = item;
          if (item < 0) {
            leaf = firstn_leaf(t, rule, row_of(t, item), x, outpos, r, o2,
                               weight, n_weight, lane, &deep);
            if (deep) break;
            if (leaf == ITEM_NONE) continue;
          }
          if (lane == outpos) o2 = leaf;
        }
        if (rule.type == 0 && is_out(weight, n_weight, item, x)) continue;
        if (lane == outpos) o = item;
        ++outpos;
        break;
      }
    }
    placed = outpos;
  } else {
    int left = rule.slots;
    for (int ftotal = 0; left > 0 && ftotal < rule.tries && !deep;
         ++ftotal) {
      for (int rep = 0; rep < rule.slots; ++rep) {
        if (__shfl_sync(FULL, o, rep) != ITEM_UNDEF) continue;
        const int r = rep + rule.numrep * ftotal;
        int item;
        const int s = descend(t, rule, rule.take_row, rule.type, x, r, 0,
                              lane, &item);
        if (s == PICK_DEEP) {
          deep = true;
          break;
        }
        if (s == PICK_EMPTY) continue;
        if (s == PICK_BAD) {
          if (lane == rep) o = o2 = ITEM_NONE;
          --left;
          continue;
        }
        if (__any_sync(FULL, lane < rule.slots && o == item)) continue;
        if (rule.recurse) {
          int leaf = item;
          if (item < 0) {
            leaf = indep_leaf(t, rule, row_of(t, item), x, rep, r, weight,
                              n_weight, lane, &deep);
            if (deep) break;
          }
          if (lane == rep) o2 = leaf;
          if (leaf == ITEM_NONE) continue;
        }
        if (rule.type == 0 && is_out(weight, n_weight, item, x)) continue;
        if (lane == rep) o = item;
        --left;
      }
    }
    placed = rule.slots;
  }
  int v = rule.recurse ? o2 : o;
  if (v == ITEM_UNDEF || lane >= placed) v = ITEM_NONE;
  if (lane < rule.result_max) out[pg * rule.result_max + lane] = v;
  if (lane == 0) {
    count[pg] = placed;
    need[pg] = deep;
  }
}

extern "C" {

int crush_rule_max_depth(void) { return CRUSH_MAX_DEPTH; }

int crush_rule_max_result(void) { return CRUSH_MAX_RESULT; }

const char* crush_rule_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Place `n` inputs xs (int64, device memory) by the rule described by the
// ints of `rule_args` (take_row, numrep, slots, type, recurse, firstn,
// tries, leaf_tries, max_devices, result_max) over the flattened tables
// `tab` (int32, device memory: rows x 3 bucket rows, max_neg + 1 id rows,
// n_items items, n_items hash ids, positions x n_items weights) and `negln`
// (65536 int64), with the reweight vector `weight` (n_weight int64).
// Writes out (n, result_max) int32, count (n,) int64, need (n,) bool.  One
// launch on `stream`; returns its CUDA error.
int crush_rule_launch(const int* tab, int rows, int max_neg, int n_items,
                      int positions, const long long* negln,
                      const int* rule_args, const long long* xs, long long n,
                      const long long* weight, int n_weight, int* out,
                      long long* count, bool* need, int device,
                      void* stream) {
  Rule rule;
  rule.take_row = rule_args[0];
  rule.numrep = rule_args[1];
  rule.slots = rule_args[2];
  rule.type = rule_args[3];
  rule.recurse = rule_args[4];
  rule.firstn = rule_args[5];
  rule.tries = rule_args[6];
  rule.leaf_tries = rule_args[7];
  rule.max_devices = rule_args[8];
  rule.result_max = rule_args[9];
  const long long blocks = (n + CRUSH_WARPS - 1) / CRUSH_WARPS;
  if (n < 1 || blocks > 0x7FFFFFFFLL || rows < 1 || max_neg < 0 ||
      n_items < 0 || positions < 1 || rule.take_row < 0 ||
      rule.take_row >= rows || rule.numrep < 1 || rule.slots < 1 ||
      rule.slots > CRUSH_MAX_RESULT || rule.result_max < 1 ||
      rule.result_max > CRUSH_MAX_RESULT || rule.slots > rule.result_max ||
      rule.tries < 1 || rule.leaf_tries < 1 || n_weight < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Tables t;
  t.hdr = tab;
  t.id_row = tab + 3LL * rows;
  t.items = t.id_row + max_neg + 1;
  t.ids = t.items + n_items;
  t.weights = reinterpret_cast<const uint32_t*>(t.ids + n_items);
  t.negln = negln;
  t.n_items = n_items;
  t.positions = positions;
  return on_device(device, [&] {
    crush_rule_kernel<<<static_cast<unsigned>(blocks), CRUSH_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        t, rule, xs, n, weight, n_weight, out, count, need);
    return cudaGetLastError();
  });
}

}  // extern "C"
