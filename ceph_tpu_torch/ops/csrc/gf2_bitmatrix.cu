// GF(2) bitmatrix apply in jerasure's packet layout, for Hopper (sm_90a).
//
// A chunk of C bytes is nb = C / (w * packetsize) blocks of w packets of
// `packetsize` bytes.  Output packet (i, l) of a block is the XOR of the
// input packets (j, lb) of the same block whose bit is set in the
// (r*w, s*w) bitmatrix; blocks never mix.
//
// One kernel, gf2_packet_kernel, runs "rows": a row XORs a list of slots
// (input packets, or results of earlier rows), keeps the result in a slot
// when a later row reads it, and stores it when it is an output packet.
// It replaces two TPU kernels of the JAX package
// (ceph_tpu/ops/pallas_gf.py), behind two wrappers in ops/gf_kernels.py
// that differ only in the rows they hand it:
//   - apply_bitmatrix_pallas (body _bitmatrix_kernel), the plain product:
//     one row per output packet, its leaves the input packets of its mask
//     (apply_bitmatrix_cuda; rows from xor_schedule.plain_row_program);
//   - apply_bitmatrix_xor_pallas (body _bitmatrix_xor_kernel), the product
//     through a CSE schedule (ops/xor_schedule.py): one row per node the
//     schedule must make (a temp read twice, or an output), its leaves the
//     inputs and temps under it, so shared temps are XORed once
//     (apply_bitmatrix_xor_cuda; rows from xor_schedule.row_program).
//
// Design:
//   - The matrix is data, not code: each product's rows are a program of
//     int32 words (ops/gf_kernels.py::packet_program, built once per
//     (matrix, row groups), uploaded once and cached), so one binary
//     serves the encode and every decode pattern.  Each block stages its
//     row group's stream from that device buffer into shared memory once
//     and walks it there: every thread reads the same word at the same
//     time (a broadcast), so the walk is the same for the whole block.
//     Read in place from the constant bank as a by-value argument, the
//     program slowed the scheduled products by a quarter; staged, the
//     by-value form only tied the buffer (PERF.md, PR 8), so the buffer
//     alone is left.
//   - A thread walks "units": V bytes (16, 8, 4 or 1, the widest that the
//     packet size, pointers and strides allow and that leaves the plan's
//     warps per SM) at one offset of one block of one stripe; consecutive
//     threads take consecutive units of a packet, so every load and store
//     coalesces.  Slot s of a thread lies s * 16 bytes from its base: 16 / V
//     threads share each 16-byte row of slots, their rows repeating at an
//     odd pitch of 16-byte words, so a warp's accesses to one slot hit
//     distinct banks, no thread reads another's slots (no barrier), and a
//     leaf's offset in the program (slot * 16) serves every unit width.
//   - A row: its leaves fold two per three-input XOR (LOP3) in steps of
//     four pairs whose eight shared-memory reads are all issued before the
//     first XOR, then the rest (up to three pairs and the odd leaf) as one
//     case of a switch, straight-line; each leaf list starts on 16 bytes,
//     so a step reads its offsets in two broadcasts.  A row writes a slot
//     only when a later row reads it.  The packer works out each row's
//     stride to the next head, the case of its rest and its kept slot, so
//     the walk finds its way with no arithmetic and reads the next row's
//     head while this row runs.  Nodes are made
//     as the outputs first need them (xor_schedule.row_program), so a temp
//     holds its slot for a short part of the walk.
//   - Loads in flight while units are walked: the grid is persistent, one
//     wave of the card (gf_kernels.packet_plan), each thread walking units
//     u, u + stride, ...  The next unit's packet is copied by cp.async into
//     an input slot as soon as the row that last touches that slot has run
//     (the loads are numbered in that order, so a row's head only counts
//     them); other warps' walks cover the wait.  Threads past the last unit
//     walk too, their copies zero-filled and their stores predicated off:
//     no branch diverges inside the walk.  A block's last round hands on
//     nothing (a launch below one wave has only that round).  Two buffers
//     of slots (the next unit's inputs copied while this one is walked)
//     were slower at every shape measured: they halve the warps an SM
//     holds.
//   - Row groups: grid y splits the output packets into G groups, each
//     with a program that makes the closure of the nodes its outputs read
//     (a temp two groups need is made in both).  The plan takes G > 1 only
//     when the units alone do not fill one wave (small batches).
//
// Program (int32 words): [0] length, [1] G, [2 + g] the offset of group
// g's stream.  A stream: n_loads, n_rows, the loads (chunk j | packet lb
// << 16, load k into slot k, in the order their slots fall free), then the
// rows, each head at 2 mod 4 words of the stream (zero padding before it):
// the head (pairs | PK_SINGLE | PK_KEEP | PK_STORE | loads handed on <<
// PK_REFILL_SHIFT), a second word (the words to the next head | the case
// of the rest, 2 * (pairs % 4) + odd leaf, << PK_CASE_SHIFT | the kept
// result's offset << 16), the leaves' offsets (slot * 16) from the next 16
// bytes on, and the output (chunk i | packet l << 16) when the head says.
//
// What bounds it (H100 SXM, cauchy_good k=8 m=3, 64 stripes x (8 in + 3
// out) x 128 KiB, packetsize 2048): 92.3 MB moved is ~27.5 us at 3.35 TB/s,
// while the XORs, folded three inputs at a time by LOP3, are ~6e7 INT32
// operations (~4 us).  So memory bounds both products.  On an NVIDIA H100
// 80GB HBM3 at a 700 W power limit (PERF.md, PR 8) the plain product took
// 0.056 ms (0.49 of that bound) and the scheduled one 0.085 (0.33); the
// scheduled decode (3, 9) at 4 stripes 0.0072 ms.  The scheduled walk is
// issue-bound by its rows' control, not by loads (it takes as long with no
// global load at all): a leaf costs 3.4 issue slots, a row's head, flags
// and switch about 20, a load handed on about 8, and the schedule's 102
// rows carry 349 leaves, at 8 warps an SM.

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "on_device.cuh"

#define PK_PAIRS 0x3FF             // head: the row's pairs of leaves
#define PK_SINGLE (1 << 10)        // head: one more leaf
#define PK_KEEP (1 << 11)          // head: a later row reads the result
#define PK_STORE (1 << 12)         // head: the result is an output packet
#define PK_REFILL_SHIFT 13         // head: loads handed on after the row
#define PK_STRIDE 0xFFF            // 2nd word: words to the next head
#define PK_CASE_SHIFT 12           // 2nd word: 2 * (pairs % 4) + odd leaf
#define PK_MAX_THREADS 256

// Where units live.  A unit v is (stripe, block, unit of a packet) with
// the unit fastest; total units of a launch stay below 2^31.
struct PacketGeometry {
  long long in_bstride;   // bytes
  long long in_cstride;
  long long out_bstride;
  long long out_cstride;
  long long block_bytes;  // w * packetsize
  unsigned units;         // units per packet
  unsigned nb;            // blocks per chunk
  unsigned total;         // batch * nb * units
  int packetsize;
  int pitch;              // slots per thread (odd)
};

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint2 vxor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ uint32_t vxor(uint32_t a, uint32_t b) {
  return a ^ b;
}
__device__ __forceinline__ unsigned char vxor(unsigned char a,
                                              unsigned char b) {
  return a ^ b;
}

// The unit's result to an output packet, where `live` (a thread past the
// last unit stores nothing): predicated streaming stores, no branch.
__device__ __forceinline__ void store_out(unsigned char* p, uint4 v,
                                          bool live) {
  asm volatile(
      "{ .reg .pred q; setp.ne.u32 q, %5, 0;\n"
      "  @q st.global.cs.v4.u32 [%0], {%1, %2, %3, %4}; }\n" ::"l"(p),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(int(live))
      : "memory");
}
__device__ __forceinline__ void store_out(unsigned char* p, uint2 v,
                                          bool live) {
  asm volatile(
      "{ .reg .pred q; setp.ne.u32 q, %3, 0;\n"
      "  @q st.global.cs.v2.u32 [%0], {%1, %2}; }\n" ::"l"(p), "r"(v.x),
      "r"(v.y), "r"(int(live))
      : "memory");
}
__device__ __forceinline__ void store_out(unsigned char* p, uint32_t v,
                                          bool live) {
  asm volatile(
      "{ .reg .pred q; setp.ne.u32 q, %2, 0;\n"
      "  @q st.global.cs.u32 [%0], %1; }\n" ::"l"(p), "r"(v),
      "r"(int(live))
      : "memory");
}
__device__ __forceinline__ void store_out(unsigned char* p, unsigned char v,
                                          bool live) {
  if (live) *p = v;
}

// One unit of input into its slot, by cp.async from 4 bytes up (in flight
// until the wait, no register held; 16 bytes bypass L1), zero-filled and
// reading nothing where not `live` (no branch); a byte load below.
template <typename V>
__device__ __forceinline__ void fetch(unsigned char* slot,
                                      const unsigned char* src, bool live) {
  if constexpr (sizeof(V) >= 4) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(slot));
    const int n = live ? static_cast<int>(sizeof(V)) : 0;
    if constexpr (sizeof(V) == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(src), "r"(n)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                   "l"(src), "n"(static_cast<int>(sizeof(V))), "r"(n)
                   : "memory");
    }
  } else {
    if (live) *slot = *src;
  }
}

// acc ^ the N leaves at `offs` (16-byte aligned, read as int4: a step's
// offsets come in one or two shared-memory broadcasts) of the slots at
// `mine`, all N reads issued before the first XOR.
template <typename V, int N>
__device__ __forceinline__ V rest(V acc, const unsigned char* mine,
                                  const int* offs) {
  int o[8];
  const int4 a = reinterpret_cast<const int4*>(offs)[0];
  o[0] = a.x;
  o[1] = a.y;
  o[2] = a.z;
  o[3] = a.w;
  if constexpr (N > 4) {
    const int4 b = reinterpret_cast<const int4*>(offs)[1];
    o[4] = b.x;
    o[5] = b.y;
    o[6] = b.z;
    o[7] = b.w;
  }
  V x[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    x[q] = *reinterpret_cast<const V*>(mine + o[q]);
  }
#pragma unroll
  for (int q = 0; q < N; ++q) acc = vxor(acc, x[q]);
  return acc;
}

// The walk of a block's row group; `prog` is its stream staged in shared
// memory, `slots` the dynamic shared memory after it.  Slot s
// of a thread lies s * 16 bytes from the thread's base: 16 / V threads
// share each 16-byte row of slots, and their rows repeat at the odd pitch
// of 16 * g.pitch bytes, so a leaf's offset in the program is the same
// for every unit width and needs no arithmetic.
template <typename V>
__device__ __forceinline__ void packet_body(
    const int* __restrict__ prog, const long long* __restrict__ load_at,
    const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
    const PacketGeometry& g, uint32_t* slots) {
  constexpr int VB = static_cast<int>(sizeof(V));
  constexpr int PER = 16 / VB;                 // threads per slot row
  const int n_loads = prog[0];                 // the row group's stream
  const int n_rows = prog[1];
  const int loads = 2;
  const int rows0 = loads + n_loads;
  // the thread's slot base, in 32-bit words where the unit allows (ptxas
  // then keeps the program's offsets in uniform registers, LDS [R+UR]; a
  // base computed in bytes turns every program read into a per-thread
  // LDC), in bytes for single-byte units
  uint32_t* const base = slots + (threadIdx.x / PER) * g.pitch * 4;
  unsigned char* const mine0 =
      VB >= 4 ? reinterpret_cast<unsigned char*>(
                    base + (threadIdx.x % PER) * (VB / 4))
              : reinterpret_cast<unsigned char*>(base) +
                    (threadIdx.x % PER) * VB;
  const unsigned stride = gridDim.x * blockDim.x;

  // unit v -> its byte offset in stripe 0's chunk 0, and its stripe
  auto locate = [&](unsigned v, long long* b) -> long long {
    const unsigned rest = v / g.units;
    const unsigned bb = rest / g.nb;
    *b = bb;
    return static_cast<long long>(rest - bb * g.nb) * g.block_bytes +
           static_cast<long long>(v - rest * g.units) * VB;
  };
  auto src_of = [&](unsigned v) -> const unsigned char* {
    long long b;
    const long long off = locate(v, &b);
    return in + b * g.in_bstride + off;
  };
  auto dst_of = [&](unsigned v) -> unsigned char* {
    long long b;
    const long long off = locate(v, &b);
    return out + b * g.out_bstride + off;
  };
  // load k of the unit at `src` into slot k of `buf`, where `live` (past
  // the last unit nothing is read), every thread alike; load_at[k] is its
  // byte offset from the unit's place in input chunk 0
  auto fetch_load = [&](unsigned char* buf, const unsigned char* src,
                        bool live, int k) {
    fetch<V>(buf + k * 16, src + load_at[k], live);
  };
  auto issue = [&](unsigned v, unsigned char* buf) {
    const bool live = v < g.total;
    const unsigned char* src = live ? src_of(v) : in;
#pragma unroll 4
    for (int k = 0; k < n_loads; ++k) fetch_load(buf, src, live, k);
  };
  auto leaf = [&](const unsigned char* mine, int off) -> V {
    return *reinterpret_cast<const V*>(mine + off);
  };
  // every row of the group over the unit whose slots are `mine`; its
  // outputs go to `dst` where `live` (a thread past the last unit walks
  // without storing, so the walk stays the same for the whole block);
  // the next unit's packets (at `nsrc`, where `next_live`) land as their
  // slots fall free: the loads are numbered in that order, so a row's
  // head only counts them.  In the block's last round (`refill` false, the
  // same for the whole block) nothing is handed on: a launch below one
  // wave copies no zeros it will never read.  A head alone gives the next
  // row's place, so the next head is read while this row runs.
  auto walk = [&](unsigned char* mine, unsigned char* dst, bool live,
                  const unsigned char* nsrc, bool next_live, bool refill) {
    // a row's head and its second word (the stride to the next head, the
    // case of its rest, its kept slot) sit at 2 and 3 mod 4 words, so its
    // leaves start on 16 bytes; the next row's two words are read while
    // this row runs (past the last row they read the loads' offsets after
    // the stream, and are not used)
    int at = rows0 + ((2 - rows0) & 3);
    int2 hw = *reinterpret_cast<const int2*>(prog + at);
    int handed = 0;
    for (int r = 0; r < n_rows; ++r) {
      const int head = hw.x, w1 = hw.y;
      const int np = head & PK_PAIRS;
      const int next = at + (w1 & PK_STRIDE);
      hw = *reinterpret_cast<const int2*>(prog + next);
      V acc{};
      // whole steps of four pairs, then the rest (up to three pairs and
      // the odd leaf) as one case of a switch: every read of a step is
      // unconditional, so its shared-memory reads are all in flight
      // before the first XOR
      const int* pair = prog + at + 2;
#pragma unroll 1
      for (int p = 4; p <= np; p += 4, pair += 8) {
        const int4 a = reinterpret_cast<const int4*>(pair)[0];
        const int4 b = reinterpret_cast<const int4*>(pair)[1];
        const V x[8] = {leaf(mine, a.x), leaf(mine, a.y), leaf(mine, a.z),
                        leaf(mine, a.w), leaf(mine, b.x), leaf(mine, b.y),
                        leaf(mine, b.z), leaf(mine, b.w)};
        acc = vxor(acc, vxor(vxor(vxor(x[0], x[1]), vxor(x[2], x[3])),
                             vxor(vxor(x[4], x[5]), vxor(x[6], x[7]))));
      }
      switch ((w1 >> PK_CASE_SHIFT) & 7) {
        case 1: acc = rest<V, 1>(acc, mine, pair); break;
        case 2: acc = rest<V, 2>(acc, mine, pair); break;
        case 3: acc = rest<V, 3>(acc, mine, pair); break;
        case 4: acc = rest<V, 4>(acc, mine, pair); break;
        case 5: acc = rest<V, 5>(acc, mine, pair); break;
        case 6: acc = rest<V, 6>(acc, mine, pair); break;
        case 7: acc = rest<V, 7>(acc, mine, pair); break;
        default: break;
      }
      if (head & PK_KEEP) {
        *reinterpret_cast<V*>(mine + (static_cast<unsigned>(w1) >> 16)) =
            acc;
      }
      if (head & PK_STORE) {
        const int where = prog[at + 2 + 2 * np + ((w1 >> PK_CASE_SHIFT) & 1)];
        store_out(dst + (where & 0xFFFF) * g.out_cstride +
                      (where >> 16) * g.packetsize,
                  acc, live);
      }
      const int n = head >> PK_REFILL_SHIFT;
      if (refill) {
        for (int k = 0; k < n; ++k) {
          fetch_load(mine, nsrc, next_live, handed + k);
        }
      }
      handed += n;
      at = next;
    }
  };

  // the block's rounds: units ub + threadIdx.x, ub + stride + ..., with
  // ub the same for the whole block
  unsigned ub = blockIdx.x * blockDim.x;
  const unsigned tid = threadIdx.x;
  issue(ub + tid, mine0);
  __pipeline_commit();
  for (; ub < g.total; ub += stride) {
    const unsigned u = ub + tid;
    __pipeline_wait_prior(0);
    const bool live = u < g.total, next_live = u + stride < g.total;
    walk(mine0, live ? dst_of(u) : out, live,
         next_live ? src_of(u + stride) : in, next_live,
         ub + stride < g.total);
    __pipeline_commit();
  }
}

// The kernel: stage this block's row group's stream of the program at
// `table` (device memory) into the front of shared memory, every thread
// of the block taking part, then the byte offsets of its loads (chunk j,
// packet lb: j * in_cstride + lb * packetsize, 64-bit) after it, and walk
// it from there: each program read is a shared-memory broadcast, which a
// persistent block stages once.  `words` and `load_words` are the room
// for the longest stream and for the most loads' offsets, each a
// multiple of 4 int32 words (gf_kernels.packet_stream_room).
template <typename V>
__global__ void __launch_bounds__(PK_MAX_THREADS)
gf2_packet_kernel(const unsigned char* __restrict__ in,
                  unsigned char* __restrict__ out, const PacketGeometry g,
                  const int* __restrict__ table, int words, int load_words) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int groups = table[1];
  const int s0 = table[2 + blockIdx.y];
  const int s1 = blockIdx.y + 1 < groups ? table[3 + blockIdx.y] : table[0];
  int* staged = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x) {
    staged[i] = table[s0 + i];
  }
  long long* load_at = reinterpret_cast<long long*>(smem + words);
  for (int k = threadIdx.x; k < table[s0]; k += blockDim.x) {
    const int h = table[s0 + 2 + k];
    load_at[k] = (h & 0xFFFF) * g.in_cstride +
                 static_cast<long long>(h >> 16) * g.packetsize;
  }
  __syncthreads();
  packet_body<V>(staged, load_at, in, out, g, smem + words + load_words);
}

template <typename V>
static cudaError_t launch(const unsigned char* in, unsigned char* out,
                          const PacketGeometry& g, const int* table,
                          int words, int load_words, dim3 grid, int threads,
                          size_t smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      gf2_packet_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gf2_packet_kernel<V><<<grid, threads, smem, st>>>(in, out, g, table, words,
                                                     load_words);
  return cudaGetLastError();
}

// Whether `words` and `load_words` hold every row group's stream of the
// program `h` and its loads' 64-bit offsets.
static bool room_holds(const int* h, int words, int load_words) {
  bool ok = words >= 0 && words % 4 == 0 && load_words >= 0 &&
            load_words % 4 == 0;
  for (int g = 0; ok && g < h[1]; ++g) {
    const int end = g + 1 < h[1] ? h[3 + g] : h[0];
    ok = end - h[2 + g] <= words && 2 * h[h[2 + g]] <= load_words;
  }
  return ok;
}

extern "C" {

const char* gf2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The program format this library reads, into out[0..7]: the head's pair
// mask, its three flags and the shift of its count of loads handed on,
// the second word's stride mask and case shift, the most threads of a
// block.
void gf2_packet_format(int* out) {
  const int v[] = {PK_PAIRS,  PK_SINGLE, PK_KEEP,       PK_STORE,
                   PK_REFILL_SHIFT, PK_STRIDE, PK_CASE_SHIFT, PK_MAX_THREADS};
  for (int k = 0; k < 8; ++k) out[k] = v[k];
}

// What the plan needs of `device`, into out[0..3]: SMs, shared memory of
// an SM, shared memory the runtime reserves per block, and the most a
// block may take.  Returns the first CUDA error.
int gf2_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxSharedMemoryPerBlockOptin};
  for (int k = 0; k < 4; ++k) {
    const cudaError_t err = cudaDeviceGetAttribute(&out[k], attrs[k], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Run a packet program (ops/gf_kernels.py::packet_program; `table` in
// device memory, `prog` the same n_words int32 words in host memory, read
// here for the row groups and to check the room) over `batch` stripes of
// input chunks of `nbytes` bytes, in packets of w x packetsize; strides in
// bytes.  Output chunk i of stripe b starts at out + b * out_bstride + i *
// out_cstride.  `words` and `load_words` are the shared memory a block
// stages its stream and its loads' offsets into
// (gf_kernels.packet_stream_room); the plan (gf_kernels.packet_plan) gives
// the unit, the block, the blocks per row group and the slots' pitch.  One
// launch on `stream` (of `device`); returns the CUDA error, 0 when the
// launch was accepted.
int gf2_packet_apply(const void* in, void* out, long long batch,
                     long long nbytes, long long in_bstride,
                     long long in_cstride, long long out_bstride,
                     long long out_cstride, int w, int packetsize,
                     const void* prog, int n_words, const void* table,
                     int words, int load_words, int unit, int threads,
                     int blocks, int pitch, int device, void* stream) {
  const auto* h = static_cast<const int*>(prog);
  const long long vals[] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(in)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(out)),
      in_bstride, in_cstride, out_bstride, out_cstride, packetsize};
  bool ok = prog != nullptr && table != nullptr && n_words >= 3 &&
            n_words % 4 == 0 && h[0] == n_words && h[1] >= 1 &&
            h[1] <= 65535 && batch >= 1 && w >= 1 && packetsize >= 1 &&
            nbytes >= 1 &&
            nbytes % (static_cast<long long>(w) * packetsize) == 0 &&
            (unit == 16 || unit == 8 || unit == 4 || unit == 1) &&
            threads >= 32 && threads <= PK_MAX_THREADS && threads % 32 == 0 &&
            blocks >= 1 && pitch >= 1 && pitch % 2 == 1 &&
            room_holds(h, words, load_words);
  for (long long v : vals) ok = ok && v % unit == 0;
  const long long nb =
      ok ? nbytes / (static_cast<long long>(w) * packetsize) : 0;
  const long long total = batch * nb * (ok ? packetsize / unit : 0);
  ok = ok && total < (1LL << 31) &&
       static_cast<long long>(blocks) * threads <= (1LL << 31);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  PacketGeometry g;
  g.in_bstride = in_bstride;
  g.in_cstride = in_cstride;
  g.out_bstride = out_bstride;
  g.out_cstride = out_cstride;
  g.block_bytes = static_cast<long long>(w) * packetsize;
  g.units = static_cast<unsigned>(packetsize / unit);
  g.nb = static_cast<unsigned>(nb);
  g.total = static_cast<unsigned>(total);
  g.packetsize = packetsize;
  g.pitch = pitch;
  const size_t smem = 4ULL * (words + load_words) +
                      static_cast<size_t>(threads) * pitch * unit;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(h[1]));
  const auto* src = static_cast<const unsigned char*>(in);
  auto* dst = static_cast<unsigned char*>(out);
  const auto* tab = static_cast<const int*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> cudaError_t {
    switch (unit) {
      case 16:
        return launch<uint4>(src, dst, g, tab, words, load_words, grid,
                             threads, smem, st);
      case 8:
        return launch<uint2>(src, dst, g, tab, words, load_words, grid,
                             threads, smem, st);
      case 4:
        return launch<uint32_t>(src, dst, g, tab, words, load_words, grid,
                                threads, smem, st);
      default:
        return launch<unsigned char>(src, dst, g, tab, words, load_words,
                                     grid, threads, smem, st);
    }
  });
}

}  // extern "C"
