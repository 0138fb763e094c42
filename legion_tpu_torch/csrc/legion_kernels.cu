// Hand-written Hopper (sm_90a) kernels of legion_tpu_torch.
//
// Each kernel but the dedup's, the gathered feature mean's, GAT's and the
// activation-dropout's replaces a Pallas TPU kernel of legion_tpu/ops/ and
// computes what that kernel computes, redesigned for the H100 rather than
// copied block by block; the dedup's tail (dedup_tail_kernel), the gathered
// feature mean (feature_mean_kernel) and the activation and dropout between
// layers (act_dropout_*_kernel, last below) replace chains of PyTorch
// passes, and GAT's edge-softmax kernels replace none: legion_tpu has no
// GAT.
// All are scans, gathers, reductions or scatters with no matrix product: at
// the main-path shapes they do < 1 FLOP per byte moved, far below the ~295
// FLOP/byte at which the H100's bf16 tensor cores would bound them, so no
// kernel here is bound by operations. The designs follow from what does
// bound them:
//
//  * K1, K3 and K5 stream hundreds of megabytes from device memory, and
//    bytes bound them: one thread per 16-byte word of an output row, each
//    byte read once in coalesced loads, sums in registers, each output
//    written once.
//  * K2 (forward and backward) and the sampling kernel move little, out of
//    the L2 or in scattered 4-byte reads. K2 forward is bound by the
//    operations a warp executes per 94-byte row and K2 backward by the
//    L2's rate of float adds; the sampling kernel by its chains of dependent
//    loads on small frontiers and its scattered sectors on large ones. K2
//    runs one warp per dst row: the row's index data is loaded once by the
//    lanes, only the valid slots are walked (ballot, then a compacted table
//    or shuffles), and the backward adds 16 bytes per atomic into a padded
//    f32 staging buffer. The sampling kernel runs one warp per tile of 32
//    frontier rows (or per slice of a tile's rounds, when the tiles are too
//    few to fill the card): the tile's ids are loaded once by its lanes, a
//    tile with no neighbor loads nothing more, and each lane keeps its
//    index loads in flight together.
//  * The gathered feature mean reads random 256-byte feature rows named
//    by an index: bytes bound it, and what reaches them is the number of
//    row loads in flight. One thread per 16-byte word of a dst row, as K1,
//    and every valid slot's load of a chunk issued before the first add.
//  * The dedup's tail streams the sorted ids once; a decoupled look-back
//    carries its one count across tiles, so it takes one launch.
//  * The activation and dropout stream h, the uniforms and the output once
//    forward, and the gradients and a bit an element back: bytes bound
//    them, met by 16-byte words and a grid-stride loop.
//  * GAT's edge-softmax aggregation (last below) gathers each slot's row
//    segment as K2 does, with one warp per (dst row, head) so that a
//    head's softmax is a warp's reductions; its backward turns the slots
//    around by position and gathers again, one warp per src row, since
//    float atomics into rows far larger than the L2 cost a device-memory
//    round trip each.
//
// Built by legion_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o legion_kernels_<hash>.so legion_kernels.cu
// Plain C launchers (extern "C" below) take raw pointers and the caller's
// stream, launch without synchronising, allocate nothing, and return
// cudaGetLastError(). Wrappers and plain PyTorch versions of each kernel:
// legion_tpu_torch/ops/identity_agg.py, legion_tpu_torch/ops/gather.py,
// legion_tpu_torch/ops/sample.py, legion_tpu_torch/ops/spmm.py,
// legion_tpu_torch/ops/dedup.py, legion_tpu_torch/ops/gat_attention.py and
// legion_tpu_torch/ops/act_dropout.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Norm { kMean = 0, kSqrt = 1, kSum = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

// An unsigned word of N bytes: one load or store instruction of that width.
template <int N> struct Word;
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// Load VEC consecutive elements at p (aligned to VEC * sizeof(T)) as f32.
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[VEC]) {
  using W = typename Word<static_cast<int>(VEC * sizeof(T))>::type;
  W w = *reinterpret_cast<const W*>(p);
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) o[i] = to_f32(e[i]);
}

template <int VEC, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  using W = typename Word<static_cast<int>(VEC * sizeof(T))>::type;
  W w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<W*>(p) = w;
}

// The fill value of a gather position outside the rows (JAX's take fills
// float rows with NaN).
__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// The norm of a sum over cnt valid slots (cnt clamped to 1: a dst with no
// valid slot has a zero sum and keeps it).
__device__ __forceinline__ float apply_norm(float v, int cnt, int norm) {
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  if (norm == kMean) return v / denom;
  if (norm == kSqrt) return v * rsqrtf(denom);
  return v;
}

// ---------------------------------------------------------------------------
// K1: masked norm-reduce over the f contiguous slot rows of each dst row.
//
//   out[r, c] = norm( sum_{j < f, mask[r, j]} x[offset + r*f + j, c] )
//
// Replaces identity_masked_mean_pallas
// (legion_tpu/ops/identity_agg_pallas.py:137): the f slots of dst r are the
// contiguous rows offset + r*f .. offset + r*f + f - 1 of the gathered
// features.
//
// Bound: bytes. At the main-path shapes it reads 1.2M rows of 512 B (about
// 626 MB plus the 1.2 MB mask) and writes 31 MB of bf16. Design: one thread
// per (dst row, VEC-column group); the threads of a warp cover consecutive
// columns of a row, so each slot's row is read by 16-byte coalesced loads
// (VEC = 4 f32) and every byte is read once. Masked slots are skipped, not
// multiplied by zero, so their rows are never read. The sum stays in f32
// registers; the norm and the cast to the output type happen before the one
// store. No shared memory, no cross-thread reduction, no assumption on P
// (a ragged last block is masked by the bounds check). The slot rows follow
// each other in memory, so a thread's f loads are independent and the
// hardware keeps them in flight; K2, whose rows are named by an index array,
// has a kernel of its own below.
// ---------------------------------------------------------------------------
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads)
masked_agg_kernel(const Tin* __restrict__ x, const uint8_t* __restrict__ mask,
                  Tout* __restrict__ out, int64_t n, int64_t p, int f, int d,
                  int64_t offset, int norm) {
  const int groups = d / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= p * groups) return;
  const int64_t r = t / groups;
  const int c = static_cast<int>(t - r * groups) * VEC;
  const uint8_t* m = mask + r * f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  int cnt = 0;
  bool filled = false;
  for (int j = 0; j < f; ++j) {
    if (!m[j]) continue;
    ++cnt;
    const int64_t row = offset + r * f + j;
    if (row < 0 || row >= n) {
      filled = true;
      continue;
    }
    float v[VEC];
    load_vec<VEC>(x + row * d + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    acc[i] = filled ? nan_f32() : apply_norm(acc[i], cnt, norm);
  store_vec<VEC>(out + r * d + c, acc);
}

// ---------------------------------------------------------------------------
// K2, forward and backward: the same reduce over rows named by an index
// array, and its transpose.
//
//   forward   out[r, c] = norm( sum_{j < f, mask[r, j]} h[pos[r, j], c] )
//   backward  dx[pos[r, j], c] += mask[r, j] * norm(g[r, c])
//
// The forward replaces gathered_masked_mean
// (legion_tpu/ops/identity_agg_pallas.py:261), which on the TPU gathered
// h[pos] into a (P*f, D) array padded to 128 columns and ran the K1 kernel
// on it; here the gather happens inside the kernel at the true width D, so
// the (P*f, D) rows never reach device memory. The backward replaces its
// custom VJP (_masked_agg_rows_bwd with _bwd_scale,
// identity_agg_pallas.py:225-248, whose scatter-add transpose of the row
// gather stayed in XLA on the TPU).
//
// A valid slot whose position lies outside the n rows (a position past the
// frontier, which exists only after a cap overflow; a negative one counts as
// outside too) is never dereferenced. Forward it makes the whole output row
// NaN, as JAX's fill-mode take makes its row NaN; backward it is dropped, as
// the transpose of that take drops it, but it still counts in the row's
// denominator, since the forward's mean counted it.
//
// Bound: neither bytes nor float operations. At the main path h is 121,856
// rows of 47 bf16 (11.5 MB) and dx's f32 staging buffer 23 MB: both live in
// the 50 MB L2, and the ~200k valid slots each name one 94-byte row. What
// the forward pays for is the operations a warp executes per slot (an index,
// an address, one small load, the conversion and the add: a thread per
// (row, column) spends them on 2 bytes and rereads the mask and position D
// times), and what the backward pays for is the L2's rate of float adds,
// about 0.5 T elements a second on this card whatever the width of the
// atomic. Design, shared by both kernels:
//
//  * One warp per dst row. Lane j loads pos[r, j] and mask[r, j] once (in
//    chunks of 32 slots for f > 32); __ballot_sync gives the row's valid
//    slots and __popc its count, and no thread loops over a masked slot.
//  * Forward, the valid in-range slots are compacted into a table in shared
//    memory, one entry a slot: the byte offset of the first word to load,
//    computed once by the slot's lane. The loop over the table then spends
//    one broadcast read, one address add, one load, the unpacking and the
//    adds on each slot, with 4 slot rows loaded before the first add.
//  * Lanes cover a row's columns in words of W elements. W = 4 (8-byte bf16
//    or 16-byte f32 loads, two words a lane for D > 128) where D, the row
//    stride and the pointers are multiples of 4 elements (D = 172). Else
//    W = 2: rows of an odd width start on an even element only every other
//    row (D = 47 bf16: 94-byte rows), so a lane loads the aligned pair that
//    holds its first element, one element early on an odd row, and takes its
//    second element from the next lane's pair (one __shfl_down_sync and one
//    funnel shift of the raw words). Every load is an aligned word that
//    holds at least one element of the row, so none leaves the tensor's
//    allocation, whatever the base pointer's alignment. The row stride
//    ld >= D is an argument, so a caller may hand in padded rows.
//  * Backward, the warp walks the set bits of the ballot, broadcasting each
//    slot's position by __shfl_sync, and a lane adds its W columns of the
//    scaled gradient row to the slot's src row with one vector reduction:
//    sm_90 has a native 16-byte float add (atomicAdd(float4*),
//    red.global.add.v4.f32). Where the result is not float32 the wrapper
//    gives the f32 staging buffer a row stride that is a multiple of 4 floats
//    (48 for D = 47), so a slot's row takes 12 vector atomics where a thread
//    per (row, column) made 47 scalar ones; an 8-byte or a scalar add
//    takes over where the stride or the pointer rules 16 bytes out (a
//    float32 result is scattered straight into its own rows). The padding
//    columns receive nothing. Sums accumulate in f32 (bf16 atomics would
//    lose the sum at hub rows), in an order that changes from run to run.
//  * narrow_rows_kernel then reads the staging buffer once and writes dx in
//    the caller's type at the true width (one pass for the cast and the
//    un-padding together).
//
// The zero fill of the staging buffer and this last pass move 23 + 35 MB at
// the main path, about 0.017 ms at 3.35 TB/s: that is the floor of a staged
// scatter, and the adds themselves take as long again. Only a gather-side
// design (each src row summing its own edges, which needs the edges grouped
// by src row) would reach the byte bound of one dx write.
// ---------------------------------------------------------------------------
constexpr int kWarp = 32;
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;

// Up to 32 slots of dst row r, one per lane, starting at slot j0.
struct SlotChunk {
  int32_t row;      // this lane's position
  unsigned valid;   // lanes whose slot is unmasked
  unsigned inside;  // valid lanes whose position is one of the n rows
};

__device__ __forceinline__ SlotChunk load_slots(
    const int32_t* __restrict__ pos, const uint8_t* __restrict__ mask,
    int64_t r, int f, int j0, int64_t n, int lane) {
  const int j = j0 + lane;
  SlotChunk s;
  s.row = j < f ? pos[r * f + j] : -1;
  const bool valid = j < f && mask[r * f + j];
  s.valid = __ballot_sync(kFullMask, valid);
  s.inside = __ballot_sync(kFullMask, valid && s.row >= 0 && s.row < n);
  return s;
}

// One aligned word of W elements as it is loaded (Raw), and its W f32
// values. W == 2 realigns: on a row that starts on an odd element the lane
// loaded the pair one element early, (c - 1, c), so its columns (c, c + 1)
// are the upper half of its own pair and the lower half of the next lane's.
template <typename T, int W> struct Words;

template <> struct Words<__nv_bfloat16, 2> {
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw zero() { return 0u; }
  static __device__ __forceinline__ void unpack(Raw w, int odd,
                                                float (&v)[2]) {
    const Raw next = __shfl_down_sync(kFullMask, w, 1);
    const Raw pair = __funnelshift_r(w, next, odd << 4);
    v[0] = __uint_as_float(pair << 16);
    v[1] = __uint_as_float(pair & 0xffff0000u);
  }
};

template <> struct Words<float, 2> {
  using Raw = float2;
  static __device__ __forceinline__ Raw zero() { return make_float2(0, 0); }
  static __device__ __forceinline__ void unpack(Raw w, int odd,
                                                float (&v)[2]) {
    const float next = __shfl_down_sync(kFullMask, w.x, 1);
    v[0] = odd ? w.y : w.x;
    v[1] = odd ? next : w.y;
  }
};

template <> struct Words<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0, 0); }
  static __device__ __forceinline__ void unpack(Raw w, int, float (&v)[4]) {
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  }
};

template <> struct Words<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0, 0, 0, 0);
  }
  static __device__ __forceinline__ void unpack(Raw w, int, float (&v)[4]) {
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
};

// W == 4: d, ld and both pointers are multiples of 4 elements, a lane owns
// CH words 32 words apart and a pass covers 128 CH columns. W == 2: CH == 1,
// lane 31 only feeds lane 30 its second element on odd rows and owns no
// column, so a pass covers 62 columns.
template <typename T, int W, int CH>
__global__ void __launch_bounds__(kThreads)
gathered_agg_kernel(const T* __restrict__ h, const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    int64_t n, int64_t p, int f, int d, int64_t ld,
                    int norm) {
  using Raw = typename Words<T, W>::Raw;
  constexpr int kInFlight = 4;        // slot rows loaded before the first add
  constexpr int kOwners = W == 2 ? kWarp - 1 : kWarp;
  constexpr int kChunkBytes = kWarp * W * static_cast<int>(sizeof(T));
  // per warp, the valid in-range slots of the current chunk, compacted:
  // the byte offset in h of the first word to load, its lowest bit set
  // where the row starts on an odd element
  __shared__ int64_t slot_table[kRowsPerBlock][kWarp];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp;
  if (r >= p) return;                 // the whole warp leaves together
  int64_t* table = slot_table[warp];
  // h's first element counted in elements: the parity of a row's start
  const int64_t h0 = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(h) / sizeof(T));
  int cnt = 0;
  bool filled = false;
  // Fills the table from the chunk of slots at j0; returns its length.
  auto fill_table = [&](int j0) {
    const SlotChunk s = load_slots(pos, mask, r, f, j0, n, lane);
    __syncwarp();                     // the table's readers are done
    if ((s.inside >> lane) & 1u) {
      const int64_t at = static_cast<int64_t>(s.row) * ld;
      const int64_t odd = W == 2 ? (h0 + at) & 1 : 0;
      table[__popc(s.inside & ((1u << lane) - 1u))] =
          (at - odd) * static_cast<int64_t>(sizeof(T)) | odd;
    }
    __syncwarp();
    cnt += __popc(s.valid);
    filled = filled || s.valid != s.inside;
    return __popc(s.inside);
  };
  const bool one_chunk = f <= kWarp;  // then the index data is read once
  int rows = one_chunk ? fill_table(0) : 0;
  for (int c0 = 0; c0 < d; c0 += kOwners * W * CH) {
    const int c = c0 + lane * W;      // the lane's first column
    const char* lane_base = reinterpret_cast<const char*>(h) +
                            static_cast<int64_t>(c) * sizeof(T);
    float acc[CH][W];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int i = 0; i < W; ++i) acc[ch][i] = 0.0f;
    if (!one_chunk) {
      cnt = 0;
      filled = false;
    }
    for (int j0 = 0; j0 < f; j0 += kWarp) {
      if (!one_chunk) rows = fill_table(j0);
      // every condition in this loop is the same across the warp
      for (int k = 0; k < rows; k += kInFlight) {
        Raw raw[kInFlight][CH];
        int odd[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          odd[u] = 0;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) raw[u][ch] = Words<T, W>::zero();
          if (k + u >= rows) continue;
          const int64_t entry = table[k + u];
          odd[u] = static_cast<int>(entry & 1);
          const char* word = lane_base + (entry - odd[u]);
#pragma unroll
          for (int ch = 0; ch < CH; ++ch)
            if (c + ch * kWarp * W - odd[u] < d)
              raw[u][ch] = *reinterpret_cast<const Raw*>(
                  word + ch * kChunkBytes);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u)
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) {
            float v[W];
            Words<T, W>::unpack(raw[u][ch], odd[u], v);
#pragma unroll
            for (int i = 0; i < W; ++i) acc[ch][i] += v[i];
          }
      }
    }
    if (lane >= kOwners) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int cc = c + ch * kWarp * W;
      if (cc >= d) continue;
#pragma unroll
      for (int i = 0; i < W; ++i)
        acc[ch][i] = filled ? nan_f32() : apply_norm(acc[ch][i], cnt, norm);
      if (W == 4) {                    // d % 4 == 0 and out is aligned
        store_vec<W>(out + r * d + cc, acc[ch]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i)
          if (cc + i < d) out[r * d + cc + i] = from_f32<T>(acc[ch][i]);
      }
    }
  }
}

template <int W>
__device__ __forceinline__ void add_vec(float* p, const float (&v)[W]);
template <>
__device__ __forceinline__ void add_vec<4>(float* p, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
template <>
__device__ __forceinline__ void add_vec<2>(float* p, const float (&v)[2]) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}
template <>
__device__ __forceinline__ void add_vec<1>(float* p, const float (&v)[1]) {
  atomicAdd(p, v[0]);
}

// dx: (n, ld) f32, zeroed by the caller, ld % W == 0 and dx aligned to W
// floats; columns d .. ld - 1 are padding.
template <typename Tg, int W>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const Tg* __restrict__ g, const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ mask, float* __restrict__ dx,
                    int64_t n, int64_t p, int f, int d, int64_t ld,
                    int norm) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  if (r >= p) return;
  const SlotChunk first = load_slots(pos, mask, r, f, 0, n, lane);
  int cnt = __popc(first.valid);
  for (int j0 = kWarp; j0 < f; j0 += kWarp) {
    const int j = j0 + lane;
    cnt += __popc(__ballot_sync(kFullMask, j < f && mask[r * f + j]));
  }
  if (cnt == 0) return;
  for (int c0 = 0; c0 < d; c0 += kWarp * W) {
    const int c = c0 + lane * W;
    float s[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      s[i] = c + i < d ? apply_norm(to_f32(g[r * d + c + i]), cnt, norm)
                       : 0.0f;
    for (int j0 = 0; j0 < f; j0 += kWarp) {
      const SlotChunk ch =
          j0 == 0 ? first : load_slots(pos, mask, r, f, j0, n, lane);
      unsigned todo = ch.inside;
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int64_t row = __shfl_sync(kFullMask, ch.row, j);
        if (c < d) add_vec<W>(dx + row * ld + c, s);
      }
    }
  }
}

// out (n, d) contiguous in Tout <- the first d columns of in (n, ld) f32.
// One thread per 4 consecutive output elements, stored as one word.
template <typename Tout>
__global__ void __launch_bounds__(kThreads)
narrow_rows_kernel(const float* __restrict__ in, Tout* __restrict__ out,
                   int64_t total, int d, int64_t ld) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x) * 4;
  if (i0 >= total) return;
  int64_t row = i0 / d;
  int col = static_cast<int>(i0 - row * d);
  const int k = total - i0 < 4 ? static_cast<int>(total - i0) : 4;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = 0.0f;
    if (i < k) {
      v[i] = in[row * ld + col];
      if (++col == d) {
        col = 0;
        ++row;
      }
    }
  }
  if (k == 4) {
    store_vec<4>(out + i0, v);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < k) out[i0 + i] = from_f32<Tout>(v[i]);
  }
}

// ---------------------------------------------------------------------------
// The gathered feature mean: K2's forward contract with norm "mean" over
// raw feature rows, which carry no gradient, emitted in a type of its own.
//
//   out[r, c] = (sum_{j < f, mask[r, j]} x[pos[r, j], c]) / max(count, 1)
//
// Replaces no TPU kernel: where SAGE's layer 0 widens a deduplicated outer
// block, legion_tpu aggregates first and leaves the mean to XLA
// (legion_tpu/models/sage.py, ops/segment.py fanout_gather_mean). The
// port ran it as five PyTorch passes over a (P, f, D) tensor: the int64
// row gather, take_rows' NaN select, the mask product, the sum and a
// divide. A valid slot whose position lies outside the n rows makes its
// output row NaN and is never dereferenced, as in K2.
//
// Bound: bytes, and the rows are random. At the cached path's layer 0
// (P ~ 93k dst rows, f = 10, D = 128 bf16) it reads up to 930k rows of
// 256 bytes (238 MB) named by an index, and writes 24 MB; K2's warp per
// dst row walks 47-wide rows out of the L2 and would leave most of a
// warp's lanes idle on a 256-byte row. Design: one thread per (dst row,
// 16-byte word of the row), as K1, so a group of D / VEC lanes (16 for 128
// bf16) reads each slot's row in coalesced 16-byte loads. A row gather
// from device memory is bound by the loads in flight, so the slots go in
// chunks of kSlots = 16 (one chunk for f <= 16, several for a longer f):
// a lane reads the chunk's positions and mask bytes (the group's lanes
// read the same addresses, which the hardware serves as one request), then
// issues every valid in-range slot's load before the first add, up to 256
// bytes a lane in flight. Sums in f32,
// the divide and the rounding to the output type once, each output word
// written once. D not a multiple of VEC, or a pointer not 16-byte
// aligned, takes single-element loads.
// ---------------------------------------------------------------------------
constexpr int kSlots = 16;

template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads)
feature_mean_kernel(const Tin* __restrict__ x,
                    const int32_t* __restrict__ pos,
                    const uint8_t* __restrict__ mask, Tout* __restrict__ out,
                    int64_t n, int64_t p, int f, int d) {
  using Raw = typename Word<static_cast<int>(VEC * sizeof(Tin))>::type;
  constexpr int kOut = VEC * sizeof(Tout) > 16
                           ? 16 / static_cast<int>(sizeof(Tout)) : VEC;
  const int groups = d / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= p * groups) return;
  const int64_t r = t / groups;
  const int c = static_cast<int>(t - r * groups) * VEC;
  const int32_t* pr = pos + r * f;
  const uint8_t* mr = mask + r * f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  int cnt = 0;
  bool filled = false;
  for (int j0 = 0; j0 < f; j0 += kSlots) {
    int64_t row[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int j = j0 + u;
      // both index loads issue before either is tested
      const int64_t at = j < f ? pr[j] : -1;
      const bool valid = j < f && mr[j];
      const bool inside = valid && at >= 0 && at < n;
      cnt += valid;
      filled = filled || (valid && !inside);
      row[u] = inside ? at : -1;
    }
    Raw raw[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      raw[u] = Raw{};
      if (row[u] >= 0)
        raw[u] = *reinterpret_cast<const Raw*>(x + row[u] * d + c);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const Tin* e = reinterpret_cast<const Tin*>(&raw[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += to_f32(e[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    acc[i] = filled ? nan_f32() : apply_norm(acc[i], cnt, kMean);
#pragma unroll
  for (int i = 0; i < VEC; i += kOut) {
    float v[kOut];
#pragma unroll
    for (int k = 0; k < kOut; ++k) v[k] = acc[i + k];
    store_vec<kOut>(out + r * d + c + i, v);
  }
}

// ---------------------------------------------------------------------------
// K3: replaces gather_rows_pallas (legion_tpu/ops/gather_pallas.py:68):
//   out[i] = table[ids[i]], a zero row where ids[i] < 0 (ids >= n clamp to
//   n - 1, as JAX's gather does).
//
// Bound: bytes. At the main path it reads 1.34M random rows of 512 B and
// writes as many (about 1.38 GB moved per step). The TPU kernel kept 8
// row DMAs in flight to hide descriptor latency; on the H100 the warp
// scheduler hides latency given enough loads in flight, so the design is
// one thread per 16-byte word of an output row: a warp moves one 512-byte
// row with a single coalesced load and store, and the 1.34M x 32 threads
// keep the memory system full. Zeroing is a select on the id already in a
// register, so masking invalid slots costs no extra pass. Words are 16
// bytes where the row and both pointers allow it, else 4 bytes; the
// kernel never looks at the element type.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const W* __restrict__ table,
                   const int32_t* __restrict__ ids, W* __restrict__ out,
                   int64_t m, int64_t n, int words) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= m * words) return;
  const int64_t r = t / words;
  const int w = static_cast<int>(t - r * words);
  const int64_t id = ids[r];
  W v{};
  if (id >= 0) v = table[(id < n ? id : n - 1) * words + w];
  out[t] = v;
}

// ---------------------------------------------------------------------------
// Neighbor sampling: replaces select_lanes_pallas
// (legion_tpu/ops/select_pallas.py:46) together with the code the JAX
// sampler wraps around it (legion_tpu/sampling/sampler.py:289-385): per
// frontier node p and slot f,
//
//   deg  = indptr[id+1] - indptr[id]              (id = frontier[p])
//   draw = min(int(u[p, f] * float(deg)), max(deg - 1, 0))
//   out[p, f] = indices[indptr[id] + draw]  if id >= 0, deg > 0, f < deg
//               -1                          otherwise
//
// On the TPU a node's CSR run was fetched as one or two 512-byte lines and
// the sampled lane picked out of the line by a VMEM masked sum (K4), since
// a 4-byte HBM gather per edge wasted the DMA descriptor; ids >= 2^24 had
// to take that kernel because the f32 one-hot select is exact only below
// 2^24. Hopper reads the CSR in place: the window is the node's run, the
// lane offset is the draw, and the select is one 4-byte load, exact for
// every int32 id.
//
// Bound. Each slot is a chain of dependent loads: the frontier id, then
// the node's indptr pair, then (where the slot is valid) its uniform, then
// one scattered 4-byte index. At hop 1 (8000 x 25 at the main path) the
// work is ~2.5 MB and the chain's latency bounds it; at hop 2 (121,856 x
// 10) the index reads touch ~1M distinct 32-byte sectors and the sectors
// bound it (ops/sample.py::sample_traffic counts both).
//
// Design. A warp takes a tile of 32 consecutive frontier rows, whose 32 * f
// slots are contiguous in u and out, or a slice of its rounds:
//  * lane i loads frontier[r0 + i] and its row's indptr pair: one coalesced
//    read and 32 independent indptr loads for the tile, where one thread
//    per slot paid that chain for every slot. A tile none of whose rows has
//    a neighbor (all -1 padding, or degree 0: ballot) writes -1 and loads
//    nothing else;
//  * the slots are walked as rounds of 32 lanes, coalesced for any f. A
//    lane's (row, slot) steps by 32 = q * f + rem slots a round in 32-bit
//    adds (one division per warp, none per slot), and the row's start and
//    degree come from its lane by shuffle;
//  * a warp issues the uniforms of its valid slots, then every index load,
//    then the stores: up to B loads in flight a lane (B = 4, 8, 16 or 32,
//    the least that holds the warp's rounds), so a warp's chain
//    is the four loads of one slot. A slot that is not valid loads neither
//    its uniform nor an index. Only the uniforms and a bit mask of the
//    valid slots are held across it (the walk is stepped again for the
//    index loads), and the batch has no branch, so the scheduler can
//    overlap its shuffles and loads;
//  * how many rounds a warp takes: all f of its tile while the tiles fill
//    kSampleWarpsPerSm warps on every SM (hop 2: a warp per tile, each
//    row's ids loaded once); with fewer tiles (hop 1: 250 tiles of 8000
//    rows) a tile is cut into slices of rounds, each slice's warp loading
//    the tile's ids again, since 250 warps each walking 25 rounds wait on
//    their own instruction chains (0.0047 ms against 0.0039 cut in 7);
//  * the uniforms are read once and evict first (__ldcs); frontier, indptr
//    and indices take the read-only path (__ldg); out is stored normally,
//    since the dedup reads it next;
//  * a persistent grid: blocks of two warps (so a few hundred warps still
//    spread over the SMs), at most as many as the SMs hold at once, each
//    warp striding over (tile, slice) items.
// The draw is computed bit-exactly as the plain version's float32 ops:
// __int2float_rn, __fmul_rn (no contraction into an FMA) and truncation
// toward zero.
// Registers (nvcc 12.9, -Xptxas -v): 96 / 56 / 40 / 32 at B = 32 / 16 / 8
// / 4, no spills. On the H100 (PERF.md, section 6) hop 2 of the main path
// takes 0.0156 ms, 65 % of its sector time, against 0.0195 for one thread
// per slot; hop 1 takes 0.0039 against 0.0033: its 200,000 slots are too
// few to hide a warp's longer chain of instructions.
// ---------------------------------------------------------------------------
constexpr int kSampleThreads = 64;
// Warps on each SM (of the 64 it holds) below which a tile is cut into
// slices of rounds. 16 cuts hop 1's 250 tiles into 7 slices of 4 rounds:
// of the slice counts 1, 2, 4, 8, 13 and 25 forced at hop 1 (8000 x 25),
// 8 was the fastest; hop 2's 3,808 tiles stay whole (PERF.md, section 6).
constexpr int kSampleWarpsPerSm = 16;

// A lane's slot of the next round: s + 32 = (row + q) * f + (j + rem).
__device__ __forceinline__ void next_round(int f, int q, int rem, int& row,
                                           int& j) {
  row += q;
  j += rem;
  if (j >= f) {
    j -= f;
    ++row;
  }
}

// A warp per (tile, slice): slice g of a tile is its rounds [g * per,
// min(f, (g + 1) * per)), per <= B; `slices` = ceil(f / per) a tile.
template <int B>
__global__ void __launch_bounds__(kSampleThreads)
sample_neighbors_kernel(const int32_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const int32_t* __restrict__ frontier,
                        const float* __restrict__ u,
                        int32_t* __restrict__ out, int64_t p, int f,
                        int per, int slices) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t items = (p + kWarp - 1) / kWarp * slices;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * (kSampleThreads / kWarp);
  const int q = kWarp / f, rem = kWarp - q * f;
  for (int64_t item = (static_cast<int64_t>(blockIdx.x) * kSampleThreads +
                       threadIdx.x) / kWarp;
       item < items; item += stride) {
    const int64_t tile = slices == 1 ? item : item / slices;
    const int k0 = static_cast<int>(item - tile * slices) * per;
    const int k1 = k0 + per < f ? k0 + per : f;
    const int64_t r0 = tile * kWarp;
    const int rows = static_cast<int>(p - r0 < kWarp ? p - r0 : kWarp);
    const int32_t id = lane < rows ? __ldg(frontier + r0 + lane) : -1;
    int32_t start = 0, deg = 0;
    if (id >= 0) {
      start = __ldg(indptr + id);
      deg = __ldg(indptr + id + 1) - start;
    }
    const int slots = rows * f;  // rows past p have id -1 and degree 0
    const float* ut = u + r0 * f;
    int32_t* dst = out + r0 * f;
    if (__ballot_sync(kFullMask, deg > 0) == 0) {
      for (int s = k0 * kWarp + lane; s < k1 * kWarp && s < slots;
           s += kWarp) {
        dst[s] = -1;
      }
      continue;
    }
    // this lane's slot of round k0: one division per warp and slice
    int row = (k0 * kWarp + lane) / f;
    int j = k0 * kWarp + lane - row * f;
    // the slice's valid slots and their uniforms
    unsigned valid = 0;
    float uu[B];
    int r = row, jj = j;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int32_t d = __shfl_sync(kFullMask, deg, r);
      const bool ok = k0 + b < k1 && jj < d;
      valid |= ok ? 1u << b : 0u;
      uu[b] = ok ? __ldcs(ut + (k0 + b) * kWarp + lane) : 0.0f;
      next_round(f, q, rem, r, jj);
    }
    // every index load of the slice, then the stores
    int32_t v[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int32_t s0 = __shfl_sync(kFullMask, start, row);
      const int32_t d = __shfl_sync(kFullMask, deg, row);
      int32_t draw = __float2int_rz(__fmul_rn(uu[b], __int2float_rn(d)));
      draw = draw < d - 1 ? draw : d - 1;
      v[b] = valid >> b & 1u ? __ldg(indices + s0 + draw) : -1;
      next_round(f, q, rem, row, j);
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int s = (k0 + b) * kWarp + lane;
      if (k0 + b < k1 && s < slots) dst[s] = v[b];
    }
  }
}

// The card's SM count, read into *sms where it is still 0: a process
// drives one kind of card, so a caller keeps it in a static.
cudaError_t sm_count(int* sms) {
  if (*sms != 0) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return err;
}

// As many blocks of `kernel` at `threads` a block as the card holds at
// once, found into *resident where it is still 0 (a static of the caller,
// one per kernel instance).
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int* resident) {
  if (*resident != 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  }
  if (err != cudaSuccess) return err;
  *resident = sms * per_sm;
  return cudaSuccess;
}

// The persistent grid of sample_neighbors_kernel<B>: as many blocks as the
// card holds at once (resident_blocks), and no more than the (tile, slice)
// items need.
template <int B>
cudaError_t launch_sample(const int32_t* indptr, const int32_t* indices,
                          const int32_t* frontier, const float* u,
                          int32_t* out, int64_t p, int f, int per,
                          cudaStream_t stream) {
  static int resident = 0;
  const cudaError_t err =
      resident_blocks(sample_neighbors_kernel<B>, kSampleThreads, &resident);
  if (err != cudaSuccess) return err;
  const int slices = (f + per - 1) / per;
  constexpr int kWarpsPerBlock = kSampleThreads / kWarp;
  const int64_t wanted =
      ((p + kWarp - 1) / kWarp * slices + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  const unsigned blocks =
      static_cast<unsigned>(wanted < resident ? wanted : resident);
  sample_neighbors_kernel<B><<<blocks, kSampleThreads, 0, stream>>>(
      indptr, indices, frontier, u, out, p, f, per, slices);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: replaces grouped_masked_sum (legion_tpu/ops/spmm_pallas.py:90), the
// SpMM of an identity-layout block:
//
//   out[g, c] = sum_{j < f} x2[g*f + j, c] * mask[g, j]
//
// The mask is bool or holds weights in x2's type; every slot is read and
// multiplied, as the reference multiplies, so a weight of zero on a
// non-finite value gives NaN there as it does in the reference. The
// Pallas kernel streamed (G*f, D) tiles through VMEM for a divisor G of P
// and 128-multiple D only; here any P, f and D run.
//
// Bound: bytes. At full width (P = 121856, f = 10, D = 128 f32) it reads
// 1,218,560 rows of 512 B and writes 121,856, about 0.69 GB, at 1 multiply-
// add per 4 bytes read. Design: one thread per (dst row, 16-byte column
// group); the threads of a warp cover consecutive columns of one row, so
// each of the f slot rows is read by coalesced 16-byte loads (4 f32 or 8
// bf16; single elements where D or a pointer does not allow it) and every
// byte is read once. The f products accumulate in f32 registers and are
// cast once at the store. No shared memory, no reduction across threads.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float weight_of(uint8_t m) {
  return m ? 1.0f : 0.0f;
}
__device__ __forceinline__ float weight_of(float m) { return m; }
__device__ __forceinline__ float weight_of(__nv_bfloat16 m) {
  return __bfloat162float(m);
}

template <typename T, typename Tm, int VEC>
__global__ void __launch_bounds__(kThreads)
grouped_masked_sum_kernel(const T* __restrict__ x, const Tm* __restrict__ mask,
                          T* __restrict__ out, int64_t p, int f, int d) {
  const int groups = d / VEC;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= p * groups) return;
  const int64_t r = t / groups;
  const int c = static_cast<int>(t - r * groups) * VEC;
  const Tm* m = mask + r * f;
  const T* rows = x + r * f * d + c;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int j = 0; j < f; ++j) {
    const float w = weight_of(m[j]);
    float v[VEC];
    load_vec<VEC>(rows + static_cast<int64_t>(j) * d, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] += v[i] * w;
  }
  store_vec<VEC>(out + r * d + c, acc);
}

inline unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Tin, typename Tout>
void launch_agg(const void* x, const uint8_t* mask, void* out, int64_t n,
                int64_t p, int f, int d, int64_t offset, int norm,
                cudaStream_t stream) {
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  const bool vec4 = d % 4 == 0 && aligned(x, 4 * sizeof(Tin)) &&
                    aligned(out, 4 * sizeof(Tout));
  if (vec4) {
    masked_agg_kernel<Tin, Tout, 4><<<blocks_for(p * (d / 4)), kThreads, 0,
                                      stream>>>(xi, mask, o, n, p, f, d,
                                                offset, norm);
  } else {
    masked_agg_kernel<Tin, Tout, 1><<<blocks_for(p * d), kThreads, 0,
                                      stream>>>(xi, mask, o, n, p, f, d,
                                                offset, norm);
  }
}

inline unsigned warp_row_blocks(int64_t rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <typename T>
void launch_gathered(const void* h, const int32_t* pos, const uint8_t* mask,
                     void* out, int64_t n, int64_t p, int f, int d,
                     int64_t ld, int norm, cudaStream_t stream) {
  const T* hi = static_cast<const T*>(h);
  T* o = static_cast<T*>(out);
  const bool vec4 = d % 4 == 0 && ld % 4 == 0 && aligned(h, 4 * sizeof(T)) &&
                    aligned(out, 4 * sizeof(T));
  const unsigned blocks = warp_row_blocks(p);
  if (vec4 && d > 4 * kWarp) {
    gathered_agg_kernel<T, 4, 2><<<blocks, kThreads, 0, stream>>>(
        hi, pos, mask, o, n, p, f, d, ld, norm);
  } else if (vec4) {
    gathered_agg_kernel<T, 4, 1><<<blocks, kThreads, 0, stream>>>(
        hi, pos, mask, o, n, p, f, d, ld, norm);
  } else {
    gathered_agg_kernel<T, 2, 1><<<blocks, kThreads, 0, stream>>>(
        hi, pos, mask, o, n, p, f, d, ld, norm);
  }
}

template <typename Tin, typename Tout>
void launch_feature_mean(const void* x, const int32_t* pos,
                         const uint8_t* mask, void* out, int64_t n, int64_t p,
                         int f, int d, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(Tin);
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  if (d % kVec == 0 && aligned(x, 16) && aligned(out, 16)) {
    feature_mean_kernel<Tin, Tout, kVec>
        <<<blocks_for(p * (d / kVec)), kThreads, 0, stream>>>(
            xi, pos, mask, o, n, p, f, d);
  } else {
    feature_mean_kernel<Tin, Tout, 1>
        <<<blocks_for(p * d), kThreads, 0, stream>>>(xi, pos, mask, o, n, p,
                                                     f, d);
  }
}

template <typename Tg>
void launch_scatter(const void* g, const int32_t* pos, const uint8_t* mask,
                    float* dx, int64_t n, int64_t p, int f, int d, int64_t ld,
                    int norm, cudaStream_t stream) {
  const Tg* gi = static_cast<const Tg*>(g);
  const unsigned blocks = warp_row_blocks(p);
  if (ld % 4 == 0 && aligned(dx, 16)) {
    scatter_rows_kernel<Tg, 4><<<blocks, kThreads, 0, stream>>>(
        gi, pos, mask, dx, n, p, f, d, ld, norm);
  } else if (ld % 2 == 0 && aligned(dx, 8)) {
    scatter_rows_kernel<Tg, 2><<<blocks, kThreads, 0, stream>>>(
        gi, pos, mask, dx, n, p, f, d, ld, norm);
  } else {
    scatter_rows_kernel<Tg, 1><<<blocks, kThreads, 0, stream>>>(
        gi, pos, mask, dx, n, p, f, d, ld, norm);
  }
}

int agg_dispatch(const void* x, int x_dtype, const uint8_t* mask, void* out,
                 int out_dtype, int64_t n, int64_t p, int f, int d,
                 int64_t offset, int norm, cudaStream_t stream) {
  if (p * d == 0) return cudaSuccess;
  if (x_dtype == kF32 && out_dtype == kF32) {
    launch_agg<float, float>(x, mask, out, n, p, f, d, offset, norm, stream);
  } else if (x_dtype == kF32 && out_dtype == kBF16) {
    launch_agg<float, __nv_bfloat16>(x, mask, out, n, p, f, d, offset, norm,
                                     stream);
  } else if (x_dtype == kBF16 && out_dtype == kF32) {
    launch_agg<__nv_bfloat16, float>(x, mask, out, n, p, f, d, offset, norm,
                                     stream);
  } else if (x_dtype == kBF16 && out_dtype == kBF16) {
    launch_agg<__nv_bfloat16, __nv_bfloat16>(x, mask, out, n, p, f, d, offset,
                                             norm, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename W>
void launch_gather(const void* table, const int32_t* ids, void* out,
                   int64_t m, int64_t n, int64_t row_bytes,
                   cudaStream_t stream) {
  const int words = static_cast<int>(row_bytes / sizeof(W));
  gather_rows_kernel<W><<<blocks_for(m * words), kThreads, 0, stream>>>(
      static_cast<const W*>(table), ids, static_cast<W*>(out), m, n, words);
}

template <typename T, typename Tm>
void launch_grouped_sum(const void* x, const void* mask, void* out, int64_t p,
                        int f, int d, cudaStream_t stream) {
  const T* xi = static_cast<const T*>(x);
  const Tm* mi = static_cast<const Tm*>(mask);
  T* o = static_cast<T*>(out);
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && aligned(x, 16) && aligned(out, 16)) {
    grouped_masked_sum_kernel<T, Tm, kVec>
        <<<blocks_for(p * (d / kVec)), kThreads, 0, stream>>>(xi, mi, o, p, f,
                                                              d);
  } else {
    grouped_masked_sum_kernel<T, Tm, 1>
        <<<blocks_for(p * d), kThreads, 0, stream>>>(xi, mi, o, p, f, d);
  }
}

// ---------------------------------------------------------------------------
// The dedup's tail: what grow_frontier (legion_tpu_torch/sampling/sampler.py)
// does after its stable sort of [prev | neighbors] by id (s, the sorted ids,
// padding as kSentinel; sorig, each entry's index before the sort).
//
//   first[i]  s[i] is not padding and differs from s[i-1]: a group leader;
//             an old id when sorig[i] < prev_cap, else a new one
//   rank[i]   new leaders in s[0..i], less one
//   pos       the position of i's group: its leader's sorig if the leader
//             is old, else num_prev + rank[i] (no leader lies between a
//             group's leader and its members, so their rank is its rank)
//   nbr_pos[sorig[i] - prev_cap] = pos, 0 where s[i] is padding
//   frontier_new[sorig[i]] = s[i]  for an old leader below cap_new
//   frontier_new[n_old + rank[i]] = s[i]  for a new leader whose
//             num_prev + rank[i] < cap_new; every other slot -1
//   num_new = num_prev + the count of new leaders (not clamped)
//
// n_old is the count of valid ids in frontier_prev. A frontier keeps its
// valid ids distinct and in front (every frontier grow_frontier makes, and
// the seeds), so old leaders fill [0, n_old) and the new ones follow: the
// slots the plain version gives them by sorting (target, id) pairs, also
// after an overflow (num_prev > prev_cap), where n_old < num_prev.
//
// Replaces no TPU kernel: the JAX dedup (legion_tpu/sampling/sampler.py,
// grow_frontier) is jnp ops (an associative_scan with a "last leader wins"
// operator and two sorts) that XLA lowers. The port ran it as a dozen
// PyTorch passes, among them a one-row torch.cummax, which scans a row on a
// single block (3.3 ms a step on the cached path, PERF.md section 5), and a
// second stable sort for the frontier.
//
// Bound: bytes. It reads s (4 B) and sorig (8 B) once and writes nbr_pos
// once (4 B an edge) and the frontier's filled slots: ~16 B an entry, ~33
// MB and ~0.01 ms at 3.35 TB/s for 2M entries. Design: one pass, one
// launch.
//  * A block takes a tile of kDedupTile consecutive sorted entries, its
//    tile number taken from an atomic counter in launch order, so a tile
//    waits only on tiles that are already running; each thread loads
//    kDedupItems entries with 16-byte loads.
//  * The scan carries (count of new leaders, the last leader's encoded
//    position: its sorig if old, -1 if new, kNoLeader before any): the
//    reference's seg_copy operator with the count added. It runs in
//    registers, across a warp by shuffles and across the block's warps
//    through shared memory; across tiles only the count has to travel,
//    by decoupled look-back (each tile publishes its count, then its
//    inclusive prefix, in one 64-bit word; a warp reads 32 predecessors
//    at a time).
//  * A group that runs in from an earlier tile (a hub's repeats can cover
//    many tiles) finds its leader by a warp's 32-way search of the sorted
//    ids, and n_old comes from one more over frontier_prev, both while the
//    other warps scan.
//  * Writes go straight to their final places: nbr_pos through sorig,
//    leaders into a frontier the wrapper filled with -1. The tile state
//    (counter and words) is zeroed by a memset on the same stream, so a
//    captured graph resets it on every replay.
// ---------------------------------------------------------------------------
constexpr int kDedupThreads = 256;
constexpr int kDedupItems = 4;
constexpr int kDedupTile = kDedupThreads * kDedupItems;
constexpr int kDedupWarps = kDedupThreads / kWarp;
constexpr int32_t kSentinel = 0x7fffffff;
constexpr int32_t kNoLeader = -2;
// a tile's word: its state in the high half, its count in the low half
constexpr unsigned long long kTileAggregate = 1ull << 32;
constexpr unsigned long long kTilePrefix = 2ull << 32;

struct Carry {
  int32_t count;  // new leaders
  int32_t lead;   // the last leader's sorig if old, -1 if new, or kNoLeader
};

// a, then b
__device__ __forceinline__ Carry combine(Carry a, Carry b) {
  return {a.count + b.count, b.lead != kNoLeader ? b.lead : a.lead};
}

__device__ __forceinline__ Carry warp_inclusive(Carry c, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    Carry o;
    o.count = __shfl_up_sync(kFullMask, c.count, d);
    o.lead = __shfl_up_sync(kFullMask, c.lead, d);
    if (lane >= d) c = combine(o, c);
  }
  return c;
}

__device__ __forceinline__ Carry warp_exclusive(Carry inclusive, int lane) {
  Carry e;
  e.count = __shfl_up_sync(kFullMask, inclusive.count, 1);
  e.lead = __shfl_up_sync(kFullMask, inclusive.lead, 1);
  return lane == 0 ? Carry{0, kNoLeader} : e;
}

// The least x in [lo, hi] with pred(x), for a pred that is false then true
// and taken as true at hi; the whole warp calls it and gets the answer.
// Each round the lanes probe 32 evenly spaced points.
template <typename Pred>
__device__ int64_t warp_search(int64_t lo, int64_t hi, int lane, Pred pred) {
  while (lo < hi) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t x = lo + (lane + 1) * step - 1;
    const unsigned m = __ballot_sync(kFullMask, x >= hi || pred(x));
    if (m == 0) return hi;
    const int t = __ffs(m) - 1;
    const int64_t xt = lo + (t + 1) * step - 1;
    hi = xt < hi ? xt : hi;
    lo += t * step;
  }
  return lo;
}

__global__ void __launch_bounds__(kDedupThreads)
dedup_tail_kernel(const int32_t* __restrict__ s,
                  const int64_t* __restrict__ sorig,
                  const int32_t* __restrict__ frontier_prev,
                  const int32_t* __restrict__ num_prev_in,
                  int32_t* __restrict__ frontier_new,
                  int32_t* __restrict__ num_new, int32_t* __restrict__ nbr_pos,
                  unsigned long long* __restrict__ state, int64_t total,
                  int64_t prev_cap, int64_t cap_new, int64_t tiles) {
  __shared__ int64_t tile_sh, n_old_sh;
  __shared__ int32_t head_sh, before_sh;
  __shared__ Carry warp_sum[kDedupWarps], warp_before[kDedupWarps];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x == 0) {
    tile_sh = static_cast<int64_t>(atomicAdd(state, 1ull));
  }
  __syncthreads();
  const int64_t tile = tile_sh;
  const int64_t base = tile * kDedupTile;
  const int64_t i0 = base + static_cast<int64_t>(threadIdx.x) * kDedupItems;
  const int32_t num_prev = __ldg(num_prev_in);

  // this thread's entries; past the end: padding with no origin
  int32_t v[kDedupItems];
  int64_t o[kDedupItems];
  if (i0 + kDedupItems <= total) {
    const int4 w = __ldcs(reinterpret_cast<const int4*>(s + i0));
    const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(sorig + i0));
    const longlong2 b =
        __ldcs(reinterpret_cast<const longlong2*>(sorig + i0 + 2));
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < kDedupItems; ++k) {
      const bool in = i0 + k < total;
      v[k] = in ? s[i0 + k] : kSentinel;
      o[k] = in ? sorig[i0 + k] : -1;
    }
  }
  int32_t prev = __shfl_up_sync(kFullMask, v[kDedupItems - 1], 1);
  if (lane == 0) prev = i0 > 0 && i0 <= total ? __ldg(s + i0 - 1) : kSentinel;

  // the thread's scan over its entries
  Carry local[kDedupItems];
  unsigned first = 0;
  Carry c{0, kNoLeader};
#pragma unroll
  for (int k = 0; k < kDedupItems; ++k) {
    const bool lead = v[k] != kSentinel && v[k] != prev;
    prev = v[k];
    if (lead) {
      first |= 1u << k;
      c = o[k] < prev_cap ? Carry{c.count, static_cast<int32_t>(o[k])}
                          : Carry{c.count + 1, -1};
    }
    local[k] = c;
  }
  const Carry inclusive = warp_inclusive(c, lane);
  const Carry thread_before = warp_exclusive(inclusive, lane);
  if (lane == kWarp - 1) warp_sum[warp] = inclusive;

  if (warp == kDedupWarps - 1) {
    // the leader of a group that runs in from the tile before
    int32_t head = kNoLeader;
    if (base > 0 && base < total) {
      const int32_t x = __ldg(s + base);
      if (x != kSentinel && __ldg(s + base - 1) == x) {
        auto at_or_past = [&](int64_t q) { return __ldg(s + q) >= x; };
        const int64_t lo = base > kWarp ? base - kWarp : 0;
        int64_t y = warp_search(lo, base, lane, at_or_past);
        if (y == lo && lo > 0) y = warp_search(0, lo, lane, at_or_past);
        const int64_t so = __ldg(sorig + y);
        head = so < prev_cap ? static_cast<int32_t>(so) : -1;
      }
    }
    if (lane == 0) head_sh = head;
  } else if (warp == kDedupWarps - 2) {
    // n_old: the valid ids of frontier_prev stand in front; num_prev
    // usually says where they end
    const int64_t g = num_prev < prev_cap ? num_prev : prev_cap;
    const bool ends_at_g = (g == 0 || __ldg(frontier_prev + g - 1) >= 0) &&
                           (g == prev_cap || __ldg(frontier_prev + g) < 0);
    const int64_t n_old =
        ends_at_g ? g : warp_search(0, prev_cap, lane, [&](int64_t q) {
          return __ldg(frontier_prev + q) < 0;
        });
    if (lane == 0) n_old_sh = n_old;
  }
  __syncthreads();

  if (warp == 0) {
    const Carry ws =
        lane < kDedupWarps ? warp_sum[lane] : Carry{0, kNoLeader};
    const Carry wi = warp_inclusive(ws, lane);
    const Carry we = warp_exclusive(wi, lane);
    if (lane < kDedupWarps) warp_before[lane] = we;
    const int32_t agg = __shfl_sync(kFullMask, wi.count, kDedupWarps - 1);
    volatile unsigned long long* words = state + 1;
    int32_t before = 0;
    if (tile == 0) {
      if (lane == 0) words[0] = kTilePrefix | static_cast<uint32_t>(agg);
    } else {
      if (lane == 0) {
        words[tile] = kTileAggregate | static_cast<uint32_t>(agg);
      }
      // look back over the predecessors, 32 at a time, up to the nearest
      // that has published its inclusive prefix
      for (int64_t j = tile - 1;; j -= kWarp) {
        const int64_t t = j - lane;
        unsigned long long w = kTilePrefix;
        if (t >= 0) {
          do {
            w = words[t];
          } while ((w >> 32) == 0);
        }
        const unsigned done = __ballot_sync(kFullMask, w >= kTilePrefix);
        const int last = done ? __ffs(done) - 1 : kWarp - 1;
        int32_t add = lane <= last ? static_cast<int32_t>(w & 0xffffffffu) : 0;
#pragma unroll
        for (int d = kWarp / 2; d > 0; d >>= 1) {
          add += __shfl_xor_sync(kFullMask, add, d);
        }
        before += add;
        if (done) break;
      }
      if (lane == 0) {
        words[tile] = kTilePrefix | static_cast<uint32_t>(before + agg);
      }
    }
    if (lane == 0) {
      before_sh = before;
      if (tile == tiles - 1) *num_new = num_prev + before + agg;
    }
  }
  __syncthreads();

  const int32_t tile_before = before_sh;
  const int64_t n_old = n_old_sh;
  const Carry start =
      combine(combine(Carry{0, head_sh}, warp_before[warp]), thread_before);
#pragma unroll
  for (int k = 0; k < kDedupItems; ++k) {
    if (o[k] < 0) continue;
    const Carry e = combine(start, local[k]);
    const int32_t rank = tile_before + e.count - 1;
    if (o[k] >= prev_cap) {
      nbr_pos[o[k] - prev_cap] =
          v[k] == kSentinel ? 0 : e.lead >= 0 ? e.lead : num_prev + rank;
    }
    if (first >> k & 1u) {
      if (o[k] < prev_cap) {
        if (o[k] < cap_new) frontier_new[o[k]] = v[k];
      } else if (static_cast<int64_t>(num_prev) + rank < cap_new &&
                 n_old + rank < cap_new) {
        frontier_new[n_old + rank] = v[k];
      }
    }
  }
}

}  // namespace

extern "C" {

int legion_identity_masked_mean(const void* x, int x_dtype, const void* mask,
                                void* out, int out_dtype, int64_t n, int64_t p,
                                int f, int d, int64_t offset, int norm,
                                void* stream) {
  return agg_dispatch(x, x_dtype, static_cast<const uint8_t*>(mask), out,
                      out_dtype, n, p, f, d, offset, norm,
                      static_cast<cudaStream_t>(stream));
}

// h: n rows of d elements, ld elements apart (ld >= d); out: (p, d)
// contiguous in h's type.
int legion_gathered_masked_mean(const void* h, int dtype, const void* pos,
                                const void* mask, void* out, int64_t n,
                                int64_t p, int f, int d, int64_t ld, int norm,
                                void* stream) {
  if (p * d == 0) return cudaSuccess;
  if (ld < d) return cudaErrorInvalidValue;
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* ms = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    launch_gathered<float>(h, ps, ms, out, n, p, f, d, ld, norm, s);
  } else if (dtype == kBF16) {
    launch_gathered<__nv_bfloat16>(h, ps, ms, out, n, p, f, d, ld, norm, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// x: (n, d) contiguous; out: (p, d) contiguous in out_dtype.
int legion_gathered_feature_mean(const void* x, int x_dtype, const void* pos,
                                 const void* mask, void* out, int out_dtype,
                                 int64_t n, int64_t p, int f, int d,
                                 void* stream) {
  if (p * d == 0) return cudaSuccess;
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* ms = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && out_dtype == kF32) {
    launch_feature_mean<float, float>(x, ps, ms, out, n, p, f, d, s);
  } else if (x_dtype == kF32 && out_dtype == kBF16) {
    launch_feature_mean<float, __nv_bfloat16>(x, ps, ms, out, n, p, f, d, s);
  } else if (x_dtype == kBF16 && out_dtype == kF32) {
    launch_feature_mean<__nv_bfloat16, float>(x, ps, ms, out, n, p, f, d, s);
  } else if (x_dtype == kBF16 && out_dtype == kBF16) {
    launch_feature_mean<__nv_bfloat16, __nv_bfloat16>(x, ps, ms, out, n, p, f,
                                                      d, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dx: the zeroed (n, ld) f32 staging buffer, ld >= d; g: (p, d) contiguous.
int legion_gathered_masked_mean_bwd(const void* g, int g_dtype,
                                    const void* pos, const void* mask,
                                    void* dx, int64_t n, int64_t p, int f,
                                    int d, int64_t ld, int norm,
                                    void* stream) {
  if (p * d == 0) return cudaSuccess;
  if (ld < d) return cudaErrorInvalidValue;
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* ms = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == kF32) {
    launch_scatter<float>(g, ps, ms, o, n, p, f, d, ld, norm, s);
  } else if (g_dtype == kBF16) {
    launch_scatter<__nv_bfloat16>(g, ps, ms, o, n, p, f, d, ld, norm, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out (n, d) contiguous in out_dtype, 16-byte aligned <- the first d columns
// of the (n, ld) f32 staging buffer.
int legion_narrow_rows(const void* in, void* out, int out_dtype, int64_t n,
                       int d, int64_t ld, void* stream) {
  const int64_t total = n * d;
  if (total == 0) return cudaSuccess;
  if (ld < d || !aligned(out, 16)) return cudaErrorInvalidValue;
  const float* src = static_cast<const float*>(in);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for((total + 3) / 4);
  if (out_dtype == kF32) {
    narrow_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        src, static_cast<float*>(out), total, d, ld);
  } else if (out_dtype == kBF16) {
    narrow_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        src, static_cast<__nv_bfloat16*>(out), total, d, ld);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int legion_gather_rows(const void* table, const void* ids, void* out,
                       int64_t m, int64_t n, int64_t row_bytes,
                       void* stream) {
  if (m * row_bytes == 0) return cudaSuccess;
  const int32_t* id = static_cast<const int32_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16)) {
    launch_gather<uint4>(table, id, out, m, n, row_bytes, s);
  } else if (row_bytes % 4 == 0 && aligned(table, 4) && aligned(out, 4)) {
    launch_gather<uint32_t>(table, id, out, m, n, row_bytes, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int legion_sample_neighbors(const void* indptr, const void* indices,
                            const void* frontier, const void* u, void* out,
                            int64_t p, int f, void* stream) {
  if (p * f == 0) return cudaSuccess;
  // Rounds a warp takes of its tile: all f while the tiles fill
  // kSampleWarpsPerSm warps on every SM, else the tile is cut into slices
  // until they do; never more than 32.
  static int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (p + kWarp - 1) / kWarp;
  const int64_t fill = static_cast<int64_t>(sms) * kSampleWarpsPerSm / tiles;
  const int cut = static_cast<int>(fill < 1 ? 1 : fill < f ? fill : f);
  int per = (f + cut - 1) / cut;
  per = per < kWarp ? per : kWarp;
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* uf = static_cast<const float*>(u);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per <= 4) return launch_sample<4>(ip, ix, fr, uf, o, p, f, per, s);
  if (per <= 8) return launch_sample<8>(ip, ix, fr, uf, o, p, f, per, s);
  if (per <= 16) return launch_sample<16>(ip, ix, fr, uf, o, p, f, per, s);
  return launch_sample<32>(ip, ix, fr, uf, o, p, f, per, s);
}

// mask_is_weight == 0: a bool mask (one byte per slot); otherwise weights
// in x's type.
int legion_grouped_masked_sum(const void* x, int dtype, const void* mask,
                              int mask_is_weight, void* out, int64_t p, int f,
                              int d, void* stream) {
  if (p * d == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && !mask_is_weight) {
    launch_grouped_sum<float, uint8_t>(x, mask, out, p, f, d, s);
  } else if (dtype == kF32) {
    launch_grouped_sum<float, float>(x, mask, out, p, f, d, s);
  } else if (dtype == kBF16 && !mask_is_weight) {
    launch_grouped_sum<__nv_bfloat16, uint8_t>(x, mask, out, p, f, d, s);
  } else if (dtype == kBF16) {
    launch_grouped_sum<__nv_bfloat16, __nv_bfloat16>(x, mask, out, p, f, d,
                                                     s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// s (total,) int32 and sorig (total,) int64, both 16-byte aligned: the stable
// sort of [frontier_prev | neighbors]; frontier_new (cap_new,) filled with -1;
// nbr_pos (total - prev_cap,); state (tiles + 1,) 64-bit words, zeroed here.
int legion_dedup_tail(const void* s, const void* sorig,
                      const void* frontier_prev, const void* num_prev,
                      void* frontier_new, void* num_new, void* nbr_pos,
                      void* state, int64_t total, int64_t prev_cap,
                      int64_t cap_new, void* stream) {
  if (total <= 0 || !aligned(s, 16) || !aligned(sorig, 16)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (total + kDedupTile - 1) / kDedupTile;
  unsigned long long* words = static_cast<unsigned long long*>(state);
  const cudaError_t err =
      cudaMemsetAsync(words, 0, (tiles + 1) * sizeof(*words), st);
  if (err != cudaSuccess) return err;
  dedup_tail_kernel<<<static_cast<unsigned>(tiles), kDedupThreads, 0, st>>>(
      static_cast<const int32_t*>(s), static_cast<const int64_t*>(sorig),
      static_cast<const int32_t*>(frontier_prev),
      static_cast<const int32_t*>(num_prev),
      static_cast<int32_t*>(frontier_new), static_cast<int32_t*>(num_new),
      static_cast<int32_t*>(nbr_pos), words, total, prev_cap, cap_new, tiles);
  return cudaGetLastError();
}

}  // extern "C"


// ---------------------------------------------------------------------------
// GAT's edge-softmax aggregation (legion_tpu_torch/ops/gat_attention.py):
// for each dst row d < *num_dst and head h, over the valid sampled slots of
// row d whose position is not d, plus one self slot at position d,
//
//   e     = leaky_relu(a_src[j, h] + a_dst[d, h], 0.2)
//   alpha = softmax over the row's scored slots of e
//   out[d, h, :] = sum alpha * z[j, h, :]
//
// Replaces no TPU kernel: legion_tpu has no GAT. PyTorch would compute it
// as a gather of every slot's z row into a (D, F + 1, H, C) tensor (9.4 GB
// in float32 at the products cell's layer 0) and several passes over it.
//
// Bound: bytes. A score is 2 flops a slot and the weighted sum 2 a
// column, against 2 bytes (bf16) read a column: under 1 flop a byte. At
// layer 0 of the products cell the rows are 1,024 bytes (4 heads of 128
// bf16) and each src row is named by about three slots, so the least
// bytes are the 1.4M src rows read once; a gather reads each slot's row
// segment (256 B a head) once, from the L2 where a neighbour row was read
// recently, else from device memory.
//
// Forward (edge_softmax_fwd_kernel): one warp per (dst row, head), so a
// head's softmax is one warp's reductions and no block-level
// synchronisation is needed. Lane j scores slot j (a_src and a_dst are
// precomputed (S, H) and (D, H) score matrices, the products of z with the
// attention vectors, so scoring reads no z row); an online max-and-sum
// per lane and two butterfly reductions give the row's softmax, whose
// (max, 1 / sum) the kernel keeps for the backward (8 bytes a row and
// head). Then the lanes walk the scored slots (ballot, then shuffles of
// each slot's row and weight), four at a time so that four VEC-wide loads
// of the slot rows' head segments are in flight, and sum in f32
// registers; VEC = 4 where the head width allows 32 lanes of 4. The
// output row is written once, in z's type. Rows at or past *num_dst (read
// on the device, so a captured step needs no host value) are zero.
//
// Backward: d out -> dz, da_src, da_dst. dz[j] = sum over the slots that
// name j of alpha * g[d] is a sum over a src row's slots, so the backward
// turns the slots around (a counting sort by position: count, then
// PyTorch's cumsum of the counts, then place, with int atomics on arrays
// that stay in the L2; then each placed slot's weights for every head) and
// runs one warp per src row (edge_softmax_src_kernel): it holds z[j] in
// registers, reads each naming dst row's gradient once, sums alpha * g in
// f32 registers and writes dz[j] once in z's type, and in the same pass
// takes each slot's dot g[d] . z[j] per head, the gradient of its weight.
// No f32 staging of dz and no float atomics into rows far larger than the
// L2: on an H100 at the products cell's layer-0 shapes a scatter with
// 16-byte f32 atomics took 13.2 ms against the forward's 2.2, this pass
// 5.5 (one warp a (row, head): 6.3; a (row, 256-column pass): 9.7). Then
// one warp per (dst row, head) (edge_softmax_dst_kernel) runs the
// softmax's and the leaky ReLU's backward over the row's slots: da_dst is
// one value a (row, head), written once; da_src gets one f32 atomic a
// slot into an (S, H) staging array that fits the L2, cast to z's type
// by edge_softmax_cast_kernel. edge_softmax_zero_kernel zeroes the
// counts, the ranks and that array in one pass.
// ---------------------------------------------------------------------------
namespace {

constexpr float kGatSlope = 0.2f;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum_f(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Slot s of dst row d: the sampled slot s < f (scored if valid, not d and
// inside the n rows), or the self slot s == f (scored).
struct GatSlot {
  int64_t row;
  bool ok;
};

__device__ __forceinline__ GatSlot gat_slot(const int32_t* __restrict__ pos,
                                            const uint8_t* __restrict__ mask,
                                            int64_t d, int f, int s,
                                            int64_t n) {
  if (s == f) return {d, true};
  if (s > f) return {0, false};
  const int64_t p = pos[d * f + s];
  return {p, mask[d * f + s] != 0 && p != d && p >= 0 && p < n};
}

__device__ __forceinline__ float leaky(float x) {
  return x > 0.0f ? x : kGatSlope * x;
}

// The weight of a slot whose raw score is x, under its row's softmax.
__device__ __forceinline__ float gat_weight(float x, float2 sm) {
  return expf(leaky(x) - sm.x) * sm.y;
}

// The softmax of row d, head h: (max, 1 / sum) over its scored slots.
template <typename T>
__device__ __forceinline__ float2 gat_softmax(
    const T* __restrict__ a_src, int64_t lds, const int32_t* __restrict__ pos,
    const uint8_t* __restrict__ mask, int64_t d, int f, int h, int64_t n,
    float adst, int lane) {
  float m = neg_inf(), sum = 0.0f;
  for (int s0 = 0; s0 <= f; s0 += kWarp) {
    const GatSlot sl = gat_slot(pos, mask, d, f, s0 + lane, n);
    if (sl.ok) {
      const float e = leaky(to_f32(a_src[sl.row * lds + h]) + adst);
      if (e > m) {
        sum = sum * expf(m - e) + 1.0f;
        m = e;
      } else {
        sum += expf(e - m);
      }
    }
  }
  const float top = warp_max_f(m);
  const float total = warp_sum_f(m == neg_inf() ? 0.0f : sum * expf(m - top));
  return make_float2(top, 1.0f / total);
}

// out: (p, heads, c); stats: (p, heads) (max, 1 / sum), for the backward.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
edge_softmax_fwd_kernel(const T* __restrict__ z, const T* __restrict__ a_src,
                        int64_t lds, const T* __restrict__ a_dst, int64_t ldd,
                        const int32_t* __restrict__ pos,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ num_dst,
                        T* __restrict__ out, float2* __restrict__ stats,
                        int64_t n, int64_t p, int f, int heads, int c) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                       threadIdx.x / kWarp;
  if (item >= p * heads) return;
  const int64_t d = item / heads;
  const int h = static_cast<int>(item - d * heads);
  T* o = out + item * c;
  if (d >= *num_dst) {
    for (int cc = lane; cc < c; cc += kWarp) o[cc] = from_f32<T>(0.0f);
    if (lane == 0) stats[item] = make_float2(0.0f, 0.0f);
    return;
  }
  const float adst = to_f32(a_dst[d * ldd + h]);
  const float2 sm = gat_softmax(a_src, lds, pos, mask, d, f, h, n, adst, lane);
  if (lane == 0) stats[item] = sm;
  for (int c0 = 0; c0 < c; c0 += kWarp * VEC) {
    const int cc = c0 + lane * VEC;
    const bool col = cc < c;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    for (int s0 = 0; s0 <= f; s0 += kWarp) {
      const GatSlot sl = gat_slot(pos, mask, d, f, s0 + lane, n);
      const float alpha =
          sl.ok ? gat_weight(to_f32(a_src[sl.row * lds + h]) + adst, sm)
                : 0.0f;
      unsigned todo = __ballot_sync(kFullMask, sl.ok);
      while (todo) {
        int64_t rows[4];
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rows[k] = -1;
          w[k] = 0.0f;
          if (todo) {
            const int j = __ffs(todo) - 1;
            todo &= todo - 1;
            rows[k] = __shfl_sync(kFullMask, sl.row, j);
            w[k] = __shfl_sync(kFullMask, alpha, j);
          }
        }
        float v[4][VEC];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (col && rows[k] >= 0) {
            load_vec<VEC>(z + (rows[k] * heads + h) * c + cc, v[k]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) v[k][i] = 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += w[k] * v[k][i];
      }
    }
    if (col) store_vec<VEC>(o + cc, acc);
  }
}

// The slots turned around, one thread a slot entry e = d * (f + 1) + s:
// counts of each position (at cnt[row + 1]), then each scored entry placed
// at off[row] + its rank among the row's (cur: zeroed ranks).
__global__ void __launch_bounds__(kThreads)
edge_softmax_count_kernel(const int32_t* __restrict__ pos,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ num_dst,
                          int32_t* __restrict__ cnt, int64_t n, int64_t p,
                          int f) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= p * (f + 1)) return;
  const int64_t d = e / (f + 1);
  if (d >= *num_dst) return;
  const GatSlot sl =
      gat_slot(pos, mask, d, f, static_cast<int>(e - d * (f + 1)), n);
  if (sl.ok) atomicAdd(cnt + sl.row + 1, 1);
}

__global__ void __launch_bounds__(kThreads)
edge_softmax_place_kernel(const int32_t* __restrict__ pos,
                          const uint8_t* __restrict__ mask,
                          const int32_t* __restrict__ num_dst,
                          const int32_t* __restrict__ off,
                          int32_t* __restrict__ cur,
                          int32_t* __restrict__ entries, int64_t n, int64_t p,
                          int f) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= p * (f + 1)) return;
  const int64_t d = e / (f + 1);
  if (d >= *num_dst) return;
  const GatSlot sl =
      gat_slot(pos, mask, d, f, static_cast<int>(e - d * (f + 1)), n);
  if (sl.ok) {
    entries[off[sl.row] + atomicAdd(cur + sl.row, 1)] =
        static_cast<int32_t>(e);
  }
}

// Each placed entry's weights, one thread an entry, heads side by side:
// w[k, h] = alpha of entry entries[k] under head h.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_softmax_weights_kernel(const T* __restrict__ a_src, int64_t lds,
                            const T* __restrict__ a_dst, int64_t ldd,
                            const int32_t* __restrict__ pos,
                            const float2* __restrict__ stats,
                            const int32_t* __restrict__ off,
                            const int32_t* __restrict__ entries,
                            float* __restrict__ w, int64_t n, int f,
                            int heads) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= off[n]) return;
  const int32_t e = entries[k];
  const int64_t d = e / (f + 1);
  const int s = static_cast<int>(e - d * (f + 1));
  const int64_t row = s == f ? d : pos[e - d];
  for (int h = 0; h < heads; ++h) {
    w[k * heads + h] = gat_weight(to_f32(a_src[row * lds + h]) +
                                      to_f32(a_dst[d * ldd + h]),
                                  stats[d * heads + h]);
  }
}

// f32 adds of VEC values into p (aligned to 4 * min(VEC, 4) bytes), 16
// bytes an atomic where VEC allows.
template <int VEC>
__device__ __forceinline__ void add_f32(float* p, const float (&v)[VEC]) {
  if constexpr (VEC <= 4) {
    add_vec<VEC>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      const float part[4] = {v[q], v[q + 1], v[q + 2], v[q + 3]};
      add_vec<4>(p + q, part);
    }
  }
}

// The entries [lo, hi) that name src row j, every head: sum w * g[d] into
// dz_row (stored, in T) or, for a part of a heavy row, into stage_row (f32
// atomics); dalpha[e, h] = g[d, h] . z[j, h]. A lane holds NCH chunks of
// VEC columns (chunk i at column (i * 32 + lane) * VEC of a pass), so the
// whole row is one pass where it fits and the warp's chain of dependent
// loads (entries, then gradient rows) is walked once; entries go two at a
// time. A head's dot is a butterfly over the lanes, the other heads'
// columns masked out.
// VEC elements of T as loaded, one word, unpacked to f32 where used: a
// bf16 row segment keeps half the registers of its f32 copy.
template <int VEC, typename T>
struct Packed {
  typename Word<static_cast<int>(VEC * sizeof(T))>::type w;
  __device__ __forceinline__ void load(const T* p) {
    w = *reinterpret_cast<const decltype(w)*>(p);
  }
  __device__ __forceinline__ void zero() { w = decltype(w){}; }
  __device__ __forceinline__ float at(int i) const {
    return to_f32(reinterpret_cast<const T*>(&w)[i]);
  }
};

template <typename T, int VEC, int NCH>
__device__ __forceinline__ void gat_src_entries(
    const T* __restrict__ g, const T* __restrict__ z,
    const int32_t* __restrict__ entries, const float* __restrict__ w,
    T* __restrict__ dz_row, float* __restrict__ stage_row,
    float* __restrict__ dalpha, int64_t j, int64_t lo, int64_t hi, int f,
    int heads, int c, int lane) {
  const int width = heads * c;
  for (int c0 = 0; c0 < width; c0 += kWarp * VEC * NCH) {
    int cc[NCH], hd[NCH];
    Packed<VEC, T> zv[NCH];
    float acc[NCH][VEC];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      cc[i] = c0 + (i * kWarp + lane) * VEC;
      hd[i] = cc[i] < width ? cc[i] / c : -1;
#pragma unroll
      for (int u = 0; u < VEC; ++u) acc[i][u] = 0.0f;
      zv[i].zero();
      if (hd[i] >= 0 && hi > lo) zv[i].load(z + j * width + cc[i]);
    }
    const int h_lo = c0 / c;
    const int h_hi = min(heads - 1, (c0 + kWarp * VEC * NCH - 1) / c);
    for (int64_t k0 = lo; k0 < hi; k0 += 2) {
      int32_t es[2];
      Packed<VEC, T> v[2][NCH];
      float wk[2][NCH];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const bool live = k0 + k < hi;
        es[k] = live ? entries[k0 + k] : -1;
        const T* grow = g + (live ? es[k] / (f + 1) : 0) * width;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          wk[k][i] = live && hd[i] >= 0 ? w[(k0 + k) * heads + hd[i]] : 0.0f;
          v[k][i].zero();
          if (live && hd[i] >= 0) v[k][i].load(grow + cc[i]);
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float dot[NCH];
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          dot[i] = 0.0f;
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const float x = v[k][i].at(u);
            acc[i][u] += wk[k][i] * x;
            dot[i] += x * zv[i].at(u);
          }
        }
        if (es[k] < 0) continue;
        for (int hh = h_lo; hh <= h_hi; ++hh) {
          float mine = 0.0f;
#pragma unroll
          for (int i = 0; i < NCH; ++i) mine += hd[i] == hh ? dot[i] : 0.0f;
          const float t = warp_sum_f(mine);
          if (lane == 0) {
            // a head that began in an earlier pass adds to its dot (a
            // read back that stalls the warp, so only then)
            float* at = dalpha + static_cast<int64_t>(es[k]) * heads + hh;
            if (hh * c >= c0) {
              *at = t;
            } else {
              *at += t;
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      if (hd[i] < 0) continue;
      if (stage_row != nullptr) {
        add_f32<VEC>(stage_row + cc[i], acc[i]);
      } else {
        store_vec<VEC>(dz_row + cc[i], acc[i]);
      }
    }
  }
}

// One warp per src row j named by at most `chunk` entries: its dz row,
// written once (zero for a row no slot names). Rows named by more (the
// hubs of a skewed graph: one can be named by tens of thousands of slots,
// which one warp would walk alone while the rest of the card idles) are
// left to edge_softmax_heavy_kernel.
template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kThreads, 4)
edge_softmax_src_kernel(const T* __restrict__ g, const T* __restrict__ z,
                        const int32_t* __restrict__ off,
                        const int32_t* __restrict__ entries,
                        const float* __restrict__ w, T* __restrict__ dz,
                        float* __restrict__ dalpha, int64_t n, int f,
                        int heads, int c, int chunk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  if (j >= n) return;
  const int64_t lo = off[j], hi = off[j + 1];
  if (hi - lo > chunk) return;
  gat_src_entries<T, VEC, NCH>(g, z, entries, w, dz + j * heads * c,
                               nullptr, dalpha, j, lo, hi, f, heads, c,
                               lane);
}

// One warp per `chunk` entries of a heavy row: hrank (inclusive count of
// heavy rows up to each row) numbers the heavy rows, cprefix (inclusive
// count of their chunks) numbers the chunks; a warp finds its row by a
// binary search over cprefix and adds its part of dz into the row's f32
// staging row (zeroed), which edge_softmax_finish_kernel casts.
template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kThreads, 4)
edge_softmax_heavy_kernel(const T* __restrict__ g, const T* __restrict__ z,
                          const int32_t* __restrict__ off,
                          const int32_t* __restrict__ entries,
                          const float* __restrict__ w,
                          const int32_t* __restrict__ hrank,
                          const int32_t* __restrict__ cprefix,
                          float* __restrict__ stage,
                          float* __restrict__ dalpha, int64_t n, int f,
                          int heads, int c, int chunk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  if (n == 0 || q >= cprefix[n - 1]) return;
  int64_t a = 0, b = n - 1;          // the first row whose prefix passes q
  while (a < b) {
    const int64_t m = (a + b) / 2;
    if (cprefix[m] > q) {
      b = m;
    } else {
      a = m + 1;
    }
  }
  const int64_t lo_row = off[a], hi_row = off[a + 1];
  const int64_t chunks = (hi_row - lo_row + chunk - 1) / chunk;
  const int64_t first = cprefix[a] - chunks;
  const int64_t lo = lo_row + (q - first) * chunk;
  const int64_t hi = min(hi_row, lo + chunk);
  gat_src_entries<T, VEC, NCH>(
      g, z, entries, w, nullptr,
      stage + static_cast<int64_t>(hrank[a] - 1) * heads * c, dalpha, a, lo,
      hi, f, heads, c, lane);
}

// The heavy rows' f32 staging: its rows up to the count of heavy rows
// (hrank's last) zeroed, one warp a row; then each heavy row cast into its
// dz row.
__global__ void __launch_bounds__(kThreads)
edge_softmax_zero_rows_kernel(float* __restrict__ stage,
                              const int32_t* __restrict__ hrank, int64_t n,
                              int width, int64_t rows) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  if (r >= rows || r >= hrank[n - 1]) return;
  for (int cc = lane; cc < width; cc += kWarp) stage[r * width + cc] = 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_softmax_finish_kernel(const float* __restrict__ stage,
                           const int32_t* __restrict__ off,
                           const int32_t* __restrict__ hrank,
                           T* __restrict__ dz, int64_t n, int width,
                           int chunk) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                    threadIdx.x / kWarp;
  if (j >= n || off[j + 1] - off[j] <= chunk) return;
  const float* src = stage + static_cast<int64_t>(hrank[j] - 1) * width;
  for (int cc = lane; cc < width; cc += kWarp)
    dz[j * width + cc] = from_f32<T>(src[cc]);
}

// One warp per (dst row d, head h), lane s on slot s: the softmax's and
// the leaky ReLU's backward; da_dst written once, da_s (f32, zeroed) one
// atomic a slot.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_softmax_dst_kernel(const T* __restrict__ a_src, int64_t lds,
                        const T* __restrict__ a_dst, int64_t ldd,
                        const int32_t* __restrict__ pos,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ num_dst,
                        const float2* __restrict__ stats,
                        const float* __restrict__ dalpha,
                        float* __restrict__ da_s, T* __restrict__ da_dst,
                        int64_t n, int64_t p, int f, int heads) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                       threadIdx.x / kWarp;
  if (item >= p * heads) return;
  const int64_t d = item / heads;
  const int h = static_cast<int>(item - d * heads);
  if (d >= *num_dst) {
    if (lane == 0) da_dst[item] = from_f32<T>(0.0f);
    return;
  }
  const float adst = to_f32(a_dst[d * ldd + h]);
  const float2 sm = stats[item];
  float t = 0.0f;
  for (int s = lane; s <= f; s += kWarp) {
    const GatSlot sl = gat_slot(pos, mask, d, f, s, n);
    if (sl.ok) {
      t += gat_weight(to_f32(a_src[sl.row * lds + h]) + adst, sm) *
           dalpha[(d * (f + 1) + s) * heads + h];
    }
  }
  t = warp_sum_f(t);
  float ddst = 0.0f;
  for (int s = lane; s <= f; s += kWarp) {
    const GatSlot sl = gat_slot(pos, mask, d, f, s, n);
    if (!sl.ok) continue;
    const float raw = to_f32(a_src[sl.row * lds + h]) + adst;
    const float de = gat_weight(raw, sm) *
                     (dalpha[(d * (f + 1) + s) * heads + h] - t);
    const float ds = raw > 0.0f ? de : kGatSlope * de;
    atomicAdd(da_s + sl.row * heads + h, ds);
    ddst += ds;
  }
  ddst = warp_sum_f(ddst);
  if (lane == 0) da_dst[item] = from_f32<T>(ddst);
}

// A zero fill of 4-byte words and a cast of f32 to T: one thread per 4
// consecutive elements.
__global__ void __launch_bounds__(kThreads)
edge_softmax_zero_kernel(float* __restrict__ buf, int64_t total) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i0 + 4 <= total) {
    *reinterpret_cast<float4*>(buf + i0) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int64_t i = i0; i < total; ++i) buf[i] = 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_softmax_cast_kernel(const float* __restrict__ in, T* __restrict__ out,
                         int64_t total) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  for (int64_t i = i0; i < total && i < i0 + 4; ++i)
    out[i] = from_f32<T>(in[i]);
}

// The widest of 4, 2, 1 elements that divides the head width, leaves no
// lane of a 32-lane pass idle (or is 1), and keeps both pointers aligned.
template <typename T>
int gat_vec(int c, const void* a, const void* b) {
  for (int v = 4; v > 1; v >>= 1) {
    const int bytes = v * static_cast<int>(sizeof(T));
    if (c % v == 0 && c / v >= kWarp && aligned(a, bytes) && aligned(b, bytes))
      return v;
  }
  return 1;
}

inline unsigned warps_for(int64_t items) {
  return static_cast<unsigned>((items + kRowsPerBlock - 1) / kRowsPerBlock);
}

inline unsigned threads_for(int64_t items) {
  return static_cast<unsigned>((items + kThreads - 1) / kThreads);
}

template <typename T>
void launch_gat_fwd(const void* z, const void* as, int64_t lds,
                    const void* ad, int64_t ldd, const int32_t* pos,
                    const uint8_t* mask, const int32_t* num_dst, void* out,
                    float2* stats, int64_t n, int64_t p, int f, int heads,
                    int c, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  const T* ast = static_cast<const T*>(as);
  const T* adt = static_cast<const T*>(ad);
  T* o = static_cast<T*>(out);
  const unsigned blocks = warps_for(p * heads);
  switch (gat_vec<T>(c, z, out)) {
    case 4:
      edge_softmax_fwd_kernel<T, 4><<<blocks, kThreads, 0, s>>>(
          zt, ast, lds, adt, ldd, pos, mask, num_dst, o, stats, n, p, f,
          heads, c);
      break;
    case 2:
      edge_softmax_fwd_kernel<T, 2><<<blocks, kThreads, 0, s>>>(
          zt, ast, lds, adt, ldd, pos, mask, num_dst, o, stats, n, p, f,
          heads, c);
      break;
    default:
      edge_softmax_fwd_kernel<T, 1><<<blocks, kThreads, 0, s>>>(
          zt, ast, lds, adt, ldd, pos, mask, num_dst, o, stats, n, p, f,
          heads, c);
  }
}

// The src pass's VEC: the widest of 8, 4, 2, 1 elements (16 bytes at
// most) that divides the head width and keeps both pointers aligned.
template <typename T>
int gat_row_vec(int c, const void* a, const void* b) {
  for (int v = 16 / static_cast<int>(sizeof(T)); v > 1; v >>= 1) {
    const int bytes = v * static_cast<int>(sizeof(T));
    if (c % v == 0 && aligned(a, bytes) && aligned(b, bytes)) return v;
  }
  return 1;
}

// The src pass's kernels. NCH = 2 chunks a lane: a row of 4 heads of 128
// bf16 is one pass; wider rows (or float32 ones) take more passes, and
// fewer template instances keep the build short.
struct GatHeavy {
  const int32_t* hrank;
  const int32_t* cprefix;
  float* stage;
  int64_t chunks_bound;
  int64_t stage_rows;
};

template <typename T, int VEC>
void launch_gat_src(const T* g, const T* z, const int32_t* off,
                    const int32_t* entries, const float* w, T* dz,
                    float* dalpha, const GatHeavy& hv, int64_t n, int f,
                    int heads, int c, int chunk, cudaStream_t s) {
  constexpr int kNch = 2;
  const int64_t width = static_cast<int64_t>(heads) * c;
  edge_softmax_src_kernel<T, VEC, kNch><<<warps_for(n), kThreads, 0, s>>>(
      g, z, off, entries, w, dz, dalpha, n, f, heads, c, chunk);
  edge_softmax_zero_rows_kernel<<<warps_for(hv.stage_rows), kThreads, 0,
                                  s>>>(hv.stage, hv.hrank, n,
                                       static_cast<int>(width),
                                       hv.stage_rows);
  edge_softmax_heavy_kernel<T, VEC, kNch>
      <<<warps_for(hv.chunks_bound), kThreads, 0, s>>>(
          g, z, off, entries, w, hv.hrank, hv.cprefix, hv.stage, dalpha, n,
          f, heads, c, chunk);
  edge_softmax_finish_kernel<T><<<warps_for(n), kThreads, 0, s>>>(
      hv.stage, off, hv.hrank, dz, n, static_cast<int>(width), chunk);
}

template <typename T>
void launch_gat_bwd(const void* g, const void* z, const void* as,
                    int64_t lds, const void* ad, int64_t ldd,
                    const int32_t* pos, const uint8_t* mask,
                    const int32_t* num_dst, const float2* stats,
                    const int32_t* off, int32_t* cur, int32_t* entries,
                    float* w, float* dalpha, float* da_s, const GatHeavy& hv,
                    void* dz, void* da_src, void* da_dst, int64_t n,
                    int64_t p, int f, int heads, int c, int chunk,
                    cudaStream_t s) {
  const T* gt = static_cast<const T*>(g);
  const T* zt = static_cast<const T*>(z);
  const T* ast = static_cast<const T*>(as);
  const T* adt = static_cast<const T*>(ad);
  const int64_t slots = p * (f + 1);
  edge_softmax_place_kernel<<<threads_for(slots), kThreads, 0, s>>>(
      pos, mask, num_dst, off, cur, entries, n, p, f);
  edge_softmax_weights_kernel<T><<<threads_for(slots), kThreads, 0, s>>>(
      ast, lds, adt, ldd, pos, stats, off, entries, w, n, f, heads);
  T* dzt = static_cast<T*>(dz);
  switch (gat_row_vec<T>(c, z, g)) {
    case 8:  // bf16 only (16 bytes); a float row takes 4 at most
      launch_gat_src<T, 16 / sizeof(T)>(gt, zt, off, entries, w, dzt, dalpha,
                                        hv, n, f, heads, c, chunk, s);
      break;
    case 4:
      launch_gat_src<T, 4>(gt, zt, off, entries, w, dzt, dalpha, hv, n, f,
                           heads, c, chunk, s);
      break;
    case 2:
      launch_gat_src<T, 2>(gt, zt, off, entries, w, dzt, dalpha, hv, n, f,
                           heads, c, chunk, s);
      break;
    default:
      launch_gat_src<T, 1>(gt, zt, off, entries, w, dzt, dalpha, hv, n, f,
                           heads, c, chunk, s);
  }
  edge_softmax_dst_kernel<T><<<warps_for(p * heads), kThreads, 0, s>>>(
      ast, lds, adt, ldd, pos, mask, num_dst, stats, dalpha, da_s,
      static_cast<T*>(da_dst), n, p, f, heads);
  edge_softmax_cast_kernel<T><<<threads_for((n * heads + 3) / 4), kThreads,
                                0, s>>>(da_s, static_cast<T*>(da_src),
                                        n * heads);
}

}  // namespace

extern "C" {

// z: (n, heads, c) contiguous; a_src rows lds apart, a_dst rows ldd apart,
// heads side by side; out: (p, heads, c) contiguous; stats: (p, heads)
// float2.
int legion_edge_softmax_fwd(const void* z, const void* a_src, int64_t lds,
                            const void* a_dst, int64_t ldd, int dtype,
                            const void* pos, const void* mask,
                            const void* num_dst, void* out, void* stats,
                            int64_t n, int64_t p, int f, int heads, int c,
                            void* stream) {
  if (p * heads * c == 0) return cudaSuccess;
  if (p > n || !aligned(stats, 8)) {
    return cudaErrorInvalidValue;
  }
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* ms = static_cast<const uint8_t*>(mask);
  const int32_t* nd = static_cast<const int32_t*>(num_dst);
  float2* st = static_cast<float2*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    launch_gat_fwd<float>(z, a_src, lds, a_dst, ldd, ps, ms, nd, out, st, n,
                          p, f, heads, c, s);
  } else if (dtype == kBF16) {
    launch_gat_fwd<__nv_bfloat16>(z, a_src, lds, a_dst, ldd, ps, ms, nd, out,
                                  st, n, p, f, heads, c, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The backward's first half: words (4-byte) zeroed, then cnt = words[0, n]
// counts each scored position at cnt[row + 1]. The caller takes the
// inclusive cumsum of cnt as off (n + 1) before the second half.
int legion_edge_softmax_bwd_count(const void* pos, const void* mask,
                                  const void* num_dst, void* words,
                                  int64_t total_words, int64_t n, int64_t p,
                                  int f, void* stream) {
  if (!aligned(words, 16)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edge_softmax_zero_kernel<<<threads_for((total_words + 3) / 4), kThreads, 0,
                             s>>>(static_cast<float*>(words), total_words);
  if (p * (f + 1) > 0) {
    edge_softmax_count_kernel<<<threads_for(p * (f + 1)), kThreads, 0, s>>>(
        static_cast<const int32_t*>(pos), static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(num_dst), static_cast<int32_t*>(words),
        n, p, f);
  }
  return cudaGetLastError();
}

// The second half: g (p, heads, c) contiguous; stats from the forward;
// off (n + 1); cur (n) and da_s (n * heads f32) zeroed; entries (p * (f +
// 1)), w and dalpha (p * (f + 1) * heads f32 each) scratch; the rows named
// by more than `chunk` entries: hrank and cprefix (n each, inclusive
// counts of heavy rows and of their chunks), their f32 staging `stage`
// (stage_rows rows of heads * c) and a bound on their chunks; out dz (n,
// heads, c), da_src (n, heads), da_dst (p, heads), all in dtype.
int legion_edge_softmax_bwd(const void* g, const void* z, const void* a_src,
                            int64_t lds, const void* a_dst, int64_t ldd,
                            int dtype, const void* pos, const void* mask,
                            const void* num_dst, const void* stats,
                            const void* off, void* cur, void* entries,
                            void* w, void* dalpha, void* da_s,
                            const void* hrank, const void* cprefix,
                            void* stage, int64_t stage_rows,
                            int64_t chunks_bound, int chunk, void* dz,
                            void* da_src, void* da_dst, int64_t n, int64_t p,
                            int f, int heads, int c, void* stream) {
  if (n * heads * c == 0) return cudaSuccess;
  if (p > n || chunk < 1 || !aligned(stage, 16)) return cudaErrorInvalidValue;
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* ms = static_cast<const uint8_t*>(mask);
  const int32_t* nd = static_cast<const int32_t*>(num_dst);
  const float2* st = static_cast<const float2*>(stats);
  const int32_t* of = static_cast<const int32_t*>(off);
  int32_t* cu = static_cast<int32_t*>(cur);
  int32_t* en = static_cast<int32_t*>(entries);
  float* wt = static_cast<float*>(w);
  float* dal = static_cast<float*>(dalpha);
  float* das = static_cast<float*>(da_s);
  const GatHeavy hv{static_cast<const int32_t*>(hrank),
                    static_cast<const int32_t*>(cprefix),
                    static_cast<float*>(stage), chunks_bound, stage_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    launch_gat_bwd<float>(g, z, a_src, lds, a_dst, ldd, ps, ms, nd, st, of,
                          cu, en, wt, dal, das, hv, dz, da_src, da_dst, n, p,
                          f, heads, c, chunk, s);
  } else if (dtype == kBF16) {
    launch_gat_bwd<__nv_bfloat16>(g, z, a_src, lds, a_dst, ldd, ps, ms, nd,
                                  st, of, cu, en, wt, dal, das, hv, dz,
                                  da_src, da_dst, n, p, f, heads, c, chunk,
                                  s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"


// ---------------------------------------------------------------------------
// The activation and dropout between layers
// (legion_tpu_torch/ops/act_dropout.py): over the n elements of h, with u
// torch.rand's float32 uniforms as drawn and keep = 1 - rate,
//
//   out[i] = u[i] < keep ? act(h[i]) / keep : 0
//   dh[i]  = u[i] < keep ? act'(h[i]) * (g[i] / keep) : 0
//
// act is ReLU or ELU (alpha 1). act(h) and g / keep are
// rounded to h's type where F.relu / F.elu and the dropout's division
// round them, and ELU takes expm1f and expf as PyTorch's CUDA kernels do,
// so the kernels give the bits of that chain.
//
// Replaces no TPU kernel: legion_tpu's models leave the activation and the
// dropout to XLA, which fuses them. PyTorch runs them as the activation, a
// comparison, a division and a where against a broadcast 0-dim zero (its
// non-vectorised elementwise kernel), and a backward for each.
//
// Bound: bytes. A few operations an element against, in bf16, 8 bytes
// forward (h 2, u 4, out 2) and 4 backward (g 2, dh 2; ELU reads h, 2
// more), beside the mask. Design: the forward keeps one bit an element
// (bit i % 8 of byte i / 8): kept, and for ReLU kept and h > 0, which is
// all the backward needs but ELU's h, a sixteenth of the bf16 bytes. One
// thread a group of 8 elements, in a grid-stride loop over as many blocks
// as the card holds at once: h, out, g and dh move in 16-byte words (one a
// bf16 group, two a float one), u in two, and a group's bits in one byte,
// so a warp's bits are one 32-byte sector. The group that ends past n, or
// every group of a tensor off a 16-byte boundary, moves element by
// element.
// ---------------------------------------------------------------------------
namespace {

enum Act { kActRelu = 1, kActElu = 2 };
constexpr int kGroup = 8;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The `count` (<= 8) elements at p as f32, the rest 0; 16-byte words where
// `vec` (p on a 16-byte boundary) and the group is whole.
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ p, bool vec,
                                           int count, float (&o)[kGroup]) {
  constexpr int kV = 16 / sizeof(T);
  if (vec && count == kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; k += kV) {
      float w[kV];
      load_vec<kV>(p + k, w);
#pragma unroll
      for (int i = 0; i < kV; ++i) o[k + i] = w[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) o[i] = i < count ? to_f32(p[i]) : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void store_group(T* __restrict__ p, bool vec,
                                            int count,
                                            const float (&v)[kGroup]) {
  constexpr int kV = 16 / sizeof(T);
  if (vec && count == kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; k += kV) {
      float w[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) w[i] = v[k + i];
      store_vec<kV>(p + k, w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i < count) p[i] = from_f32<T>(v[i]);
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
act_dropout_fwd_kernel(const T* __restrict__ h, const float* __restrict__ u,
                       float keep, T* __restrict__ out,
                       uint8_t* __restrict__ bits, int64_t n, bool vec) {
  const int64_t groups = (n + kGroup - 1) / kGroup;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t grp = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       grp < groups; grp += stride) {
    const int64_t i0 = grp * kGroup;
    const int count = n - i0 < kGroup ? static_cast<int>(n - i0) : kGroup;
    float x[kGroup], r[kGroup], y[kGroup];
    load_group(h + i0, vec, count, x);
    load_group(u + i0, vec, count, r);
    unsigned byte = 0;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float a = x[i];
      if (ACT == kActRelu) {
        a = a <= 0.0f ? 0.0f : a;  // NaN passes, as in F.relu
      } else if (ACT == kActElu) {
        a = round_to<T>(a <= 0.0f ? expm1f(a) : a);
      }
      const bool kept = r[i] < keep;
      y[i] = kept ? a / keep : 0.0f;
      const bool bit = ACT == kActRelu ? kept && !(x[i] <= 0.0f) : kept;
      byte |= static_cast<unsigned>(bit && i < count) << i;
    }
    store_group(out + i0, vec, count, y);
    bits[grp] = static_cast<uint8_t>(byte);
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
act_dropout_bwd_kernel(const T* __restrict__ g,
                       const uint8_t* __restrict__ bits,
                       const T* __restrict__ h, float keep,
                       T* __restrict__ dh, int64_t n, bool vec) {
  const int64_t groups = (n + kGroup - 1) / kGroup;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t grp = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       grp < groups; grp += stride) {
    const int64_t i0 = grp * kGroup;
    const int count = n - i0 < kGroup ? static_cast<int>(n - i0) : kGroup;
    float gr[kGroup], x[kGroup], d[kGroup];
    load_group(g + i0, vec, count, gr);
    if (ACT == kActElu) load_group(h + i0, vec, count, x);
    const unsigned byte = bits[grp];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      float t = round_to<T>(gr[i] / keep);
      if (ACT == kActElu) t = x[i] <= 0.0f ? t * expf(x[i]) : t;
      d[i] = (byte >> i) & 1u ? t : 0.0f;
    }
    store_group(dh + i0, vec, count, d);
  }
}

// As many blocks as the card holds at once of `kernel` (resident_blocks),
// and no more than the groups of n need.
template <typename K>
cudaError_t stride_blocks(K kernel, int* resident, int64_t n,
                          unsigned* blocks) {
  const cudaError_t err = resident_blocks(kernel, kThreads, resident);
  if (err != cudaSuccess) return err;
  const int64_t want = ((n + kGroup - 1) / kGroup + kThreads - 1) / kThreads;
  *blocks = static_cast<unsigned>(want < *resident ? want : *resident);
  return cudaSuccess;
}

template <typename T, int ACT>
cudaError_t launch_act_dropout_fwd(const void* h, const float* u, float keep,
                                   void* out, uint8_t* bits, int64_t n,
                                   cudaStream_t s) {
  static int resident = 0;
  unsigned blocks = 0;
  cudaError_t err = stride_blocks(act_dropout_fwd_kernel<T, ACT>, &resident,
                                  n, &blocks);
  if (err != cudaSuccess) return err;
  const bool vec = aligned(h, 16) && aligned(u, 16) && aligned(out, 16);
  act_dropout_fwd_kernel<T, ACT><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(h), u, keep, static_cast<T*>(out), bits, n, vec);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_act_dropout_bwd(const void* g, const uint8_t* bits,
                                   const void* h, float keep, void* dh,
                                   int64_t n, cudaStream_t s) {
  static int resident = 0;
  unsigned blocks = 0;
  cudaError_t err = stride_blocks(act_dropout_bwd_kernel<T, ACT>, &resident,
                                  n, &blocks);
  if (err != cudaSuccess) return err;
  const bool vec = aligned(g, 16) && aligned(dh, 16) &&
                   (ACT != kActElu || aligned(h, 16));
  act_dropout_bwd_kernel<T, ACT><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(g), bits, static_cast<const T*>(h), keep,
      static_cast<T*>(dh), n, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t act_dropout_fwd(const void* h, const float* u, float keep,
                            int act, void* out, uint8_t* bits, int64_t n,
                            cudaStream_t s) {
  switch (act) {
    case kActRelu:
      return launch_act_dropout_fwd<T, kActRelu>(h, u, keep, out, bits, n, s);
    case kActElu:
      return launch_act_dropout_fwd<T, kActElu>(h, u, keep, out, bits, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t act_dropout_bwd(const void* g, const uint8_t* bits,
                            const void* h, float keep, int act, void* dh,
                            int64_t n, cudaStream_t s) {
  switch (act) {
    case kActRelu:
      return launch_act_dropout_bwd<T, kActRelu>(g, bits, h, keep, dh, n, s);
    case kActElu:
      return launch_act_dropout_bwd<T, kActElu>(g, bits, h, keep, dh, n, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// h and out: n elements of dtype; u: n floats; bits: (n + 7) / 8 bytes.
int legion_act_dropout_fwd(const void* h, int dtype, const void* u,
                           float keep, int act, void* out, void* bits,
                           int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  const float* uf = static_cast<const float*>(u);
  uint8_t* b = static_cast<uint8_t*>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return act_dropout_fwd<float>(h, uf, keep, act, out, b,
                                                   n, s);
  if (dtype == kBF16) {
    return act_dropout_fwd<__nv_bfloat16>(h, uf, keep, act, out, b, n, s);
  }
  return cudaErrorInvalidValue;
}

// g and dh: n elements of dtype; bits from the forward; h, the forward's
// input, read for ELU only.
int legion_act_dropout_bwd(const void* g, int dtype, const void* bits,
                           const void* h, float keep, int act, void* dh,
                           int64_t n, void* stream) {
  if (n == 0) return cudaSuccess;
  const uint8_t* b = static_cast<const uint8_t*>(bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return act_dropout_bwd<float>(g, b, h, keep, act, dh, n,
                                                   s);
  if (dtype == kBF16) {
    return act_dropout_bwd<__nv_bfloat16>(g, b, h, keep, act, dh, n, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
