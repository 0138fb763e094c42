// Hand-written Hopper (sm_90a) kernels of legion_tpu_torch.
//
// Each kernel replaces a Pallas TPU kernel of legion_tpu/ops/ and computes
// what that kernel computes, redesigned for the H100 rather than copied
// block by block. All are gathers, reductions or scatters with no matrix
// product: at the main-path shapes they do < 1 FLOP per byte moved, far
// below the ~295 FLOP/byte at which the H100's bf16 tensor cores would bound
// them, so no kernel here is bound by operations. Two designs follow from
// what does bound them:
//
//  * K1, K3 and K5 stream hundreds of megabytes from device memory, and
//    bytes bound them: one thread per 16-byte word of an output row, each
//    byte read once in coalesced loads, sums in registers, each output
//    written once.
//  * K2 (forward and backward) and the sampling kernel move little, out of
//    the L2 or in scattered 4-byte reads. K2 forward is bound by the
//    operations a warp executes per 94-byte row and K2 backward by the
//    L2's rate of float adds; the sampling kernel by its dependent loads. K2
//    runs one warp per dst row: the row's index data is loaded once by the
//    lanes, only the valid slots are walked (ballot, then a compacted table
//    or shuffles), and the backward adds 16 bytes per atomic into a padded
//    f32 staging buffer. The sampling kernel keeps one thread per slot.
//
// Built by legion_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o legion_kernels_<hash>.so legion_kernels.cu
// Plain C launchers (extern "C" below) take raw pointers and the caller's
// stream, launch without synchronising, allocate nothing, and return
// cudaGetLastError(). Wrappers and plain PyTorch versions of each kernel:
// legion_tpu_torch/ops/identity_agg.py, legion_tpu_torch/ops/gather.py,
// legion_tpu_torch/ops/sample.py and legion_tpu_torch/ops/spmm.py.

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
// Bound: latency of dependent loads (frontier id -> indptr pair -> one
// index), about 12 bytes of useful reads per slot; at the main path's hop 2
// it is 1.2M slots. Design: one thread per (p, f) slot, the threads of a
// warp on consecutive slots of one or two nodes, so the frontier and indptr
// reads coalesce or hit L1 and only the neighbor read scatters. The draw is
// computed bit-exactly as the plain version's float32 ops: __int2float_rn,
// __fmul_rn (no contraction into an FMA) and truncation toward zero.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
sample_neighbors_kernel(const int32_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const int32_t* __restrict__ frontier,
                        const float* __restrict__ u,
                        int32_t* __restrict__ out, int64_t p, int f) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= p * f) return;
  const int64_t r = t / f;
  const int j = static_cast<int>(t - r * f);
  const int32_t id = frontier[r];
  int32_t v = -1;
  if (id >= 0) {
    const int32_t start = indptr[id];
    const int32_t deg = indptr[id + 1] - start;
    if (deg > 0 && j < deg) {
      int32_t draw = __float2int_rz(__fmul_rn(u[t], __int2float_rn(deg)));
      draw = draw < deg - 1 ? draw : deg - 1;
      v = indices[static_cast<int64_t>(start) + draw];
    }
  }
  out[t] = v;
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
  sample_neighbors_kernel<<<blocks_for(p * f), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(indices),
      static_cast<const int32_t*>(frontier), static_cast<const float*>(u),
      static_cast<int32_t*>(out), p, f);
  return cudaGetLastError();
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

}  // extern "C"
