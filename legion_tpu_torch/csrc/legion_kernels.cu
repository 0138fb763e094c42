// Hand-written Hopper (sm_90a) kernels of legion_tpu_torch.
//
// Each kernel replaces a Pallas TPU kernel of legion_tpu/ops/ and computes
// what that kernel computes, redesigned for the H100 rather than copied
// block by block. All are gathers, reductions or scatters with no matrix
// product: at the main-path shapes they do < 1 FLOP per byte moved,
// far below the ~295 FLOP/byte at which the H100's bf16 tensor cores would
// bound them, so device-memory bytes bound every one of them. The design
// answer is the same for all: read each byte once, in coalesced 16-byte
// loads where the row width allows, keep sums in registers, and write each
// output once.
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
// K1 and K2 forward: masked norm-reduce over f slots per dst row.
//
//   out[r, c] = norm( sum_{j < f, mask[r, j]} x[row(r, j), c] )
//   row(r, j) = pos ? pos[r*f + j] : offset + r*f + j
//
// A valid slot whose row lies outside the n rows of x (a position past the
// frontier, which exists only after a cap overflow) is not read: it makes
// the whole output row NaN, as JAX's fill-mode take makes its row NaN.
//
// K1 (pos == nullptr) replaces identity_masked_mean_pallas
// (legion_tpu/ops/identity_agg_pallas.py:137): the f slots of dst r are the
// contiguous rows offset + r*f .. offset + r*f + f - 1 of the gathered
// features. K2 (pos given) replaces the forward of gathered_masked_mean
// (identity_agg_pallas.py:261), which on the TPU gathered h_t[nbr_pos] into
// a (P*f, D) array padded to 128 columns and then ran the K1 kernel on it;
// here the gather happens inside the kernel, at the true width D, so the
// (P*f, D) rows never reach device memory.
//
// Bound: bytes. K1 at the main-path shapes reads 1.2M rows of 512 B (about
// 626 MB plus the 1.2 MB mask) and writes 31 MB of bf16. Design: one thread
// per (dst row, VEC-column group); the threads of a warp cover consecutive
// columns of a row, so each slot's row is read by 16-byte coalesced loads
// (VEC = 4 f32) and every byte is read once. Masked slots are skipped, not
// multiplied by zero, so their rows are never read. The sum stays in f32
// registers; the norm and the cast to the output type happen before the one
// store. No shared memory, no cross-thread reduction, no assumption on P
// (a ragged last block is masked by the bounds check).
// ---------------------------------------------------------------------------
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kThreads)
masked_agg_kernel(const Tin* __restrict__ x, const int32_t* __restrict__ pos,
                  const uint8_t* __restrict__ mask, Tout* __restrict__ out,
                  int64_t n, int64_t p, int f, int d, int64_t offset,
                  int norm) {
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
    const int64_t row = pos ? static_cast<int64_t>(pos[r * f + j])
                            : offset + r * f + j;
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
// K2 backward: replaces the custom VJP of gathered_masked_mean
// (_masked_agg_rows_bwd with _bwd_scale, identity_agg_pallas.py:225-248,
// whose scatter-add transpose of the row gather stayed in XLA on the TPU):
//
//   dx[pos[r, j], c] += mask[r, j] * g[r, c] * scale(cnt_r)
//
// A slot whose position lies outside the n rows of dx is dropped, as the
// transpose of a fill-mode take drops it; it still counts in cnt_r, since
// the forward's mean counted it.
//
// Bound: bytes and atomics. It reads g (P x D) once and issues one f32
// atomicAdd per valid (edge, column): 8320 x 25 x 47 at the main path,
// into a 122240 x 47 f32 buffer (23 MB) that stays resident in the 50 MB
// L2, so the atomics resolve in L2. Design: one thread per (dst row,
// column); consecutive threads add to consecutive columns of one src row,
// so a warp's atomics fall on one or two 128-byte lines. Sums accumulate
// in f32 (bf16 atomics would lose the sum at hub rows); the wrapper casts
// the f32 buffer to h_t's type once at the end.
// ---------------------------------------------------------------------------
template <typename Tg>
__global__ void __launch_bounds__(kThreads)
masked_agg_bwd_kernel(const Tg* __restrict__ g,
                      const int32_t* __restrict__ pos,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ dx, int64_t n, int64_t p, int f,
                      int d, int norm) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= p * d) return;
  const int64_t r = t / d;
  const int c = static_cast<int>(t - r * d);
  const uint8_t* m = mask + r * f;
  int cnt = 0;
  for (int j = 0; j < f; ++j) cnt += m[j] ? 1 : 0;
  if (cnt == 0) return;
  const float s = apply_norm(to_f32(g[t]), cnt, norm);
  for (int j = 0; j < f; ++j) {
    if (!m[j]) continue;
    const int64_t row = pos[r * f + j];
    if (row < 0 || row >= n) continue;
    atomicAdd(dx + row * d + c, s);
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
void launch_agg(const void* x, const int32_t* pos, const uint8_t* mask,
                void* out, int64_t n, int64_t p, int f, int d, int64_t offset,
                int norm, cudaStream_t stream) {
  const Tin* xi = static_cast<const Tin*>(x);
  Tout* o = static_cast<Tout*>(out);
  const bool vec4 = d % 4 == 0 && aligned(x, 4 * sizeof(Tin)) &&
                    aligned(out, 4 * sizeof(Tout));
  if (vec4) {
    masked_agg_kernel<Tin, Tout, 4><<<blocks_for(p * (d / 4)), kThreads, 0,
                                      stream>>>(xi, pos, mask, o, n, p, f,
                                                d, offset, norm);
  } else {
    masked_agg_kernel<Tin, Tout, 1><<<blocks_for(p * d), kThreads, 0,
                                      stream>>>(xi, pos, mask, o, n, p, f,
                                                d, offset, norm);
  }
}

int agg_dispatch(const void* x, int x_dtype, const int32_t* pos,
                 const uint8_t* mask, void* out, int out_dtype, int64_t n,
                 int64_t p, int f, int d, int64_t offset, int norm,
                 cudaStream_t stream) {
  if (p * d == 0) return cudaSuccess;
  if (x_dtype == kF32 && out_dtype == kF32) {
    launch_agg<float, float>(x, pos, mask, out, n, p, f, d, offset, norm,
                             stream);
  } else if (x_dtype == kF32 && out_dtype == kBF16) {
    launch_agg<float, __nv_bfloat16>(x, pos, mask, out, n, p, f, d, offset,
                                     norm, stream);
  } else if (x_dtype == kBF16 && out_dtype == kF32) {
    launch_agg<__nv_bfloat16, float>(x, pos, mask, out, n, p, f, d, offset,
                                     norm, stream);
  } else if (x_dtype == kBF16 && out_dtype == kBF16) {
    launch_agg<__nv_bfloat16, __nv_bfloat16>(x, pos, mask, out, n, p, f, d,
                                             offset, norm, stream);
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
  return agg_dispatch(x, x_dtype, nullptr,
                      static_cast<const uint8_t*>(mask), out, out_dtype, n, p,
                      f, d, offset, norm, static_cast<cudaStream_t>(stream));
}

int legion_gathered_masked_mean(const void* h, int dtype, const void* pos,
                                const void* mask, void* out, int64_t n,
                                int64_t p, int f, int d, int norm,
                                void* stream) {
  return agg_dispatch(h, dtype, static_cast<const int32_t*>(pos),
                      static_cast<const uint8_t*>(mask), out, dtype, n, p, f,
                      d, 0, norm, static_cast<cudaStream_t>(stream));
}

int legion_gathered_masked_mean_bwd(const void* g, int g_dtype,
                                    const void* pos, const void* mask,
                                    void* dx, int64_t n, int64_t p, int f,
                                    int d, int norm, void* stream) {
  if (p * d == 0) return cudaSuccess;
  const int32_t* ps = static_cast<const int32_t*>(pos);
  const uint8_t* ms = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == kF32) {
    masked_agg_bwd_kernel<float><<<blocks_for(p * d), kThreads, 0, s>>>(
        static_cast<const float*>(g), ps, ms, o, n, p, f, d, norm);
  } else if (g_dtype == kBF16) {
    masked_agg_bwd_kernel<__nv_bfloat16><<<blocks_for(p * d), kThreads, 0,
                                           s>>>(
        static_cast<const __nv_bfloat16*>(g), ps, ms, o, n, p, f, d, norm);
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
