// Fused per-pixel cross-entropy for Hopper (sm_90a): the forward NLL and
// its gradient, over [N, C] rows of logits.
//
// Counterpart of dasac_tpu/ops/ce.py:
//   nll_fwd  replaces the Pallas _fwd_kernel (:49, through _fwd_call):
//            per row nll = logsumexp(x) - x[label] in f32, 0 where
//            label == 255;
//   nll_bwd  replaces the Pallas _bwd_kernel (:60, through _bwd_call):
//            dx = g * (softmax(x) - onehot(label)) in x's dtype, the softmax
//            recomputed from x, 0 at ignored rows.
// A label outside [0, C) other than 255 matches no class: nll = lse and
// dx = g * p, as the Pallas kernels' iota compare gives.
//
// What bounds them: one streaming pass over the logits and no matrix
// product, so bytes.  At the shipped shape (N = 4,194,304 rows, C = 19,
// f32) the forward moves 352 MB and the backward 671 MB; the f32
// operations take under 10 us of the 67 TFLOP/s.  The card needs about
// 25 KB in flight per SM to keep 3.35 TB/s busy at ~1 us of latency, and a
// 19-wide row (76 bytes) is never 16-byte aligned, so row-tiled vector
// loads cannot reach it.  The design, for contiguous rows with a 16-byte
// aligned base (the bulk path, every launch of the training step):
//
//   * A tile of kRows = 256 rows is one flat run of 256 * C elements.  Since
//     256 is a multiple of 16, every tile's byte size and byte offset are
//     multiples of 16 for any C and for 2- and 4-byte logits, so the Tensor
//     Memory Accelerator's 1-D bulk copy (cp.async.bulk, no tensor map)
//     moves it into shared memory whole; the tile's labels (and, backward,
//     its upstream gradient) come the same way, all counted on one
//     mbarrier with expect_tx.
//   * A persistent grid (SMs x blocks per SM) walks the tiles with a grid
//     stride through a ring of stages: while a block reduces one tile, the
//     next stages are in flight (3 x 20.5 KB per block forward, 2 blocks
//     per SM).  A stage goes back to the producer (thread 0) through
//     __syncthreads once every thread has read its row.
//   * One thread reduces one row straight from shared memory in f32: max,
//     label pick, then sum of exp(x - m) over the row's values held in
//     registers (the shipped C = 19 is a template constant, fully
//     unrolled; any other C takes a runtime loop that reads shared memory
//     again).  Rows are C words apart in f32: C = 19 is odd, so a warp's 32
//     rows fall on 32 distinct banks.  An even C makes some rows share a
//     bank (2-way at C = 2 mod 4, more for higher powers of two); nothing
//     is tuned for it since every configuration the repo ships has C = 19.
//     2-byte logits put rows 2C bytes apart, which can meet 2-way conflicts.
//   * Forward: nll is stored straight to device memory, one coalesced f32
//     per thread.  Backward: each thread writes its row of dx into a
//     shared output buffer, and thread 0 stores the whole tile with one
//     bulk store (cp.async.bulk ... bulk_group) after a proxy fence; the
//     buffer is written again only after cp.async.bulk.wait_group.read has
//     seen that store read it.
//   * The ragged tail: the last N mod 256 rows form a tile whose size may
//     not be a multiple of 16 bytes.  After its walk over full tiles, the
//     block that would own that tile reads it with plain loads, one thread
//     per row, from device memory, and writes its outputs the same way.
//
// Rows that are strided, or whose base is not 16-byte aligned (a view such
// as x2[1:] or a class slice), take a simple one-thread-per-row kernel that
// reads with the strides it is given.  It is there so that the kernels take
// every input, not for speed.
//
// exp and log are the accurate expf / logf; the softmax divides as the
// plain version does.  Build: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC (dasac_tpu_torch/ops/cuda_build.py).
// Each entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;        // rows per tile = threads per block
constexpr int kFwdStages = 4;     // forward ring
constexpr int kBwdStages = 3;     // backward ring (plus the output buffers)
constexpr int kOutBufs = 2;       // backward shared output buffers
constexpr int kBarBytes = 128;    // mbarriers at the front of shared memory
constexpr int kIgnore = 255;
constexpr int kShippedC = 19;     // the class count of every shipped config

// element types: the codes the wrapper passes
enum { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum { kI32 = 0, kI64 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// --- shared-memory barriers and bulk copies (PTX) --------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the producer's arrival, announcing the bytes the stage's copies bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// device memory -> shared memory, completion counted on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared memory -> device memory, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N committed store groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// the threads' shared-memory writes, made visible to the bulk store
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- one row ---------------------------------------------------------------

// nll of the row at ``row[k * stride]``, k < C; CT > 0 fixes C at compile
// time and keeps the row in registers, CT == 0 reads it twice.
template <int CT, typename T, typename L>
__device__ __forceinline__ float row_nll(const T* row, int64_t stride, int c,
                                         L lbl) {
  float m = -INFINITY, picked = 0.f, s = 0.f;
  if constexpr (CT > 0) {
    float v[CT];
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      v[k] = to_f32(row[k * stride]);
      m = fmaxf(m, v[k]);
      picked = static_cast<L>(k) == lbl ? v[k] : picked;
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) s += expf(v[k] - m);
  } else {
    for (int k = 0; k < c; ++k) {
      const float v = to_f32(row[k * stride]);
      m = fmaxf(m, v);
      picked = static_cast<L>(k) == lbl ? v : picked;
    }
    for (int k = 0; k < c; ++k) s += expf(to_f32(row[k * stride]) - m);
  }
  const float lse = logf(s) + m;
  return lbl == static_cast<L>(kIgnore) ? 0.f : lse - picked;
}

// dx of the row into ``out[k]`` (contiguous), k < C
template <int CT, typename T, typename L>
__device__ __forceinline__ void row_dx(const T* row, int64_t stride, int c,
                                       L lbl, float g, T* out) {
  const float gv = lbl == static_cast<L>(kIgnore) ? 0.f : g;
  float m = -INFINITY, s = 0.f;
  if constexpr (CT > 0) {
    float e[CT];
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      e[k] = to_f32(row[k * stride]);
      m = fmaxf(m, e[k]);
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      e[k] = expf(e[k] - m);
      s += e[k];
    }
#pragma unroll
    for (int k = 0; k < CT; ++k) {
      const float hot = static_cast<L>(k) == lbl ? 1.f : 0.f;
      out[k] = from_f32<T>(gv * (e[k] / s - hot));
    }
  } else {
    for (int k = 0; k < c; ++k) m = fmaxf(m, to_f32(row[k * stride]));
    for (int k = 0; k < c; ++k) s += expf(to_f32(row[k * stride]) - m);
    for (int k = 0; k < c; ++k) {
      const float hot = static_cast<L>(k) == lbl ? 1.f : 0.f;
      const float p = expf(to_f32(row[k * stride]) - m) / s;
      out[k] = from_f32<T>(gv * (p - hot));
    }
  }
}

// --- the bulk path ---------------------------------------------------------

// Tiles of this block: blockIdx.x + i * gridDim.x for i < count.
__device__ __forceinline__ int64_t block_tiles(int64_t n_full) {
  const int64_t b = blockIdx.x;
  return b < n_full ? (n_full - 1 - b) / gridDim.x + 1 : 0;
}

__device__ __forceinline__ int64_t tile_of(int64_t i) {
  return blockIdx.x + i * static_cast<int64_t>(gridDim.x);
}

// Does this block read the ragged tail (rows n_full * kRows .. n - 1)?
__device__ __forceinline__ bool owns_tail(int64_t n, int64_t n_full) {
  return n > n_full * kRows && blockIdx.x == n_full % gridDim.x;
}

template <int CT, typename T, typename L>
__global__ void __launch_bounds__(kRows)
nll_fwd_bulk_kernel(const T* __restrict__ x, const L* __restrict__ lbl,
                    float* __restrict__ nll, int64_t n, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t x_bytes = kRows * c * sizeof(T);
  const uint32_t l_bytes = kRows * sizeof(L);
  const uint32_t stage_bytes = x_bytes + l_bytes;
  unsigned char* stages = smem + kBarBytes;
  const int tid = threadIdx.x;
  const int64_t n_full = n / kRows;
  const int64_t count = block_tiles(n_full);

  if (tid == 0) {
    for (int s = 0; s < kFwdStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  // thread 0: fill stage i % S with the block's i-th tile
  auto refill = [&](int64_t i) {
    const int s = static_cast<int>(i % kFwdStages);
    const int64_t t = tile_of(i);
    unsigned char* st = stages + s * stage_bytes;
    mbar_expect_tx(&full[s], stage_bytes);
    bulk_load(st, x + t * kRows * c, x_bytes, &full[s]);
    bulk_load(st + x_bytes, lbl + t * kRows, l_bytes, &full[s]);
  };
  if (tid == 0) {
    for (int64_t i = 0; i < count && i < kFwdStages; ++i) refill(i);
  }
  for (int64_t i = 0; i < count; ++i) {
    const int s = static_cast<int>(i % kFwdStages);
    mbar_wait(&full[s], static_cast<uint32_t>((i / kFwdStages) & 1));
    const unsigned char* st = stages + s * stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st) + tid * c;
    const L l = reinterpret_cast<const L*>(st + x_bytes)[tid];
    nll[tile_of(i) * kRows + tid] = row_nll<CT>(xs, 1, c, l);
    __syncthreads();  // every row of stage s is read: hand it back
    if (tid == 0 && i + kFwdStages < count) refill(i + kFwdStages);
  }

  if (owns_tail(n, n_full) && n_full * kRows + tid < n) {
    const int64_t r = n_full * kRows + tid;
    nll[r] = row_nll<CT>(x + r * c, 1, c, lbl[r]);
  }
}

template <int CT, typename T, typename L>
__global__ void __launch_bounds__(kRows)
nll_bwd_bulk_kernel(const T* __restrict__ x, const L* __restrict__ lbl,
                    const float* __restrict__ g, T* __restrict__ dx,
                    int64_t n, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const uint32_t x_bytes = kRows * c * sizeof(T);
  const uint32_t l_bytes = kRows * sizeof(L);
  const uint32_t g_bytes = kRows * sizeof(float);
  const uint32_t stage_bytes = x_bytes + l_bytes + g_bytes;
  unsigned char* stages = smem + kBarBytes;
  unsigned char* outs = stages + kBwdStages * stage_bytes;
  const int tid = threadIdx.x;
  const int64_t n_full = n / kRows;
  const int64_t count = block_tiles(n_full);

  if (tid == 0) {
    for (int s = 0; s < kBwdStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  auto refill = [&](int64_t i) {
    const int s = static_cast<int>(i % kBwdStages);
    const int64_t t = tile_of(i);
    unsigned char* st = stages + s * stage_bytes;
    mbar_expect_tx(&full[s], stage_bytes);
    bulk_load(st, x + t * kRows * c, x_bytes, &full[s]);
    bulk_load(st + x_bytes, lbl + t * kRows, l_bytes, &full[s]);
    bulk_load(st + x_bytes + l_bytes, g + t * kRows, g_bytes, &full[s]);
  };
  if (tid == 0) {
    for (int64_t i = 0; i < count && i < kBwdStages; ++i) refill(i);
  }
  for (int64_t i = 0; i < count; ++i) {
    const int s = static_cast<int>(i % kBwdStages);
    mbar_wait(&full[s], static_cast<uint32_t>((i / kBwdStages) & 1));
    const unsigned char* st = stages + s * stage_bytes;
    const T* xs = reinterpret_cast<const T*>(st) + tid * c;
    const L l = reinterpret_cast<const L*>(st + x_bytes)[tid];
    const float gr = reinterpret_cast<const float*>(st + x_bytes + l_bytes)[tid];
    T* out = reinterpret_cast<T*>(outs + (i % kOutBufs) * x_bytes);
    row_dx<CT>(xs, 1, c, l, gr, out + tid * c);
    fence_proxy_async();
    // the next tile writes the other buffer: its store (tile i - 1) must
    // have read it before the barrier lets the threads on
    if (tid == 0) bulk_wait_read<kOutBufs - 2>();
    __syncthreads();
    if (tid == 0) {
      bulk_store(dx + tile_of(i) * kRows * c, out, x_bytes);
      bulk_commit();
      if (i + kBwdStages < count) refill(i + kBwdStages);
    }
  }
  if (tid == 0) bulk_wait_all();

  if (owns_tail(n, n_full) && n_full * kRows + tid < n) {
    const int64_t r = n_full * kRows + tid;
    row_dx<CT>(x + r * c, 1, c, lbl[r], g[r], dx + r * c);
  }
}

// --- the strided path --------------------------------------------------------

template <typename T, typename L>
__global__ void __launch_bounds__(kRows)
nll_fwd_strided_kernel(const T* __restrict__ x, const L* __restrict__ lbl,
                       float* __restrict__ nll, int64_t n, int c,
                       int64_t stride_row, int64_t stride_cls,
                       int64_t stride_lbl) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kRows) + threadIdx.x;
  if (r < n) {
    nll[r] = row_nll<0>(x + r * stride_row, stride_cls, c,
                        lbl[r * stride_lbl]);
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(kRows)
nll_bwd_strided_kernel(const T* __restrict__ x, const L* __restrict__ lbl,
                       const float* __restrict__ g, T* __restrict__ dx,
                       int64_t n, int c, int64_t stride_row,
                       int64_t stride_cls, int64_t stride_lbl,
                       int64_t stride_g) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kRows) + threadIdx.x;
  if (r < n) {
    row_dx<0>(x + r * stride_row, stride_cls, c, lbl[r * stride_lbl],
              g[r * stride_g], dx + r * c);
  }
}

// --- launches ----------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// Calls fn(Tag<logit type>, Tag<label type>) for the wrapper's codes.
template <typename Fn>
int with_types(int x_dtype, int lbl_dtype, Fn&& fn) {
  if (lbl_dtype != kI32 && lbl_dtype != kI64) return cudaErrorInvalidValue;
  const bool i64 = lbl_dtype == kI64;
  switch (x_dtype) {
    case kF32:
      return i64 ? fn(Tag<float>(), Tag<int64_t>())
                 : fn(Tag<float>(), Tag<int32_t>());
    case kBF16:
      return i64 ? fn(Tag<__nv_bfloat16>(), Tag<int64_t>())
                 : fn(Tag<__nv_bfloat16>(), Tag<int32_t>());
    case kF16:
      return i64 ? fn(Tag<__half>(), Tag<int64_t>())
                 : fn(Tag<__half>(), Tag<int32_t>());
    default:
      return cudaErrorInvalidValue;
  }
}

// A persistent grid: as many blocks as fit on the card at once, at most one
// per full tile, at least one (for the ragged tail).
template <typename Kernel, typename... Args>
int launch_bulk(Kernel kernel, size_t smem, int64_t n, int device,
                void* stream, Args... args) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRows,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  int64_t grid = static_cast<int64_t>(sms) * per_sm;
  if (grid > n / kRows) grid = n / kRows;
  if (grid < 1) grid = 1;
  kernel<<<static_cast<unsigned>(grid), kRows, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int64_t n, int device, void* stream,
                Args... args) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int64_t grid = (n + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(grid), kRows, 0,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// --- the C interface (bound with ctypes in dasac_tpu_torch/ops/ce.py) -------
// x [n, c] logits of type x_dtype (0 f32, 1 bf16, 2 f16); lbl [n] labels of
// type lbl_dtype (0 int32, 1 int64); g [n] f32; nll [n] f32 and dx [n, c]
// (x's type) contiguous.  The bulk entry points need x, lbl and g
// contiguous with 16-byte aligned bases.  Strides are in elements.  Each
// returns a cudaError_t, 0 on success.

extern "C" int ce_nll_fwd_bulk(const void* x, const void* lbl, void* nll,
                               int64_t n, int64_t c, int x_dtype,
                               int lbl_dtype, int device, void* stream) {
  return with_types(x_dtype, lbl_dtype, [&](auto xt, auto lt) {
    using T = typename decltype(xt)::type;
    using L = typename decltype(lt)::type;
    const size_t smem =
        kBarBytes + kFwdStages * (kRows * c * sizeof(T) + kRows * sizeof(L));
    auto kernel = c == kShippedC ? nll_fwd_bulk_kernel<kShippedC, T, L>
                                 : nll_fwd_bulk_kernel<0, T, L>;
    return launch_bulk(kernel, smem, n, device, stream,
                       static_cast<const T*>(x), static_cast<const L*>(lbl),
                       static_cast<float*>(nll), n, static_cast<int>(c));
  });
}

extern "C" int ce_nll_fwd_strided(const void* x, const void* lbl, void* nll,
                                  int64_t n, int64_t c, int64_t stride_row,
                                  int64_t stride_cls, int64_t stride_lbl,
                                  int x_dtype, int lbl_dtype, int device,
                                  void* stream) {
  return with_types(x_dtype, lbl_dtype, [&](auto xt, auto lt) {
    using T = typename decltype(xt)::type;
    using L = typename decltype(lt)::type;
    return launch_rows(nll_fwd_strided_kernel<T, L>, n, device, stream,
                       static_cast<const T*>(x), static_cast<const L*>(lbl),
                       static_cast<float*>(nll), n, static_cast<int>(c),
                       stride_row, stride_cls, stride_lbl);
  });
}

extern "C" int ce_nll_bwd_bulk(const void* x, const void* lbl, const void* g,
                               void* dx, int64_t n, int64_t c, int x_dtype,
                               int lbl_dtype, int device, void* stream) {
  return with_types(x_dtype, lbl_dtype, [&](auto xt, auto lt) {
    using T = typename decltype(xt)::type;
    using L = typename decltype(lt)::type;
    const size_t x_bytes = kRows * c * sizeof(T);
    const size_t smem =
        kBarBytes +
        kBwdStages * (x_bytes + kRows * sizeof(L) + kRows * sizeof(float)) +
        kOutBufs * x_bytes;
    auto kernel = c == kShippedC ? nll_bwd_bulk_kernel<kShippedC, T, L>
                                 : nll_bwd_bulk_kernel<0, T, L>;
    return launch_bulk(kernel, smem, n, device, stream,
                       static_cast<const T*>(x), static_cast<const L*>(lbl),
                       static_cast<const float*>(g), static_cast<T*>(dx), n,
                       static_cast<int>(c));
  });
}

extern "C" int ce_nll_bwd_strided(const void* x, const void* lbl,
                                  const void* g, void* dx, int64_t n,
                                  int64_t c, int64_t stride_row,
                                  int64_t stride_cls, int64_t stride_lbl,
                                  int64_t stride_g, int x_dtype,
                                  int lbl_dtype, int device, void* stream) {
  return with_types(x_dtype, lbl_dtype, [&](auto xt, auto lt) {
    using T = typename decltype(xt)::type;
    using L = typename decltype(lt)::type;
    return launch_rows(nll_bwd_strided_kernel<T, L>, n, device, stream,
                       static_cast<const T*>(x), static_cast<const L*>(lbl),
                       static_cast<const float*>(g), static_cast<T*>(dx), n,
                       static_cast<int>(c), stride_row, stride_cls,
                       stride_lbl, stride_g);
  });
}

extern "C" const char* ce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
