// Live batch normalisation for Hopper (sm_90a): the big passes of
// SyncBatchNorm's batch-statistics path (dasac_tpu_torch/nn/layers.py) over
// [M, C] rows of a channels_last activation (M = N * H * W).
//
//   live_bn_sums       sums[0:C] = sum_rows x, sums[C:2C] = sum_rows x * x,
//                      in f32 over a bf16 (or f32) input;
//   live_bn_sums_bwd   dx = g[0:C] + 2 * g[C:2C] * x, the backward of sums;
//   live_bn_apply      y = relu?(x * scale + shift [+ residual]), the f32
//                      per-channel coefficients used unrounded, one
//                      rounding to the output type;
//   live_bn_apply_bwd  d = relu ? (y <= 0 ? 0 : dy) : dy; dx = d * scale,
//                      dresidual = d, and out[0:C] = sum_rows d,
//                      out[C:2C] = sum_rows d * x (the gradients of shift
//                      and scale).
//
// They replace no Pallas kernel: dasac_tpu's BN is jnp code
// (dasac_tpu/nn/layers.py), which XLA fuses on the TPU.  Eager PyTorch runs
// it as separate passes: an f32 copy of the activation, two mean passes
// over it, a bf16 multiply, an add, the ReLU and the residual add, each
// with its backward, about 38 bytes an activation forward and 60 backward.
//
// What bounds them: bytes.  They do a few f32 operations an element, far
// under the card's rate; sums reads 2 bytes an element (bf16), apply reads
// 2 (+2 residual) and writes 2, apply_bwd reads 6 and writes 2 (+2), and
// sums_bwd reads 2 and writes 2.  The design:
//
//   * A block of 512 threads covers up to 8 vector columns of 16 bytes (64
//     bf16 channels, 128 bytes of a row) and 512 / columns rows at a time;
//     each thread keeps one column, so its per-channel coefficients and its
//     sums stay in registers, and a warp reads whole 128-byte lines.  The
//     grid is (row blocks, column chunks), two blocks an SM in all (one
//     for apply_bwd, which needs the registers), each block a contiguous
//     run of rows; a thread has the loads of 8 (sums, sums_bwd) or 4 rows
//     (apply, apply_bwd) in flight at once, none of them predicated.  A C that is not a multiple of
//     the vector, or a base that is not 16-byte aligned, takes the same
//     kernels with one element a thread.
//   * The two reductions are deterministic: each thread sums its rows in a
//     fixed order, the block adds its threads in a fixed order into one
//     partial row of 2C floats, and the last block of each column chunk to
//     finish (a ticket taken with atomicAdd after a __threadfence, the
//     counter reset by that block) adds the partial rows of every block in
//     a fixed order.  The atomic orders only the ticket, never a value, so
//     two runs on the same input give the same bits, and the sums need no
//     second launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (dasac_tpu_torch/ops/cuda_build.py).  Each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;   // threads a block
constexpr int kMaxVec = 8;      // elements of a 16-byte vector, at most

// element types: the codes the wrapper passes
enum { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T, moved as one load or store (16 bytes when vectorised)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// loads stay packed in registers until each element is used
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> a;
#pragma unroll
  for (int j = 0; j < V; ++j) a.v[j] = from_f32<T>(in[j]);
  *reinterpret_cast<Vec<T, V>*>(p) = a;
}

// --- a thread's place in the grid ------------------------------------------

struct Tile {
  int cw;        // vector columns a block
  int rows;      // rows a step: kThreads / cw
  int lane;      // this thread's column within the block
  int sub;       // this thread's row within a step
  int64_t col;   // this thread's vector column in the row
  bool active;   // holds a column of the row and a row of the step
};

__device__ __forceinline__ Tile tile(int cv, int cw) {
  Tile t;
  t.cw = cw;
  t.rows = kThreads / cw;
  t.lane = threadIdx.x % cw;
  t.sub = threadIdx.x / cw;
  t.col = static_cast<int64_t>(blockIdx.y) * cw + t.lane;
  t.active = t.sub < t.rows && t.col < cv;
  return t;
}

// The rows of this thread.  A step is `rows` consecutive rows; block b
// takes steps [b * per, (b + 1) * per) of the ceil(m / rows) steps, per =
// ceil(steps / gridDim.x), and the thread row `sub` of each.  go(row0,
// Int<N>) takes rows row0 + u * rows, u < N, all below m: N = U for the
// whole rounds of U steps, whose loads the thread has in flight at once,
// then N = 1 for the steps left and the last, partial step.  The order is
// fixed.
template <int N>
using Int = std::integral_constant<int, N>;

template <int U, typename Go>
__device__ __forceinline__ void walk(const Tile& t, int64_t m, Go&& go) {
  const int64_t steps = (m + t.rows - 1) / t.rows;
  const int64_t per = (steps + gridDim.x - 1) / gridDim.x;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * per;
  const int64_t s1 = s0 + per < steps ? s0 + per : steps;
  const int64_t whole = m / t.rows < s1 ? m / t.rows : s1;
  int64_t s = s0;
  for (; s + U <= whole; s += U) go(s * t.rows + t.sub, Int<U>());
  for (; s < s1; ++s) {
    const int64_t row = s * t.rows + t.sub;
    if (row < m) go(row, Int<1>());
  }
}

// Adds the block's accumulators a (out[0:C]) and b (out[C:2C]) over its
// threads into the block's partial row, and has the last block of the
// column chunk add every block's partial row, in block order, into out.
template <int V>
__device__ __forceinline__ void finish(const float (&a)[V],
                                       const float (&b)[V], const Tile& t,
                                       int c, float* partials, int* tickets,
                                       float* out) {
  __shared__ float red[kThreads * 2 * kMaxVec];
  __shared__ bool last;
  const int per_stat = t.cw * V;      // channels of the chunk
  const int k_all = 2 * per_stat;     // values of the chunk's partial
  const int groups = kThreads / k_all;
  if (t.sub < t.rows) {
    float* dst = red + t.sub * k_all + t.lane * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      dst[j] = a[j];
      dst[per_stat + j] = b[j];
    }
  }
  __syncthreads();
  // thread (g, k) adds rows g, g + groups, ... of value k; then thread k
  // adds the groups
  const int k = threadIdx.x % k_all, g = threadIdx.x / k_all;
  const int stat = k / per_stat;
  const int64_t ch = static_cast<int64_t>(blockIdx.y) * per_stat +
                     k % per_stat;
  float acc = 0.f;
  if (g < groups)
    for (int s = g; s < t.rows; s += groups) acc += red[s * k_all + k];
  __syncthreads();
  if (g < groups) red[g * k_all + k] = acc;
  __syncthreads();
  if (threadIdx.x < k_all && ch < c) {
    float v = 0.f;
    for (int i = 0; i < groups; ++i) v += red[i * k_all + k];
    partials[static_cast<int64_t>(blockIdx.x) * 2 * c + stat * c + ch] = v;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.y, 1) ==
           static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  acc = 0.f;
  if (g < groups && ch < c) {
#pragma unroll 8
    for (int blk = g; blk < static_cast<int>(gridDim.x); blk += groups)
      acc += __ldcg(partials + static_cast<int64_t>(blk) * 2 * c +
                    stat * c + ch);
  }
  if (g < groups) red[g * k_all + k] = acc;
  __syncthreads();
  if (threadIdx.x < k_all && ch < c) {
    float v = 0.f;
    for (int i = 0; i < groups; ++i) v += red[i * k_all + k];
    out[stat * c + ch] = v;
  }
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// --- the kernels -------------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    live_bn_sums_kernel(const T* __restrict__ x, float* partials,
                        int* tickets, float* __restrict__ out, int64_t m,
                        int c, int cw) {
  const Tile t = tile(c / V, cw);
  float s[V], q[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = q[j] = 0.f;
  if (t.active) {
    const T* base = x + t.col * V;
    const int64_t stride = static_cast<int64_t>(t.rows) * c;
    walk<8>(t, m, [&](int64_t row0, auto n) {
      constexpr int N = decltype(n)::value;
      const T* p = base + row0 * c;
      Vec<T, V> v[N];
#pragma unroll
      for (int u = 0; u < N; ++u) v[u] = load<T, V>(p + u * stride);
#pragma unroll
      for (int u = 0; u < N; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float e = to_f32(v[u].v[j]);
          s[j] += e;
          q[j] = fmaf(e, e, q[j]);
        }
    });
  }
  finish<V>(s, q, t, c, partials, tickets, out);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    live_bn_sums_bwd_kernel(const T* __restrict__ x,
                            const float* __restrict__ g, T* __restrict__ dx,
                            int64_t m, int c, int cw) {
  const Tile t = tile(c / V, cw);
  if (!t.active) return;
  float gs[V], gq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gs[j] = g[t.col * V + j];
    gq[j] = 2.f * g[c + t.col * V + j];
  }
  const int64_t off = t.col * V;
  const int64_t stride = static_cast<int64_t>(t.rows) * c;
  walk<8>(t, m, [&](int64_t row0, auto n) {
    constexpr int N = decltype(n)::value;
    const int64_t at = off + row0 * c;
    Vec<T, V> v[N];
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] = load<T, V>(x + at + u * stride);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = fmaf(gq[j], to_f32(v[u].v[j]), gs[j]);
      store<T, V>(dx + at + u * stride, o);
    }
  });
}

template <typename T, int V, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
    live_bn_apply_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ shift,
                         const T* __restrict__ res, T* __restrict__ y,
                         int64_t m, int c, int cw) {
  const Tile t = tile(c / V, cw);
  if (!t.active) return;
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = scale[t.col * V + j];
    b[j] = shift[t.col * V + j];
  }
  const int64_t off = t.col * V;
  const int64_t stride = static_cast<int64_t>(t.rows) * c;
  walk<4>(t, m, [&](int64_t row0, auto n) {
    constexpr int N = decltype(n)::value;
    const int64_t at = off + row0 * c;
    Vec<T, V> v[N], r[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      v[u] = load<T, V>(x + at + u * stride);
      if constexpr (RES) r[u] = load<T, V>(res + at + u * stride);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = fmaf(to_f32(v[u].v[j]), a[j], b[j]);
        if constexpr (RES) o[j] += to_f32(r[u].v[j]);
        // NaN stays NaN, as torch.relu keeps it
        if constexpr (RELU) o[j] = o[j] < 0.f ? 0.f : o[j];
      }
      store<T, V>(y + at + u * stride, o);
    }
  });
}

// One block an SM: three streams of loads in flight need more than the 64
// registers a thread that two blocks of 512 would leave.
template <typename T, int V, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads, 1)
    live_bn_apply_bwd_kernel(const T* __restrict__ dy,
                             const T* __restrict__ x,
                             const T* __restrict__ y,
                             const float* __restrict__ scale,
                             T* __restrict__ dx, T* __restrict__ dres,
                             float* partials, int* tickets,
                             float* __restrict__ out, int64_t m, int c,
                             int cw) {
  const Tile t = tile(c / V, cw);
  float a[V], sd[V], sdx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sd[j] = sdx[j] = 0.f;
  if (t.active) {
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = scale[t.col * V + j];
    const int64_t off = t.col * V;
    const int64_t stride = static_cast<int64_t>(t.rows) * c;
    walk<4>(t, m, [&](int64_t row0, auto n) {
      constexpr int N = decltype(n)::value;
      const int64_t at = off + row0 * c;
      Vec<T, V> dv[N], v[N], w[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        dv[u] = load<T, V>(dy + at + u * stride);
        v[u] = load<T, V>(x + at + u * stride);
        if constexpr (RELU) w[u] = load<T, V>(y + at + u * stride);
      }
#pragma unroll
      for (int u = 0; u < N; ++u) {
        float d[V], o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          d[j] = to_f32(dv[u].v[j]);
          // the ReLU's backward as torch's threshold_backward: 0 where the
          // output is <= 0
          if constexpr (RELU) d[j] = to_f32(w[u].v[j]) <= 0.f ? 0.f : d[j];
          o[j] = d[j] * a[j];
          sd[j] += d[j];
          sdx[j] = fmaf(d[j], to_f32(v[u].v[j]), sdx[j]);
        }
        store<T, V>(dx + at + u * stride, o);
        if constexpr (RES) store<T, V>(dres + at + u * stride, d);
      }
    });
  }
  finish<V>(sd, sdx, t, c, partials, tickets, out);
}

// --- launches ----------------------------------------------------------------

template <typename T>
struct Tag {
  using type = T;
};

// Calls fn(Tag<element type>, std::integral_constant<int, V>) for the
// wrapper's type code and vector width: 16 bytes or one element.
template <typename Fn>
int with_type(int dtype, int vec, Fn&& fn) {
  switch (dtype) {
    case kF32:
      if (vec == 4) return fn(Tag<float>(), std::integral_constant<int, 4>());
      if (vec == 1) return fn(Tag<float>(), std::integral_constant<int, 1>());
      return cudaErrorInvalidValue;
    case kBF16:
      if (vec == 8)
        return fn(Tag<__nv_bfloat16>(), std::integral_constant<int, 8>());
      if (vec == 1)
        return fn(Tag<__nv_bfloat16>(), std::integral_constant<int, 1>());
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// Calls fn(residual?, relu?) as compile-time flags.
template <typename Fn>
int with_flags(bool res, bool relu, Fn&& fn) {
  using Y = std::true_type;
  using N = std::false_type;
  if (res) return relu ? fn(Y(), Y()) : fn(Y(), N());
  return relu ? fn(N(), Y()) : fn(N(), N());
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int gx, int gy, int device, void* stream,
           Args... args) {
  if (gx < 1 || gy < 1 || gy > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(gx, gy), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return cudaGetLastError();
}

}  // namespace

// --- the C interface (bound with ctypes in dasac_tpu_torch/ops/live_bn.py) --
// Rows of m x c elements of type dtype (0 f32, 1 bf16), contiguous; vec is
// the elements a thread moves at once (16 bytes' worth, which needs c a
// multiple of it and 16-byte aligned bases, or 1); cw the vector columns of
// a block (at most 8, kThreads / cw rows a step); the grid is gx row blocks
// by gy = ceil(c / vec / cw) column chunks.  partials holds gx * 2c floats,
// tickets gy ints that are 0 (and are 0 again after the kernel); out 2c
// floats.  res, y and dres may be null where the flags do not use them.
// Each returns a cudaError_t, 0 on success.

extern "C" int live_bn_sums(const void* x, void* partials, void* tickets,
                            void* out, int64_t m, int64_t c, int vec, int cw,
                            int gx, int gy, int dtype, int device,
                            void* stream) {
  return with_type(dtype, vec, [&](auto tt, auto vv) {
    using T = typename decltype(tt)::type;
    constexpr int V = decltype(vv)::value;
    return launch(live_bn_sums_kernel<T, V>, gx, gy, device, stream,
                  static_cast<const T*>(x), static_cast<float*>(partials),
                  static_cast<int*>(tickets), static_cast<float*>(out), m,
                  static_cast<int>(c), cw);
  });
}

extern "C" int live_bn_sums_bwd(const void* x, const void* g, void* dx,
                                int64_t m, int64_t c, int vec, int cw, int gx,
                                int gy, int dtype, int device, void* stream) {
  return with_type(dtype, vec, [&](auto tt, auto vv) {
    using T = typename decltype(tt)::type;
    constexpr int V = decltype(vv)::value;
    return launch(live_bn_sums_bwd_kernel<T, V>, gx, gy, device, stream,
                  static_cast<const T*>(x), static_cast<const float*>(g),
                  static_cast<T*>(dx), m, static_cast<int>(c), cw);
  });
}

extern "C" int live_bn_apply(const void* x, const void* scale,
                             const void* shift, const void* res, void* y,
                             int64_t m, int64_t c, int vec, int cw, int gx,
                             int gy, int relu, int dtype, int device,
                             void* stream) {
  return with_type(dtype, vec, [&](auto tt, auto vv) {
    using T = typename decltype(tt)::type;
    constexpr int V = decltype(vv)::value;
    return with_flags(res != nullptr, relu != 0, [&](auto r, auto u) {
      return launch(
          live_bn_apply_kernel<T, V, decltype(r)::value, decltype(u)::value>,
          gx, gy, device, stream, static_cast<const T*>(x),
          static_cast<const float*>(scale), static_cast<const float*>(shift),
          static_cast<const T*>(res), static_cast<T*>(y), m,
          static_cast<int>(c), cw);
    });
  });
}

extern "C" int live_bn_apply_bwd(const void* dy, const void* x, const void* y,
                                 const void* scale, void* dx, void* dres,
                                 void* partials, void* tickets, void* out,
                                 int64_t m, int64_t c, int vec, int cw,
                                 int gx, int gy, int relu, int dtype,
                                 int device, void* stream) {
  if (relu && y == nullptr) return cudaErrorInvalidValue;
  return with_type(dtype, vec, [&](auto tt, auto vv) {
    using T = typename decltype(tt)::type;
    constexpr int V = decltype(vv)::value;
    return with_flags(dres != nullptr, relu != 0, [&](auto r, auto u) {
      return launch(
          live_bn_apply_bwd_kernel<T, V, decltype(r)::value,
                                   decltype(u)::value>,
          gx, gy, device, stream, static_cast<const T*>(dy),
          static_cast<const T*>(x), static_cast<const T*>(y),
          static_cast<const float*>(scale), static_cast<T*>(dx),
          static_cast<T*>(dres), static_cast<float*>(partials),
          static_cast<int*>(tickets), static_cast<float*>(out), m,
          static_cast<int>(c), cw);
    });
  });
}

extern "C" const char* live_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
