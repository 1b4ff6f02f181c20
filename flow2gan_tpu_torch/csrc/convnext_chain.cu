// The eval-form elementwise chain of a ConvNeXt block (models/convnext.py
// `ConvNeXtBlock`), in three kernels on channels-last (B, T, C) float32:
//
//   convnext_norm_film:  y = FiLM(BiasNorm(dwconv(x * mask)) + c[t // f])
//   prelu_inplace:       h = h >= 0 ? h : alpha * h         (pwconv1's output)
//   scaled_residual:     h = (h + b) + scale * residual     (pwconv2's product)
//
// with the pointwise convs (pwconv1, pwconv2, the cond and time projections)
// left to cuBLAS between them. pwconv2's bias b rides in scaled_residual:
// cuBLAS's bias epilogue ran that GEMM at the stream's batch-1 shapes up to
// 1.9x slower than the plain product. The wrappers and the plain versions
// of the same functions are in ops/convnext_chain.py.
//
// It replaces no Pallas kernel: on the TPU, XLA fused this chain itself
// (flow2gan_tpu/models/convnext.py:52-117; DESIGN.md, "Depthwise conv as an
// unrolled stencil"). In eager PyTorch the same chain was about 20 elementwise
// and copy kernels a block, moving about 53 N floats for an activation of
// N = B * T * C.
//
// What bounds it on this card: bytes. Each kernel does a few operations per
// float it moves (the 7-tap conv 14 FLOP an element). Together they move
// about 11.5 N floats a block: x read once with its halo and the cond
// projection once at its own frame rate (kernel 1: ~2-3 N), the 3C-wide
// hidden read and written once (kernel 2: 6 N), and the residual and the
// GEMM's output read and the sum written once (kernel 3: 3 N).
//
// convnext_norm_film: block (b, tile) owns `rows_per_tile` (R) consecutive
// frames of batch entry b. It stages the R + k - 1 rows its conv reads, the
// halo included, zero-padded past both ends, and the depthwise weights as
// they lie, (C, k), in shared memory: 16-byte asynchronous copies
// (cp.async), all issued before one wait, so a block pays one round trip
// to memory however many rows it stages; then each thread masks the rows it
// copied. Neighbouring rows' halos are read from device memory once per
// block and not once per output row. Each warp then owns `rows_per_warp`
// (P) consecutive rows: lane l holds channels 4l, 4l + 1, ... (8 float4 a
// lane at C = 1024, 6 at 768) in registers, runs the k taps over the P + k
// - 1 staged rows, takes the row's sum of squares with warp shuffles (no
// second barrier), and writes the row once.
//
// The tiling follows the shape (ops/convnext_chain.py `norm_film_plan`): the
// most rows a tile (16, 8, 4, 2, 1) that still gives every SM a block. Bulk
// serving (B = 16, T = 102-3489 frames) takes 8- and 16-row tiles, 2 rows a
// warp; the stream's chunk (B = 1, T = 149-593) takes 1-4-row tiles,
// 148-149 blocks, so that a batch-1 chunk still spreads over all 132 SMs,
// its halo re-read through L2 rather than its SMs left idle.
//
// prelu_inplace and scaled_residual are streaming passes, 16 bytes a thread
// a load, four loads in flight a thread where the grid still fills the card
// (one at the stream's small shapes). Both write in place into the GEMM's
// output, which nothing else holds.
//
// Every kernel launches on the caller's stream, allocates nothing and uses
// no atomics: the result does not depend on the launch, and a CUDA graph
// replays it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int MAX_VEC = 8;  // float4 groups a lane: C up to 1024
constexpr int TAPS = 7;     // the configurations' depthwise kernel size
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int STREAM_THREADS = 256;

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// An asynchronous 16-byte copy from device to shared memory (through L2).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// x: (B, T, C); mask: (B, T) or null; dw_w: (C, K); dw_b, norm_b: (C,);
// log_scale: one float; c: (B, t_c, C) or null; te: (B, C), null with c;
// out: (B, T, C). gridDim.x = B * tiles, blockDim.x = 32 * rows_per_tile / P.
template <int VEC, int P, int K>
__global__ void __launch_bounds__(256) convnext_norm_film_kernel(
    const float* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ dw_w, const float* __restrict__ dw_b,
    const float* __restrict__ norm_b, const float* __restrict__ log_scale,
    const float* __restrict__ c, const float* __restrict__ te, float* __restrict__ out, int T,
    int C, int f, int t_c, int tiles, int rows_per_tile) {
  // shared memory: the depthwise weights as they lie, (C, K), then the
  // rows_per_tile + K - 1 rows the tile's taps read, x * mask, zero-padded
  extern __shared__ float4 smem[];
  constexpr int LEFT = (K - 1) / 2;  // SAME padding: the taps reach LEFT rows back
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * rows_per_tile;
  const int c4 = C / 4;
  float4* const taps = smem;
  float4* const rows = smem + C * K / 4;
  // every copy is issued before any is waited for: one round trip to memory
  const float4* w4 = reinterpret_cast<const float4*>(dw_w);
  for (int i = threadIdx.x; i < C * K / 4; i += blockDim.x) cp_async16(taps + i, w4 + i);
  const int staged = (rows_per_tile + K - 1) * c4;
  const float4* xb = reinterpret_cast<const float4*>(x) + (size_t)b * T * c4;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const int r = i / c4, t = t0 - LEFT + r;
    if (t >= 0 && t < T)
      cp_async16(rows + i, xb + (size_t)t * c4 + (i - r * c4));
    else
      rows[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait_all();
  if (mask != nullptr) {  // each thread masks the rows' pieces it copied
    for (int i = threadIdx.x; i < staged; i += blockDim.x) {
      const int t = t0 - LEFT + i / c4;
      if (t >= 0 && t < T) {
        const float m = mask[(size_t)b * T + t];
        const float4 v = rows[i];
        rows[i] = make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % WARP;
  const int r0 = threadIdx.x / WARP * P;  // the warp's first row in the tile
  if (t0 + r0 >= T) return;               // no barrier follows

  float4 y[P][VEC];
#pragma unroll
  for (int g = 0; g < VEC; ++g) {
    const int q = g * WARP + lane;  // this lane's float4 of the row: channels 4q .. 4q + 3
    if (q < c4) {
      // channel 4q + s's taps are w[s * K .. s * K + K - 1]
      float w[4 * K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float4 v = taps[q * K + i];  // lanes 7 float4 apart: no bank conflict
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
      float4 acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < P + K - 1; ++r) {
        const float4 v = rows[(r0 + r) * c4 + q];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int j = r - p;  // the tap that row r is to output row p
          if (j >= 0 && j < K) {
            acc[p].x = fmaf(w[j], v.x, acc[p].x);
            acc[p].y = fmaf(w[K + j], v.y, acc[p].y);
            acc[p].z = fmaf(w[2 * K + j], v.z, acc[p].z);
            acc[p].w = fmaf(w[3 * K + j], v.w, acc[p].w);
          }
        }
      }
      const float4 bias = ldg4(dw_b + 4 * q);
#pragma unroll
      for (int p = 0; p < P; ++p)
        y[p][g] = make_float4(acc[p].x + bias.x, acc[p].y + bias.y, acc[p].z + bias.z,
                              acc[p].w + bias.w);
    }
  }

  const float scale = expf(__ldg(log_scale));
  const float4* cb = reinterpret_cast<const float4*>(c);
  float4* ob = reinterpret_cast<float4*>(out) + (size_t)b * T * c4;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = t0 + r0 + p;
    if (t >= T) break;  // the same for the whole warp
    // BiasNorm: rsqrt(mean((y - bias)^2)) over the row's C channels, float32
    float ss = 0.f;
#pragma unroll
    for (int g = 0; g < VEC; ++g) {
      const int q = g * WARP + lane;
      if (q < c4) {
        const float4 nb = ldg4(norm_b + 4 * q);
        const float dx = y[p][g].x - nb.x, dy = y[p][g].y - nb.y;
        const float dz = y[p][g].z - nb.z, dw = y[p][g].w - nb.w;
        ss += dx * dx + dy * dy + dz * dz + dw * dw;
      }
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float s = rsqrtf(ss / static_cast<float>(C)) * scale;
    const float4* crow = cb == nullptr ? nullptr : cb + ((size_t)b * t_c + t / f) * c4;
#pragma unroll
    for (int g = 0; g < VEC; ++g) {
      const int q = g * WARP + lane;
      if (q < c4) {
        float4 v = make_float4(y[p][g].x * s, y[p][g].y * s, y[p][g].z * s, y[p][g].w * s);
        if (crow != nullptr) {  // the cond at its own rate, then x (1 + time)
          const float4 cv = __ldg(crow + q);
          const float4 tv = ldg4(te + ((size_t)b * c4 + q) * 4);
          v = make_float4((v.x + cv.x) * (1.f + tv.x), (v.y + cv.y) * (1.f + tv.y),
                          (v.z + cv.z) * (1.f + tv.z), (v.w + cv.w) * (1.f + tv.w));
        }
        ob[(size_t)t * c4 + q] = v;
      }
    }
  }
}

// h: n4 float4, in place; alpha: h4 float4 (the channels of a row).
template <int U>
__global__ void __launch_bounds__(STREAM_THREADS) prelu_inplace_kernel(
    float4* __restrict__ h, const float4* __restrict__ alpha, int n4, int h4) {
  const int base = blockIdx.x * STREAM_THREADS * U + threadIdx.x;
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * STREAM_THREADS;
    if (i < n4) v[u] = h[i];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * STREAM_THREADS;
    if (i < n4) {
      const float4 a = __ldg(alpha + i % h4);
      float4 r = v[u];
      r.x = r.x >= 0.f ? r.x : a.x * r.x;
      r.y = r.y >= 0.f ? r.y : a.y * r.y;
      r.z = r.z >= 0.f ? r.z : a.z * r.z;
      r.w = r.w >= 0.f ? r.w : a.w * r.w;
      h[i] = r;
    }
  }
}

// h, res: n4 float4; h = (h + bias) + scale * res in place, rounded as the
// plain version rounds it (the bias sum, the product, then their sum);
// scale, bias: c4 float4 each, or null for 1 and 0.
template <int U>
__global__ void __launch_bounds__(STREAM_THREADS) scaled_residual_kernel(
    float4* __restrict__ h, const float4* __restrict__ res, const float4* __restrict__ scale,
    const float4* __restrict__ bias, int n4, int c4) {
  const int base = blockIdx.x * STREAM_THREADS * U + threadIdx.x;
  float4 hv[U], rv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * STREAM_THREADS;
    if (i < n4) {
      hv[u] = h[i];
      rv[u] = __ldg(res + i);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * STREAM_THREADS;
    if (i < n4) {
      float4 hb = hv[u], r = rv[u];
      if (bias != nullptr) {
        const float4 b = __ldg(bias + i % c4);
        hb = make_float4(__fadd_rn(hb.x, b.x), __fadd_rn(hb.y, b.y), __fadd_rn(hb.z, b.z),
                         __fadd_rn(hb.w, b.w));
      }
      if (scale != nullptr) {
        const float4 s = __ldg(scale + i % c4);
        r = make_float4(__fmul_rn(r.x, s.x), __fmul_rn(r.y, s.y), __fmul_rn(r.z, s.z),
                        __fmul_rn(r.w, s.w));
      }
      h[i] = make_float4(__fadd_rn(hb.x, r.x), __fadd_rn(hb.y, r.y), __fadd_rn(hb.z, r.z),
                         __fadd_rn(hb.w, r.w));
    }
  }
}

using NormFilm = decltype(&convnext_norm_film_kernel<1, 1, TAPS>);

template <int P>
NormFilm norm_film_by_vec(int vec) {
  static const NormFilm table[MAX_VEC] = {
      convnext_norm_film_kernel<1, P, TAPS>, convnext_norm_film_kernel<2, P, TAPS>,
      convnext_norm_film_kernel<3, P, TAPS>, convnext_norm_film_kernel<4, P, TAPS>,
      convnext_norm_film_kernel<5, P, TAPS>, convnext_norm_film_kernel<6, P, TAPS>,
      convnext_norm_film_kernel<7, P, TAPS>, convnext_norm_film_kernel<8, P, TAPS>};
  return table[vec - 1];
}

}  // namespace

// All pointers 16-byte aligned, all tensors contiguous float32 (the wrapper
// checks). x, out: (batch, frames, channels); mask: (batch, frames) or null;
// dw_w: (channels, k); dw_b, norm_b: (channels,); log_scale: one float;
// c: (batch, t_c, channels) with t_c >= ceil(frames / f), or null; te:
// (batch, channels), null exactly when c is. rows_per_tile, rows_per_warp:
// ops/convnext_chain.py `norm_film_plan`. Launches on `stream`; returns a
// cudaError_t.
extern "C" int convnext_norm_film_launch(const float* x, const float* mask, const float* dw_w,
                                         const float* dw_b, const float* norm_b,
                                         const float* log_scale, const float* c, const float* te,
                                         float* out, int batch, int frames, int channels, int k,
                                         int f, int t_c, int rows_per_tile, int rows_per_warp,
                                         void* stream) {
  if (batch < 1 || frames < 1 || channels < 4 || channels % 4 != 0 ||
      channels > 4 * WARP * MAX_VEC || k != TAPS || f < 1 || (c == nullptr) != (te == nullptr) ||
      (c != nullptr && (long long)t_c * f < frames) || (rows_per_warp != 1 && rows_per_warp != 2) ||
      rows_per_tile < 1 || rows_per_tile % rows_per_warp != 0 ||
      rows_per_tile / rows_per_warp > 256 / WARP)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)batch * frames * channels > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (frames + rows_per_tile - 1) / rows_per_tile;
  const int smem = (rows_per_tile + 2 * k - 1) * channels * 4;  // the rows, then the taps
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (channels / 4 + WARP - 1) / WARP;
  const NormFilm kernel =
      rows_per_warp == 2 ? norm_film_by_vec<2>(vec) : norm_film_by_vec<1>(vec);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(unsigned)(batch * tiles), WARP * (rows_per_tile / rows_per_warp), smem,
           static_cast<cudaStream_t>(stream)>>>(x, mask, dw_w, dw_b, norm_b, log_scale, c, te,
                                                out, frames, channels, f, t_c, tiles,
                                                rows_per_tile);
  return static_cast<int>(cudaGetLastError());
}

// h: n floats, rows of `width` channels, in place; alpha: (width,).
// unroll: 1 or 4 float4 a thread (ops/convnext_chain.py `stream_unroll`).
extern "C" int prelu_inplace_launch(float* h, const float* alpha, int n, int width, int unroll,
                                    void* stream) {
  if (n < 1 || width < 4 || width % 4 != 0 || n % width != 0 || (unroll != 1 && unroll != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n / 4, per_block = STREAM_THREADS * unroll;
  const unsigned blocks = (unsigned)((n4 + per_block - 1) / per_block);
  float4* h4 = reinterpret_cast<float4*>(h);
  const float4* a4 = reinterpret_cast<const float4*>(alpha);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unroll == 4)
    prelu_inplace_kernel<4><<<blocks, STREAM_THREADS, 0, s>>>(h4, a4, n4, width / 4);
  else
    prelu_inplace_kernel<1><<<blocks, STREAM_THREADS, 0, s>>>(h4, a4, n4, width / 4);
  return static_cast<int>(cudaGetLastError());
}

// h, res: n floats, rows of `width` channels; h = (h + bias) + scale * res
// in place; scale, bias: (width,) each, or null for none. unroll: as above.
extern "C" int scaled_residual_launch(float* h, const float* res, const float* scale,
                                      const float* bias, int n, int width, int unroll,
                                      void* stream) {
  if (n < 1 || width < 4 || width % 4 != 0 || n % width != 0 || (unroll != 1 && unroll != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n / 4, per_block = STREAM_THREADS * unroll;
  const unsigned blocks = (unsigned)((n4 + per_block - 1) / per_block);
  float4* h4 = reinterpret_cast<float4*>(h);
  const float4* r4 = reinterpret_cast<const float4*>(res);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unroll == 4)
    scaled_residual_kernel<4><<<blocks, STREAM_THREADS, 0, s>>>(h4, r4, s4, b4, n4, width / 4);
  else
    scaled_residual_kernel<1><<<blocks, STREAM_THREADS, 0, s>>>(h4, r4, s4, b4, n4, width / 4);
  return static_cast<int>(cudaGetLastError());
}
