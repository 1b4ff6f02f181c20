// Fused iSTFT for Hopper (sm_90a): complex spectrogram -> waveform in one
// launch, with the frames never written to device memory. Below it, its
// adjoint (the backward of training), built from the same FFT passes.
//
// Replaces the Pallas TPU kernel `_istft_pallas_impl`
// (flow2gan_tpu/ops/pallas_istft.py:240, body `_istft_kernel` at :78).
// Computes, for each batch entry b, the function of ops/stft.py `istft`:
//
//   out[b, n] = ola[b, n + n_fft/2] / env[n]     for n < out_len
//   out[b, n] = 0                                for out_len <= n < length
//
// where ola is the overlap-add at `hop` of the frames w[n] * irfft(X)[n]
// (periodic Hann window w; the imaginary parts of the DC and Nyquist bins
// ignored, as the plain version's iDFT matrices ignore them), env the same
// float32 squared-window envelope the plain version divides by, and
// out_len = min(length, (T_f - 1) * hop).
//
// The inverse real DFT of a frame (N = n_fft, M = N/2) is one M-point
// complex FFT. The Hermitian half-spectrum X[0..M] is packed into
//
//   Z[m] = (X[m] + conj X[M-m]) + i e^{+2 pi i m/N} (X[m] - conj X[M-m]),
//
// whose unnormalised inverse FFT z gives x[2n] = Re z[n] / N and
// x[2n+1] = Im z[n] / N. So the complex buffer, read as floats, is the frame
// in order, and 1/N rides in the window table. The FFT is Stockham in shared
// memory, ping-ponging between two buffers with one barrier per pass: a
// first pass of radix 2 where log2 M is odd, else radix 4, with the pack
// fused into it, then radix-4 passes (5 passes at N = 1024, 3 at N = 128).
// Twiddles come from a table of cos/sin(2 pi j/N), j < N/2, computed in
// float64 on the host (the other half circle by negation, which is exact),
// not from __sinf/__cosf.
//
// Tiles: block (b, tile) owns `rows_per_tile` (R) consecutive hop-wide rows
// of the overlap-added signal and transforms the R + k - 1 frames that
// overlap them (k = N / hop), so a halo frame is transformed by both tiles
// that need it, at (k - 1) / R extra work. Each output sums its k frame
// contributions in a fixed order, from the latest frame to the earliest,
// with no atomics, so the result is deterministic, and is written exactly
// once, with coalesced stores, zero pad included. Where R + k - 1 frames do
// not fit in shared memory (k above 8192 / N), the tile takes its frames in
// chunks and keeps its partial sums in shared memory. The wrapper
// (ops/fused_istft.py `tile_plan`) picks R; batch entries times tiles lie on
// gridDim.x.
//
// What bounds it on this card: bytes. The FFT form does about 2.5 N log2 N
// + 2 N FLOP per frame, under 0.6 us at the FP32 peak at (1024, 512), batch
// 16, while reading the spectrogram once (8 (N/2 + 1) bytes per frame) and
// writing the waveform once take 2.6 us at 3.35 TB/s. At the main-path sizes
// a block's time is the latency of its chain of loads, passes and barriers.
// The design issues all of a block's loads at once: the chunk's frames, which
// lie back to back in device memory, the tables and the tile's slice of the
// envelope are copied to shared memory by cp.async in 8-byte (4-byte for the
// envelope) pieces, since a frame of F = N/2 + 1 complex values starts
// 8-byte but not always 16-byte aligned. It keeps every frame on chip and
// runs about four blocks per SM, so one block's waits overlap another's work.
//
// Why not the matmul form: the first CUDA version of this kernel computed
// each output hop-row as sum_j view_as_real(spec)[t - j] @ W[j], a GEMM with
// K = k * 2F, which does 13x (N 128) to 75x (N 1024) the FFT form's FLOP.
// After six tuning rounds it took 0.0561 ms at (512, 256) and 0.1422 ms at
// (1024, 512), batch 16, on an H100 80GB HBM3 at 700 W: 17-55x its bytes
// bound, and at (1024, 512) no faster than the plain version or torch.istft.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may take

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// Asynchronous copies of 4 and 8 bytes from device to shared memory.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// e^{2 pi i j / N} for 0 <= j < N from the half-circle table tw[j], j < M:
// e^{i (theta + pi)} = -e^{i theta}, exact in float32.
__device__ __forceinline__ float2 twiddle(const float2* tw, int j, int m_pts) {
  const float2 w = tw[j & (m_pts - 1)];
  return (j & m_pts) ? make_float2(-w.x, -w.y) : w;
}

// Z[m] of the pack above from the frame x = X[0..M], w = e^{+2 pi i m/N};
// the imaginary parts of X[0] and X[M] are dropped before the pack, which at
// m = 0 reads both.
__device__ __forceinline__ float2 hermitian_pack(const float2* x, int m, int m_pts, float2 w) {
  float2 a = x[m], c = x[m_pts - m];
  if (m == 0) a.y = c.y = 0.f;
  c.y = -c.y;
  const float2 s = a + c, d = a - c;
  return make_float2(s.x - (w.x * d.y + w.y * d.x), s.y + (w.x * d.x - w.y * d.y));
}

// Stockham butterflies of an inverse FFT at stride s, with base = pp * s:
// output j of the r-point inverse DFT of the inputs goes to y[j * s],
// times e^{+2 pi i j pp s / M} = twiddle(2 j base).
__device__ __forceinline__ void radix2(float2* y, int s, int base, const float2* tw, int m_pts,
                                       float2 a, float2 b) {
  y[0] = a + b;
  y[s] = cmul(a - b, twiddle(tw, 2 * base, m_pts));
}
__device__ __forceinline__ void radix4(float2* y, int s, int base, const float2* tw, int m_pts,
                                       float2 a, float2 b, float2 c, float2 d) {
  const float2 apc = a + c, amc = a - c, bpd = b + d, bmd = b - d;
  const float2 ibmd = make_float2(-bmd.y, bmd.x);  // i (b - d)
  y[0] = apc + bpd;
  y[s] = cmul(amc + ibmd, twiddle(tw, 2 * base, m_pts));
  y[2 * s] = cmul(apc - bpd, twiddle(tw, 4 * base, m_pts));
  y[3 * s] = cmul(amc - ibmd, twiddle(tw, 6 * base, m_pts));
}

__global__ void __launch_bounds__(THREADS)
fused_istft_kernel(const float2* __restrict__ spec,   // (B, T_f, M + 1)
                   const float* __restrict__ tables,  // twiddles (M, 2), then window (N)
                   const float* __restrict__ env,     // (out_len,) at least
                   float* __restrict__ out,           // (B, length)
                   int t_f, int log2m, int log2hop, int length, int out_len, int t_lo,
                   int tiles, int rows_per_tile, int frames_per_chunk) {
  extern __shared__ __align__(16) float2 smem[];
  const int m_pts = 1 << log2m, n_fft = 2 * m_pts, quarter_m = m_pts / 4;
  const int hop = 1 << log2hop, k = n_fft >> log2hop;
  const int tile_len = rows_per_tile * hop;
  // the layout whose size the wrapper computes (TilePlan.smem_bytes)
  float2* tw = smem;                                  // M
  float2* buf0 = tw + m_pts;                          // frames_per_chunk * M
  float2* buf1 = buf0 + frames_per_chunk * m_pts;     // frames_per_chunk * (M + 1)
  float* win = reinterpret_cast<float*>(buf1 + frames_per_chunk * (m_pts + 1));  // N
  float* env_tile = win + n_fft;                      // tile_len
  float* acc = env_tile + tile_len;                   // tile_len, when chunked

  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int t0 = t_lo + tile * rows_per_tile;
  const long long idx0 = (long long)t0 * hop - m_pts;  // output index of the tile's first sample
  const int fa = max(t0 - k + 1, 0), fb = min(t0 + rows_per_tile, t_f);  // frames [fa, fb)
  const int n_chunks = max((fb - fa + frames_per_chunk - 1) / frames_per_chunk, 1);
  const float2* spec_b = spec + (size_t)b * t_f * (m_pts + 1);
  float* out_b = out + (size_t)b * length;

  // the tables and the tile's slice of the envelope, in flight with the
  // first chunk's spectrum
  for (int i = threadIdx.x; i < m_pts; i += THREADS) {
    cp_async8(tw + i, tables + 2 * i);
    cp_async8(win + 2 * i, tables + n_fft + 2 * i);
  }
  for (int e = threadIdx.x; e < tile_len; e += THREADS)
    if (idx0 + e >= 0 && idx0 + e < out_len) cp_async4(env_tile + e, env + idx0 + e);

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int hi = fb - ci * frames_per_chunk;  // this chunk's frames [lo, hi)
    const int lo = max(hi - frames_per_chunk, fa);
    const int nc = max(hi - lo, 0);

    // the chunk's frames lie back to back in device memory: copy them to
    // buf1 as they are, 8 bytes a thread (frame starts are 8-byte aligned)
    const float2* chunk = spec_b + (size_t)lo * (m_pts + 1);
    for (int i = threadIdx.x; i < nc * (m_pts + 1); i += THREADS) cp_async8(buf1 + i, chunk + i);
    cp_async_wait_all();
    __syncthreads();

    // pass 0 at stride 1 on the packed spectrum, buf1 -> buf0: radix 4, or
    // radix 2 where log2 M is odd; then radix-4 passes to the end. A pass
    // takes its r inputs at stride M / r and writes in Stockham order.
    float2* src = buf1;
    float2* dst = buf0;
    int s = 1;
    if (log2m & 1) {
      const int half_m = m_pts / 2;
      for (int i = threadIdx.x; i < nc * half_m; i += THREADS) {
        const int lf = i >> (log2m - 1), r = i & (half_m - 1);
        const float2* x = src + lf * (m_pts + 1);
        radix2(dst + lf * m_pts + 2 * r, 1, r, tw, m_pts,
               hermitian_pack(x, r, m_pts, tw[r]),
               hermitian_pack(x, r + half_m, m_pts, tw[r + half_m]));
      }
      s = 2;
    } else {
      for (int i = threadIdx.x; i < nc * quarter_m; i += THREADS) {
        const int lf = i >> (log2m - 2), r = i & (quarter_m - 1);
        const float2* x = src + lf * (m_pts + 1);
        radix4(dst + lf * m_pts + 4 * r, 1, r, tw, m_pts,
               hermitian_pack(x, r, m_pts, tw[r]),
               hermitian_pack(x, r + quarter_m, m_pts, tw[r + quarter_m]),
               hermitian_pack(x, r + 2 * quarter_m, m_pts, tw[r + 2 * quarter_m]),
               hermitian_pack(x, r + 3 * quarter_m, m_pts, tw[r + 3 * quarter_m]));
      }
      s = 4;
    }
    __syncthreads();
    for (; s < m_pts; s *= 4) {
      float2* done = dst;
      dst = src;
      src = done;
      for (int i = threadIdx.x; i < nc * quarter_m; i += THREADS) {
        const int lf = i >> (log2m - 2), r = i & (quarter_m - 1);
        const int base = r & ~(s - 1);  // pp * s
        const float2* x = src + lf * m_pts + r;
        radix4(dst + lf * m_pts + 4 * base + (r - base), s, base, tw, m_pts,
               x[0], x[quarter_m], x[2 * quarter_m], x[3 * quarter_m]);
      }
      __syncthreads();
    }

    // overlap-add: row t, column c sums window * frame over frames
    // f = t - j, j = 0 .. k-1, in this chunk; the last chunk stores
    const float* frames = reinterpret_cast<const float*>(dst);  // (chunk, N): x in order
    const bool last = ci == n_chunks - 1;
    for (int e = threadIdx.x; e < tile_len; e += THREADS) {
      const int r = e >> log2hop, c = e & (hop - 1);
      const int t = t0 + r;
      float v = ci == 0 ? 0.f : acc[e];
      for (int j = 0; j < k; ++j) {
        const int f = t - j;
        if (f >= lo && f < hi)
          v = fmaf(win[j * hop + c], frames[(f - lo) * n_fft + j * hop + c], v);
      }
      if (!last) {
        acc[e] = v;
        continue;
      }
      const long long idx = idx0 + e;  // into the trimmed output
      if (idx >= 0 && idx < length) out_b[idx] = idx < out_len ? v / env_tile[e] : 0.f;
    }
    if (!last) __syncthreads();  // the next chunk overwrites the buffers
  }
}

// The adjoint of the kernel above (its backward: the iSTFT is linear), the
// gradient of the waveform g (B, length) -> the gradient of the spectrogram
// G (B, T_f, M + 1) as d/dRe + i d/dIm. It replaces the XLA adjoint that the
// Pallas kernel's custom VJP takes (flow2gan_tpu/ops/pallas_istft.py:222).
// For frame f, with u[n] = w[n] / N * s[f hop + n - M] and s = g / env on
// [0, out_len), zero elsewhere (the trim; the pad gets no gradient):
//
//   G[f, k] = c_k sum_n u[n] e^{-2 pi i k n / N},  c_k = 1 at k = 0 and M, else 2,
//
// since the inverse real DFT weights interior bins twice. It is the forward
// kernel run the other way: one M-point forward complex FFT of the packed
// frame z[m] = u[2m] + i u[2m+1], done as the same inverse Stockham passes on
// conj z (FFT(z) = conj IFFT(conj z)), then the Hermitian unpack
//
//   G[k] = (Z[k] + conj Z[M-k]) - i e^{-2 pi i k/N} (Z[k] - conj Z[M-k]),
//
// which at k = 0 and M is real: Re Z[0] + Im Z[0] and Re Z[0] - Im Z[0],
// written with an imaginary part of exactly zero, as the forward kernel
// drops it there.
//
// Tiles: block (b, tile) transforms `frames_per_tile` consecutive frames and
// first stages the span of g / env they read ((F - 1) hop + N samples) in
// shared memory. Frames overlap in what they read but each is written by one
// block only, so there are no atomics. Bound, as the forward: bytes (g read
// once, G written once); at the main-path sizes the chain of loads, passes
// and barriers.
__global__ void __launch_bounds__(THREADS)
fused_istft_adjoint_kernel(const float* __restrict__ grad,    // (B, length)
                           const float* __restrict__ tables,  // twiddles (M, 2), then window (N)
                           const float* __restrict__ env,     // (out_len,) at least
                           float2* __restrict__ out,          // (B, T_f, M + 1)
                           int t_f, int log2m, int log2hop, int length, int out_len,
                           int tiles, int frames_per_tile) {
  extern __shared__ __align__(16) float2 smem[];
  const int m_pts = 1 << log2m, n_fft = 2 * m_pts, quarter_m = m_pts / 4;
  const int hop = 1 << log2hop;
  // the layout whose size the wrapper computes (AdjointPlan.smem_bytes)
  float2* tw = smem;                                  // M
  float2* buf0 = tw + m_pts;                          // frames_per_tile * M
  float2* buf1 = buf0 + frames_per_tile * m_pts;      // frames_per_tile * M
  float* win = reinterpret_cast<float*>(buf1 + frames_per_tile * m_pts);  // N
  float* sig = win + n_fft;                           // (frames_per_tile - 1) * hop + N

  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int f0 = tile * frames_per_tile;
  const int nc = min(frames_per_tile, t_f - f0);
  const int span = (nc - 1) * hop + n_fft;
  const long long idx0 = (long long)f0 * hop - m_pts;  // waveform index of sig[0]
  const float* g_b = grad + (size_t)b * length;

  for (int i = threadIdx.x; i < m_pts; i += THREADS) {
    cp_async8(tw + i, tables + 2 * i);
    cp_async8(win + 2 * i, tables + n_fft + 2 * i);
  }
  for (int e = threadIdx.x; e < span; e += THREADS) {
    const long long idx = idx0 + e;
    sig[e] = idx >= 0 && idx < out_len ? g_b[idx] / env[idx] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // conj z of each frame, windowed (1/N rides in the window table)
  for (int i = threadIdx.x; i < nc * m_pts; i += THREADS) {
    const int lf = i >> log2m, m = i & (m_pts - 1);
    const float* u = sig + lf * hop + 2 * m;
    buf0[i] = make_float2(u[0] * win[2 * m], -(u[1] * win[2 * m + 1]));
  }
  __syncthreads();

  // the inverse Stockham passes of the forward kernel: radix 2 first where
  // log2 M is odd, then radix 4 to the end
  float2* src = buf0;
  float2* dst = buf1;
  int s = 1;
  if (log2m & 1) {
    const int half_m = m_pts / 2;
    for (int i = threadIdx.x; i < nc * half_m; i += THREADS) {
      const int lf = i >> (log2m - 1), r = i & (half_m - 1);
      const float2* x = src + lf * m_pts;
      radix2(dst + lf * m_pts + 2 * r, 1, r, tw, m_pts, x[r], x[r + half_m]);
    }
    s = 2;
    float2* done = dst;
    dst = src;
    src = done;
    __syncthreads();
  }
  for (; s < m_pts; s *= 4) {
    for (int i = threadIdx.x; i < nc * quarter_m; i += THREADS) {
      const int lf = i >> (log2m - 2), r = i & (quarter_m - 1);
      const int base = r & ~(s - 1);  // pp * s
      const float2* x = src + lf * m_pts + r;
      radix4(dst + lf * m_pts + 4 * base + (r - base), s, base, tw, m_pts,
             x[0], x[quarter_m], x[2 * quarter_m], x[3 * quarter_m]);
    }
    float2* done = dst;
    dst = src;
    src = done;
    __syncthreads();
  }

  // unpack: src holds conj Z of each frame; the tile's frames are
  // contiguous in `out`, so the stores are coalesced
  float2* out_t = out + ((size_t)b * t_f + f0) * (m_pts + 1);
  for (int i = threadIdx.x; i < nc * (m_pts + 1); i += THREADS) {
    const int lf = i / (m_pts + 1), k = i - lf * (m_pts + 1);
    const float2* res = src + lf * m_pts;
    float2 v;
    if (k == 0) {
      v = make_float2(res[0].x - res[0].y, 0.f);
    } else if (k == m_pts) {
      v = make_float2(res[0].x + res[0].y, 0.f);
    } else {
      const float2 a = make_float2(res[k].x, -res[k].y), c = res[m_pts - k];
      const float2 sum = a + c;
      const float2 wd = cmul(a - c, make_float2(tw[k].x, -tw[k].y));  // e^{-2 pi i k/N} d
      v = make_float2(sum.x + wd.y, sum.y - wd.x);
    }
    out_t[i] = v;
  }
}

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace

// spec: (batch, t_f, n_fft/2 + 1) complex64 viewed as interleaved float32.
// tables: twiddles (n_fft/2, 2), then the window (n_fft), float32.
// env: ((t_f - 1) * hop,). out: (batch, length).
// t_lo, tiles, rows_per_tile, frames_per_chunk, smem_bytes: the tile plan
// and the block's dynamic shared memory (ops/fused_istft.py `tile_plan`,
// `TilePlan.smem_bytes`: the layout at the top of the kernel).
// Launches on `stream` and returns a cudaError_t (0 on success).
extern "C" int fused_istft_launch(const float* spec, const float* tables, const float* env,
                                  float* out, int batch, int t_f, int n_fft, int hop,
                                  int length, int t_lo, int tiles, int rows_per_tile,
                                  int frames_per_chunk, int smem_bytes, void* stream) {
  const int log2n = log2_exact(n_fft), log2hop = log2_exact(hop);
  if (log2n < 6 || log2n > 10 || log2hop < 0 || hop > n_fft || rows_per_tile < 1 ||
      frames_per_chunk < 1 || tiles < 1 || smem_bytes < 1 || smem_bytes > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long default_len = (long long)(t_f - 1) * hop;
  const int out_len = length < default_len ? length : static_cast<int>(default_len);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_istft_kernel<<<(unsigned)batch * tiles, THREADS, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(spec), tables, env, out, t_f, log2n - 1, log2hop, length,
      out_len, t_lo, tiles, rows_per_tile, frames_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

// grad: (batch, length) float32. tables, env: as above. out: (batch, t_f,
// n_fft/2 + 1) complex64 viewed as interleaved float32. tiles,
// frames_per_tile, smem_bytes: ops/fused_istft.py `adjoint_plan` and
// `AdjointPlan.smem_bytes`. Launches on `stream`; returns a cudaError_t.
extern "C" int fused_istft_adjoint_launch(const float* grad, const float* tables,
                                          const float* env, float* out, int batch, int t_f,
                                          int n_fft, int hop, int length, int tiles,
                                          int frames_per_tile, int smem_bytes, void* stream) {
  const int log2n = log2_exact(n_fft), log2hop = log2_exact(hop);
  if (log2n < 6 || log2n > 10 || log2hop < 0 || hop > n_fft || frames_per_tile < 1 ||
      tiles < 1 || (long long)tiles * frames_per_tile < t_f || smem_bytes < 1 ||
      smem_bytes > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long default_len = (long long)(t_f - 1) * hop;
  const int out_len = length < default_len ? length : static_cast<int>(default_len);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_istft_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_istft_adjoint_kernel<<<(unsigned)batch * tiles, THREADS, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      grad, tables, env, reinterpret_cast<float2*>(out), t_f, log2n - 1, log2hop, length,
      out_len, tiles, frames_per_tile);
  return static_cast<int>(cudaGetLastError());
}
