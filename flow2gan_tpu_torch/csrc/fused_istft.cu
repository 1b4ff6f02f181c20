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
// Pallas kernel's custom VJP takes (flow2gan_tpu/ops/pallas_istft.py:222,
// `_istft_pallas_diff_bwd`); its plain version is ops/stft.py
// `istft_adjoint`. For frame f, with u[n] = w[n] / N * s[f hop + n - M] and
// s = g / env on [0, out_len), zero elsewhere (the trim; the pad gets no
// gradient):
//
//   G[f, k] = c_k sum_n u[n] e^{-2 pi i k n / N},  c_k = 1 at k = 0 and M, else 2,
//
// since the inverse real DFT weights interior bins twice. It is one M-point
// forward complex FFT Z of z[m] = u[2m] + i u[2m+1], then the Hermitian unpack
//
//   G[k] = (Z[k] + conj Z[M-k]) - i e^{-2 pi i k/N} (Z[k] - conj Z[M-k]),
//
// which at k = 0 and M is real: Re Z[0] + Im Z[0] and Re Z[0] - Im Z[0],
// written with an imaginary part of exactly zero, as the forward kernel
// drops it there. Each bin is written once, with no atomics.
//
// What bounds it on this card: bytes, g read once (4 B a sample) and G
// written once (8 (M + 1) B a frame): 33 us a launch at the reference's FM
// batch of 256 per card (1.5 s crops) at 3.35 TB/s, 8 us at its fine-tuning
// batch of 64; the FFT form's 2.5 N log2 N FLOP a frame at 67 TFLOP/s take
// a fifth of that. At batch 16 the bound is 2 us a launch, under the ~5 us
// that an empty launch reads, and the time is the chain of one block's
// copy, divide, passes and stores.
//
// The design:
// - Persistent blocks, at most two per SM (ops/fused_istft.py
//   `adjoint_plan` reads the SM count). A work item is (b, tile of F
//   consecutive frames), F one group of frames for each consumer warp
//   (smaller at a small batch, so that the blocks share the work); block i
//   takes items i, i + gridDim.x, ... and loads the tables once.
// - A ring of 2-3 slots in shared memory, each holding one item's span of g
//   ((F - 1) hop + N samples) and the envelope's over the same samples, as
//   they lie in device memory. One producer warp fills the slots ahead of
//   the consumers: one bulk copy (TMA: cp.async.bulk, completing on an
//   mbarrier that expects its bytes) for each span's whole 16-byte units
//   inside [0, out_len), which the slot holds at the same place on the
//   16-byte grid (shifted by 0-3 samples), while its lanes copy the heads and
//   tails of under 4 samples, so any length and any row start work. A
//   second mbarrier hands the slot back once every consumer thread is done
//   with it, so item i+1's bytes arrive while item i is transformed.
// - Seven consumer warps (with the producer, 8 warps a block, so that two
//   blocks split the register file's quarters evenly at 128 registers a
//   thread). They divide the slot's span by the envelope in place, each
//   sample once (a frame reads N / hop of them: dividing in the pack, once
//   per frame that reads a sample, was slower on the card at every timed
//   shape), zero outside [0, out_len), and meet at one barrier of their own
//   per item.
// - A warp holds the FFTs of a group of frames in its registers, 16 complex
//   points a lane (N/32 lanes a frame: 1 frame a warp at N = 1024, 16 at
//   N = 64). The pack multiplies by the window (1/N in it) on the way from
//   the slot to the registers; where a warp takes 4 or more frames, which
//   lie hop apart on the same banks, it goes through the warp's slice of
//   shared memory, lane by lane.
// - Stockham passes in registers: radix 16 (as 4 x 4), then a radix 2, 4 or
//   8 pass for log2 M mod 4, so 2 passes at N = 64-512 and 3 at 1024; a
//   lane's butterflies take its own registers, and between passes the data
//   go through the warp's padded slice of shared memory with __syncwarp,
//   never a block barrier. The last pass needs no twiddles. The kernel is a
//   template on log2 M, so the passes and offsets are constants.
// - The unpack makes bins k and M - k from Z[k] and Z[M - k] in registers
//   and stores the warp's frames, which lie back to back in `out`, with
//   streaming stores; where a frame's run of bins is short (4 or more frames
//   a warp) it lays them out in the slice first, so each store is 256
//   contiguous bytes.
// - Float32 on the CUDA cores. Twiddles come from the float64-built table
//   (ops/fused_istft.py `kernel_tables_np`): the passes' from it in shared
//   memory (and its even entries as the M-point circle), the radix-16
//   constants (2 pi e/16) from three of its entries with exact quarter
//   turns; never __sinf/__cosf or a recurrence. No tensor cores: a TF32 or
//   bf16 DFT would miss the 1e-5 limit against the plain adjoint, and the
//   kernel is not bound by operations.
// What holds it back (PERF.md, PR 8): at batches 64 and 256 the consumer
// warps are latency-bound (14 a SM, the most that registers and shared
// memory allow) and meet once per item; at batch 16, the chain above.
//
// History: PR 4-7's version gave each block one tile of frames, staged
// g / env with synchronous loads, reloaded the tables in every block, and
// ran the inverse Stockham passes through shared memory with a block
// barrier after each (5 at N = 512), four blocks per SM. It took 0.0380 ms
// for a batch-16 training step's three launches against a bound of 0.00624
// (PERF.md, PR 7), and 0.16-0.17 ms a launch at batch 256.
constexpr int ADJ_WARPS = 7;                          // consumer warps
constexpr int ADJ_THREADS = 32 * (ADJ_WARPS + 1);     // and one producer warp
constexpr int ADJ_POINTS = 16;                        // complex points a lane
constexpr int ADJ_EXCHANGE = 32 * ADJ_POINTS * 17 / 16;  // float2 a warp, 1 pad per 16
constexpr int ADJ_MAX_STAGES = 3;                     // ring slots the layout has barriers for

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ int pad16(int x) { return x + (x >> 4); }

// the consumer warps' own barrier (barrier 0 is __syncthreads')
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * ADJ_WARPS) : "memory");
}

// a * conj(w)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 w) {
  return make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y);
}

// x * e^{-2 pi i e / 16} for a constant e: quarter turns exactly, the rest
// from c[r] = (cos, sin)(2 pi r / 16), r = 1, 2, 3, turned by e / 4 quarters
template <int E>
__device__ __forceinline__ float2 rot16(float2 x, const float2 (&c)[3]) {
  constexpr int e = E & 15, r = e & 3, q = e >> 2;
  if constexpr (r == 0) {
    if constexpr (q == 0) return x;
    if constexpr (q == 1) return make_float2(x.y, -x.x);   // * -i
    if constexpr (q == 2) return make_float2(-x.x, -x.y);  // * -1
    return make_float2(-x.y, x.x);                         // * i
  } else {
    float2 w = c[r - 1];
    if constexpr (q & 1) w = make_float2(-w.y, w.x);
    if constexpr (q & 2) w = make_float2(-w.x, -w.y);
    return cmul_conj(x, w);
  }
}

// forward DFTs in registers, in place; dft<R> leaves output j at
// x[out_slot<R>(j)]
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 d = a - b;
  a = a + b;
  b = d;
}
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 apc = a + c, amc = a - c, bpd = b + d, bmd = b - d;
  const float2 mibmd = make_float2(bmd.y, -bmd.x);  // -i (b - d)
  a = apc + bpd;
  b = amc + mibmd;
  c = apc - bpd;
  d = amc - mibmd;
}
template <int R>
__host__ __device__ constexpr int out_slot(int j) {
  return R <= 4 ? j : (j >> 2) + (R / 4) * (j & 3);
}
// x[n1 + r1 k2] *= e^{-2 pi i n1 k2 / R} for n1 = N1 .. r1 - 1 (r1 = R / 4)
template <int R, int N1>
__device__ __forceinline__ void twiddle_columns(float2 (&x)[R], const float2 (&c)[3]) {
  constexpr int r1 = R / 4, step = 16 / R;
  if constexpr (N1 < r1) {
    x[N1 + r1] = rot16<N1 * 1 * step>(x[N1 + r1], c);
    x[N1 + 2 * r1] = rot16<N1 * 2 * step>(x[N1 + 2 * r1], c);
    x[N1 + 3 * r1] = rot16<N1 * 3 * step>(x[N1 + 3 * r1], c);
    twiddle_columns<R, N1 + 1>(x, c);
  }
}
// radix 8 and 16 as r1 x 4 (r1 = R / 4): radix 4 over x[n1 + r1 n2], the
// twiddle e^{-2 pi i n1 k2 / R}, radix r1 over n1; output k2 + 4 k1 lands
// in x[k1 + r1 k2]
template <int R>
__device__ __forceinline__ void dft(float2 (&x)[R], const float2 (&c)[3]) {
  if constexpr (R == 2) {
    dft2(x[0], x[1]);
  } else if constexpr (R == 4) {
    dft4(x[0], x[1], x[2], x[3]);
  } else {
    constexpr int r1 = R / 4;
#pragma unroll
    for (int n1 = 0; n1 < r1; ++n1) dft4(x[n1], x[n1 + r1], x[n1 + 2 * r1], x[n1 + 3 * r1]);
    twiddle_columns<R, 1>(x, c);
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      if constexpr (r1 == 2) {
        dft2(x[r1 * k2], x[r1 * k2 + 1]);
      } else {
        dft4(x[r1 * k2], x[r1 * k2 + 1], x[r1 * k2 + 2], x[r1 * k2 + 3]);
      }
    }
  }
}

// pad16(jl + lanes p) - pad16(jl) for jl < lanes: lanes divides 16, or 16
// divides lanes, so the 16-runs a lane's points fall in do not depend on jl
template <int LANES>
__host__ __device__ constexpr int reg_offset(int p) {
  return LANES >= 16 ? LANES * p * 17 / 16 : LANES * p + ((LANES * p) >> 4);
}

// One Stockham pass of radix R at stride S on an M-point frame whose slice
// of the exchange buffer starts at xf (padded as pad16): the lane's
// butterflies t = jl + lanes i take registers i + k * 16/R; output j, times
// e^{-2 pi i j base / M} (base = t rounded down to S; 1 in the last pass),
// goes to R base + t mod S + j S. Radix 16 comes first (S = 1) and the
// remainder last (S >= 16), so the R outputs lie in one run of 16 or 16
// apart: their padded places are p0 + j * step. Unless it is the last pass,
// the lane then reads back its registers, z[jl + lanes p].
template <int R, int S, int M>
__device__ __forceinline__ void stockham_pass(float2 (&v)[ADJ_POINTS], float2* xf, int jl,
                                              const float2* circ, const float2 (&c)[3]) {
  constexpr int per = ADJ_POINTS / R, lanes = M / ADJ_POINTS;
  constexpr bool last = S * R == M;
  constexpr int step = S >= 16 ? S + S / 16 : S;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    float2 x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = v[i + k * per];
    dft<R>(x, c);
    const int t = jl + lanes * i;
    const int base = t & ~(S - 1);
    float2* y = xf + pad16(R * base + (t & (S - 1)));
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float2 o = x[out_slot<R>(j)];
      if (j > 0 && !last) o = cmul_conj(o, circ[(j * base) & (M - 1)]);
      y[j * step] = o;
    }
  }
  __syncwarp();
  if constexpr (!last) {
    const float2* r = xf + pad16(jl);
#pragma unroll
    for (int p = 0; p < ADJ_POINTS; ++p) v[p] = r[reg_offset<lanes>(p)];
    __syncwarp();
  }
}

// the passes: radix 16 while 16 S <= M, then the remainder radix
template <int S, int M>
__device__ __forceinline__ void fft_passes(float2 (&v)[ADJ_POINTS], float2* xf, int jl,
                                           const float2* circ, const float2 (&c)[3]) {
  if constexpr (16 * S <= M) {
    stockham_pass<16, S, M>(v, xf, jl, circ, c);
    fft_passes<16 * S, M>(v, xf, jl, circ, c);
  } else if constexpr (S < M) {
    stockham_pass<M / S, S, M>(v, xf, jl, circ, c);
  }
}

// Where an item's span of a waveform-long array (g's row, or the envelope)
// lies in its ring slot: slot[x] holds element idx0 + x - q of `base`, on
// the same 16-byte grid as in device memory; [lo, hi) is the part inside
// [0, out_len), of which [bulk_lo, bulk_hi) is whole 16-byte units (one bulk
// copy) and the rest a head and a tail of under 4 elements each.
struct SlotSpan {
  int q, lo, hi, bulk_lo, bulk_hi;
};
__device__ __forceinline__ SlotSpan slot_span(const float* base, int idx0, int count, int out_len) {
  SlotSpan sp;
  sp.q = static_cast<int>(((reinterpret_cast<unsigned long long>(base) >> 2) +
                           static_cast<unsigned long long>(idx0)) & 3ull);
  sp.lo = max(idx0, 0) - idx0 + sp.q;
  sp.hi = max(min(idx0 + count, out_len) - idx0 + sp.q, sp.lo);
  sp.bulk_lo = min((sp.lo + 3) & ~3, sp.hi);
  sp.bulk_hi = max(sp.hi & ~3, sp.bulk_lo);
  return sp;
}

// lanes 0-3 of the 8 given copy the head of a span, lanes 4-7 its tail
__device__ __forceinline__ void copy_edges(float* dst, const float* src, const SlotSpan& sp,
                                           int lane) {
  if (lane < 4) {
    if (sp.lo + lane < sp.bulk_lo) dst[sp.lo + lane] = src[sp.lo + lane];
  } else if (lane < 8) {
    if (sp.bulk_hi + lane - 4 < sp.hi) dst[sp.bulk_hi + lane - 4] = src[sp.bulk_hi + lane - 4];
  }
}

// The windowed rows of a group of frames (frame f at rows[f hop], `live`
// of them) into the exchange slice xw as z (frame f's z[m] at pad16(f M +
// m)), each lane taking consecutive samples: conflict free in both
template <int M>
__device__ __forceinline__ void pack_rows(float2* xw, const float* rows, const float* win, int hop,
                                          int live, int lane) {
  constexpr int N = 2 * M, per_warp = 32 * ADJ_POINTS / M;
  float* xs = reinterpret_cast<float*>(xw);
#pragma unroll
  for (int r = 0; r < per_warp * N / 32; ++r) {
    const int f = 32 * r / N, n = (32 * r) % N + lane;  // f is the same for the whole warp
    xs[2 * pad16(f * M + (n >> 1)) + (n & 1)] = f < live ? rows[f * hop + n] * win[n] : 0.f;
  }
  __syncwarp();
}

template <int LOG2M>
__global__ void __launch_bounds__(ADJ_THREADS, 2)
fused_istft_adjoint_kernel(const float* __restrict__ grad,    // (B, length)
                           const float* __restrict__ tables,  // twiddles (M, 2), then window (N)
                           const float* __restrict__ env,     // (out_len,) at least
                           float2* __restrict__ out,          // (B, T_f, M + 1)
                           int t_f, int log2hop, int length, int out_len, int tiles,
                           int frames_per_tile, int items, int stages, int stage_floats) {
  constexpr int M = 1 << LOG2M, N = 2 * M;
  constexpr int lanes = M / ADJ_POINTS, per_warp = 32 / lanes;
  extern __shared__ __align__(16) unsigned long long adj_smem[];
  const int hop = 1 << log2hop;
  // the layout whose size the wrapper computes (AdjointPlan.smem_bytes)
  unsigned long long* full = adj_smem;                 // ADJ_MAX_STAGES
  unsigned long long* empty = full + ADJ_MAX_STAGES;   // ADJ_MAX_STAGES
  float2* tw = reinterpret_cast<float2*>(empty + ADJ_MAX_STAGES);  // M: e^{2 pi i k/N}
  float2* circ = tw + M;                               // M: e^{2 pi i x/M}
  float* win = reinterpret_cast<float*>(circ + M);     // N
  float2* exchange = reinterpret_cast<float2*>(win + N);  // ADJ_WARPS * ADJ_EXCHANGE
  float* ring = reinterpret_cast<float*>(exchange + ADJ_WARPS * ADJ_EXCHANGE);  // stages slots
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 32 * ADJ_WARPS) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 32);                   // the producer's lanes, and the bytes
      mbar_init(empty + i, 32 * ADJ_WARPS);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == ADJ_WARPS) {  // the producer
    int it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
      const int slot = it % stages;
      if (it >= stages) mbar_wait(empty + slot, (it / stages - 1) & 1);
      const int b = w / tiles, f0 = (w - b * tiles) * frames_per_tile;
      const int nc = min(frames_per_tile, t_f - f0);
      const int idx0 = f0 * hop - M;  // waveform index of the span's start
      const int count = (nc - 1) * hop + N;
      const float* row = grad + (size_t)b * length;
      const SlotSpan sg = slot_span(row, idx0, count, out_len);
      const SlotSpan se = slot_span(env, idx0, count, out_len);
      float* dst_g = ring + 2 * slot * stage_floats;  // the slot: g's span, then env's
      float* dst_e = dst_g + stage_floats;
      const float* src_g = row + (idx0 - sg.q);  // src[x] for x in [lo, hi) only
      const float* src_e = env + (idx0 - se.q);
      if (lane < 8) {
        copy_edges(dst_g, src_g, sg, lane);
      } else {
        copy_edges(dst_e, src_e, se, lane - 8);
      }
      __syncwarp();
      if (lane == 0) {
        const unsigned bytes_g = 4u * static_cast<unsigned>(sg.bulk_hi - sg.bulk_lo);
        const unsigned bytes_e = 4u * static_cast<unsigned>(se.bulk_hi - se.bulk_lo);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_expect_tx(full + slot, bytes_g + bytes_e);
        if (bytes_g) bulk_copy(dst_g + sg.bulk_lo, src_g + sg.bulk_lo, bytes_g, full + slot);
        if (bytes_e) bulk_copy(dst_e + se.bulk_lo, src_e + se.bulk_lo, bytes_e, full + slot);
      } else {
        mbar_arrive(full + slot);
      }
    }
    return;
  }

  // the consumers load the tables while the first spans are in flight
  const float2* tw_in = reinterpret_cast<const float2*>(tables);
  for (int i = threadIdx.x; i < M; i += 32 * ADJ_WARPS) {
    tw[i] = tw_in[i];
    const float2 w = tw_in[(2 * i) & (M - 1)];  // e^{i (theta + pi)} = -e^{i theta}
    circ[i] = 2 * i < M ? w : make_float2(-w.x, -w.y);
    reinterpret_cast<float2*>(win)[i] = reinterpret_cast<const float2*>(tables + N)[i];
  }
  consumer_sync();
  // lane = lf * lanes + jl holds points jl + lanes p of frame lf of the
  // warp's group
  const int lf = lane / lanes, jl = lane & (lanes - 1);
  float2* xw = exchange + warp * ADJ_EXCHANGE;  // the warp's slice
  float2* xf = xw + pad16(lf * M);                 // this lane's frame in it
  const float2 c[3] = {tw[M >> 3], tw[M >> 2], tw[3 * (M >> 3)]};  // 2 pi r/16
  int it = 0, groups = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, ++it) {
    const int slot = it % stages;
    mbar_wait(full + slot, (it / stages) & 1);
    const int b = w / tiles, f0 = (w - b * tiles) * frames_per_tile;
    const int nc = min(frames_per_tile, t_f - f0);
    const int idx0 = f0 * hop - M;
    const int count = (nc - 1) * hop + N;
    const float* row = grad + (size_t)b * length;
    // sig[e], envs[e]: sample idx0 + e of g's row and of the envelope
    float* sig = ring + 2 * slot * stage_floats + slot_span(row, idx0, count, out_len).q;
    const float* envs = ring + (2 * slot + 1) * stage_floats + slot_span(env, idx0, count, out_len).q;
    // the envelope divide, once for each sample of the span (each is read by
    // N / hop frames), zero outside [0, out_len)
#pragma unroll 4
    for (int e = threadIdx.x; e < count; e += 32 * ADJ_WARPS) {
      const int idx = idx0 + e;
      sig[e] = idx >= 0 && idx < out_len ? sig[e] / envs[e] : 0.f;
    }
    consumer_sync();
    const int n_groups = (nc + per_warp - 1) / per_warp;
    for (int gi = (warp - groups % ADJ_WARPS + ADJ_WARPS) % ADJ_WARPS; gi < n_groups;
         gi += ADJ_WARPS) {
      // pack: z[m] = u[2m] + i u[2m+1], u = (g / env) * window
      const int g0 = gi * per_warp, fl = g0 + lf;
      float2 v[ADJ_POINTS];
      if constexpr (per_warp >= 4) {
        // several frames a warp lie hop apart in the slot, on the same banks:
        // read the group's rows lane by lane into the exchange slice first
        pack_rows<M>(xw, sig + g0 * hop, win, hop, nc - g0, lane);
#pragma unroll
        for (int p = 0; p < ADJ_POINTS; ++p) v[p] = xf[pad16(jl) + reg_offset<lanes>(p)];
        __syncwarp();
      } else {
        const float* sg = sig + fl * hop + 2 * jl;
        const float* wn = win + 2 * jl;
#pragma unroll
        for (int p = 0; p < ADJ_POINTS; ++p)
          v[p] = fl < nc ? make_float2(sg[2 * lanes * p] * wn[2 * lanes * p],
                                       sg[2 * lanes * p + 1] * wn[2 * lanes * p + 1])
                         : make_float2(0.f, 0.f);
      }
      fft_passes<1, M>(v, xf, jl, circ, c);

      // unpack: lane jl of frame lf takes k = jl + lanes r, r < 8 (so k <
      // M/2), and makes bins k and M - k from Z[k] and Z[M - k]; with
      // w = e^{-2 pi i k/N} (d) = (p, q):
      //   G[k] = (sum.x + q, sum.y - p),  G[M-k] = (sum.x - q, -sum.y - p),
      // since e^{-2 pi i (M-k)/N} = -conj w; k = 0 gives DC and Nyquist, and
      // lane 0 of the frame also makes bin M/2
      float2 lo_bins[ADJ_POINTS / 2 + 1], hi_bins[ADJ_POINTS / 2];
      const float2* zk = xf + pad16(jl);
#pragma unroll
      for (int r = 0; r <= ADJ_POINTS / 2; ++r) {
        const int k = r < ADJ_POINTS / 2 ? jl + lanes * r : M / 2;
        const float2 a = r < ADJ_POINTS / 2 ? zk[reg_offset<lanes>(r)] : xf[pad16(M / 2)];
        const float2 zc = xf[pad16((M - k) & (M - 1))];
        if (r < ADJ_POINTS / 2 && k == 0) {
          lo_bins[r] = make_float2(a.x + a.y, 0.f);
          hi_bins[r] = make_float2(a.x - a.y, 0.f);
          continue;
        }
        const float2 cc = make_float2(zc.x, -zc.y);  // conj Z[M - k]
        const float2 sum = a + cc;
        const float2 wd = cmul_conj(a - cc, tw[k]);  // e^{-2 pi i k/N} d
        lo_bins[r] = make_float2(sum.x + wd.y, sum.y - wd.x);
        if (r < ADJ_POINTS / 2) hi_bins[r] = make_float2(sum.x - wd.y, -sum.y - wd.x);
      }
      // the group's frames lie back to back in `out`
      float2* dst = out + ((size_t)b * t_f + f0 + g0) * (M + 1);
      if constexpr (per_warp >= 4) {
        // a frame's run of bins is short: lay the group's bins out in the
        // slice in their order in `out`, then store them 256 bytes a warp
        __syncwarp();
        float2* xo = xw + lf * (M + 1);
#pragma unroll
        for (int r = 0; r < ADJ_POINTS / 2; ++r) {
          const int k = jl + lanes * r;
          xo[k] = lo_bins[r];
          xo[k ? M - k : M] = hi_bins[r];
        }
        if (jl == 0) xo[M / 2] = lo_bins[ADJ_POINTS / 2];
        __syncwarp();
        const int n_out = min(per_warp, nc - g0) * (M + 1);
#pragma unroll
        for (int r = 0; r < per_warp * (M + 1) / 32 + 1; ++r)
          if (lane + 32 * r < n_out) __stcs(dst + lane + 32 * r, xw[lane + 32 * r]);
      } else if (fl < nc) {
        float2* d = dst + lf * (M + 1);
#pragma unroll
        for (int r = 0; r < ADJ_POINTS / 2; ++r) {
          const int k = jl + lanes * r;
          __stcs(d + k, lo_bins[r]);
          __stcs(d + (k ? M - k : M), hi_bins[r]);
        }
        if (jl == 0) __stcs(d + M / 2, lo_bins[ADJ_POINTS / 2]);
      }
      __syncwarp();  // the next group's first pass overwrites the slice
    }
    groups += n_groups;
    // this thread is done with the slot; its writes there (the divide) come
    // before the next bulk copy into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(empty + slot);
  }
}

template <int LOG2M>
cudaError_t launch_adjoint(const float* grad, const float* tables, const float* env, float* out,
                           int blocks, int smem_bytes, cudaStream_t stream, int t_f, int log2hop,
                           int length, int out_len, int tiles, int frames_per_tile, int items,
                           int stages, int stage_floats) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fused_istft_adjoint_kernel<LOG2M>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem_bytes);
    if (err != cudaSuccess) return err;
  }
  fused_istft_adjoint_kernel<LOG2M><<<(unsigned)blocks, ADJ_THREADS, smem_bytes, stream>>>(
      grad, tables, env, reinterpret_cast<float2*>(out), t_f, log2hop, length, out_len, tiles,
      frames_per_tile, items, stages, stage_floats);
  return cudaGetLastError();
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

// grad: (batch, length) float32, 4-byte aligned. tables, env: as above.
// out: (batch, t_f, n_fft/2 + 1) complex64 viewed as interleaved float32.
// frames_per_tile, blocks, stages, stage_floats, smem_bytes: ops/fused_istft.py
// `adjoint_plan` (the layout at the top of the kernel). Launches on
// `stream`; returns a cudaError_t.
extern "C" int fused_istft_adjoint_launch(const float* grad, const float* tables,
                                          const float* env, float* out, int batch, int t_f,
                                          int n_fft, int hop, int length, int frames_per_tile,
                                          int blocks, int stages, int stage_floats,
                                          int smem_bytes, void* stream) {
  const int log2n = log2_exact(n_fft), log2hop = log2_exact(hop);
  if (log2n < 6 || log2n > 10 || log2hop < 0 || hop > n_fft || frames_per_tile < 1 ||
      blocks < 1 || stages < 2 || stages > ADJ_MAX_STAGES || batch < 1 || t_f < 1 ||
      stage_floats % 4 != 0 ||
      (long long)stage_floats < (long long)(frames_per_tile - 1) * hop + n_fft + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel indexes the waveform and the spans in 32-bit ints
  if ((long long)t_f * hop + n_fft > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long layout = 8LL * 2 * ADJ_MAX_STAGES + 12LL * n_fft +
                           8LL * ADJ_WARPS * ADJ_EXCHANGE + 8LL * stages * stage_floats;
  if (smem_bytes != layout || smem_bytes > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (t_f + frames_per_tile - 1) / frames_per_tile;
  const long long items = (long long)batch * tiles;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const long long default_len = (long long)(t_f - 1) * hop;
  const int out_len = length < default_len ? length : static_cast<int>(default_len);
  using Launch = decltype(&launch_adjoint<5>);
  constexpr Launch by_log2m[] = {launch_adjoint<5>, launch_adjoint<6>, launch_adjoint<7>,
                                 launch_adjoint<8>, launch_adjoint<9>};
  return static_cast<int>(by_log2m[log2n - 6](
      grad, tables, env, out, blocks, smem_bytes, static_cast<cudaStream_t>(stream), t_f, log2hop,
      length, out_len, tiles, frames_per_tile, static_cast<int>(items), stages, stage_floats));
}
