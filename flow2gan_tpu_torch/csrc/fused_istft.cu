// Fused iSTFT for Hopper (sm_90a): complex spectrogram -> waveform in one
// launch, with the frames never written to device memory.
//
// Replaces the Pallas TPU kernel `_istft_kernel` / `_istft_pallas_impl` in
// flow2gan_tpu/ops/pallas_istft.py. Computes, for each batch row b,
//
//   out[b, n] = ola[b, n + n_fft/2] / env[n]     for n < out_len
//   out[b, n] = 0                                for out_len <= n < length
//
// where ola is the overlap-add of the frames Re @ Aw + Im @ Bw (Aw, Bw the
// onesided inverse-DFT matrices with the periodic Hann window folded in),
// env the precomputed squared-window envelope, and
// out_len = min(length, (T_f - 1) * hop).
//
// Design: output-stationary. With k = n_fft / hop, the OLA signal split into
// hop-wide rows is
//
//   ola_row[t] = sum_{j<k} spec[t-j] (2F interleaved re/im) @ W[j]     (hop)
//
// where W[j] (2F, hop) holds columns [j*hop, (j+1)*hop) of Aw and Bw with the
// rows interleaved to match view_as_real(spec). That is one GEMM with
// M = output hop-rows, N = hop and K = k * 2F, whose A operand is the
// spectrogram read at k row shifts. Each block owns a BM x BN tile of output
// rows and columns and sums all k shifts itself: no halo between tiles, no
// atomics, so the result is deterministic. The centre trim, the envelope
// divide and the zero pad to `length` happen in the store.
//
// What bounds it on this card: the matmul formulation does 2 * B * T_f * 2F *
// n_fft FLOP against B * T_f * F * 8 + B * length * 4 bytes, about 140 FLOP
// per byte at (512, 256), so with float32 accumulation on the CUDA cores
// (no TF32, to stay near 1e-6 of the float32 reference) the kernel is bound
// by operations, not bytes. The design keeps the operations dense: a
// register-blocked 4x8 outer product per thread from a cp.async pipeline of
// shared-memory tiles, with the frames, the overlap-add partial sums and the
// untrimmed signal all staying on chip.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;      // output hop-rows per block (batch rows flattened)
constexpr int BN = 64;      // output columns (offsets within a hop) per block
constexpr int BK = 8;       // reduction slice per pipeline stage
constexpr int STAGES = 3;   // slices in flight between device memory and compute
constexpr int KSPLIT = 4;   // thread groups of a block that share out the K slices
constexpr int TX = BN / 8, TY = BM / 4;  // threads of a group, each 4 rows x 8 columns
constexpr int GROUP = TX * TY;           // 64
constexpr int THREADS = KSPLIT * GROUP;  // 256
constexpr int A_PER = BM * BK / GROUP;        // A-tile floats each thread copies
constexpr int W_PER = BK * BN / 4 / GROUP;    // W-tile float4s each thread copies
constexpr int APAD = 4;  // keeps the transposed A tile 16-byte aligned
constexpr int A_TILE = BK * (BM + APAD), W_TILE = BK * BN;  // floats per stage
constexpr int SMEM_FLOATS = KSPLIT * STAGES * (A_TILE + W_TILE);
static_assert(SMEM_FLOATS >= (KSPLIT - 1) * BM * BN, "partial tiles reuse the ring");

// Asynchronous copies into shared memory; an invalid source is read as zero
// bytes, which zero-fills the destination.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Rows of all batch entries are flattened into one M dimension of
// batch * rows output hop-rows, so small batches and short clips still give
// the grid enough blocks. The K loop runs over (j, 2F) in BK slices: the
// block's KSPLIT thread groups take turns at the slices (the problem has few
// output tiles and a long K, so this multiplies the warps in flight), each
// keeping STAGES slices in a ring of shared-memory buffers filled by
// cp.async. A thread's 8 columns are two runs of 4, 32 apart, so a warp's
// 16-byte shared-memory reads have no bank conflicts. The groups' partial
// tiles are summed in a fixed order at the end.
__global__ void __launch_bounds__(THREADS)
fused_istft_kernel(const float* __restrict__ spec,  // (B, T_f, 2F)
                   const float* __restrict__ w,     // (k, 2F, w_stride)
                   const float* __restrict__ env,   // (out_len,) at least
                   float* __restrict__ out,         // (B, length)
                   int t_f, int two_f, int hop, int w_stride, int k, int half,
                   int length, int out_len, int t_lo, int rows, int total_rows) {
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  const int g = threadIdx.x / GROUP;  // this thread's K group
  const int tid = threadIdx.x % GROUP;
  const int tx = tid % TX, ty = tid / TX;
  const int grow0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int kk_a = tid % BK;  // the A column this thread copies (GROUP % BK == 0)
  // this group's ring: As[stage][kk][row], then Ws[stage][kk][col]
  float* as = smem + g * STAGES * A_TILE;
  float* ws = smem + KSPLIT * STAGES * A_TILE + g * STAGES * W_TILE;

  // the rows this thread copies into the A tile: offset of its batch entry
  // and its hop-row t (a row past the end gets a t that matches no frame)
  size_t a_off[A_PER];
  int a_t[A_PER];
#pragma unroll
  for (int s = 0; s < A_PER; ++s) {
    const int gr = grow0 + (tid + s * GROUP) / BK;
    a_off[s] = gr < total_rows ? (size_t)(gr / rows) * t_f * two_f : 0;
    a_t[s] = gr < total_rows ? t_lo + gr % rows : -(1 << 30);
  }

  const int k_slices = (two_f + BK - 1) / BK;
  const int n_steps = k * k_slices;                     // K slices in all
  const int n_iters = (n_steps + KSPLIT - 1) / KSPLIT;  // slices per group

  // copy slice `step` into this group's ring at `stage`
  auto issue = [&](int step, int stage) {
    const int j = step / k_slices, k0 = (step % k_slices) * BK;
    const int q = k0 + kk_a;
#pragma unroll
    for (int s = 0; s < A_PER; ++s) {
      const int f = a_t[s] - j;
      const bool ok = f >= 0 && f < t_f && q < two_f;
      cp_async4(as + stage * A_TILE + kk_a * (BM + APAD) + (tid + s * GROUP) / BK,
                ok ? spec + a_off[s] + (size_t)f * two_f + q : spec, ok);
    }
    const float* wj = w + (size_t)j * two_f * w_stride;
#pragma unroll
    for (int s = 0; s < W_PER; ++s) {
      const int i = (tid + s * GROUP) * 4;  // first of 4 columns
      const int qw = k0 + i / BN, col = col0 + i % BN;
      const bool ok = qw < two_f && col < w_stride;
      cp_async16(ws + stage * W_TILE + i, ok ? wj + (size_t)qw * w_stride + col : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s * KSPLIT + g < n_steps) issue(s * KSPLIT + g, s);
    cp_async_commit();
  }

  float acc[4][8] = {};
  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice `it` have landed
    __syncthreads();              // everyone's have, and slice `it - 1` is consumed
    const int next = (it + STAGES - 1) * KSPLIT + g;
    if (next < n_steps) issue(next, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    if (it * KSPLIT + g >= n_steps) continue;
    const float* a_s = as + (it % STAGES) * A_TILE + ty * 4;
    const float* w_s = ws + (it % STAGES) * W_TILE + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(a_s + kk * (BM + APAD));
      const float4 c0 = *reinterpret_cast<const float4*>(w_s + kk * BN);
      const float4 c1 = *reinterpret_cast<const float4*>(w_s + kk * BN + 32);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], cv[n], acc[m][n]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // groups 1.. hand their partial tiles to group 0 through the ring
  if (g > 0) {
    float* part = smem + (g - 1) * BM * BN;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(&part[(ty * 4 + m) * BN + tx * 4 + 32 * h]) =
            make_float4(acc[m][4 * h], acc[m][4 * h + 1], acc[m][4 * h + 2], acc[m][4 * h + 3]);
  }
  __syncthreads();
  if (g > 0) return;
#pragma unroll
  for (int other = 0; other < KSPLIT - 1; ++other)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 p = *reinterpret_cast<const float4*>(
            &smem[other * BM * BN + (ty * 4 + m) * BN + tx * 4 + 32 * h]);
        acc[m][4 * h] += p.x;
        acc[m][4 * h + 1] += p.y;
        acc[m][4 * h + 2] += p.z;
        acc[m][4 * h + 3] += p.w;
      }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int gr = grow0 + ty * 4 + m;
    if (gr >= total_rows) continue;
    float* out_b = out + (size_t)(gr / rows) * length;
    const long long t = t_lo + gr % rows;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = col0 + tx * 4 + (n % 4) + 32 * (n / 4);
      if (c >= hop) continue;
      const long long idx = t * hop + c - half;  // index into the trimmed output
      if (idx < 0 || idx >= length) continue;
      out_b[idx] = idx < out_len ? acc[m][n] / env[idx] : 0.f;
    }
  }
}

}  // namespace

// spec: (batch, t_f, n_freq) complex64 viewed as interleaved float32.
// w: (n_fft / hop, 2 * n_freq, hop rounded up to a multiple of 4, zero-padded).
// env: ((t_f - 1) * hop,). out: (batch, length).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_istft_launch(const float* spec, const float* w,
                                  const float* env, float* out, int batch,
                                  int t_f, int n_freq, int n_fft, int hop,
                                  int length, void* stream) {
  const int k = n_fft / hop;
  const int half = n_fft / 2;
  const int default_len = (t_f - 1) * hop;
  const int out_len = length < default_len ? length : default_len;
  // output sample idx sits at OLA position idx + half, in hop-row (idx + half) / hop
  const int t_lo = half / hop;
  const int t_hi = (half + length - 1) / hop;
  const int rows = t_hi - t_lo + 1;
  const int total_rows = batch * rows;
  const int w_stride = (hop + 3) / 4 * 4;
  dim3 grid((total_rows + BM - 1) / BM, (hop + BN - 1) / BN);
  fused_istft_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      spec, w, env, out, t_f, 2 * n_freq, hop, w_stride, k, half, length, out_len,
      t_lo, rows, total_rows);
  return static_cast<int>(cudaGetLastError());
}
