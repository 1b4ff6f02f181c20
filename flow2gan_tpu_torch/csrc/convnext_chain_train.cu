// The train form of a ConvNeXt block's elementwise chain (models/convnext.py
// `ConvNeXtBlock`, run through ops/convnext_chain_train.py `TrainChain`), on
// channels-last (B, T, C) float32. Forward, around cuBLAS's pwconv1 and
// pwconv2 and beside convnext_chain.cu's `convnext_norm_film` and
// `scaled_residual`:
//
//   convnext_prelu_fwd:   p = h1 >= 0 ? h1 : alpha * h1, out of place, so
//                         that the pre-activation h1 is kept for backward
//
// and in backward, around the four GEMMs of pwconv1's and pwconv2's
// gradients:
//
//   convnext_prelu_bwd:      dh1 = dp * (h1 >= 0 ? 1 : alpha), in place in
//                            dp; p recomputed from h1 for pwconv2's weight
//                            GEMM; column partials of dalpha and pwconv1's
//                            bias
//   convnext_norm_film_bwd:  from x (the 7-tap conv recomputed over a window
//                            of rows) and dy = pwconv1's input gradient: the
//                            row's BiasNorm statistics, dz (the gradient of
//                            the depthwise conv's output), dc at the cond's
//                            own rate, partials of the norm's bias and
//                            log-scale and of dte
//   convnext_dwconv_bwd:     dx = conv^T(dz) * mask + scale * g (g: the
//                            block's output gradient), partials of the
//                            depthwise weight and bias, the residual scale
//                            and pwconv2's bias
//
// It replaces no Pallas kernel: on the TPU, XLA fused this chain and
// differentiated it (flow2gan_tpu/models/convnext.py:52-117). In eager
// PyTorch autograd ran each op's backward, about 400 aten ops a block, and
// kept about 12.8 N floats of activations for it (N = B * T * C); the
// Function keeps x, y and h1, 5 N.
//
// What bounds it on this card: bytes. Each kernel does a few operations per
// float it moves. convnext_prelu_fwd reads h1 and writes p (6 N);
// convnext_prelu_bwd reads dp and h1 and writes dh1 and p (12 N);
// convnext_norm_film_bwd reads x, dy and the cond and writes dz and dc
// (about 3 N + 2 N / f); convnext_dwconv_bwd reads dz, x and g and writes dx
// (4 N). The depthwise conv's gradient is split from the norm's (dz is
// written and read again, 2 N) because one pass would hold two 7-row windows
// and the 7-tap weight gradient in registers at once, and the norm's row
// statistics need the whole row in one block.
//
// The two conv kernels walk along time: a thread owns one float4 of
// channels of one batch entry over a segment of rows (ops/
// convnext_chain_train.py `segment_plan`), and keeps the conv's 7-row
// window in registers, so each row of x and dz is read from memory once
// and the segments' 6-row halos again. In convnext_norm_film_bwd a block
// holds a whole row (C / 4 threads): the row's two sums (of (z - bias)^2
// and of dn * z) are one block reduction a row, one barrier. In
// convnext_dwconv_bwd the threads are independent; a block of 8 warps sums
// its warps' weight partials before it writes them.
//
// Partials: each block writes its own row of partial sums, which the
// wrapper adds up in float64 (torch's reductions, a fixed order for a fixed
// shape). Every kernel launches on the caller's stream, allocates nothing
// and uses no atomics: a step repeats bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int TAPS = 7;  // the configurations' depthwise kernel size
constexpr int LEFT = (TAPS - 1) / 2;
constexpr int STREAM_THREADS = 256;
constexpr int ROW_THREADS = 256;  // convnext_norm_film_bwd: C / 4 threads, C up to 1024
constexpr int CONV_WARPS = 8;     // convnext_dwconv_bwd: segments a block
constexpr int CONV_SUMS = 4 * TAPS + 12;  // dw, dw bias, scale, pwconv2 bias a thread

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float prelu1(float h, float a) { return h >= 0.f ? h : a * h; }

// h, p: n4 float4 each; alpha: h4 float4 (the channels of a row).
template <int U>
__global__ void __launch_bounds__(STREAM_THREADS) convnext_prelu_fwd_kernel(
    const float4* __restrict__ h, const float4* __restrict__ alpha, float4* __restrict__ p, int n4,
    int h4) {
  const int base = blockIdx.x * STREAM_THREADS * U + threadIdx.x;
  float4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * STREAM_THREADS;
    if (i < n4) v[u] = __ldg(h + i);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = base + u * STREAM_THREADS;
    if (i < n4) {
      const float4 a = __ldg(alpha + i % h4);
      p[i] = make_float4(prelu1(v[u].x, a.x), prelu1(v[u].y, a.y), prelu1(v[u].z, a.z),
                         prelu1(v[u].w, a.w));
    }
  }
}

// One channel of convnext_prelu_bwd: g the gradient of p in, dh1's out.
__device__ __forceinline__ void prelu_grad1(float& g, float h, float a, float& p, float& da,
                                            float& db) {
  const bool pos = h >= 0.f;
  if (!pos) da += g * h;
  p = pos ? h : a * h;
  g = pos ? g : a * g;
  db += g;
}

// dp, h1, p: (rows, h4) float4; dp in: the gradient of p; out: dh1's.
// partials: (chunks, 2 * h4) float4, a chunk's [dalpha | pwconv1 bias].
// gridDim.x = chunks; blockDim.x = h4 rounded up to a warp: thread q owns
// float4 column q over the chunk's rows.
template <int U>
__global__ void __launch_bounds__(1024) convnext_prelu_bwd_kernel(
    float4* __restrict__ dp, const float4* __restrict__ h1, const float4* __restrict__ alpha,
    float4* __restrict__ p, float4* __restrict__ partials, int rows, int h4, int chunk_rows) {
  const int q = threadIdx.x;
  if (q >= h4) return;  // no barrier follows
  const int r0 = blockIdx.x * chunk_rows;
  const int r1 = min(rows, r0 + chunk_rows);
  const float4 a = __ldg(alpha + q);
  float4 da = zero4(), db = zero4();
  int r = r0;
  for (; r + U <= r1; r += U) {
    float4 g[U], h[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = (size_t)(r + u) * h4 + q;
      g[u] = dp[i];
      h[u] = __ldg(h1 + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = (size_t)(r + u) * h4 + q;
      float4 pv;
      prelu_grad1(g[u].x, h[u].x, a.x, pv.x, da.x, db.x);
      prelu_grad1(g[u].y, h[u].y, a.y, pv.y, da.y, db.y);
      prelu_grad1(g[u].z, h[u].z, a.z, pv.z, da.z, db.z);
      prelu_grad1(g[u].w, h[u].w, a.w, pv.w, da.w, db.w);
      dp[i] = g[u];
      p[i] = pv;
    }
  }
  for (; r < r1; ++r) {
    const size_t i = (size_t)r * h4 + q;
    float4 g = dp[i], pv;
    const float4 h = __ldg(h1 + i);
    prelu_grad1(g.x, h.x, a.x, pv.x, da.x, db.x);
    prelu_grad1(g.y, h.y, a.y, pv.y, da.y, db.y);
    prelu_grad1(g.z, h.z, a.z, pv.z, da.z, db.z);
    prelu_grad1(g.w, h.w, a.w, pv.w, da.w, db.w);
    dp[i] = g;
    p[i] = pv;
  }
  partials[(size_t)blockIdx.x * 2 * h4 + q] = da;
  partials[(size_t)blockIdx.x * 2 * h4 + h4 + q] = db;
}

// The depthwise taps of channels 4q .. 4q + 3 from (C, K) as they lie:
// channel 4q + s's taps are w[s * K .. s * K + K - 1].
__device__ __forceinline__ void load_taps(const float* dw_w, int q, float* w) {
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    const float4 v = ldg4(dw_w + (size_t)q * 4 * TAPS + 4 * i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Row t's float4 q of x * mask for batch entry xb / mb; 0 outside [0, T).
__device__ __forceinline__ float4 masked_row(const float* xb, const float* mb, int t, int T, int C,
                                             int q) {
  if (t < 0 || t >= T) return zero4();
  const float4 v = ldg4(xb + (size_t)t * C + 4 * q);
  return mb == nullptr ? v : scale4(v, __ldg(mb + t));
}

// x, dy, dz: (B, T, C); mask: (B, T) or null; dw_w: (C, K); dw_b, norm_b:
// (C,); log_scale: one float; c, dc: (B, t_c, C) and te: (B, C), with COND;
// part_rows: (B * segs, C + 4), a block's [dnorm_b | dlog_scale, 0, 0, 0];
// part_te: (segs, B, C), with COND. gridDim.x = B * segs (block: batch
// entry b, segment seg, rows [seg * seg_rows, + seg_rows) within T,
// seg_rows a multiple of f); blockDim.x = C / 4 rounded up to a warp.
template <bool COND>
__global__ void __launch_bounds__(ROW_THREADS) convnext_norm_film_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ mask, const float* __restrict__ dw_w,
    const float* __restrict__ dw_b, const float* __restrict__ norm_b,
    const float* __restrict__ log_scale, const float* __restrict__ c, const float* __restrict__ te,
    const float* __restrict__ dy, float* __restrict__ dz, float* __restrict__ dc,
    float* __restrict__ part_rows, float* __restrict__ part_te, int batch, int T, int C, int f,
    int t_c, int segs, int seg_rows) {
  __shared__ float2 red[2][ROW_THREADS / WARP];
  const int b = blockIdx.x / segs, seg = blockIdx.x - b * segs;
  const int q = threadIdx.x, lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int warps = blockDim.x / WARP;
  // a thread past the row's channels takes part in the block's sums with 0
  const bool active = q < C / 4;
  const float e = expf(__ldg(log_scale));
  const float cf = static_cast<float>(C);
  float w[4 * TAPS];
  float4 bias = zero4(), nb = zero4(), te1 = make_float4(1.f, 1.f, 1.f, 1.f);
  if (active) {
    load_taps(dw_w, q, w);
    bias = ldg4(dw_b + 4 * q);
    nb = ldg4(norm_b + 4 * q);
    if (COND) te1 = add4(te1, ldg4(te + ((size_t)b * C) + 4 * q));
  }
  const int t_begin = seg * seg_rows, t_end = min(T, t_begin + seg_rows);
  const float* xb = x + (size_t)b * T * C;
  const float* mb = mask == nullptr ? nullptr : mask + (size_t)b * T;
  // win[k]: row t - LEFT + k of x * mask, the rows row t's taps read
  float4 win[TAPS];
#pragma unroll
  for (int k = 1; k < TAPS; ++k)
    win[k] = active ? masked_row(xb, mb, t_begin - LEFT + k - 1, T, C, q) : zero4();
  float4 dnb = zero4(), dte = zero4(), dcs = zero4();
  float dls = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
    for (int k = 0; k < TAPS - 1; ++k) win[k] = win[k + 1];
    float4 z = zero4(), dyv = zero4();
    if (active) {
      win[TAPS - 1] = masked_row(xb, mb, t + LEFT, T, C, q);
      dyv = ldg4(dy + ((size_t)b * T + t) * C + 4 * q);
      // the conv as the forward kernel sums it: the taps in order, then the bias
      float4 acc = zero4();
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        acc.x = fmaf(w[k], win[k].x, acc.x);
        acc.y = fmaf(w[TAPS + k], win[k].y, acc.y);
        acc.z = fmaf(w[2 * TAPS + k], win[k].z, acc.z);
        acc.w = fmaf(w[3 * TAPS + k], win[k].w, acc.w);
      }
      z = add4(acc, bias);
    }
    const float4 d = make_float4(z.x - nb.x, z.y - nb.y, z.z - nb.z, z.w - nb.w);
    const float4 dn = COND ? mul4(dyv, te1) : dyv;  // the gradient of the norm's output
    float ss = d.x * d.x + d.y * d.y + d.z * d.z + d.w * d.w;
    float ds = dn.x * z.x + dn.y * z.y + dn.z * z.z + dn.w * z.w;
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      ds += __shfl_xor_sync(0xffffffffu, ds, o);
    }
    // two slots: a warp writes row t + 1's sums while another still reads row t's
    const int slot = t & 1;
    if (lane == 0) red[slot][warp] = make_float2(ss, ds);
    __syncthreads();
    ss = 0.f;
    ds = 0.f;
    for (int i = 0; i < warps; ++i) {
      const float2 v = red[slot][i];
      ss += v.x;
      ds += v.y;
    }
    const float r = rsqrtf(ss / cf);
    const float s = r * e;  // the row's scale, as the forward kernel forms it
    // d(norm)/dz: dn * s - (ds * e * r^3 / C) * (z - norm_b)
    const float coef = ds * s * r * r / cf;
    dls += ds * s;
    if (active) {
      const float4 g = make_float4(fmaf(-coef, d.x, dn.x * s), fmaf(-coef, d.y, dn.y * s),
                                   fmaf(-coef, d.z, dn.z * s), fmaf(-coef, d.w, dn.w * s));
      *reinterpret_cast<float4*>(dz + ((size_t)b * T + t) * C + 4 * q) = g;
      dnb = add4(dnb, scale4(d, coef));
      if (COND) {
        const float4 cv = ldg4(c + ((size_t)b * t_c + t / f) * C + 4 * q);
        const float4 u = add4(scale4(z, s), cv);  // the FiLM's input
        dte = add4(dte, mul4(dyv, u));
        dcs = add4(dcs, dn);
        if ((t + 1) % f == 0 || t + 1 == T) {  // the last row of cond row t / f
          *reinterpret_cast<float4*>(dc + ((size_t)b * t_c + t / f) * C + 4 * q) = dcs;
          dcs = zero4();
        }
      }
    }
  }
  float* row = part_rows + (size_t)blockIdx.x * (C + 4);
  if (active) {
    *reinterpret_cast<float4*>(row + 4 * q) = dnb;
    if (COND)
      *reinterpret_cast<float4*>(part_te + ((size_t)seg * batch + b) * C + 4 * q) = dte;
  }
  if (threadIdx.x == 0) *reinterpret_cast<float4*>(row + C) = make_float4(dls, 0.f, 0.f, 0.f);
}

// dz, x, g, dx: (B, T, C); mask: (B, T) or null; dw_w: (C, K); scale: (C,)
// or null for 1; partials: (gridDim.y, C * (K + 3)), a block row's
// [dw_w as (C, K) | dw_b | scale | pwconv2 bias]. gridDim = (ceil(C / 128),
// ceil(B * segs / 8)); blockDim = (32, 8): lane l of warp y owns float4
// column 32 * blockIdx.x + l of the (batch entry, segment) pair
// 8 * blockIdx.y + y, rows as in convnext_norm_film_bwd.
__global__ void __launch_bounds__(WARP * CONV_WARPS, 2) convnext_dwconv_bwd_kernel(
    const float* __restrict__ dz, const float* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ dw_w, const float* __restrict__ g, const float* __restrict__ scale,
    float* __restrict__ dx, float* __restrict__ partials, int batch, int T, int C, int segs,
    int seg_rows) {
  __shared__ float red[CONV_WARPS][WARP][CONV_SUMS + 1];  // +1: no bank conflicts
  const int q = blockIdx.x * WARP + threadIdx.x;
  const int pair = blockIdx.y * CONV_WARPS + threadIdx.y;
  const bool active = q < C / 4 && pair < batch * segs;
  float dw[4 * TAPS];
#pragma unroll
  for (int i = 0; i < 4 * TAPS; ++i) dw[i] = 0.f;
  float4 dbias = zero4(), dscale = zero4(), db2 = zero4();
  if (active) {
    float w[4 * TAPS];
    load_taps(dw_w, q, w);
    const float4 sc = scale == nullptr ? make_float4(1.f, 1.f, 1.f, 1.f) : ldg4(scale + 4 * q);
    const int b = pair / segs, seg = pair - b * segs;
    const int t_begin = seg * seg_rows, t_end = min(T, t_begin + seg_rows);
    const size_t base = (size_t)b * T * C + 4 * q;
    const float* mb = mask == nullptr ? nullptr : mask + (size_t)b * T;
    // zw[k]: row s - LEFT + k of dz. Row s of x * mask meets dz of rows
    // s + LEFT - k through tap k, both in the input's gradient and in the
    // weight's, so one window serves both
    float4 zw[TAPS];
#pragma unroll
    for (int k = 1; k < TAPS; ++k) {
      const int t = t_begin - LEFT + k - 1;
      zw[k] = t >= 0 && t < T ? ldg4(dz + base + (size_t)t * C) : zero4();
    }
    for (int s = t_begin; s < t_end; ++s) {
#pragma unroll
      for (int k = 0; k < TAPS - 1; ++k) zw[k] = zw[k + 1];
      zw[TAPS - 1] = s + LEFT < T ? ldg4(dz + base + (size_t)(s + LEFT) * C) : zero4();
      const float4 gv = ldg4(g + base + (size_t)s * C);
      const float4 xs = ldg4(x + base + (size_t)s * C);  // the residual's x, unmasked
      const float m = mb == nullptr ? 1.f : __ldg(mb + s);
      const float4 xm = scale4(xs, m);
      float4 acc = zero4();
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const float4 v = zw[TAPS - 1 - k];
        acc.x = fmaf(w[k], v.x, acc.x);
        acc.y = fmaf(w[TAPS + k], v.y, acc.y);
        acc.z = fmaf(w[2 * TAPS + k], v.z, acc.z);
        acc.w = fmaf(w[3 * TAPS + k], v.w, acc.w);
        dw[k] = fmaf(xm.x, v.x, dw[k]);
        dw[TAPS + k] = fmaf(xm.y, v.y, dw[TAPS + k]);
        dw[2 * TAPS + k] = fmaf(xm.z, v.z, dw[2 * TAPS + k]);
        dw[3 * TAPS + k] = fmaf(xm.w, v.w, dw[3 * TAPS + k]);
      }
      const float4 out = make_float4(fmaf(acc.x, m, gv.x * sc.x), fmaf(acc.y, m, gv.y * sc.y),
                                     fmaf(acc.z, m, gv.z * sc.z), fmaf(acc.w, m, gv.w * sc.w));
      *reinterpret_cast<float4*>(dx + base + (size_t)s * C) = out;
      dbias = add4(dbias, zw[LEFT]);
      dscale = add4(dscale, mul4(gv, xs));
      db2 = add4(db2, gv);
    }
  }
  // the block's 8 warps summed in order, then one row of partials
  float* mine = red[threadIdx.y][threadIdx.x];
#pragma unroll
  for (int i = 0; i < 4 * TAPS; ++i) mine[i] = dw[i];
  const float4 rest[3] = {dbias, dscale, db2};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    mine[4 * TAPS + 4 * j] = rest[j].x;
    mine[4 * TAPS + 4 * j + 1] = rest[j].y;
    mine[4 * TAPS + 4 * j + 2] = rest[j].z;
    mine[4 * TAPS + 4 * j + 3] = rest[j].w;
  }
  __syncthreads();
  if (threadIdx.y != 0 || q >= C / 4) return;  // no barrier follows
  float sum[CONV_SUMS];
#pragma unroll
  for (int i = 0; i < CONV_SUMS; ++i) sum[i] = red[0][threadIdx.x][i];
  for (int y = 1; y < CONV_WARPS; ++y) {
#pragma unroll
    for (int i = 0; i < CONV_SUMS; ++i) sum[i] += red[y][threadIdx.x][i];
  }
  float* row = partials + (size_t)blockIdx.y * C * (TAPS + 3);
#pragma unroll
  for (int i = 0; i < TAPS; ++i)
    *reinterpret_cast<float4*>(row + (size_t)q * 4 * TAPS + 4 * i) =
        make_float4(sum[4 * i], sum[4 * i + 1], sum[4 * i + 2], sum[4 * i + 3]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    *reinterpret_cast<float4*>(row + (size_t)(TAPS + j) * C + 4 * q) =
        make_float4(sum[4 * TAPS + 4 * j], sum[4 * TAPS + 4 * j + 1], sum[4 * TAPS + 4 * j + 2],
                    sum[4 * TAPS + 4 * j + 3]);
}

bool bad_rows(int n, int width) { return n < 1 || width < 4 || width % 4 != 0 || n % width != 0; }

}  // namespace

// All pointers 16-byte aligned, all tensors contiguous float32 (the wrapper
// checks). Each launcher returns a cudaError_t.

// h, p: n floats, rows of `width` channels; alpha: (width,). unroll: 1 or 4
// float4 a thread (ops/convnext_chain.py `stream_unroll`).
extern "C" int convnext_prelu_fwd_launch(const float* h, const float* alpha, float* p, int n,
                                         int width, int unroll, void* stream) {
  if (bad_rows(n, width) || (unroll != 1 && unroll != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n4 = n / 4, per_block = STREAM_THREADS * unroll;
  const unsigned blocks = (unsigned)((n4 + per_block - 1) / per_block);
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* a4 = reinterpret_cast<const float4*>(alpha);
  float4* p4 = reinterpret_cast<float4*>(p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unroll == 4)
    convnext_prelu_fwd_kernel<4><<<blocks, STREAM_THREADS, 0, s>>>(h4, a4, p4, n4, width / 4);
  else
    convnext_prelu_fwd_kernel<1><<<blocks, STREAM_THREADS, 0, s>>>(h4, a4, p4, n4, width / 4);
  return static_cast<int>(cudaGetLastError());
}

// dp (in place), h1, p: (rows, width); alpha: (width,); partials:
// (chunks, 2 * width); chunk_rows: rows a block (ops/convnext_chain_train.py
// `prelu_bwd_plan`), chunks * chunk_rows >= rows.
extern "C" int convnext_prelu_bwd_launch(float* dp, const float* h1, const float* alpha, float* p,
                                         float* partials, int rows, int width, int chunks,
                                         int chunk_rows, void* stream) {
  if (rows < 1 || width < 4 || width % 4 != 0 || width > 4 * 1024 || chunks < 1 ||
      chunk_rows < 1 || (long long)chunks * chunk_rows < rows ||
      (long long)(chunks - 1) * chunk_rows >= rows || (long long)rows * width > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h4 = width / 4;
  const int threads = (h4 + WARP - 1) / WARP * WARP;
  convnext_prelu_bwd_kernel<4><<<(unsigned)chunks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(dp), reinterpret_cast<const float4*>(h1),
      reinterpret_cast<const float4*>(alpha), reinterpret_cast<float4*>(p),
      reinterpret_cast<float4*>(partials), rows, h4, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dz: (batch, frames, channels); mask: (batch, frames) or null; dw_w:
// (channels, k); dw_b, norm_b: (channels,); log_scale: one float; c, dc:
// (batch, t_c, channels) and te: (batch, channels), or all three null;
// part_rows: (batch * segs, channels + 4); part_te: (segs, batch, channels),
// null without c. segs, seg_rows: ops/convnext_chain_train.py
// `segment_plan` (seg_rows a multiple of f).
extern "C" int convnext_norm_film_bwd_launch(
    const float* x, const float* mask, const float* dw_w, const float* dw_b, const float* norm_b,
    const float* log_scale, const float* c, const float* te, const float* dy, float* dz, float* dc,
    float* part_rows, float* part_te, int batch, int frames, int channels, int k, int f, int t_c,
    int segs, int seg_rows, void* stream) {
  const bool cond = c != nullptr;
  if (batch < 1 || frames < 1 || channels < 4 || channels % 4 != 0 ||
      channels > 4 * ROW_THREADS || k != TAPS || f < 1 || segs < 1 || seg_rows < 1 ||
      seg_rows % f != 0 || (long long)segs * seg_rows < frames ||
      (long long)(segs - 1) * seg_rows >= frames || cond != (te != nullptr) ||
      cond != (dc != nullptr) || cond != (part_te != nullptr) ||
      (cond && (long long)t_c * f < frames) ||
      (long long)batch * frames * channels > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (channels / 4 + WARP - 1) / WARP * WARP;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)(batch * segs);
  if (cond)
    convnext_norm_film_bwd_kernel<true><<<blocks, threads, 0, s>>>(
        x, mask, dw_w, dw_b, norm_b, log_scale, c, te, dy, dz, dc, part_rows, part_te, batch,
        frames, channels, f, t_c, segs, seg_rows);
  else
    convnext_norm_film_bwd_kernel<false><<<blocks, threads, 0, s>>>(
        x, mask, dw_w, dw_b, norm_b, log_scale, nullptr, nullptr, dy, dz, nullptr, part_rows,
        nullptr, batch, frames, channels, 1, 0, segs, seg_rows);
  return static_cast<int>(cudaGetLastError());
}

// dz, x, g, dx: (batch, frames, channels); mask: (batch, frames) or null;
// dw_w: (channels, k); scale: (channels,) or null; partials:
// (ceil(batch * segs / 8), channels * (k + 3)); segments as above.
extern "C" int convnext_dwconv_bwd_launch(const float* dz, const float* x, const float* mask,
                                          const float* dw_w, const float* g, const float* scale,
                                          float* dx, float* partials, int batch, int frames,
                                          int channels, int k, int segs, int seg_rows,
                                          void* stream) {
  if (batch < 1 || frames < 1 || channels < 4 || channels % 4 != 0 || k != TAPS || segs < 1 ||
      seg_rows < 1 || (long long)segs * seg_rows < frames ||
      (long long)(segs - 1) * seg_rows >= frames ||
      (long long)batch * frames * channels > 0x7fffffffLL ||
      ((long long)batch * segs + CONV_WARPS - 1) / CONV_WARPS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((channels / 4 + WARP - 1) / WARP),
                  (unsigned)((batch * segs + CONV_WARPS - 1) / CONV_WARPS));
  convnext_dwconv_bwd_kernel<<<grid, dim3(WARP, CONV_WARPS), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      dz, x, mask, dw_w, g, scale, dx, partials, batch, frames, channels, segs, seg_rows);
  return static_cast<int>(cudaGetLastError());
}
