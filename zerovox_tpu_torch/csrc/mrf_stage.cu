// Fused HiFi-GAN multi-receptive-field (MRF) stage, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel zerovox_tpu/ops/pallas/folded_mrf.py:154-717
// (_mrf_kernel behind folded_mrf_stage, and mrf_stage_unfolded at :720-794).
// It computes, for one vocoder stage on channels-last (B, L, C) activations:
//
//   x   = [ConvTranspose1d(leaky_in(x_pre)) ] + in_bias         (optional parts)
//   h_j = resblock_j(x),  per dilation d:  h += conv_k(leaky(conv_k,d(leaky(h)) + b1)) + b2
//   out = [leaky_out]( (1/n_rb) * sum_j h_j )
//
// with every conv zero-padding its own input at the utterance edges (the
// TPU kernel's mask_oob), leaky slopes 0.1 inside the resblocks.
//
// What bounds it: FP32 FMA throughput.  A production stage runs 18 k=3
// convolutions, 18*2*3*C^2*L FLOPs (53-71 GFLOP per stage at B=1), against
// under 100 MB of HBM traffic, so the stage is compute-bound on the card's
// non-tensor f32 rate.
//
// What the design does about it:
//   * one CTA per (time tile, batch row); the receptive-field halo
//     (12 rows per side at k=3, dilations 1/3/5) is recomputed, not carried,
//     so CTAs run in any order;
//   * the whole 18-conv chain runs in shared memory: the stage input window,
//     the residual h and the conv1 output live there in f32, and each conv
//     shrinks the row range it computes by its own reach; the stage reads
//     its input from HBM once and writes its output once (the resblock sum
//     accumulates in the output rows the CTA owns); the upsampled
//     activation of a fused upsample never leaves the SM;
//   * each conv is a small GEMM (rows x C_out, depth taps x C_in): the
//     weights stream through shared memory in chunks of input channels,
//     double-buffered with cp.async so the next chunk loads while this one
//     is used, and every warp of the CTA shares each chunk; a thread keeps
//     an 8-row x TN-channel register tile (TN = 8, or 4 where C % 8 != 0),
//     and per (tap, input channel) issues 8 conflict-free shared loads of
//     inputs and TN/4 vector loads of weights for 8*TN FMAs;
//   * the time tile is sized so one round of the CTA's 8 warps covers every
//     conv of the chain.
//   Plain f32 FMA, no TF32, no tensor cores: this is the parity path.
//
// Interface: plain C, loaded with ctypes.  The host wrapper
// (zerovox_tpu_torch/ops/cuda/mrf_stage.py) chooses the geometry (tile,
// row stride, weight chunk, warp shape, shared-memory bytes), packs the
// weights in chain order, and raises on any non-zero return (the
// cudaError_t of the attribute call or the launch).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per CTA: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRM = 8;          // rows per thread tile
constexpr int kCN = 4;          // output channels per thread tile in the upsample
constexpr int kMaxRB = 8;       // resblocks per stage
constexpr int kMaxD = 8;        // dilations per resblock

struct Params {
  const float* x;        // (B, L_in, Cin) stage input (pre-upsample when w_up)
  const float* w_up;     // (K_up, Cin, C) ConvTranspose1d weight, or nullptr
  const float* in_bias;  // (C,) or nullptr
  const float* w;        // (n_conv, kr, C, C) [k][ci][co], chain order
  const float* b;        // (n_conv, C)
  float* y;              // (B, L_out, C)
  int L_in, Cin, C, L_out;
  int K_up, stride, pad;
  int has_in_leaky;
  float in_leaky;
  int has_out_leaky;
  float out_leaky;
  int n_rb, kr;
  int dils[kMaxRB][kMaxD];  // 0 = no conv pair at this slot
  int halo, tile, ss;       // ss: shared-memory row stride in floats (odd)
  int ch, wc;               // weight chunk (input channels), warp columns
  float inv_n;
};

__device__ __forceinline__ float leaky(float v, float s) {
  return v >= 0.f ? v : v * s;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Start the asynchronous copy of weight chunk q (conv q / nch, input
// channels [(q % nch) * ch, +ch), all taps) into `dst`; always commits one
// group, empty past the last chunk, so group counting stays uniform.
__device__ void issue_chunk(const Params& p, float* dst, int q, int nch, int n_chunks) {
  if (q < n_chunks) {
    const int C = p.C;
    const int c0 = (q % nch) * p.ch;
    const float* src = p.w + (size_t)(q / nch) * p.kr * C * C + (size_t)c0 * C;
    const int per_k = p.ch * C / 4;              // float4s per tap
    for (int e = threadIdx.x; e < p.kr * per_k; e += blockDim.x) {
      const int k = e / per_k, rem = e % per_k;
      __pipeline_memcpy_async(dst + k * p.ch * C + rem * 4,
                              src + (size_t)k * C * C + rem * 4, 16);
    }
  }
  __pipeline_commit();
}

// One same-length conv over window rows [o_lo, o_hi), reading rows
// [o_lo - half*d, o_hi + half*d) of `src`; consumes nch weight chunks from
// the stream position q.  t_base is the global time step of window row 0;
// rows whose step lies outside [0, L) are zeroed, because every conv
// zero-pads its own input.
//   conv1 (RESIDUAL false): dst = leaky(conv(leaky(src)) + bias, 0.1)
//   conv2 (RESIDUAL true):  dst += conv(src) + bias   (the residual h)
template <int TN, bool RESIDUAL>
__device__ void conv_pass(const Params& p, const float* src, float* dst,
                          const float* __restrict__ bias, float* wbuf, int wbuf_floats,
                          int& q, int nch, int n_chunks, int o_lo, int o_hi, int d,
                          int t_base) {
  const int C = p.C, ss = p.ss, half = (p.kr - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = p.wc, wr = 32 / wc;
  const int col_tiles = C / TN / wc;
  const int rows_wt = kRM * wr;                  // rows per warp tile
  const int row_tiles = (o_hi - o_lo + rows_wt - 1) / rows_wt;
  const bool active = warp < row_tiles * col_tiles;
  // channels of the thread tile: TN/4 groups of 4, `quarter` apart, so that a
  // warp's vector weight loads fall in distinct banks
  const int quarter = C / (TN / 4);
  const int cg = (warp % col_tiles) * wc + lane % wc;
  const int r_base = o_lo + (warp / col_tiles) * rows_wt + lane / wc;  // rows r_base + wr*i
  int rowoff[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) rowoff[i] = min(r_base + wr * i, o_hi - 1) * ss;
  float acc[kRM][TN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < nch; ++c, ++q) {
    issue_chunk(p, wbuf + ((q + 1) & 1) * wbuf_floats, q + 1, nch, n_chunks);
    __pipeline_wait_prior(1);
    __syncthreads();
    if (active) {
      const float* ws = wbuf + (q & 1) * wbuf_floats + cg * 4;
      for (int k = 0; k < p.kr; ++k) {
        const float* s = src + (k - half) * d * ss + c * p.ch;
        const float* wk = ws + k * p.ch * C;
#pragma unroll 2
        for (int ci = 0; ci < p.ch; ++ci) {
          float bw[TN];
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(wk + ci * C + (j >> 2) * quarter);
            bw[j] = v4.x; bw[j + 1] = v4.y; bw[j + 2] = v4.z; bw[j + 3] = v4.w;
          }
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            float a = s[rowoff[i] + ci];
            if (!RESIDUAL) a = leaky(a, 0.1f);
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, bw[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  float bb[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) bb[j] = __ldg(bias + (j >> 2) * quarter + cg * 4 + (j & 3));
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = r_base + wr * i;
    if (r >= o_hi) break;
    const int t = t_base + r;
    const bool valid = t >= 0 && t < p.L_out;
    float* o = dst + r * ss + cg * 4;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float* oj = o + (j >> 2) * quarter + (j & 3);
      const float v = acc[i][j] + bb[j];
      if (RESIDUAL) *oj = valid ? *oj + v : 0.f;
      else *oj = valid ? leaky(v, 0.1f) : 0.f;
    }
  }
}

// Fused ConvTranspose1d prologue: fills the window X (rows [0, W), global
// steps t_base + r) from the pre-upsample rows, staged (with leaky_in) in P.
// Rows r, r+s, r+2s, ... share their kernel taps, so a thread tile takes
// kRM rows of one phase: consecutive pre rows, the same weights.
__device__ void upsample_prologue(const Params& p, float* X, float* P, int W,
                                  int t_base, int batch) {
  const int C = p.C, Cin = p.Cin, s = p.stride, ss = p.ss;
  const int jlo = floordiv(t_base + p.pad - (p.K_up - 1), s);
  const int np_rows = floordiv(t_base + W - 1 + p.pad, s) - jlo + 1;
  const float* xb = p.x + (size_t)batch * p.L_in * Cin;
  for (int e = threadIdx.x; e < np_rows * Cin; e += blockDim.x) {
    const int j = jlo + e / Cin;
    float v = (j >= 0 && j < p.L_in) ? xb[(size_t)j * Cin + e % Cin] : 0.f;
    if (p.has_in_leaky) v = leaky(v, p.in_leaky);
    P[e] = v;
  }
  __syncthreads();

  const int G = C / kCN;
  const int m_max = (W + s - 1) / s;
  const int qg = (m_max + kRM - 1) / kRM;
  const int nitems = s * qg * G;
  for (int item = threadIdx.x; item < nitems; item += blockDim.x) {
    const int cg = item % G;
    const int rest = item / G;
    const int q = rest % qg;
    const int ph = rest / qg;
    const int r_first = ph + s * q * kRM;
    if (r_first >= W) continue;
    const int u = t_base + r_first + p.pad;
    const int k0 = ((u % s) + s) % s;
    float acc[kRM][kCN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) acc[i][j] = 0.f;
    for (int k = k0; k < p.K_up; k += s) {
      const int base = (u - k) / s - jlo;        // exact: u - k is a multiple of s
      int poff[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) poff[i] = min(base + i, np_rows - 1) * Cin;
      const float4* wk = reinterpret_cast<const float4*>(p.w_up + (size_t)k * Cin * C) + cg;
#pragma unroll 4
      for (int ci = 0; ci < Cin; ++ci) {
        const float4 wv = __ldg(wk + (size_t)ci * G);
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float v = P[poff[i] + ci];
          acc[i][0] = fmaf(v, wv.x, acc[i][0]);
          acc[i][1] = fmaf(v, wv.y, acc[i][1]);
          acc[i][2] = fmaf(v, wv.z, acc[i][2]);
          acc[i][3] = fmaf(v, wv.w, acc[i][3]);
        }
      }
    }
    float bb[kCN] = {0.f, 0.f, 0.f, 0.f};
    if (p.in_bias != nullptr) {
      const float4 bv = __ldg(reinterpret_cast<const float4*>(p.in_bias) + cg);
      bb[0] = bv.x; bb[1] = bv.y; bb[2] = bv.z; bb[3] = bv.w;
    }
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int r = r_first + s * i;
      if (r >= W) break;
      const int t = t_base + r;
      const bool valid = t >= 0 && t < p.L_out;
#pragma unroll
      for (int j = 0; j < kCN; ++j)
        X[r * ss + cg * kCN + j] = valid ? acc[i][j] + bb[j] : 0.f;
    }
  }
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 1) mrf_stage_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = p.C, ss = p.ss, H = p.halo, T = p.tile;
  const int W = T + 2 * H;
  const int wbuf_floats = p.kr * p.ch * C;
  float* wbuf = smem;                         // 2 weight chunks (16-byte aligned)
  float* X = wbuf + 2 * wbuf_floats;          // stage input window
  float* Hb = X + W * ss;                     // residual h
  float* Tb = Hb + W * ss;                    // leaky(conv1 + b1): the conv2 input
  const int batch = blockIdx.y;
  const int t0 = blockIdx.x * T;
  const int t_base = t0 - H;

  int n_conv = 0;
  for (int rb = 0; rb < p.n_rb; ++rb)
    for (int di = 0; di < kMaxD && p.dils[rb][di] != 0; ++di) n_conv += 2;
  const int nch = C / p.ch;
  const int n_chunks = n_conv * nch;
  int q = 0;
  issue_chunk(p, wbuf, 0, nch, n_chunks);     // overlaps the prologue

  if (p.w_up != nullptr) {
    upsample_prologue(p, X, Hb, W, t_base, batch);   // Hb..Tb are free until the chain
  } else {
    const float* xb = p.x + (size_t)batch * p.L_in * C;
    for (int e = threadIdx.x; e < W * C; e += blockDim.x) {
      const int r = e / C, c = e % C;
      const int t = t_base + r;
      float v = 0.f;
      if (t >= 0 && t < p.L_out) {
        v = xb[(size_t)t * C + c];
        if (p.in_bias != nullptr) v += p.in_bias[c];
      }
      X[r * ss + c] = v;
    }
  }
  __syncthreads();

  const int half = (p.kr - 1) / 2;
  float* yb = p.y + (size_t)batch * p.L_out * C;
  int conv = 0;
  for (int rb = 0; rb < p.n_rb; ++rb) {
    for (int e = threadIdx.x; e < W * C; e += blockDim.x) {
      const int r = e / C, c = e % C;
      Hb[r * ss + c] = X[r * ss + c];
    }
    // (the first chunk's wait + barrier inside conv_pass orders this copy)
    int lo = 0, hi = W;
    for (int di = 0; di < kMaxD && p.dils[rb][di] != 0; ++di) {
      const int d = p.dils[rb][di];
      lo += half * d;
      hi -= half * d;
      conv_pass<TN, false>(p, Hb, Tb, p.b + (size_t)conv * C, wbuf, wbuf_floats,
                           q, nch, n_chunks, lo, hi, d, t_base);
      ++conv;
      lo += half;
      hi -= half;
      conv_pass<TN, true>(p, Tb, Hb, p.b + (size_t)conv * C, wbuf, wbuf_floats,
                          q, nch, n_chunks, lo, hi, 1, t_base);
      ++conv;
    }
    __syncthreads();
    // resblock sum, accumulated in the output rows this CTA owns
    const bool last = rb == p.n_rb - 1;
    for (int e = threadIdx.x; e < T * C; e += blockDim.x) {
      const int t = t0 + e / C;
      if (t >= p.L_out) break;
      float* o = yb + (size_t)t * C + e % C;
      float v = Hb[(H + e / C) * ss + e % C];
      if (rb > 0) v = *o + v;
      if (last) {
        v *= p.inv_n;
        if (p.has_out_leaky) v = leaky(v, p.out_leaky);
      }
      *o = v;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int zv_mrf_stage_f32(
    const float* x, const float* w_up, const float* in_bias, const float* w,
    const float* b, float* y, int B, int L_in, int Cin, int C, int L_out,
    int K_up, int stride, int pad, int has_in_leaky, float in_leaky,
    int has_out_leaky, float out_leaky, int n_rb, int n_dmax, int kr,
    const int* dils, int halo, int tile, int ss, int ch, int wc, int tn,
    int smem_bytes, void* stream) {
  if (n_rb < 1 || n_rb > kMaxRB || n_dmax < 1 || n_dmax > kMaxD || tile < 1 ||
      kr < 1 || kr % 2 != 1 || halo < 0 || ss < C ||
      (tn != 4 && tn != 8) || C % tn != 0 || wc < 1 || 32 % wc != 0 ||
      (C / tn) % wc != 0 || (C / tn / wc) > kWarps || ch < 1 || C % ch != 0 ||
      (ch * C) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  // The geometry the host chose must hold the chain: the halo covers each
  // resblock's reach, one round of the CTA's warps covers every conv's rows
  // (the first conv of a resblock computes the most), the buffers fit the
  // shared memory asked for, and the pre-upsample rows fit their staging.
  const int half = (kr - 1) / 2;
  const int W = tile + 2 * halo;
  const int rows_round = (kWarps / (C / tn / wc)) * kRM * (32 / wc);
  for (int i = 0; i < n_rb; ++i) {
    const int* d = dils + i * n_dmax;
    if (d[0] < 1) return (int)cudaErrorInvalidValue;
    int reach = 0;
    for (int j = 0; j < n_dmax && d[j] != 0; ++j) reach += half * (d[j] + 1);
    if (reach > halo || rows_round < W - 2 * half * d[0])
      return (int)cudaErrorInvalidValue;
  }
  if ((long long)smem_bytes < 4LL * (2LL * kr * ch * C + 3LL * W * ss))
    return (int)cudaErrorInvalidValue;
  if (w_up != nullptr &&
      (stride < 1 || K_up < 1 ||
       (long long)((W - 1 + K_up - 1) / stride + 2) * Cin > 2LL * W * ss))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w_up = w_up; p.in_bias = in_bias; p.w = w; p.b = b; p.y = y;
  p.L_in = L_in; p.Cin = Cin; p.C = C; p.L_out = L_out;
  p.K_up = K_up; p.stride = stride; p.pad = pad;
  p.has_in_leaky = has_in_leaky; p.in_leaky = in_leaky;
  p.has_out_leaky = has_out_leaky; p.out_leaky = out_leaky;
  p.n_rb = n_rb; p.kr = kr;
  for (int i = 0; i < kMaxRB; ++i)
    for (int j = 0; j < kMaxD; ++j)
      p.dils[i][j] = (i < n_rb && j < n_dmax) ? dils[i * n_dmax + j] : 0;
  p.halo = halo; p.tile = tile; p.ss = ss; p.ch = ch; p.wc = wc;
  p.inv_n = 1.0f / (float)n_rb;
  const dim3 grid((L_out + tile - 1) / tile, B);
  cudaError_t err;
  if (tn == 8) {
    err = cudaFuncSetAttribute(mrf_stage_kernel<8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    mrf_stage_kernel<8><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(mrf_stage_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    mrf_stage_kernel<4><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* zv_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
