// Fused HiFi-GAN multi-receptive-field (MRF) stage for Hopper (sm_90a), in
// three modes chosen when this file is compiled: f32 accuracy on the tensor
// cores (3xTF32; the default), with -DZV_MRF_BF16=1 the bf16 serving mode
// (bf16 tensors, bf16 MMA operands, f32 accumulation and chain state), and
// with -DZV_MRF_F16_STAGED=1 the f16-staged mode of checkpoint verification
// (f32 tensors, f16 conv operands, f32 accumulation and chain state).
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
// What bounds it.  A production stage runs 18 k=3 convolutions,
// 18*2*3*C^2*L FLOPs (53-71 GFLOP per stage at B=1) against under 100 MB of
// HBM traffic, so the floor is arithmetic.  Each conv is a GEMM (rows x
// C_out, depth 3*C_in) run on mma.sync m16n8k8 TF32 with every operand split
// in two (v = hi + lo, hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi)) and
// three products hi*hi + hi*lo + lo*hi accumulated in f32: about 22
// significant bits per product, f32 parity at three MMAs per product, so the
// least time is 3 * FLOPs / the TF32 rate.  mma.sync is used, not wgmma: the
// dilated tap shift of 1/3/5 rows is not expressible in a wgmma shared-memory
// descriptor (8-row core matrices).  On the H100 the chain of MMAs (issue
// and latency with two warps per scheduler: the 255-register warp tile
// leaves one CTA per SM) takes about two thirds of a stage; the rest is the
// per-cluster work around it (staging, upsample, epilogues, the weight
// stream from L2, 4.7 MB per CTA at C=256), which no other CTA overlaps.
// At C=256 shared memory caps the window at 64 rows for a 40-row tile, so a
// stage-1 conv computes about 1.4x the rows it keeps (PERF.md).
//
// What the design does about it:
//   * one resblock per CTA, the n_rb CTAs of a time tile in one thread-block
//     cluster: the CTA's residual h starts as the stage input in place, so a
//     CTA holds two f32 windows (h and the conv1 output), and the grid has
//     n_rb times the CTAs of one-CTA-per-tile;
//   * the fused upsample prologue runs once per cluster: each CTA computes
//     a share of the window's rows (f32 FMA, the input channels split over
//     lane quarters, each weight read once per row group) and stores them
//     into every CTA's h window through distributed shared memory; the
//     pre-upsample rows are staged with kBatch float4 loads in flight;
//   * the resblock sum goes through distributed shared memory too: each CTA
//     sums a share of the output rows over the cluster's h windows in rank
//     order (deterministic, no atomics), scales by 1/n_rb, applies
//     leaky_out and writes the output once;
//   * the receptive-field halo (12 rows per side at k=3, dilations 1/3/5) is
//     recomputed, not carried: every conv zeroes its output rows outside
//     [0, L) and shrinks its computed range by its own reach, so clusters
//     run in any order;
//   * 8 warps tile each conv as warps_m x warps_n; a warp keeps MT m16 row
//     tiles x NT n8 column tiles of f32 accumulators, so every weight
//     fragment it loads serves MT row tiles; the tap shift (k - half) * d
//     rows is an offset on the A-fragment loads, the conv1 input's leaky is
//     applied once per A element before the split; the weights are split in
//     registers, so they stream as f32 (half the bytes of a pre-split copy);
//   * weights stream through a ring of `stages` (>= 3) chunks (one tap x KC
//     input channels x C outputs, KC a template parameter so a chunk's
//     k-steps unroll) filled by bulk async copies (cp.async.bulk) that
//     complete on an mbarrier per stage; warps release a stage through a
//     shared-memory counter, the last one refills it, so no CTA-wide barrier
//     is taken per chunk, only one per conv (the activation dependency).
//
// The bf16 mode (the TPU kernel's dot_bf16: zerovox_tpu/ops/pallas/
// folded_mrf.py:334-349, :369-391, :434-443) is the same flow with one
// mma.sync m16n8k16 bf16 product per k-step of 16 input channels.  What
// bounds it: the same FLOPs at the dense bf16 rate, a sixth of the 3xTF32
// floor, so the work around the chain weighs more.  What it keeps and what
// it changes:
//   * the windows in shared memory stay f32 (h, the residual and the
//     resblock sum are the chain state); an A fragment is two adjacent f32
//     channels per register, leaky'd in f32 and rounded once to a bf16 pair
//     (cvt.rn, round to nearest even) as it is loaded, so the row stride is
//     C + 8 floats (the 8-byte loads of four rows then hit distinct banks);
//   * the weights are bf16 as loaded, packed by the host as 32-bit words of
//     two consecutive input channels ([k][ci/2][co][ci%2]), so a B fragment
//     register is one word and a word row is addressed, swizzled and
//     streamed exactly as an f32 weight row is: KC counts 32-bit word rows
//     per chunk in both modes (2 KC input channels here);
//   * the input is read as 16-byte groups of 8 bf16 and widened, the output
//     is scaled and leaky'd in f32 and rounded once on the store; biases
//     reach the kernel widened to f32 (exact), and are added in f32;
//   * the upsample prologue stays on the FMA units: its operands are bf16
//     values (the staged rows rounded after the f32 leaky, the weights as
//     loaded) widened to f32, so every product is exact and the sum is f32.
//
// The f16-staged mode computes what the reference's ggml graph computes (f16
// conv weights and an f16 im2col, f32 accumulation) and what the JAX
// package's f16_staging computes on its XLA route (zerovox_tpu/ops/conv.py:
// 29-67; the TPU kernel never staged).  It is the f32 mode with every conv
// operand rounded to f16 after the leaky (cvt.rn: to nearest even, beyond
// +-65504 to +-inf): the A fragments as they are loaded, the upsample's
// staged rows always (not only after leaky_in), and the weights, which the
// host packs as f16 values in the f32 layout.  Every f16 value is a TF32
// value (TF32 keeps the same 10 explicit mantissa bits, with a wider
// exponent), so an operand's split has lo = 0 and ONE m16n8k8 TF32 product
// per k-step is exact: the f32 mode without two thirds of its MMAs, on the
// f32 mode's layouts, tile plans and instances.  The alternative, one
// m16n8k16 f16 product per k-step, would halve the MMAs again but needs the
// bf16 mode's packed pairs of input channels beside f32 activations in
// device memory, a fourth layout; a correct kernel came first.

// Interface: plain C, loaded with ctypes.  The host wrapper
// (zerovox_tpu_torch/ops/cuda/mrf_stage.py) chooses the geometry (tile,
// row strides, weight chunk, warp tile), packs the weights in chain order,
// and raises on any non-zero return (the cudaError_t of the attribute call
// or the launch).  The C side rejects a geometry that would leave rows
// uncomputed or overrun shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ZV_MRF_BF16
#define ZV_MRF_BF16 0
#endif
#ifndef ZV_MRF_F16_STAGED
#define ZV_MRF_F16_STAGED 0
#endif
#if ZV_MRF_BF16 && ZV_MRF_F16_STAGED
#error "the f16-staged mode is a float32 mode: build it with ZV_MRF_BF16=0"
#endif

namespace cg = cooperative_groups;

namespace {

#if ZV_MRF_BF16
typedef __nv_bfloat16 elem_t;   // activations and weights in device memory
constexpr int kCPW = 2;         // input channels per 32-bit word of a weight row
#else
typedef float elem_t;
constexpr int kCPW = 1;
#endif
constexpr int kVec = 16 / (int)sizeof(elem_t);   // channels per 16-byte global load

constexpr int kThreads = 256;   // threads per CTA: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 8;   // weight ring depth
constexpr int kUR = 16;         // rows of one phase per warp item in the upsample
constexpr int kCN = 4;          // output channels per lane in the upsample
constexpr int kBatch = 4;       // float4 loads in flight per thread when staging rows
constexpr int kMaxRB = 8;       // resblocks per stage (= cluster size)
constexpr int kMaxD = 8;        // dilations per resblock

struct Params {
  const elem_t* x;       // (B, L_in, Cin) stage input (pre-upsample when w_up)
  const elem_t* w_up;    // (K_up, Cin, C) ConvTranspose1d weight, or nullptr
  const float* in_bias;  // (C,) or nullptr
  const uint32_t* w;     // (n_conv, kr, C / kCPW, C) words [k][ci / kCPW][co], chain order
  const float* b;        // (n_conv, C)
  elem_t* y;             // (B, L_out, C)
  int L_in, Cin, C, L_out;
  int K_up, stride, pad;
  int has_in_leaky;
  float in_leaky;
  int has_out_leaky;
  float out_leaky;
  int n_rb, kr;
  int dils[kMaxRB][kMaxD];  // 0 = no conv pair at this slot
  int halo, tile;
  int ss;                   // window row stride (floats, C + 4: conflict-free A loads)
  int kc;                   // 32-bit word rows per weight chunk (the instance's KC)
  int stages;               // weight ring depth
  float inv_n;
};

struct Smem {
  uint32_t* ring;     // stages x kc x C words: the weight chunks
  float* h;           // residual h window, W x ss
  float* t;           // conv1 output window, W x ss (upsample staging before the chain)
  uint64_t* full;     // stages mbarriers: chunk landed
  int* released;      // stages counters: warps done with the stage's chunk
};

__device__ __forceinline__ float leaky(float v, float s) {
  return v >= 0.f ? v : v * s;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The bits of cvt.rna.tf32.f32(v) (round to nearest, ties away from zero:
// add half a TF32 unit to the magnitude, clear the 13 low bits), on the
// integer pipe: cvt to TF32 costs more issue slots than two integer ops.
__device__ __forceinline__ uint32_t rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo with hi, lo TF32: hi = rna(v), lo = rna(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#if ZV_MRF_BF16
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// {lo, hi} rounded to nearest even, lo in the low half: one MMA operand register
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
#endif

// kVec consecutive channels of a row, widened to f32: one 16-byte load
struct Vec { float v[kVec]; };

__device__ __forceinline__ Vec zero_vec() {
  Vec r;
#pragma unroll
  for (int i = 0; i < kVec; ++i) r.v[i] = 0.f;
  return r;
}

__device__ __forceinline__ Vec load_vec(const elem_t* ptr) {
  Vec r;
#if ZV_MRF_BF16
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(ptr));
  r.v[0] = bf16_lo(u.x); r.v[1] = bf16_hi(u.x); r.v[2] = bf16_lo(u.y); r.v[3] = bf16_hi(u.y);
  r.v[4] = bf16_lo(u.z); r.v[5] = bf16_hi(u.z); r.v[6] = bf16_lo(u.w); r.v[7] = bf16_hi(u.w);
#else
  const float4 u = __ldg(reinterpret_cast<const float4*>(ptr));
  r.v[0] = u.x; r.v[1] = u.y; r.v[2] = u.z; r.v[3] = u.w;
#endif
  return r;
}

__device__ __forceinline__ void store_vec(float* dst, const Vec& r) {   // shared memory, f32
#pragma unroll
  for (int i = 0; i < kVec; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(r.v[i], r.v[i + 1], r.v[i + 2], r.v[i + 3]);
}

// four consecutive output channels of one upsample weight row, widened to f32
__device__ __forceinline__ float4 load_w4(const elem_t* ptr) {
#if ZV_MRF_BF16
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(ptr));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
#else
  return __ldg(reinterpret_cast<const float4*>(ptr));
#endif
}

// four consecutive channels of an output row: rounded once, here, in the bf16 mode
__device__ __forceinline__ void store_out4(elem_t* ptr, float4 v) {
#if ZV_MRF_BF16
  *reinterpret_cast<uint2*>(ptr) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
#else
  *reinterpret_cast<float4*>(ptr) = v;
#endif
}

// an operand of a product: as it is in f32, a bf16 value in the bf16 mode, an
// f16 value in the f16-staged mode
__device__ __forceinline__ float round_operand(float v) {
#if ZV_MRF_BF16
  return __bfloat162float(__float2bfloat16_rn(v));
#elif ZV_MRF_F16_STAGED
  return __half2float(__float2half_rn(v));
#else
  return v;
#endif
}

struct Stream {
  int conv_base;   // first conv of this CTA's resblock in the packed chain
  int nb;          // chunks per tap (C / kCPW / kc)
  int cpc;         // chunks per conv (kr * nb)
  int n_chunks;    // chunks of this CTA's resblock
};

// One bulk copy brings chunk n (conv, tap, kc word rows: kc * kCPW input
// channels, contiguous in the packed weights) into ring stage n % stages.
__device__ void issue_chunk(const Params& p, const Smem& sm, const Stream& st, int n) {
  const int C = p.C, s = n % p.stages;
  const int rem = n % st.cpc;
  const int tap = rem / st.nb, row0 = (rem % st.nb) * p.kc;
  const uint32_t* src = p.w +
      ((size_t)(st.conv_base + n / st.cpc) * p.kr + tap) * (C / kCPW) * C + (size_t)row0 * C;
  mbar_expect_tx(sm.full + s, (uint32_t)(p.kc * C * 4));
  bulk_copy(sm.ring + (size_t)s * p.kc * C, src, (uint32_t)(p.kc * C * 4), sm.full + s);
}

// One same-length conv over window rows [o_lo, o_hi), reading rows
// [o_lo - half*d, o_hi + half*d) of `src`; consumes the next cpc chunks of
// the weight stream from position q.  t_base is the global time step of
// window row 0; rows whose step lies outside [0, L) are zeroed, because
// every conv zero-pads its own input.
//   conv1 (RESIDUAL false): dst = leaky(conv(leaky(src)) + bias, 0.1)
//   conv2 (RESIDUAL true):  dst += conv(src) + bias   (the residual h)
// A warp is done with chunk q (all its lanes have consumed their fragments):
// lane 0 counts it out of the chunk's stage (a shared-memory counter); the
// last warp to leave refills the stage with chunk q + stages at once, so the
// ring always runs stages - 1 chunks ahead of the slowest warp, no thread
// waits for a free stage, and no CTA-wide barrier is taken per chunk.
__device__ void release(const Params& p, const Smem& sm, const Stream& st, int q) {
  __syncwarp();
  if ((threadIdx.x & 31) != 0) return;
  const int s = q % p.stages;
  __threadfence_block();
  if (atomicAdd(sm.released + s, 1) != kWarps - 1) return;
  atomicExch(sm.released + s, 0);
  if (q + p.stages < st.n_chunks) {
    // the generic-proxy reads of the stage come before the async copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    issue_chunk(p, sm, st, q + p.stages);
  }
}

template <int NT, int MT, int KC, bool RESIDUAL>
__device__ void conv_pass(const Params& p, const Smem& sm, const Stream& st,
                          const float* src, float* dst, const float* __restrict__ bias,
                          int& q, int o_lo, int o_hi, int d, int t_base) {
  const int ss = p.ss, C = p.C, half = (p.kr - 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warps_n = C / (NT * 8);
  const int warps_m = kWarps / warps_n;
  const int wn = warp % warps_n, wm = warp / warps_n;
  const int n0 = wn * NT * 8;
  const int n_mt = (o_hi - o_lo + 15) / 16;

  int roff[MT][2];
  bool act[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = o_lo + (wm + warps_m * i) * 16 + g;
    act[i] = wm + warps_m * i < n_mt;
    roff[i][0] = min(r, o_hi - 1) * ss;
    roff[i][1] = min(r + 8, o_hi - 1) * ss;
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < st.cpc; ++c, ++q) {
    const int s = q % p.stages;
    mbar_wait(sm.full + s, (q / p.stages) & 1);
    const int tap = c / st.nb, ci0 = (c % st.nb) * KC * kCPW;
    // a lane's first channel of a k-step: t of 8 (TF32), the pair 2t, 2t + 1 of 16 (bf16)
    const float* a_base = src + (tap - half) * d * ss + ci0 + kCPW * t;
    // word (row, co) of a chunk sits at row * C + (co ^ 8 * (row % 4)) (pack_stage's
    // swizzle), so the B fragments' rows kk + t and kk + t + 4 hit distinct banks
    const uint32_t* w_base = sm.ring + (size_t)s * KC * C + n0 + g;
    // KC is a compile-time chunk: the k-steps of a chunk unroll into one block
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
#if ZV_MRF_BF16
      // one k-step: 8 word rows = 16 input channels, one product
      uint32_t bw[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = ((j ^ t) << 3);
        bw[j][0] = w_base[(kk + t) * C + col];
        bw[j][1] = w_base[(kk + t + 4) * C + col];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!act[i]) continue;
        const float* a0 = a_base + roff[i][0] + 2 * kk;
        const float* a1 = a_base + roff[i][1] + 2 * kk;
        float2 v[4] = {*reinterpret_cast<const float2*>(a0), *reinterpret_cast<const float2*>(a1),
                       *reinterpret_cast<const float2*>(a0 + 8),
                       *reinterpret_cast<const float2*>(a1 + 8)};
        uint32_t a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!RESIDUAL) {
            v[e].x = leaky(v[e].x, 0.1f);
            v[e].y = leaky(v[e].y, 0.1f);
          }
          a[e] = pack_bf16x2(v[e].x, v[e].y);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, bw[j][0], bw[j][1]);
      }
#elif ZV_MRF_F16_STAGED
      // f16 values in f32 words are TF32 values: one exact product, no split
      uint32_t bh[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = ((j ^ t) << 3);
        bh[j][0] = w_base[(kk + t) * C + col];
        bh[j][1] = w_base[(kk + t + 4) * C + col];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!act[i]) continue;
        float a[4] = {a_base[roff[i][0] + kk], a_base[roff[i][1] + kk],
                      a_base[roff[i][0] + kk + 4], a_base[roff[i][1] + kk + 4]};
        uint32_t ah[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!RESIDUAL) a[e] = leaky(a[e], 0.1f);
          ah[e] = __float_as_uint(round_operand(a[e]));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
      }
#else
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = ((j ^ t) << 3);
        split_tf32(__uint_as_float(w_base[(kk + t) * C + col]), bh[j][0], bl[j][0]);
        split_tf32(__uint_as_float(w_base[(kk + t + 4) * C + col]), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (!act[i]) continue;
        float a[4] = {a_base[roff[i][0] + kk], a_base[roff[i][1] + kk],
                      a_base[roff[i][0] + kk + 4], a_base[roff[i][1] + kk + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!RESIDUAL) a[e] = leaky(a[e], 0.1f);
          split_tf32(a[e], ah[e], al[e]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
#endif
    }
    release(p, sm, st, q);
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (!act[i]) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = o_lo + (wm + warps_m * i) * 16 + g + 8 * hh;
      if (r >= o_hi) continue;
      const int tg = t_base + r;
      const bool valid = tg >= 0 && tg < p.L_out;
      float* o = dst + r * ss + n0 + 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + n0 + j * 8 + 2 * t));
        float2* oj = reinterpret_cast<float2*>(o + j * 8);
        const float v0 = acc[i][j][2 * hh] + bb.x, v1 = acc[i][j][2 * hh + 1] + bb.y;
        float2 res;
        if (RESIDUAL) {
          const float2 old = *oj;
          res = valid ? make_float2(old.x + v0, old.y + v1) : make_float2(0.f, 0.f);
        } else {
          res = valid ? make_float2(leaky(v0, 0.1f), leaky(v1, 0.1f)) : make_float2(0.f, 0.f);
        }
        *oj = res;
      }
    }
  }
}

// Fused ConvTranspose1d prologue, shared by the cluster: fills rows [0, W)
// of every CTA's h window (global steps t_base + r) from the pre-upsample
// rows, staged (with leaky_in) in P.  Rows r, r+s, r+2s, ... share their
// kernel taps, so a warp item takes kUR rows of one phase (consecutive pre
// rows, the same weights) x 8 channel groups of kCN; the item's four lane
// quarters split the input channels (4 consecutive of every 16, one float4
// of P per row) and are summed by two xor shuffles, in which both lanes of a
// pair add the same two values, so the sum is deterministic.  CTA `rank`
// takes every n_rb-th warp item, so each weight is read once per row group
// of a phase, by one cluster.  Needs C % 32 == 0 and Cin % kVec == 0.  In the
// bf16 mode the staged rows are rounded to bf16 after the leaky (rows that
// were not leaky'd are bf16 values already) and the weights are bf16, both
// held as f32: exact products, an f32 sum.  In the f16-staged mode every
// staged row is rounded to f16 and the weights are f16 values from the host.
__device__ void upsample_prologue(const Params& p, cg::cluster_group& cluster, float* H,
                                  float* P, int W, int t_base, int batch, int rank) {
  const int C = p.C, Cin = p.Cin, s = p.stride, ss = p.ss;
  const int jlo = floordiv(t_base + p.pad - (p.K_up - 1), s);
  const int np_rows = floordiv(t_base + W - 1 + p.pad, s) - jlo + 1;
  const elem_t* xb = p.x + (size_t)batch * p.L_in * Cin;
  // 16-byte loads, kBatch in flight per thread before the first store
  const int CVin = Cin / kVec, nv = np_rows * CVin;
  for (int e0 = threadIdx.x; e0 < nv; e0 += kBatch * kThreads) {
    Vec v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int j = jlo + e / CVin;
      v[u] = zero_vec();
      if (e < nv && j >= 0 && j < p.L_in)
        v[u] = load_vec(xb + (size_t)j * Cin + (e % CVin) * kVec);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= nv) break;
      if (p.has_in_leaky) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[u].v[i] = round_operand(leaky(v[u].v[i], p.in_leaky));
      } else if (ZV_MRF_F16_STAGED) {   // f32 rows are no f16 values (bf16 rows are bf16)
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[u].v[i] = round_operand(v[u].v[i]);
      }
      store_vec(P + (size_t)e * kVec, v[u]);
    }
  }
  __syncthreads();

  float* dst[kMaxRB];
  for (int r = 0; r < p.n_rb; ++r) dst[r] = cluster.map_shared_rank(H, r);
  const int G = C / kCN;                   // channel groups, a multiple of 8
  const int gw = G / 8;
  const int qg = ((W + s - 1) / s + kUR - 1) / kUR;
  const int n_items = s * qg * gw;
  const int lane = threadIdx.x & 31, ks = lane >> 3;
  for (int wi = rank * kWarps + (threadIdx.x >> 5); wi < n_items; wi += kWarps * p.n_rb) {
    const int cgp = (wi % gw) * 8 + (lane & 7);
    const int qq = (wi / gw) % qg, ph = wi / gw / qg;
    const int r_first = ph + s * qq * kUR;
    if (r_first >= W) continue;              // the whole warp
    const int u = t_base + r_first + p.pad;
    const int k0 = ((u % s) + s) % s;
    float acc[kUR][kCN];
#pragma unroll
    for (int i = 0; i < kUR; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) acc[i][j] = 0.f;
    for (int k = k0; k < p.K_up; k += s) {
      const int base = (u - k) / s - jlo;    // exact: u - k is a multiple of s
      int poff[kUR];
#pragma unroll
      for (int i = 0; i < kUR; ++i) poff[i] = min(base + i, np_rows - 1) * Cin;
      const elem_t* wk = p.w_up + (size_t)k * Cin * C + cgp * kCN;
      for (int c4 = 4 * ks; c4 < Cin; c4 += 16) {
        float4 wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[e] = load_w4(wk + (size_t)(c4 + e) * C);
#pragma unroll
        for (int i = 0; i < kUR; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(P + poff[i] + c4);
          const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][0] = fmaf(ve[e], wv[e].x, acc[i][0]);
            acc[i][1] = fmaf(ve[e], wv[e].y, acc[i][1]);
            acc[i][2] = fmaf(ve[e], wv[e].z, acc[i][2]);
            acc[i][3] = fmaf(ve[e], wv[e].w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kUR; ++i)
#pragma unroll
      for (int j = 0; j < kCN; ++j) {
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 8);
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
      }
    float4 bb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.in_bias != nullptr) bb = __ldg(reinterpret_cast<const float4*>(p.in_bias) + cgp);
    // lane quarter ks stores rows i = ks mod 4 (every quarter holds the sums)
#pragma unroll
    for (int i = 0; i < kUR; ++i) {
      const int r = r_first + s * i;
      if ((i & 3) != ks || r >= W) continue;
      const int tg = t_base + r;
      const bool valid = tg >= 0 && tg < p.L_out;
      const float4 v = valid ? make_float4(acc[i][0] + bb.x, acc[i][1] + bb.y,
                                           acc[i][2] + bb.z, acc[i][3] + bb.w)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int rr = 0; rr < p.n_rb; ++rr)
        *reinterpret_cast<float4*>(dst[rr] + r * ss + cgp * kCN) = v;
    }
  }
}

template <int NT, int MT, int KC>
__global__ void __launch_bounds__(kThreads, 1) mrf_stage_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rb = (int)cluster.block_rank();        // this CTA's resblock
  extern __shared__ __align__(128) float4 smem4[];
  const int C = p.C, ss = p.ss, H = p.halo, T = p.tile;
  const int W = T + 2 * H;
  Smem sm;
  sm.ring = reinterpret_cast<uint32_t*>(smem4);
  sm.h = reinterpret_cast<float*>(sm.ring + (size_t)p.stages * p.kc * C);
  sm.t = sm.h + W * ss;
  sm.full = reinterpret_cast<uint64_t*>(sm.t + W * ss);
  sm.released = reinterpret_cast<int*>(sm.full + p.stages);
  const int batch = blockIdx.y;
  const int t0 = (blockIdx.x / p.n_rb) * T;
  const int t_base = t0 - H;

  int n_d = 0, conv_base = 0;
  for (int j = 0; j < p.n_rb; ++j) {
    int nj = 0;
    while (nj < kMaxD && p.dils[j][nj] != 0) ++nj;
    if (j < rb) conv_base += 2 * nj;
    if (j == rb) n_d = nj;
  }
  Stream st;
  st.conv_base = conv_base;
  st.nb = C / kCPW / p.kc;
  st.cpc = p.kr * st.nb;
  st.n_chunks = 2 * n_d * st.cpc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(sm.full + s, 1);
      sm.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < min(p.stages, st.n_chunks); ++n)   // overlaps the prologue
      issue_chunk(p, sm, st, n);
  }
  __syncthreads();
  cluster.sync();                                // every CTA of the cluster runs

  if (p.w_up != nullptr) {
    upsample_prologue(p, cluster, sm.h, sm.t, W, t_base, batch, rb);
  } else {
    const elem_t* xb = p.x + (size_t)batch * p.L_in * C;
    const int CV = C / kVec, nv = W * CV;
    for (int e0 = threadIdx.x; e0 < nv; e0 += kBatch * kThreads) {
      Vec v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int tg = t_base + e / CV;
        v[u] = zero_vec();
        if (e < nv && tg >= 0 && tg < p.L_out)
          v[u] = load_vec(xb + (size_t)tg * C + (e % CV) * kVec);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= nv) break;
        const int r = e / CV, c0 = (e % CV) * kVec, tg = t_base + r;
        if (p.in_bias != nullptr && tg >= 0 && tg < p.L_out) {
#pragma unroll
          for (int i = 0; i < kVec; i += 4) {
            const float4 bv = __ldg(reinterpret_cast<const float4*>(p.in_bias + c0 + i));
            v[u].v[i] += bv.x; v[u].v[i + 1] += bv.y; v[u].v[i + 2] += bv.z; v[u].v[i + 3] += bv.w;
          }
        }
        store_vec(sm.h + r * ss + c0, v[u]);
      }
    }
  }
  cluster.sync();                                // every h window holds the stage input

  const int half = (p.kr - 1) / 2;
  const float* bias = p.b + (size_t)conv_base * C;
  int q = 0, lo = 0, hi = W;
  for (int di = 0; di < n_d; ++di) {
    const int d = p.dils[rb][di];
    lo += half * d;
    hi -= half * d;
    conv_pass<NT, MT, KC, false>(p, sm, st, sm.h, sm.t, bias + (size_t)(2 * di) * C, q, lo, hi,
                             d, t_base);
    __syncthreads();
    lo += half;
    hi -= half;
    conv_pass<NT, MT, KC, true>(p, sm, st, sm.t, sm.h, bias + (size_t)(2 * di + 1) * C, q, lo,
                            hi, 1, t_base);
    __syncthreads();
  }
  cluster.sync();                                // every resblock's h is final

  // resblock sum over the cluster, rank order; this CTA writes its share of rows
  elem_t* yb = p.y + (size_t)batch * p.L_out * C;
  const float* hs[kMaxRB];
  for (int r = 0; r < p.n_rb; ++r) hs[r] = cluster.map_shared_rank(sm.h, r);
  const int share = (T + p.n_rb - 1) / p.n_rb;
  const int r_lo = rb * share, r_hi = min(T, r_lo + share);
  const int C4 = C / 4;
  for (int e = r_lo * C4 + threadIdx.x; e < r_hi * C4; e += blockDim.x) {
    const int r = e / C4, c4 = e % C4;
    const int tg = t0 + r;
    if (tg >= p.L_out) break;
    const int off = (H + r) * ss + c4 * 4;
    float4 v = *reinterpret_cast<const float4*>(hs[0] + off);
    for (int j = 1; j < p.n_rb; ++j) {
      const float4 u = *reinterpret_cast<const float4*>(hs[j] + off);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    v.x *= p.inv_n; v.y *= p.inv_n; v.z *= p.inv_n; v.w *= p.inv_n;
    if (p.has_out_leaky) {
      v.x = leaky(v.x, p.out_leaky); v.y = leaky(v.y, p.out_leaky);
      v.z = leaky(v.z, p.out_leaky); v.w = leaky(v.w, p.out_leaky);
    }
    store_out4(yb + (size_t)tg * C + c4 * 4, v);
  }
  cluster.sync();                                // no CTA leaves while its h is read
}

// The kernel instances: (NT n8 column tiles, MT m16 row tiles) per warp and
// the weight chunk's 32-bit word rows KC (ops/cuda/mrf_stage.py's _MT and _KC).
typedef void (*KernelFn)(const Params);

KernelFn pick_kernel(int nt, int mt, int kc) {
  if (nt == 8 && mt == 3 && kc == 16) return mrf_stage_kernel<8, 3, 16>;
  if (nt == 8 && mt == 3 && kc == 32) return mrf_stage_kernel<8, 3, 32>;
  if (nt == 8 && mt == 3 && kc == 64) return mrf_stage_kernel<8, 3, 64>;
  if (nt == 4 && mt == 6 && kc == 16) return mrf_stage_kernel<4, 6, 16>;
  if (nt == 4 && mt == 6 && kc == 32) return mrf_stage_kernel<4, 6, 32>;
  return nullptr;
}

cudaLaunchConfig_t launch_config(dim3 grid, int n_rb, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_rb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// One entry per mode; a library built from this file holds one of them.
#if ZV_MRF_BF16
#define ZV_STAGE_ENTRY zv_mrf_stage_bf16
#define ZV_CLUSTERS_ENTRY zv_mrf_max_clusters_bf16
#elif ZV_MRF_F16_STAGED
#define ZV_STAGE_ENTRY zv_mrf_stage_f16_staged
#define ZV_CLUSTERS_ENTRY zv_mrf_max_clusters_f16_staged
#else
#define ZV_STAGE_ENTRY zv_mrf_stage_f32
#define ZV_CLUSTERS_ENTRY zv_mrf_max_clusters
#endif

// kc counts 32-bit word rows of a weight chunk (f32: input channels; bf16:
// pairs of them); in_bias and b are f32 in both modes.
extern "C" int ZV_STAGE_ENTRY(
    const elem_t* x, const elem_t* w_up, const float* in_bias, const uint32_t* w,
    const float* b, elem_t* y, int B, int L_in, int Cin, int C, int L_out,
    int K_up, int stride, int pad, int has_in_leaky, float in_leaky,
    int has_out_leaky, float out_leaky, int n_rb, int n_dmax, int kr,
    const int* dils, int halo, int tile, int ss, int kc, int stages, int nt, int mt,
    int smem_bytes, void* stream) {
  const KernelFn kernel = pick_kernel(nt, mt, kc);
  if (kernel == nullptr || n_rb < 1 || n_rb > kMaxRB || n_dmax < 1 || n_dmax > kMaxD ||
      tile < 1 || kr < 1 || kr % 2 != 1 || halo < 0 || C < 8 || C % (nt * 8) != 0 ||
      kWarps % (C / (nt * 8)) != 0 || C % 32 != 0 || ss < C || ss % 4 != 0 ||
      (C / kCPW) % kc != 0 || stages < 2 || stages > kMaxStages ||
      kc * C * 4 >= (1 << 20) || B < 1 || L_out < 1)
    return (int)cudaErrorInvalidValue;
  // The geometry the host chose must hold the chain: the halo covers each
  // resblock's reach, the warps' row tiles cover every conv's rows (the first
  // conv of a resblock computes the most), the buffers fit the shared memory
  // asked for, and the pre-upsample rows fit their staging window.
  const int half = (kr - 1) / 2;
  const int W = tile + 2 * halo;
  const int rows_round = (kWarps / (C / (nt * 8))) * mt * 16;
  for (int i = 0; i < n_rb; ++i) {
    const int* d = dils + i * n_dmax;
    if (d[0] < 1) return (int)cudaErrorInvalidValue;
    int reach = 0;
    for (int j = 0; j < n_dmax && d[j] != 0; ++j) reach += half * (d[j] + 1);
    if (reach > halo || rows_round < W - 2 * half * d[0])
      return (int)cudaErrorInvalidValue;
  }
  if ((long long)smem_bytes <
      4LL * ((long long)stages * kc * C + 2LL * W * ss) + 16LL * stages)
    return (int)cudaErrorInvalidValue;
  // every pointer read or written in 16-byte or 8-byte groups is 16-byte aligned
  const void* ptrs[] = {x, w_up, in_bias, w, b, y};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (w_up != nullptr &&
      (stride < 1 || K_up < 1 || Cin < kVec || Cin % kVec != 0 ||
       (long long)((W - 1 + K_up - 1) / stride + 2) * Cin > (long long)W * ss))
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
  p.halo = halo; p.tile = tile; p.ss = ss; p.kc = kc; p.stages = stages;
  p.inv_n = 1.0f / (float)n_rb;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(((L_out + tile - 1) / tile) * n_rb, B, 1), n_rb, smem_bytes,
                    (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of n_rb CTAs of the (nt, mt) instances that the card holds at
// once with smem_bytes of shared memory each (one wave; the same for every
// chunk size: one CTA per SM); negative: -cudaError_t.
extern "C" int ZV_CLUSTERS_ENTRY(int n_rb, int nt, int mt, int smem_bytes) {
  const KernelFn kernel = pick_kernel(nt, mt, 32);
  if (kernel == nullptr || n_rb < 1 || n_rb > kMaxRB) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(dim3(n_rb, 1, 1), n_rb, smem_bytes, 0, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return n;
}

#if !ZV_MRF_BF16 && !ZV_MRF_F16_STAGED
extern "C" const char* zv_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
