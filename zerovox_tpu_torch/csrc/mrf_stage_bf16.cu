// Fused HiFi-GAN multi-receptive-field (MRF) stage for Hopper (sm_90a) on
// warpgroup MMAs (wgmma) fed by the TMA unit, in two modes chosen when this
// file is compiled: the bf16 serving mode (the default), and with
// -DZV_MRF_F16_STAGED=1 the f16-staged mode of checkpoint verification
// (below).
//
// Replaces the TPU kernel's dot_bf16 path: zerovox_tpu/ops/pallas/
// folded_mrf.py:334-349, :380-391 and :434-443, inside _mrf_kernel (:154-443)
// behind folded_mrf_stage (:446-717) and mrf_stage_unfolded (:720-794).  For
// one vocoder stage on channels-last (B, L, C) bf16 activations it computes
//
//   x   = [ConvTranspose1d(leaky_in(x_pre))] + in_bias            (optional parts)
//   h_j = resblock_j(x),  per dilation d:  h += conv_k(leaky(conv_k,d(leaky(h)) + b1)) + b2
//   out = [leaky_out]( (1/n_rb) * sum_j h_j )
//
// with every conv zero-padding its own input at the utterance edges, slopes
// 0.1 inside the resblocks.  Numerics (those of mrf_stage_ref on bf16
// tensors, and of the TPU kernel's dot_bf16):
// every conv operand, the upsample's too, is leaky'd in f32 and rounded once
// to bf16 (round to nearest even); products are exact and summed in f32; h,
// the residual and the resblock sum stay f32; the resblock sum is taken in
// rank order (deterministic); the output is rounded once.
//
// What bounds it on an H100.  The same 18 k=3 convs as the f32 mode, at the
// dense bf16 tensor-core rate: 53-71 GFLOP per full-length B=1 stage against
// 15-48 MB of HBM traffic, so the floor is arithmetic (0.054-0.072 ms per
// stage).  Around the products sits per-tile work that the tensor cores do
// not do: staging the window, the upsample, each conv's epilogue (bias,
// residual, leaky, rounding) and the weight stream (each CTA reads its
// resblock's 6 x 3 x C^2 bf16 weights, 2.36 MB at C=256, from L2).  An
// mma.sync design spends 63-73 % of a stage there when one CTA fills an SM,
// nothing overlaps that work, and every A element is leaky'd and rounded
// again at every k-step.
//
// What this design does about it:
//   * wgmma m64nCk16 (N = C, the whole output width), both operands read
//     from shared memory through no-swizzle (INTERLEAVE) descriptors.  An
//     operand is kept as planes of 8 channels, each plane a column of rows
//     at 16 bytes per row, so an 8x16-byte core matrix is 8 consecutive rows
//     of a plane and a dilated tap shift of s rows is a start address s*16
//     bytes further on: the shifted tap is a descriptor, not a copy.
//     (csrc/mrf_stage.cu ruled wgmma out for the tap shift; that holds for
//     the swizzled layouts only.  chip_smoke.py's phase 3 runs this file's
//     zv_wgmma_probe at shifts 0-7 against a plain product.)  Every tile's
//     wgmma is issued unconditionally: a wgmma under a branch that depends
//     on the thread makes ptxas serialize all of them (C7520).
//   * each operand is prepared once per conv, not once per k-step: conv1's
//     epilogue writes conv2's planes, round(leaky(conv1 + b1)), and conv2's
//     epilogue updates h and writes the next conv1's, round(leaky(h)), with
//     stmatrix (8x8 bf16 blocks straight from the accumulator layout).  One
//     operand buffer beside the f32 h window (no second f32 window), so a
//     window holds up to 128 rows at C=256 (two f32 windows: 64) and
//     32768/C rows at C >= 64: two warpgroups hold every 64-row M-tile of
//     the window in registers (128 f32 accumulators a thread), so each
//     weight chunk is read once per CTA and conv and serves every row.  At
//     C=32, whose rows are many and weights few, a window holds 512 rows
//     (64 accumulators) and two CTAs share an SM, so that one's epilogue
//     overlaps the other's products (stage 4 0.74-0.77 ms against about 1.0
//     with one CTA of 1024-row windows).  A
//     conv's epilogue overwrites the buffer every M-tile's products read, so
//     it waits for all of them: the warpgroups do not ping-pong.
//   * the weight stream: a chunk (one tap x KB input channels x C outputs,
//     packed on the host in the exact shared-memory plane layout) is one
//     bulk copy of the TMA unit into a ring of `stages` slots with a full
//     mbarrier each; the ring takes the shared memory the window leaves
//     (2-16 slots), so the next conv's weights are in flight during an
//     epilogue.  There is no producer warp: the last of the 8 warps to leave
//     a slot refills it, `stages` chunks ahead.  A ninth warp puts three
//     warps on one SM sub-partition and caps every thread at 168 registers
//     (setmaxnreg would need a whole producer warpgroup for one issuing
//     lane); 256 threads leave 255.  At C >= 128 the stream from L2, not the
//     products, bounds a CTA, and it moves faster in larger copies: the
//     chunks are 32 KB there (C=256: 64 input channels; C=128: a whole
//     tap), at the price of a shorter window (two slots).
//   * the ConvTranspose1d upsample (k = t*s) on the tensor cores: s polyphase
//     products of depth t*C_in over the pre-upsample rows, staged once as
//     planes of round(leaky_in(x)); tap m of a phase is the same operand
//     shifted by -m rows.  The CTAs of a cluster split the phases and write
//     each output row, + in_bias, into every CTA's h window through
//     distributed shared memory.
//   * one resblock per CTA, the n_rb CTAs of a time tile in one cluster: the
//     resblock sum reads the cluster's h windows in rank order; the
//     receptive-field halo is recomputed, so clusters run in any order.
//
// The f16-staged mode (-DZV_MRF_F16_STAGED=1) computes what the reference's
// ggml graph computes (f16 conv weights and an f16 im2col, f32
// accumulation) and what the JAX package's f16_staging computes on its XLA
// route (zerovox_tpu/ops/conv.py:29-67; the TPU kernel never staged): the
// numerics above with f16 in place of bf16 (cvt.rn: to nearest even,
// beyond +-65504 to +-inf, so a non-finite operand shows in the output), on
// f32 tensors.  It is this design with f16 operand planes and f16 weights
// (wgmma .f32.f16.f16: the same shapes, descriptors and rate, and an f16
// product is exact in f32 as a bf16 one is); only the edges differ: the
// stage input is read as f32 (two 16-byte loads per plane row of 8
// channels), the pre-upsample rows are rounded to f16 whether or not
// leaky_in acts on them (f32 values are no f16 values), the unfolded
// entry's input goes into h unrounded, and the output is written f32,
// unrounded.  The h window, the biases, the residual and the resblock sum
// are f32 in both modes, so the geometry (bf16_plan) is the same.

// Interface: plain C, loaded with ctypes by zerovox_tpu_torch/ops/cuda/
// mrf_stage.py, which chooses the geometry (tile, window, operand plane rows,
// ring depth, chunk) in plain Python (`bf16_plan`) and packs the weights
// (`pack_stage`).  The entry rejects a geometry that would leave rows
// uncomputed or overrun shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef ZV_MRF_F16_STAGED
#define ZV_MRF_F16_STAGED 0
#endif

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;
#if ZV_MRF_F16_STAGED
typedef __half op_t;                                  // operand planes and weights
typedef float io_t;                                   // stage input and output
#define ZV_WGMMA_AB ".f16.f16 "
#else
typedef bf16 op_t;
typedef bf16 io_t;
#define ZV_WGMMA_AB ".bf16.bf16 "
#endif

constexpr int kWarps = 8;                             // two warpgroups
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;                             // 16-byte loads in flight per thread (staging)
constexpr int kMaxStages = 16;                        // weight ring slots
constexpr int kMaxRB = 8;                             // resblocks per stage (= cluster size)
constexpr int kMaxD = 8;                              // dilations per resblock
constexpr int kSmemMax = 232448;
constexpr float kSlope = 0.1f;

// Compile-time geometry of the instance for C channels, weight chunks of KB
// input channels and MT 64-row M-tiles per warpgroup: 256 / C (128 f32
// accumulators a thread, one CTA an SM), or at C=32 128 / C (64, two CTAs
// an SM: their epilogues hide each other's latency).
template <int C, int KB_, int MT_>
struct Geo {
  static constexpr int KB = KB_;                 // input channels per weight chunk
  static constexpr int MT = MT_;                 // 64-row M-tiles per warpgroup
  static constexpr int CHUNK = KB * C * 2;       // bytes of a weight chunk
  static constexpr int CTAS = MT * C <= 128 ? 2 : 1;   // CTAs an SM holds
};

struct Params {
  const io_t* x;          // (B, L_in, Cin) stage input (pre-upsample when w_up)
  const op_t* w_up;       // (K_up, Cin/8, C, 8) upsample taps as planes, or nullptr
  const float* in_bias;   // (C,) or nullptr
  const op_t* w;          // (n_conv, kr, C/8, C, 8) conv taps as planes, chain order
  const float* b;         // (n_conv, C)
  io_t* y;                // (B, L_out, C)
  int L_in, Cin, L_out;
  int K_up, stride, pad;
  int has_in_leaky;
  float in_leaky;
  int has_out_leaky;
  float out_leaky;
  int n_rb, kr;
  int dils[kMaxRB][kMaxD];  // 0 = no conv pair at this slot
  int halo, tile, window;   // window = tile + 2 * halo rows
  int margin;               // operand plane rows before window row 0 (the largest tap shift)
  int plane_rows;           // rows of an operand plane
  int np_rows;              // rows of a pre-upsample plane
  int buf_bytes;            // the operand buffer (operand planes, or the pre-upsample planes)
  int stages;
  float inv_n;
};

struct Smem {
  uint8_t* buf;            // operand planes: plane (c / 8) row (margin + r) at c/8 * plane_rows*16 + ...
  float* h;                // f32 residual window, window x C, 32-byte groups swizzled by row
  float* bias;             // (C,) the bias of the epilogue in hand
  uint64_t* full;          // per ring slot: chunk landed
  int* released;           // per ring slot: warps done with its chunks (a running count)
  uint32_t ring_addr;      // shared-space addresses (descriptors, copies, explicit accesses)
  uint32_t buf_addr;
  uint32_t h_addr;
  uint32_t bias_addr;
};

struct Stream {
  int conv_base;   // first conv of this CTA's resblock in the packed chain
  int nb;          // chunks per conv tap (C / KB)
  int cpc;         // chunks per conv (kr * nb)
  int nb_up;       // chunks per upsample tap (Cin / KB)
  int up_cpc;      // chunks per upsample phase (taps per phase * nb_up)
  int n_up;        // upsample chunks of this CTA (its phases)
  int n_chunks;    // all chunks of this CTA
};

__device__ __forceinline__ float leaky(float v, float s) { return v >= 0.f ? v : v * s; }

// the resblocks' leaky relu (slope 0.1): max(v, 0.1 v), the same value in two operations
__device__ __forceinline__ float leaky01(float v) { return fmaxf(v, v * kSlope); }

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// {lo, hi} as two operands (bf16, or f16 in the f16-staged mode) rounded to
// nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_op2(float lo, float hi) {
#if ZV_MRF_F16_STAGED
  const __half2 v = __floats2half2_rn(lo, hi);
#else
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
#endif
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// h element (r, c) of a window of C channels: 32-byte groups (8 floats)
// XOR-swizzled by r % 4, so the accumulator layout's float2 accesses (8 rows
// x 4 lanes per warp) and 8-channel row reads spread over the banks
template <int C>
__device__ __forceinline__ int hidx(int r, int c) {
  return r * C + ((((c >> 3) ^ (r & 3))) << 3) + (c & 7);
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

// Waits for the barrier's phase of `parity` to complete.  A wait of more
// than about 10 s traps (a launch error the host reports) instead of hanging
// the card: the producer and the consumers wait on each other.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes to shared memory before async-proxy (wgmma) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Explicit shared-space accesses (32-bit shared addresses), and those of
// another CTA of the cluster (shared::cluster addresses from mapa)
__device__ __forceinline__ void sts_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_u4(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void sts_f2(uint32_t a, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(v.x), "f"(v.y) : "memory");
}
__device__ __forceinline__ void sts_f4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
// four 8x8 bf16 matrices from the accumulator layout, one row address per lane
__device__ __forceinline__ void stmatrix_x4(uint32_t a, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}
__device__ __forceinline__ float2 lds_f2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float4 lds_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster_f2(uint32_t a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(v.x), "f"(v.y)
               : "memory");
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// A wgmma matrix descriptor from its raw fields (bytes): start address,
// leading byte offset (LBO), stride byte offset (SBO); layout type 0, no
// swizzle, base offset 0.
__device__ __forceinline__ uint64_t raw_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

// Which field of a no-swizzle K-major descriptor holds the offset between
// the two 8-element halves of a k16 step: LBO (SBO holds the offset between
// 8-row groups).  zv_wgmma_probe tells the two apart on the card
// (chip_smoke.py phase 3): with the fields swapped the product is wrong, and
// a probe whose shared memory did not cover the swapped reading faulted.
constexpr bool kLboIsK = true;

// A no-swizzle (INTERLEAVE) K-major operand: core matrices of 8 rows x 16
// bytes stored as 128 contiguous bytes; `k_bytes` between the two 8-element
// halves of a k16 step (here: between planes), `mn_bytes` between
// consecutive 8-row groups (here 128: a plane's rows are contiguous).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t k_bytes,
                                              uint32_t mn_bytes) {
  return kLboIsK ? raw_desc(addr, k_bytes, mn_bytes) : raw_desc(addr, mn_bytes, k_bytes);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across the async MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N, f32) (+)= A(64 x 16) * B(16 x N), operands bf16 (f16 in the f16-staged
// mode, ZV_WGMMA_AB); scale_d == 0 overwrites D
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" ZV_WGMMA_AB
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" ZV_WGMMA_AB
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" ZV_WGMMA_AB
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32" ZV_WGMMA_AB
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int C>
__device__ __forceinline__ void wgmma(float (&d)[C / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (C == 32) wgmma_n32(d, da, db, scale_d);
  else if constexpr (C == 64) wgmma_n64(d, da, db, scale_d);
  else if constexpr (C == 128) wgmma_n128(d, da, db, scale_d);
  else wgmma_n256(d, da, db, scale_d);
}

// Chunk n of this CTA's weight stream: first its upsample phases (rank,
// rank + n_rb, ...; per phase its taps ph + s*m, per tap Cin / KB chunks),
// then its resblock's convs (per conv its taps, per tap C / KB chunks).  The
// host packs both as planes, so a chunk is KB * C contiguous 16-bit values.
template <int C, int KB, int MT>
__device__ __forceinline__ const op_t* chunk_src(const Params& p, const Stream& st, int rank,
                                                 int n) {
  using G = Geo<C, KB, MT>;
  if (n < st.n_up) {
    const int ph = rank + (n / st.up_cpc) * p.n_rb;
    const int rem = n % st.up_cpc;
    const int k = ph + p.stride * (rem / st.nb_up), ci0 = (rem % st.nb_up) * G::KB;
    return p.w_up + ((size_t)k * p.Cin + ci0) * C;
  }
  const int nn = n - st.n_up;
  const int rem = nn % st.cpc;
  const int tap = rem / st.nb, ci0 = (rem % st.nb) * G::KB;
  return p.w + (((size_t)(st.conv_base + nn / st.cpc) * p.kr + tap) * C + ci0) * C;
}

// One bulk copy of the TMA unit brings chunk n into ring slot n % stages,
// expected on the slot's full barrier.
template <int C, int KB, int MT>
__device__ __forceinline__ void issue_chunk(const Params& p, const Smem& sm, const Stream& st,
                                            int rb, int n) {
  using G = Geo<C, KB, MT>;
  const int s = n % p.stages;
  const uint32_t dst = sm.ring_addr + (uint32_t)(s * G::CHUNK);
  mbar_expect_tx(sm.full + s, (uint32_t)G::CHUNK);
  bulk_copy(dst, chunk_src<C, KB, MT>(p, st, rb, n), (uint32_t)G::CHUNK, sm.full + s);
}

// A consumer warp is done with chunk q (the products that read it have
// completed): its lane 0 counts the warp out of the slot; the last of the 8
// warps to leave refills it with chunk q + lag (lag = stages: the ring runs
// stages chunks ahead of the products).  The count runs on (use k of a slot
// ends at (k + 1) * 8), so nothing resets it.  No warp waits for a slot, and
// no CTA-wide barrier is taken per chunk.
template <int C, int KB, int MT>
__device__ __forceinline__ void release(const Params& p, const Smem& sm, const Stream& st,
                                        int rb, int q, int lag) {
  __syncwarp();
  if ((threadIdx.x & 31) != 0) return;
  const int s = q % p.stages, k = q / p.stages;
  if (atomicAdd(sm.released + s, 1) != (k + 1) * kWarps - 1) return;
  if (q + lag >= st.n_chunks) return;
  fence_proxy_async();
  issue_chunk<C, KB, MT>(p, sm, st, rb, q + lag);
}

// The products of one GEMM over `n_chunks` consecutive chunks of the stream,
// from position q: acc[i] of this warpgroup's M-tile j = wg + 2i (+)= A rows
// [64 j, +64) x the chunk's weights, A read from operand planes at `a_base`
// (chunk c: planes from (c % nb) * KB / 8, rows shifted by shift(c / nb), the
// chunk's tap), `plane_bytes` apart.  Every tile's wgmma is issued, always:
// one under a branch that depends on the thread (a warpgroup's own tiles)
// makes ptxas serialize every wgmma of the kernel (C7520).  A tile beyond
// the `n_tiles` that hold data recomputes the last of them (its epilogue
// skips it).  A chunk is released once the products of the next one are
// issued (one group in flight).
template <int C, int KB, int MT, bool MMA = true, typename Shift>
__device__ __forceinline__ void gemm(const Params& p, const Smem& sm, const Stream& st, int rank,
                                     int lag, float (&acc)[Geo<C, KB, MT>::MT][C / 2], int n_tiles,
                                     int& q, int n_chunks, int nb, uint32_t a_base,
                                     uint32_t plane_bytes, Shift shift) {
  using G = Geo<C, KB, MT>;
  const int wg = threadIdx.x >> 7;
  uint32_t a_tile[G::MT];
#pragma unroll
  for (int i = 0; i < G::MT; ++i) a_tile[i] = (uint32_t)(64 * min(wg + 2 * i, n_tiles - 1) * 16);
#pragma unroll
  for (int i = 0; i < G::MT; ++i) fence_regs(acc[i]);
  wg_fence();
  for (int c = 0; c < n_chunks; ++c, ++q) {
    const int s = q % p.stages;
    mbar_wait(sm.full + s, (q / p.stages) & 1);
    const uint32_t a0 = a_base + (uint32_t)((c % nb) * (G::KB / 8)) * plane_bytes +
                        (uint32_t)(shift(c / nb) * 16);
    const uint32_t b0 = sm.ring_addr + (uint32_t)(s * G::CHUNK);
#pragma unroll
    for (int ks = 0; ks < G::KB / 16; ++ks) {
      const uint64_t db = make_desc(b0 + (uint32_t)(ks * 2 * C * 16), C * 16, 128);
#pragma unroll
      for (int i = 0; i < G::MT; ++i) {
        const uint64_t da = make_desc(a0 + 2u * ks * plane_bytes + a_tile[i], plane_bytes, 128);
        if (MMA) wgmma<C>(acc[i], da, db, (c | ks) != 0);
      }
    }
    wg_commit();
    wg_wait<1>();
    if (c > 0) release<C, KB, MT>(p, sm, st, rank, q - 1, lag);
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < G::MT; ++i) fence_regs(acc[i]);
  if (n_chunks > 0) release<C, KB, MT>(p, sm, st, rank, q - 1, lag);
}

// One same-length conv over window rows [lo, hi) (dilation d), reading the
// operand planes; then its epilogue, once every product of the conv is done
// (it overwrites the planes the products read):
//   conv1 (RESIDUAL false): planes = round(leaky(conv + bias))          (conv2's operand)
//   conv2 (RESIDUAL true):  h += conv + bias; planes = round(leaky(h))  (the next conv1's)
// Rows whose global step t_base + r lies outside [0, L_out) are zeroed: every
// conv zero-pads its own input.
template <int C, int KB, int MT, bool RESIDUAL>
__device__ __forceinline__ void conv_pass(const Params& p, const Smem& sm, const Stream& st,
                                          int rank, int lag, float (&acc)[Geo<C, KB, MT>::MT][C / 2],
                                          int& q, int lo, int hi, int d,
                                          const float* __restrict__ bias, int t_base,
                                          bool write_planes) {
  using G = Geo<C, KB, MT>;
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int half = (p.kr - 1) / 2;
  const uint32_t plane_bytes = (uint32_t)p.plane_rows * 16;
  bool act[G::MT];
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
    const int r0 = 64 * (wg + 2 * i);
    act[i] = r0 < hi && r0 + 64 > lo;
  }
  gemm<C, KB, MT>(p, sm, st, rank, lag, acc, (p.window + 63) / 64, q, st.cpc, st.nb,
          sm.buf_addr + (uint32_t)p.margin * 16, plane_bytes,
          [&](int tap) { return (tap - half) * d; });
  __syncthreads();
  // stmatrix.x4 stores 8x8 bf16 blocks (n8 blocks jb, jb + 1 x rows 0-7,
  // 8-15 of the warp's 16) from the accumulator layout into the planes; lane
  // l gives the address of row (l & 7) + 8 ((l >> 3) & 1) of block jb + (l >> 4).
  // It writes whole rows: rows of the tile outside [lo, hi) get values no
  // later conv reads for a row it keeps (each reads only its input range).
  const uint32_t st_lane = (uint32_t)((lane & 7) + 8 * ((lane >> 3) & 1)) * 16 +
                           (uint32_t)(lane >> 4) * plane_bytes;
#pragma unroll
  for (int i = 0; i < G::MT; ++i) {
    if (!act[i]) continue;                           // the same for the warpgroup
    const int rt = 64 * (wg + 2 * i) + 16 * wq;      // the warp's 16 rows
    bool in[2], valid[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rt + g + 8 * hh, tg = t_base + r;
      in[hh] = r >= lo && r < hi;
      valid[hh] = in[hh] && tg >= 0 && tg < p.L_out;
    }
    const uint32_t st_addr = sm.buf_addr + (uint32_t)(p.margin + rt) * 16 + st_lane;
#pragma unroll
    for (int jb = 0; jb < C / 8; jb += 2) {
      uint32_t w[2][2];                              // [block jb + e][row half hh]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (jb + e) + 2 * t4;
        const float2 bb = lds_f2(sm.bias_addr + 4u * c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v0 = acc[i][4 * (jb + e) + 2 * hh] + bb.x;
          const float v1 = acc[i][4 * (jb + e) + 2 * hh + 1] + bb.y;
          float o0, o1;
          if (RESIDUAL) {
            const uint32_t ha = sm.h_addr + 4u * (uint32_t)hidx<C>(rt + g + 8 * hh, c);
            float2 h2 = make_float2(0.f, 0.f);
            if (in[hh]) {
              const float2 hv = lds_f2(ha);
              if (valid[hh]) h2 = make_float2(hv.x + v0, hv.y + v1);
              sts_f2(ha, h2);
            }
            o0 = leaky01(h2.x);
            o1 = leaky01(h2.y);
          } else {
            o0 = valid[hh] ? leaky01(v0) : 0.f;
            o1 = valid[hh] ? leaky01(v1) : 0.f;
          }
          w[e][hh] = pack_op2(o0, o1);
        }
      }
      if (!RESIDUAL || write_planes)
        stmatrix_x4(st_addr + (uint32_t)jb * plane_bytes, w[0][0], w[0][1], w[1][0], w[1][1]);
    }
  }
  fence_proxy_async();
  __syncthreads();
}

// The fused ConvTranspose1d on the tensor cores.  Window row r (global step
// t_base + r) has u = t_base + r + pad = s*q + ph and sums, over the taps
// k = ph + s*m, pre-upsample row q - m times tap k.  Per phase ph the rows
// r_ph + s*i (i = 0 .. n_ph-1) are one GEMM of depth (K_up/s)*Cin over the
// pre-upsample planes, tap m the same operand shifted by -m rows.  This CTA
// takes phases rank, rank + n_rb, ...; its epilogue writes each row (+ in_bias;
// 0 outside [0, L_out)) into the h window of every CTA of the cluster.
template <int C, int KB, int MT>
__device__ __forceinline__ void upsample(const Params& p, const Smem& sm, const Stream& st,
                                         int rank, int lag,
                                         float (&acc)[Geo<C, KB, MT>::MT][C / 2], int& q, int t_base,
                                         int jlo) {
  using G = Geo<C, KB, MT>;
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s = p.stride, W = p.window;
  uint32_t hs[kMaxRB];                 // every CTA's h window, in the cluster's shared space
#pragma unroll
  for (int r = 0; r < kMaxRB; ++r) hs[r] = r < p.n_rb ? cluster_addr(sm.h_addr, r) : 0u;
  const uint32_t plane_bytes = (uint32_t)p.np_rows * 16;
  for (int ph = rank; ph < s; ph += p.n_rb) {
    const int r_ph = ((ph - (t_base + p.pad)) % s + s) % s;
    const int n_ph = r_ph < W ? (W - r_ph + s - 1) / s : 0;
    // pre-upsample plane row of the phase's first output row at tap 0 (exact division)
    const int base = (t_base + r_ph + p.pad - ph) / s - jlo;
    bool act[G::MT];
#pragma unroll
    for (int i = 0; i < G::MT; ++i) act[i] = 64 * (wg + 2 * i) < n_ph;
    gemm<C, KB, MT>(p, sm, st, rank, lag, acc, max(1, (n_ph + 63) / 64), q, st.up_cpc, st.nb_up,
            sm.buf_addr, plane_bytes, [&](int m) { return base - m; });
#pragma unroll
    for (int i = 0; i < G::MT; ++i) {
      if (!act[i]) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ir = 64 * (wg + 2 * i) + 16 * wq + g + 8 * hh;
        if (ir >= n_ph) continue;
        const int r = r_ph + s * ir, tg = t_base + r;
        const bool valid = tg >= 0 && tg < p.L_out;
#pragma unroll
        for (int jb = 0; jb < C / 8; ++jb) {
          const int c = 8 * jb + 2 * t4;
          float2 v = make_float2(0.f, 0.f);
          if (valid) {
            const float2 bb = *reinterpret_cast<const float2*>(sm.bias + c);
            v = make_float2(acc[i][4 * jb + 2 * hh] + bb.x, acc[i][4 * jb + 2 * hh + 1] + bb.y);
          }
          const uint32_t off = 4u * (uint32_t)hidx<C>(r, c);
#pragma unroll
          for (int rr = 0; rr < kMaxRB; ++rr)
            if (rr < p.n_rb) st_cluster_f2(hs[rr] + off, v);
        }
      }
    }
  }
}

#if ZV_MRF_F16_STAGED
// The f16-staged mode's pre-upsample rows jlo .. jlo + np_rows - 1 as planes
// of round_f16(leaky_in(x)), rounded with or without leaky_in (f32 rows are
// no f16 values): two 16-byte loads per plane row of 8 channels, kBatch rows
// in flight per thread.
__device__ __forceinline__ void stage_pre_rows_f32(const Params& p, const Smem& sm, int batch,
                                                   int jlo) {
  const float* xb = p.x + (size_t)batch * p.L_in * p.Cin;
  const int n = p.np_rows * (p.Cin / 8);
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float4 v[kBatch][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int pr = e / (p.Cin / 8), g8 = e % (p.Cin / 8), j = jlo + pr;
      v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n && j >= 0 && j < p.L_in) {
        const float4* src = reinterpret_cast<const float4*>(xb + (size_t)j * p.Cin + g8 * 8);
        v[u][0] = __ldg(src);
        v[u][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= n) break;
      const int pr = e / (p.Cin / 8), g8 = e % (p.Cin / 8);
      float f[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                    v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
      if (p.has_in_leaky) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = leaky(f[i], p.in_leaky);
      }
      sts_u4(sm.buf_addr + (uint32_t)g8 * p.np_rows * 16 + (uint32_t)pr * 16,
             make_uint4(pack_op2(f[0], f[1]), pack_op2(f[2], f[3]), pack_op2(f[4], f[5]),
                        pack_op2(f[6], f[7])));
    }
  }
}

// The f16-staged mode's stage input (+ in_bias) into the h window as it is:
// f32 rows, unrounded (no upsample: mrf_stage_unfolded's call).
template <int C>
__device__ __forceinline__ void widen_input_f32(const Params& p, const Smem& sm, int batch,
                                                int t_base) {
  const float* xb = p.x + (size_t)batch * p.L_in * C;
  const int n = p.window * (C / 8);
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float4 v[kBatch][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int tg = t_base + e / (C / 8);
      v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < n && tg >= 0 && tg < p.L_out) {
        const float4* src = reinterpret_cast<const float4*>(xb + (size_t)tg * C + (e % (C / 8)) * 8);
        v[u][0] = __ldg(src);
        v[u][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kThreads;
      if (e >= n) break;
      const int r = e / (C / 8), g8 = e % (C / 8), tg = t_base + r;
      float f[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                    v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
      if (p.in_bias != nullptr && tg >= 0 && tg < p.L_out) {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] += __ldg(p.in_bias + g8 * 8 + i);
      }
      const uint32_t ha = sm.h_addr + 4u * (uint32_t)hidx<C>(r, 8 * g8);
      sts_f4(ha, make_float4(f[0], f[1], f[2], f[3]));
      sts_f4(ha + 16, make_float4(f[4], f[5], f[6], f[7]));
    }
  }
}
#endif

template <int C, int KB, int MT>
__global__ void __launch_bounds__(kThreads, Geo<C, KB, MT>::CTAS) mrf_bf16_kernel(const Params p) {
  using G = Geo<C, KB, MT>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();        // this CTA's resblock
  extern __shared__ __align__(1024) uint8_t smem[];
  const int W = p.window;
  Smem sm;
  sm.buf = smem + p.stages * G::CHUNK;
  sm.h = reinterpret_cast<float*>(sm.buf + p.buf_bytes);
  sm.bias = sm.h + W * C;
  sm.full = reinterpret_cast<uint64_t*>(sm.bias + C);
  sm.released = reinterpret_cast<int*>(sm.full + p.stages);
  sm.ring_addr = smem_addr(smem);
  sm.buf_addr = smem_addr(sm.buf);
  sm.h_addr = smem_addr(sm.h);
  sm.bias_addr = smem_addr(sm.bias);
  const int batch = blockIdx.y;
  const int t0 = (blockIdx.x / p.n_rb) * p.tile;
  const int t_base = t0 - p.halo;

  int n_d = 0, conv_base = 0;
  for (int j = 0; j < p.n_rb; ++j) {
    int nj = 0;
    while (nj < kMaxD && p.dils[j][nj] != 0) ++nj;
    if (j < rank) conv_base += 2 * nj;
    if (j == rank) n_d = nj;
  }
  Stream st;
  st.conv_base = conv_base;
  st.nb = C / G::KB;
  st.cpc = p.kr * st.nb;
  st.nb_up = p.Cin / G::KB;
  st.up_cpc = p.w_up != nullptr ? (p.K_up / p.stride) * st.nb_up : 0;
  st.n_up = p.w_up != nullptr && rank < p.stride
                ? ((p.stride - rank + p.n_rb - 1) / p.n_rb) * st.up_cpc : 0;
  st.n_chunks = st.n_up + 2 * n_d * st.cpc;
  const int lag = p.stages;                           // chunks the ring runs ahead

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(sm.full + s, 1);
      sm.released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < min(lag, st.n_chunks); ++n)   // in flight during the staging
      issue_chunk<C, KB, MT>(p, sm, st, rank, n);
  }
  cluster.sync();                                    // every CTA of the cluster runs

  const int jlo = p.w_up != nullptr ? floordiv(t_base + p.pad - (p.K_up - 1), p.stride) : 0;
#if ZV_MRF_F16_STAGED
  if (p.w_up != nullptr) stage_pre_rows_f32(p, sm, batch, jlo);
  else widen_input_f32<C>(p, sm, batch, t_base);
#else
  if (p.w_up != nullptr) {
    // the pre-upsample rows jlo .. jlo + np_rows - 1 as planes of round(leaky_in(x)),
    // kBatch 16-byte loads in flight per thread
    const bf16* xb = p.x + (size_t)batch * p.L_in * p.Cin;
    const int n = p.np_rows * (p.Cin / 8);
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int pr = e / (p.Cin / 8), g8 = e % (p.Cin / 8), j = jlo + pr;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e < n && j >= 0 && j < p.L_in)
          v[u] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)j * p.Cin + g8 * 8));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= n) break;
        const int pr = e / (p.Cin / 8), g8 = e % (p.Cin / 8);
        uint4 w = v[u];
        if (p.has_in_leaky) {
          const float a = p.in_leaky;
          w = make_uint4(pack_op2(leaky(bf16_lo(w.x), a), leaky(bf16_hi(w.x), a)),
                         pack_op2(leaky(bf16_lo(w.y), a), leaky(bf16_hi(w.y), a)),
                         pack_op2(leaky(bf16_lo(w.z), a), leaky(bf16_hi(w.z), a)),
                         pack_op2(leaky(bf16_lo(w.w), a), leaky(bf16_hi(w.w), a)));
        }
        sts_u4(sm.buf_addr + (uint32_t)g8 * p.np_rows * 16 + (uint32_t)pr * 16, w);
      }
    }
  } else {
    // the stage input (+ in_bias), widened into the h window
    const bf16* xb = p.x + (size_t)batch * p.L_in * C;
    const int n = W * (C / 8);
    for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
      uint4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        const int tg = t_base + e / (C / 8);
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (e < n && tg >= 0 && tg < p.L_out)
          v[u] = __ldg(reinterpret_cast<const uint4*>(xb + (size_t)tg * C + (e % (C / 8)) * 8));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e >= n) break;
        const int r = e / (C / 8), g8 = e % (C / 8), tg = t_base + r;
        float f[8] = {bf16_lo(v[u].x), bf16_hi(v[u].x), bf16_lo(v[u].y), bf16_hi(v[u].y),
                      bf16_lo(v[u].z), bf16_hi(v[u].z), bf16_lo(v[u].w), bf16_hi(v[u].w)};
        if (p.in_bias != nullptr && tg >= 0 && tg < p.L_out) {
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] += __ldg(p.in_bias + g8 * 8 + i);
        }
        const uint32_t ha = sm.h_addr + 4u * (uint32_t)hidx<C>(r, 8 * g8);
        sts_f4(ha, make_float4(f[0], f[1], f[2], f[3]));
        sts_f4(ha + 16, make_float4(f[4], f[5], f[6], f[7]));
      }
    }
  }
#endif
  // the upsample's bias (its epilogue reads it from here)
  for (int c = threadIdx.x; c < C; c += kThreads)
    sm.bias[c] = p.in_bias != nullptr ? __ldg(p.in_bias + c) : 0.f;
  fence_proxy_async();
  __syncthreads();

  float acc[G::MT][C / 2];
  int q = 0;
  if (p.w_up != nullptr) upsample<C, KB, MT>(p, sm, st, rank, lag, acc, q, t_base, jlo);
  cluster.sync();                                    // every h window holds the stage input

  // conv1's operand of the first dilation: round(leaky(h)) as planes
  {
    const uint32_t plane_bytes = (uint32_t)p.plane_rows * 16;
    const int n = W * (C / 8);
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int g8 = e / W, r = e % W;
      const uint32_t ha = sm.h_addr + 4u * (uint32_t)hidx<C>(r, 8 * g8);
      const float4 a = lds_f4(ha), b = lds_f4(ha + 16);
      sts_u4(sm.buf_addr + (uint32_t)g8 * plane_bytes + (uint32_t)(p.margin + r) * 16,
             make_uint4(pack_op2(leaky01(a.x), leaky01(a.y)),
                        pack_op2(leaky01(a.z), leaky01(a.w)),
                        pack_op2(leaky01(b.x), leaky01(b.y)),
                        pack_op2(leaky01(b.z), leaky01(b.w))));
    }
  }
  const int half = (p.kr - 1) / 2;
  int lo = 0, hi = W;
  for (int di = 0; di < n_d; ++di) {
    const int d = p.dils[rank][di];
    const float* b1 = p.b + (size_t)(conv_base + 2 * di) * C;
    const float* b2 = b1 + C;
    // this conv's bias, read by the epilogue from shared memory
    for (int c = threadIdx.x; c < C; c += kThreads) sm.bias[c] = __ldg(b1 + c);
    fence_proxy_async();
    __syncthreads();
    lo += half * d;
    hi -= half * d;
    conv_pass<C, KB, MT, false>(p, sm, st, rank, lag, acc, q, lo, hi, d, b1, t_base, true);
    for (int c = threadIdx.x; c < C; c += kThreads) sm.bias[c] = __ldg(b2 + c);
    __syncthreads();
    lo += half;
    hi -= half;
    conv_pass<C, KB, MT, true>(p, sm, st, rank, lag, acc, q, lo, hi, 1, b2, t_base, di + 1 < n_d);
  }
  cluster.sync();                                    // every resblock's h is final

  // resblock sum over the cluster in rank order; this CTA writes its share of rows
  io_t* yb = p.y + (size_t)batch * p.L_out * C;
  uint32_t hs[kMaxRB];
#pragma unroll
  for (int r = 0; r < kMaxRB; ++r) hs[r] = r < p.n_rb ? cluster_addr(sm.h_addr, r) : 0u;
  const int share = (p.tile + p.n_rb - 1) / p.n_rb;
  const int r_lo = rank * share, r_hi = min(p.tile, r_lo + share);
  for (int e = r_lo * (C / 8) + threadIdx.x; e < r_hi * (C / 8); e += kThreads) {
    const int r = e / (C / 8), g8 = e % (C / 8), tg = t0 + r;
    if (tg >= p.L_out) continue;
    const uint32_t off = 4u * (uint32_t)hidx<C>(p.halo + r, 8 * g8);
    float4 a = ld_cluster_f4(hs[0] + off), b = ld_cluster_f4(hs[0] + off + 16);
#pragma unroll
    for (int j = 1; j < kMaxRB; ++j) {
      if (j >= p.n_rb) break;
      const float4 u = ld_cluster_f4(hs[j] + off), w = ld_cluster_f4(hs[j] + off + 16);
      a.x += u.x; a.y += u.y; a.z += u.z; a.w += u.w;
      b.x += w.x; b.y += w.y; b.z += w.z; b.w += w.w;
    }
    float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] *= p.inv_n;
      if (p.has_out_leaky) v[i] = leaky(v[i], p.out_leaky);
    }
#if ZV_MRF_F16_STAGED
    float4* dst = reinterpret_cast<float4*>(yb + (size_t)tg * C + g8 * 8);   // f32, unrounded
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
#else
    *reinterpret_cast<uint4*>(yb + (size_t)tg * C + g8 * 8) =
        make_uint4(pack_op2(v[0], v[1]), pack_op2(v[2], v[3]), pack_op2(v[4], v[5]),
                   pack_op2(v[6], v[7]));
#endif
  }
  cluster.sync();                                    // no CTA leaves while its h is read
}

// The probe of the shifted no-swizzle descriptor: one warpgroup computes
// D(64 x 32) = A[shift : shift + 64, 0:16] * B(32 x 16)^T of the mode's
// operand type (bf16; f16 in the f16-staged build) with A (rows x 16,
// row-major in global memory) staged as two planes of 8 channels and B as two
// planes of 8 k values per n.  lbo_k: 1 = LBO holds the stride between the k
// halves (planes) and SBO between 8-row groups; 0 = the two swapped.  The
// shared arrays leave room for either reading (they are zeroed first), so
// the wrong assignment gives a wrong product, not a fault.
__global__ void __launch_bounds__(128, 1)
    wgmma_probe_kernel(const op_t* a, const op_t* b, float* d, int rows, int shift, int lbo_k) {
  __shared__ __align__(128) uint8_t sa[16384];
  __shared__ __align__(128) uint8_t sb[4096];
  for (int e = threadIdx.x; e < 16384 / 16; e += 128)
    reinterpret_cast<uint4*>(sa)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < 4096 / 16; e += 128)
    reinterpret_cast<uint4*>(sb)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int e = threadIdx.x; e < 2 * rows; e += 128) {
    const int k8 = e / rows, r = e % rows;
    *reinterpret_cast<uint4*>(sa + k8 * rows * 16 + r * 16) =
        *reinterpret_cast<const uint4*>(a + r * 16 + k8 * 8);
  }
  for (int e = threadIdx.x; e < 2 * 32; e += 128) {
    const int k8 = e / 32, n = e % 32;
    *reinterpret_cast<uint4*>(sb + k8 * 32 * 16 + n * 16) =
        *reinterpret_cast<const uint4*>(b + n * 16 + k8 * 8);
  }
  fence_proxy_async();
  __syncthreads();
  const uint32_t la = rows * 16, lb = 32 * 16;
  const uint64_t da = lbo_k ? raw_desc(smem_addr(sa) + shift * 16, la, 128)
                            : raw_desc(smem_addr(sa) + shift * 16, 128, la);
  const uint64_t db = lbo_k ? raw_desc(smem_addr(sb), lb, 128) : raw_desc(smem_addr(sb), 128, lb);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wg_fence();
  wgmma_n32(acc, da, db, 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int jb = 0; jb < 4; ++jb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh, col = 8 * jb + 2 * t4;
      d[row * 32 + col] = acc[4 * jb + 2 * hh];
      d[row * 32 + col + 1] = acc[4 * jb + 2 * hh + 1];
    }
}

typedef void (*KernelFn)(const Params);

// The instances: (C, KB, MT) = (channels, input channels per weight chunk,
// M-tiles per warpgroup), as ops/cuda/mrf_stage.py's _BF16_KB and _BF16_MT
// list them.
KernelFn pick_kernel(int C, int kb, int mt) {
  if (C == 256 && kb == 16 && mt == 1) return mrf_bf16_kernel<256, 16, 1>;
  if (C == 256 && kb == 64 && mt == 1) return mrf_bf16_kernel<256, 64, 1>;
  if (C == 128 && kb == 32 && mt == 2) return mrf_bf16_kernel<128, 32, 2>;
  if (C == 128 && kb == 128 && mt == 2) return mrf_bf16_kernel<128, 128, 2>;
  if (C == 64 && kb == 64 && mt == 4) return mrf_bf16_kernel<64, 64, 4>;
  if (C == 32 && kb == 32 && mt == 4) return mrf_bf16_kernel<32, 32, 4>;
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

// One set of entries per mode; a library built from this file holds one of them.
#if ZV_MRF_F16_STAGED
#define ZV_STAGE_ENTRY zv_mrf_stage_f16_staged
#define ZV_CLUSTERS_ENTRY zv_mrf_max_clusters_f16_staged
#define ZV_PROBE_ENTRY zv_wgmma_probe_f16
#else
#define ZV_STAGE_ENTRY zv_mrf_stage_bf16
#define ZV_CLUSTERS_ENTRY zv_mrf_max_clusters_bf16
#define ZV_PROBE_ENTRY zv_wgmma_probe
#endif

// kb: the instance's chunk channels (checked); in_bias and b are f32; x and
// y bf16 (f32 in the f16-staged mode), w_up and w bf16 (f16) planes.
extern "C" int ZV_STAGE_ENTRY(
    const io_t* x, const op_t* w_up, const float* in_bias, const op_t* w, const float* b, io_t* y,
    int B, int L_in, int Cin, int C, int L_out, int K_up, int stride, int pad, int has_in_leaky,
    float in_leaky, int has_out_leaky, float out_leaky, int n_rb, int n_dmax, int kr,
    const int* dils, int halo, int tile, int window, int margin, int plane_rows, int np_rows,
    int buf_bytes, int kb, int mt, int stages, int smem_bytes, void* stream) {
  const KernelFn kernel = pick_kernel(C, kb, mt);
  if (kernel == nullptr || n_rb < 1 || n_rb > kMaxRB || n_dmax < 1 ||
      n_dmax > kMaxD || tile < 1 || kr < 1 || kr % 2 != 1 || halo < 0 ||
      window != tile + 2 * halo || window > 128 * mt || stages < 2 || stages > kMaxStages ||
      B < 1 || L_out < 1 || margin < 0 || buf_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // The geometry the host chose must hold the chain: the halo covers each
  // resblock's reach, the margin its largest tap shift, the operand planes
  // every M-tile's shifted rows, the pre-upsample planes every phase's rows,
  // and the buffers fit the shared memory asked for.
  const int half = (kr - 1) / 2;
  const int n_mt = (window + 63) / 64;
  for (int i = 0; i < n_rb; ++i) {
    const int* d = dils + i * n_dmax;
    if (d[0] < 1) return (int)cudaErrorInvalidValue;
    int reach = 0;
    for (int j = 0; j < n_dmax && d[j] != 0; ++j) {
      if (d[j] < 1 || half * d[j] > margin) return (int)cudaErrorInvalidValue;
      reach += half * (d[j] + 1);
    }
    if (reach > halo) return (int)cudaErrorInvalidValue;
  }
  if (plane_rows < 64 * n_mt + 2 * margin || (long long)plane_rows * C * 2 > buf_bytes)
    return (int)cudaErrorInvalidValue;
  if (w_up != nullptr) {
    if (stride < 1 || K_up < stride || K_up % stride != 0 || Cin % kb != 0 ||
        np_rows < K_up / stride + 1 + 64 * (((window + stride - 1) / stride + 63) / 64) ||
        (long long)np_rows * Cin * 2 > buf_bytes)
      return (int)cudaErrorInvalidValue;
  } else if (Cin != C || L_in != L_out) {
    return (int)cudaErrorInvalidValue;
  }
  const long long need = (long long)stages * kb * C * 2 + buf_bytes + 4LL * window * C +
                         4LL * C + 16LL * stages;
  if (smem_bytes < need || smem_bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, w_up, in_bias, w, b, y};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.w_up = w_up; p.in_bias = in_bias; p.w = w; p.b = b; p.y = y;
  p.L_in = L_in; p.Cin = Cin; p.L_out = L_out;
  p.K_up = K_up; p.stride = stride; p.pad = pad;
  p.has_in_leaky = has_in_leaky; p.in_leaky = in_leaky;
  p.has_out_leaky = has_out_leaky; p.out_leaky = out_leaky;
  p.n_rb = n_rb; p.kr = kr;
  for (int i = 0; i < kMaxRB; ++i)
    for (int j = 0; j < kMaxD; ++j)
      p.dils[i][j] = (i < n_rb && j < n_dmax) ? dils[i * n_dmax + j] : 0;
  p.halo = halo; p.tile = tile; p.window = window;
  p.margin = margin; p.plane_rows = plane_rows; p.np_rows = np_rows; p.buf_bytes = buf_bytes;
  p.stages = stages;
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

// Clusters of n_rb CTAs of the (C, mt) instances that the card holds at
// once with smem_bytes of shared memory each (one wave; the same for every
// chunk size); negative: -cudaError_t.
extern "C" int ZV_CLUSTERS_ENTRY(int n_rb, int C, int mt, int smem_bytes) {
  const KernelFn kernel = pick_kernel(C, C == 256 ? 64 : C, mt);
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

// The stage kernel's descriptor field assignment (kLboIsK).
extern "C" int zv_wgmma_lbo_is_k() { return kLboIsK ? 1 : 0; }

// The descriptor probe (above): a (rows x 16) and b (32 x 16) row-major of the
// mode's operand type, d (64 x 32) f32; 0 or a cudaError_t.
extern "C" int ZV_PROBE_ENTRY(const op_t* a, const op_t* b, float* d, int rows, int shift,
                              int lbo_k, void* stream) {
  if (rows < 64 || rows > 136 || shift < 0 || shift + 64 > rows) return (int)cudaErrorInvalidValue;
  wgmma_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, b, d, rows, shift, lbo_k);
  return (int)cudaGetLastError();
}
