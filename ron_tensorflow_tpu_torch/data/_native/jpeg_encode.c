/* Baseline sequential Huffman JPEG encoder (JFIF), the counterpart of
 * `PIL.Image.save(buf, format="JPEG", quality=q)` with Pillow's defaults.
 *
 * It follows libjpeg-turbo's default compression path step for step:
 *   - the fixed-point RGB -> YCbCr of jccolor.c (SCALEBITS 16, the
 *     0.5 - epsilon rounding of Cb and Cr);
 *   - 4:2:0 chroma for 3 components (Y 2x2, Cb and Cr 1x1, libjpeg's
 *     default), by jcsample.c's h2v2 average with its alternating 1, 2
 *     bias; one component (gray) at 1x1;
 *   - the image's last column and row replicated out to whole blocks
 *     (jcsample.c's expand_right_edge, jcprepct.c's expand_bottom_edge),
 *     and the dummy blocks of a partial MCU as jccoefct.c makes them (zero
 *     AC, the DC of the block before);
 *   - the ISLOW forward DCT (jfdctint.c: CONST_BITS 13, PASS1_BITS 2) and
 *     quantization rounded half away from zero (jcdctmgr.c);
 *   - the Annex K quantization tables scaled to the quality as
 *     jpeg_set_quality(quality, force_baseline=TRUE) scales them;
 *   - the Annex K Huffman tables (no optimized coding);
 *   - the markers of jcmarker.c: SOI, JFIF APP0 (1.01, aspect 1:1), DQT,
 *     SOF0, DHT, SOS, EOI.
 *
 * No function keeps global mutable state: each call owns its buffers, so
 * threads may encode in parallel (the ctypes binding releases the GIL).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static const int natural_order[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* Annex K.1, natural order (jcparam.c) */
static const unsigned std_luminance_quant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const unsigned std_chrominance_quant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

/* Annex K.3: code counts by length 1..16, then the symbols */
static const uint8_t dc_luminance_bits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t dc_chrominance_bits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t dc_values[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t ac_luminance_bits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t ac_luminance_values[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};
static const uint8_t ac_chrominance_bits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t ac_chrominance_values[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};

typedef struct {
    const uint8_t *bits;
    const uint8_t *values;
    int n_values;
    uint16_t code[256];
    uint8_t size[256];
} huff_t;

typedef struct {
    uint8_t *buf;
    size_t len, cap;
    uint32_t acc; /* pending bits, right-aligned */
    int n_acc;
    int failed; /* out of memory */
} writer_t;

typedef struct {
    int id, h, v, quant, table; /* table: 0 luminance, 1 chrominance (DC and AC) */
    int width_in_blocks, height_in_blocks;
    int stride, rows; /* the padded plane: whole blocks */
    uint8_t *plane;
    int last_dc;
} component_t;

static void put_byte(writer_t *w, uint8_t b) {
    if (w->len == w->cap) {
        size_t cap = w->cap ? 2 * w->cap : 4096;
        uint8_t *buf = (uint8_t *)realloc(w->buf, cap);
        if (!buf) {
            w->failed = 1;
            return;
        }
        w->buf = buf;
        w->cap = cap;
    }
    w->buf[w->len++] = b;
}

static void put_u16(writer_t *w, unsigned v) {
    put_byte(w, (uint8_t)(v >> 8));
    put_byte(w, (uint8_t)v);
}

/* `size` <= 16 bits of `code`, most significant first; a 0xFF byte is
 * followed by a stuffed 0 (jchuff.c emit_bits) */
static void put_bits(writer_t *w, unsigned code, int size) {
    w->acc = (w->acc << size) | (code & ((1u << size) - 1));
    w->n_acc += size;
    while (w->n_acc >= 8) {
        uint8_t b = (uint8_t)(w->acc >> (w->n_acc - 8));
        put_byte(w, b);
        if (b == 0xFF) put_byte(w, 0);
        w->n_acc -= 8;
    }
    w->acc &= (1u << w->n_acc) - 1;
}

/* jchuff.c flush_bits: pad the last byte with 1 bits */
static void flush_bits(writer_t *w) {
    put_bits(w, 0x7F, 7);
    w->acc = 0;
    w->n_acc = 0;
}

/* canonical codes from the counts by length (jpeg_make_c_derived_tbl) */
static void derive_table(huff_t *t, const uint8_t *bits, const uint8_t *values, int n_values) {
    int k = 0;
    unsigned code = 0;
    t->bits = bits;
    t->values = values;
    t->n_values = n_values;
    memset(t->size, 0, sizeof t->size);
    for (int len = 1; len <= 16; len++) {
        for (int i = 0; i < bits[len - 1]; i++, k++) {
            t->code[values[k]] = (uint16_t)code++;
            t->size[values[k]] = (uint8_t)len;
        }
        code <<= 1;
    }
}

/* jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline) */
static void scaled_quant(unsigned out[64], const unsigned base[64], int quality) {
    long scale = quality < 50 ? 5000L / quality : 200L - 2L * quality;
    for (int i = 0; i < 64; i++) {
        long q = ((long)base[i] * scale + 50L) / 100L;
        out[i] = (unsigned)(q <= 0 ? 1 : q > 255 ? 255 : q);
    }
}

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int32_t)2446)
#define FIX_0_390180644 ((int32_t)3196)
#define FIX_0_541196100 ((int32_t)4433)
#define FIX_0_765366865 ((int32_t)6270)
#define FIX_0_899976223 ((int32_t)7373)
#define FIX_1_175875602 ((int32_t)9633)
#define FIX_1_501321110 ((int32_t)12299)
#define FIX_1_847759065 ((int32_t)15137)
#define FIX_1_961570560 ((int32_t)16069)
#define FIX_2_053119869 ((int32_t)16819)
#define FIX_2_562915447 ((int32_t)20995)
#define FIX_3_072711026 ((int32_t)25172)
#define DESCALE(x, n) (((x) + ((int32_t)1 << ((n)-1))) >> (n))

/* jfdctint.c jpeg_fdct_islow: in place, the output scaled up by 8 */
static void fdct_islow(int32_t *data) {
    int32_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
    for (int pass = 0; pass < 2; pass++) {
        const int step = pass ? 8 : 1;  /* stride between a row's (columns') elements */
        const int next = pass ? 1 : 8;  /* stride between rows (columns) */
        const int shift = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
        int32_t *d = data;
        for (int ctr = 0; ctr < 8; ctr++, d += next) {
            tmp0 = d[0] + d[7 * step];
            tmp7 = d[0] - d[7 * step];
            tmp1 = d[1 * step] + d[6 * step];
            tmp6 = d[1 * step] - d[6 * step];
            tmp2 = d[2 * step] + d[5 * step];
            tmp5 = d[2 * step] - d[5 * step];
            tmp3 = d[3 * step] + d[4 * step];
            tmp4 = d[3 * step] - d[4 * step];

            tmp10 = tmp0 + tmp3;
            tmp13 = tmp0 - tmp3;
            tmp11 = tmp1 + tmp2;
            tmp12 = tmp1 - tmp2;
            if (pass) {
                d[0] = DESCALE(tmp10 + tmp11, PASS1_BITS);
                d[4 * step] = DESCALE(tmp10 - tmp11, PASS1_BITS);
            } else {
                d[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
                d[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
            }
            z1 = (tmp12 + tmp13) * FIX_0_541196100;
            d[2 * step] = DESCALE(z1 + tmp13 * FIX_0_765366865, shift);
            d[6 * step] = DESCALE(z1 + tmp12 * -FIX_1_847759065, shift);

            z1 = tmp4 + tmp7;
            z2 = tmp5 + tmp6;
            z3 = tmp4 + tmp6;
            z4 = tmp5 + tmp7;
            z5 = (z3 + z4) * FIX_1_175875602;
            tmp4 = tmp4 * FIX_0_298631336;
            tmp5 = tmp5 * FIX_2_053119869;
            tmp6 = tmp6 * FIX_3_072711026;
            tmp7 = tmp7 * FIX_1_501321110;
            z1 = z1 * -FIX_0_899976223;
            z2 = z2 * -FIX_2_562915447;
            z3 = z3 * -FIX_1_961570560;
            z4 = z4 * -FIX_0_390180644;
            z3 += z5;
            z4 += z5;
            d[7 * step] = DESCALE(tmp4 + z1 + z3, shift);
            d[5 * step] = DESCALE(tmp5 + z2 + z4, shift);
            d[3 * step] = DESCALE(tmp6 + z2 + z3, shift);
            d[1 * step] = DESCALE(tmp7 + z1 + z4, shift);
        }
    }
}

/* the block at block column bx, block row by of a padded plane -> quantized
 * coefficients in natural order (jcdctmgr.c forward_DCT + quantize) */
static void transform_block(const component_t *c, int bx, int by, const unsigned q[64], int16_t out[64]) {
    int32_t ws[64];
    for (int y = 0; y < 8; y++) {
        const uint8_t *row = c->plane + (size_t)(by * 8 + y) * c->stride + bx * 8;
        for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)row[x] - 128;
    }
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) {
        int32_t qval = (int32_t)q[i] << 3, t = ws[i];
        out[i] = (int16_t)(t < 0 ? -((-t + (qval >> 1)) / qval) : (t + (qval >> 1)) / qval);
    }
}

/* jchuff.c encode_one_block */
static void encode_block(writer_t *w, const int16_t coef[64], int *last_dc, const huff_t *dc, const huff_t *ac) {
    int t = coef[0] - *last_dc, t2 = t, nbits = 0;
    *last_dc = coef[0];
    if (t < 0) {
        t = -t;
        t2--;
    }
    while (t) {
        nbits++;
        t >>= 1;
    }
    put_bits(w, dc->code[nbits], dc->size[nbits]);
    if (nbits) put_bits(w, (unsigned)t2, nbits);
    int run = 0;
    for (int k = 1; k < 64; k++) {
        t = coef[natural_order[k]];
        if (t == 0) {
            run++;
            continue;
        }
        while (run > 15) {
            put_bits(w, ac->code[0xF0], ac->size[0xF0]);
            run -= 16;
        }
        t2 = t;
        if (t < 0) {
            t = -t;
            t2--;
        }
        nbits = 0;
        while (t) {
            nbits++;
            t >>= 1;
        }
        int sym = (run << 4) + nbits;
        put_bits(w, ac->code[sym], ac->size[sym]);
        put_bits(w, (unsigned)t2, nbits);
        run = 0;
    }
    if (run > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static void write_dqt(writer_t *w, int id, const unsigned q[64]) {
    put_byte(w, 0xFF);
    put_byte(w, 0xDB);
    put_u16(w, 67);
    put_byte(w, (uint8_t)id);
    for (int i = 0; i < 64; i++) put_byte(w, (uint8_t)q[natural_order[i]]);
}

static void write_dht(writer_t *w, int cls_id, const huff_t *t) {
    put_byte(w, 0xFF);
    put_byte(w, 0xC4);
    put_u16(w, 2 + 1 + 16 + t->n_values);
    put_byte(w, (uint8_t)cls_id);
    for (int i = 0; i < 16; i++) put_byte(w, t->bits[i]);
    for (int i = 0; i < t->n_values; i++) put_byte(w, t->values[i]);
}

static void headers(writer_t *w, int height, int width, int nc, const component_t *comp, unsigned quant[2][64],
                    const huff_t dc[2], const huff_t ac[2]) {
    static const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    put_u16(w, 0xFFD8);
    put_u16(w, 0xFFE0);
    put_u16(w, 2 + sizeof jfif);
    for (size_t i = 0; i < sizeof jfif; i++) put_byte(w, jfif[i]);
    for (int t = 0; t < (nc == 3 ? 2 : 1); t++) write_dqt(w, t, quant[t]);
    put_u16(w, 0xFFC0);
    put_u16(w, 8 + 3 * nc);
    put_byte(w, 8);
    put_u16(w, (unsigned)height);
    put_u16(w, (unsigned)width);
    put_byte(w, (uint8_t)nc);
    for (int i = 0; i < nc; i++) {
        put_byte(w, (uint8_t)comp[i].id);
        put_byte(w, (uint8_t)((comp[i].h << 4) | comp[i].v));
        put_byte(w, (uint8_t)comp[i].quant);
    }
    for (int t = 0; t < (nc == 3 ? 2 : 1); t++) {
        write_dht(w, 0x00 | t, &dc[t]);
        write_dht(w, 0x10 | t, &ac[t]);
    }
    put_u16(w, 0xFFDA);
    put_u16(w, 6 + 2 * nc);
    put_byte(w, (uint8_t)nc);
    for (int i = 0; i < nc; i++) {
        put_byte(w, (uint8_t)comp[i].id);
        put_byte(w, (uint8_t)((comp[i].table << 4) | comp[i].table));
    }
    put_byte(w, 0);
    put_byte(w, 63);
    put_byte(w, 0);
}

#define SCALEBITS 16
#define ONE_HALF ((int32_t)1 << (SCALEBITS - 1))
#define CBCR_OFFSET ((int32_t)128 << SCALEBITS)
#define FIX(x) ((int32_t)((x) * (1L << SCALEBITS) + 0.5))

/* the component planes, padded to whole blocks: colour conversion
 * (jccolor.c), the right and bottom edges replicated, the chroma averaged
 * 2x2 (jcsample.c h2v2_downsample) */
static int fill_planes(const uint8_t *px, int height, int width, int nc, component_t *comp) {
    for (int i = 0; i < nc; i++) {
        component_t *c = &comp[i];
        c->stride = c->width_in_blocks * 8;
        c->rows = c->height_in_blocks * 8;
        c->plane = (uint8_t *)malloc((size_t)c->stride * c->rows);
        if (!c->plane) return -1;
    }
    if (nc == 1) {
        component_t *c = &comp[0];
        for (int y = 0; y < c->rows; y++) {
            const uint8_t *src = px + (size_t)(y < height ? y : height - 1) * width;
            uint8_t *dst = c->plane + (size_t)y * c->stride;
            for (int x = 0; x < c->stride; x++) dst[x] = src[x < width ? x : width - 1];
        }
        return 0;
    }
    /* full-resolution Cb and Cr, right edge out to the chroma blocks' span
     * (2 samples each), rows out to an even count */
    const int cw = comp[1].width_in_blocks * 16, ch = (height + 1) & ~1;
    uint8_t *cb = (uint8_t *)malloc((size_t)cw * ch), *cr = (uint8_t *)malloc((size_t)cw * ch);
    if (!cb || !cr) {
        free(cb);
        free(cr);
        return -1;
    }
    component_t *yc = &comp[0];
    for (int y = 0; y < height; y++) {
        const uint8_t *src = px + (size_t)y * width * 3;
        uint8_t *dy = yc->plane + (size_t)y * yc->stride;
        uint8_t *db = cb + (size_t)y * cw, *dr = cr + (size_t)y * cw;
        for (int x = 0; x < width; x++) {
            int32_t r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
            dy[x] = (uint8_t)((FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b + ONE_HALF) >> SCALEBITS);
            db[x] = (uint8_t)((-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.50000) * b + CBCR_OFFSET + ONE_HALF - 1)
                              >> SCALEBITS);
            dr[x] = (uint8_t)((FIX(0.50000) * r - FIX(0.41869) * g - FIX(0.08131) * b + CBCR_OFFSET + ONE_HALF - 1)
                              >> SCALEBITS);
        }
        for (int x = width; x < yc->stride; x++) dy[x] = dy[width - 1];
        for (int x = width; x < cw; x++) {
            db[x] = db[width - 1];
            dr[x] = dr[width - 1];
        }
    }
    for (int y = height; y < yc->rows; y++)
        memcpy(yc->plane + (size_t)y * yc->stride, yc->plane + (size_t)(height - 1) * yc->stride, yc->stride);
    if (ch > height) {
        memcpy(cb + (size_t)height * cw, cb + (size_t)(height - 1) * cw, cw);
        memcpy(cr + (size_t)height * cw, cr + (size_t)(height - 1) * cw, cw);
    }
    const int out_rows = ch / 2;
    for (int k = 1; k < 3; k++) {
        component_t *c = &comp[k];
        const uint8_t *full = k == 1 ? cb : cr;
        for (int y = 0; y < c->rows; y++) {
            uint8_t *dst = c->plane + (size_t)y * c->stride;
            if (y >= out_rows) { /* bottom padding: the last row computed */
                memcpy(dst, c->plane + (size_t)(out_rows - 1) * c->stride, c->stride);
                continue;
            }
            const uint8_t *r0 = full + (size_t)(2 * y) * cw, *r1 = r0 + cw;
            int bias = 1;
            for (int x = 0; x < c->stride; x++) {
                dst[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
                bias ^= 3;
            }
        }
    }
    free(cb);
    free(cr);
    return 0;
}

static void encode_scan(writer_t *w, int height, int width, int nc, component_t *comp, unsigned quant[2][64],
                        const huff_t dc[2], const huff_t ac[2]) {
    int16_t blk[64];
    if (nc == 1) { /* non-interleaved: one block an MCU, no dummy blocks */
        component_t *c = &comp[0];
        for (int by = 0; by < c->height_in_blocks; by++)
            for (int bx = 0; bx < c->width_in_blocks; bx++) {
                transform_block(c, bx, by, quant[0], blk);
                encode_block(w, blk, &c->last_dc, &dc[0], &ac[0]);
            }
        return;
    }
    /* interleaved 4:2:0: an MCU is 2x2 Y blocks, then Cb, then Cr (jccoefct.c) */
    const int mcu_cols = (width + 15) / 16, mcu_rows = (height + 15) / 16;
    for (int my = 0; my < mcu_rows; my++)
        for (int mx = 0; mx < mcu_cols; mx++)
            for (int i = 0; i < 3; i++) {
                component_t *c = &comp[i];
                const int t = c->table;
                int16_t prev_dc = 0; /* the DC of the MCU's block before, for the dummy blocks */
                for (int yi = 0; yi < c->v; yi++) {
                    const int by = my * c->v + yi;
                    int16_t row_dc[2];
                    for (int xi = 0; xi < c->h; xi++) {
                        const int bx = mx * c->h + xi;
                        if (by >= c->height_in_blocks) {
                            memset(blk, 0, sizeof blk);
                            blk[0] = row_dc[xi] = prev_dc;
                        } else if (bx >= c->width_in_blocks) {
                            memset(blk, 0, sizeof blk);
                            blk[0] = row_dc[xi] = xi ? row_dc[xi - 1] : prev_dc;
                        } else {
                            transform_block(c, bx, by, quant[t], blk);
                            row_dc[xi] = blk[0];
                        }
                        encode_block(w, blk, &c->last_dc, &dc[t], &ac[t]);
                    }
                    /* a bottom dummy row takes the DC of the last block of the row above */
                    prev_dc = row_dc[c->h - 1];
                }
            }
}

/* uint8 pixels [height, width, channels] (channels 3: RGB, 1: gray) -> a
 * malloc'd JFIF in *out (free with jpeg_free), its length in *out_len.
 * Returns 0, or -1 with a message in err. */
int jpeg_encode(const uint8_t *pixels, int height, int width, int channels, int quality, uint8_t **out,
                size_t *out_len, char *err, size_t err_len) {
    *out = NULL;
    *out_len = 0;
    if (channels != 1 && channels != 3) {
        snprintf(err, err_len, "jpeg_encode takes 1 or 3 channels, got %d", channels);
        return -1;
    }
    if (height < 1 || width < 1 || height > 65535 || width > 65535) {
        snprintf(err, err_len, "jpeg_encode: a baseline JPEG is 1 to 65535 pixels a side, got %dx%d", height, width);
        return -1;
    }
    if (quality < 1 || quality > 100) {
        snprintf(err, err_len, "jpeg_encode: quality must lie in 1..100, got %d", quality);
        return -1;
    }
    unsigned quant[2][64];
    scaled_quant(quant[0], std_luminance_quant, quality);
    scaled_quant(quant[1], std_chrominance_quant, quality);
    huff_t dc[2], ac[2];
    derive_table(&dc[0], dc_luminance_bits, dc_values, 12);
    derive_table(&ac[0], ac_luminance_bits, ac_luminance_values, 162);
    derive_table(&dc[1], dc_chrominance_bits, dc_values, 12);
    derive_table(&ac[1], ac_chrominance_bits, ac_chrominance_values, 162);

    component_t comp[3];
    memset(comp, 0, sizeof comp);
    const int hmax = channels == 3 ? 2 : 1;
    for (int i = 0; i < channels; i++) {
        component_t *c = &comp[i];
        c->id = i + 1;
        c->h = c->v = (i == 0 && channels == 3) ? 2 : 1;
        c->quant = c->table = i ? 1 : 0;
        c->width_in_blocks = (width * c->h + hmax * 8 - 1) / (hmax * 8);
        c->height_in_blocks = (height * c->v + hmax * 8 - 1) / (hmax * 8);
    }
    writer_t w = {0};
    int rc = 0;
    if (fill_planes(pixels, height, width, channels, comp)) {
        snprintf(err, err_len, "jpeg_encode: out of memory for a %dx%d image", height, width);
        rc = -1;
    } else {
        headers(&w, height, width, channels, comp, quant, dc, ac);
        encode_scan(&w, height, width, channels, comp, quant, dc, ac);
        flush_bits(&w);
        put_u16(&w, 0xFFD9);
        if (w.failed) {
            snprintf(err, err_len, "jpeg_encode: out of memory for the output of a %dx%d image", height, width);
            rc = -1;
        }
    }
    for (int i = 0; i < channels; i++) free(comp[i].plane);
    if (rc) {
        free(w.buf);
        return rc;
    }
    *out = w.buf;
    *out_len = w.len;
    return 0;
}

void jpeg_free(void *p) { free(p); }
