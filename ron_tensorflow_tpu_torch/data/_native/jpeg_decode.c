/* Sequential and progressive Huffman JPEG decoder and a uint8 bilinear resize.
 *
 * For hosts that have neither OpenCV nor Pillow. The decoder follows
 * libjpeg-turbo's default decompression path step for step, so that its
 * RGB output equals `cv2.imdecode(..., IMREAD_COLOR)` (converted to RGB)
 * and `PIL.Image.open(...).convert("RGB")` bit for bit:
 *   - SOF0/SOF1 (sequential) and SOF2 (progressive) frames, 8-bit samples,
 *     1 or 3 components with sampling factors 1 or 2; DQT (8- and 16-bit),
 *     DHT, DRI and RSTn; several scans per frame;
 *   - progressive scans as jdphuff.c decodes them: spectral selection and
 *     successive approximation (DC first and refine, AC first and refine,
 *     EOB runs), interleaved DC scans, non-interleaved scans and restart
 *     intervals inside them. A progressive frame's scans put their
 *     coefficients into one buffer for the whole frame, which the IDCT reads
 *     once the data has ended, as jdcoefct.c's multi-scan path does; a
 *     sequential frame's blocks go through the IDCT as they are decoded, as
 *     its single-pass path does. libjpeg-turbo smooths the blocks of
 *     a progressive frame (jdcoefct.c, smoothing_ok) only while some
 *     coefficient bits are still unknown at that point; a complete scan
 *     script leaves none, and a frame that leaves some (truncated, or an
 *     incomplete script) is refused with a message that names the first
 *     missing coefficient, rather than smoothed;
 *   - the ISLOW integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) and
 *     its range limit;
 *   - "fancy" upsampling for h2v1, h1v2 and h2v2 chroma (jdsample.c),
 *     with the image's first and last rows and columns replicated as
 *     jdmainct.c's context rows do;
 *   - the fixed-point YCbCr -> RGB of jdcolor.c (SCALEBITS 16), or no
 *     transform for an Adobe RGB or 'R','G','B' frame (jdapimin.c's guess);
 *   - grayscale expanded to three equal channels.
 * Lossless, hierarchical and arithmetic-coded frames, other sample
 * precisions, sampling factors above 2 (4:1:1) and 2- or 4-component (CMYK,
 * YCCK) images are refused with a message that names them.
 *
 * `resize_bilinear_u8` is OpenCV's cv::resize(INTER_LINEAR) on 8-bit
 * images (imgproc/src/resize.cpp): half-pixel centres, 11-bit fixed-point
 * coefficients (INTER_RESIZE_COEF_BITS) rounded as saturate_cast<short>
 * does, the vertical pass's 16-bit high products, and the 2x2 box average
 * that OpenCV substitutes at an exact factor of two.
 *
 * No function keeps global mutable state: each call owns its buffers, so
 * threads may decode in parallel (the ctypes binding releases the GIL).
 * Compile with -ffp-contract=off: the resize's coefficients are computed
 * in float and must round as OpenCV's do.
 */

#include <math.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define LOOKAHEAD 9

/* zigzag index -> natural (row-major) index, with 16 guard entries as in
 * libjpeg's jpeg_natural_order: a corrupt run past 63 lands on 63 */
static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
    uint8_t look_len[1 << LOOKAHEAD]; /* code length of the code at the top 9 bits, 0 if longer */
    uint8_t look_sym[1 << LOOKAHEAD];
    int32_t maxcode[18]; /* largest code of each length, -1 if none; [17] a sentinel */
    int32_t valoffset[18];
    uint8_t huffval[256];
    int defined;
} huff_t;

typedef struct {
    int id, h, v, tq;
    int width, height; /* the component's own size: ceil(image * factor / max factor) */
    int bw, bh;        /* 8x8 blocks of the padded plane */
    int16_t *coef;     /* progressive: bh * bw blocks of 64 coefficients in natural order */
    uint8_t *plane;    /* bh * 8 rows of bw * 8 samples */
    int16_t quant[64]; /* the table latched at the component's first scan (jdinput.c) */
    int coef_bits[64]; /* progressive: the lowest bit each coefficient is known to, -1 before its first scan */
    int dc_pred, td, ta, decoded;
} comp_t;

typedef struct {
    const uint8_t *data;
    size_t len, pos;
    int16_t quant[4][64]; /* natural order, as libjpeg's 16-bit ISLOW multipliers */
    int quant_defined[4];
    huff_t dc[4], ac[4];
    comp_t comp[3];
    int ncomp, width, height, hmax, vmax, mcux, mcuy, restart_interval;
    int jfif, adobe, adobe_transform, frame, progressive;
    int ss, se, ah, al, eobrun; /* the current scan's spectral band and approximation bits */
    /* bit reader over the entropy-coded segment */
    uint64_t bitbuf; /* next bits at the top */
    int bitcnt, fake_bits, marker;
    size_t bpos;
    char *err;
    size_t errlen;
} dec_t;

static int fail(dec_t *d, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    if (d->errlen) vsnprintf(d->err, d->errlen, fmt, ap);
    va_end(ap);
    return -1;
}

/* ------------------------------------------------------------------------ */
/* markers */

static int read_u8(dec_t *d, int *out) {
    if (d->pos >= d->len) return fail(d, "truncated JPEG: marker segment runs past the end of the data");
    *out = d->data[d->pos++];
    return 0;
}

static int read_u16(dec_t *d, int *out) {
    if (d->pos + 2 > d->len) return fail(d, "truncated JPEG: marker segment runs past the end of the data");
    *out = (d->data[d->pos] << 8) | d->data[d->pos + 1];
    d->pos += 2;
    return 0;
}

/* the next marker code at or after pos (skipping garbage and fill bytes), -1 at the end */
static int next_marker(dec_t *d) {
    for (;;) {
        while (d->pos < d->len && d->data[d->pos] != 0xFF) d->pos++;
        while (d->pos < d->len && d->data[d->pos] == 0xFF) d->pos++;
        if (d->pos >= d->len) return -1;
        int c = d->data[d->pos++];
        if (c != 0) return c;
    }
}

static const char *frame_name(int m) {
    switch (m) {
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "differential sequential (SOF5)";
    case 0xC6: return "differential progressive (SOF6)";
    case 0xC7: return "differential lossless (SOF7)";
    case 0xC9: return "arithmetic-coded sequential (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded differential sequential (SOF13)";
    case 0xCE: return "arithmetic-coded differential progressive (SOF14)";
    case 0xCF: return "arithmetic-coded differential lossless (SOF15)";
    default: return NULL;
    }
}

static int build_huff(dec_t *d, huff_t *t, const uint8_t counts[17], const uint8_t *symbols, int nsym) {
    int code = 0, k = 0;
    memset(t, 0, sizeof(*t));
    memcpy(t->huffval, symbols, (size_t)nsym);
    for (int l = 1; l <= 16; l++) {
        if (counts[l]) {
            t->valoffset[l] = k - code;
            k += counts[l];
            code += counts[l];
            t->maxcode[l] = code - 1;
        } else {
            t->maxcode[l] = -1;
        }
        if (code >= (1 << l) && counts[l]) return fail(d, "bad Huffman table"); /* no all-ones code (jdhuff.c) */
        code <<= 1;
    }
    t->maxcode[17] = 0x7FFFFFFF;
    /* lookahead: every code of length <= 9, at all its 9-bit extensions */
    code = 0;
    k = 0;
    for (int l = 1; l <= LOOKAHEAD; l++) {
        for (int i = 0; i < counts[l]; i++, k++) {
            int lookbits = code << (LOOKAHEAD - l);
            for (int ctr = 1 << (LOOKAHEAD - l); ctr > 0; ctr--, lookbits++) {
                t->look_len[lookbits] = (uint8_t)l;
                t->look_sym[lookbits] = symbols[k];
            }
            code++;
        }
        code <<= 1;
    }
    t->defined = 1;
    return 0;
}

static int parse_dht(dec_t *d) {
    int len = 0;
    if (read_u16(d, &len)) return -1;
    size_t end = d->pos + (size_t)len - 2;
    if (len < 2 || end > d->len) return fail(d, "bad DHT segment length");
    while (d->pos < end) {
        int tc_th = d->data[d->pos++];
        int tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) return fail(d, "bad DHT table class/index %d/%d", tc, th);
        if (d->pos + 16 > end) return fail(d, "bad DHT segment length");
        uint8_t counts[17] = {0};
        int nsym = 0;
        for (int l = 1; l <= 16; l++) nsym += counts[l] = d->data[d->pos++];
        if (nsym > 256 || d->pos + (size_t)nsym > end) return fail(d, "bad DHT symbol count %d", nsym);
        for (int i = 0; !tc && i < nsym; i++)
            if (d->data[d->pos + i] > 15) return fail(d, "bad Huffman table: DC symbol %d", d->data[d->pos + i]);
        if (build_huff(d, tc ? &d->ac[th] : &d->dc[th], counts, d->data + d->pos, nsym)) return -1;
        d->pos += (size_t)nsym;
    }
    return 0;
}

static int parse_dqt(dec_t *d) {
    int len = 0;
    if (read_u16(d, &len)) return -1;
    size_t end = d->pos + (size_t)len - 2;
    if (len < 2 || end > d->len) return fail(d, "bad DQT segment length");
    while (d->pos < end) {
        int pq_tq = d->data[d->pos++];
        int pq = pq_tq >> 4, tq = pq_tq & 15;
        if (pq > 1 || tq > 3) return fail(d, "bad DQT precision/index %d/%d", pq, tq);
        if (d->pos + (size_t)(64 << pq) > end) return fail(d, "bad DQT segment length");
        for (int i = 0; i < 64; i++) {
            int q = pq ? (d->data[d->pos] << 8) | d->data[d->pos + 1] : d->data[d->pos];
            d->pos += (size_t)(1 + pq);
            d->quant[tq][natural_order[i]] = (int16_t)q;
        }
        d->quant_defined[tq] = 1;
    }
    return 0;
}

static int parse_sof(dec_t *d, int progressive) {
    int len = 0, prec = 0, h = 0, w = 0, n = 0;
    if (read_u16(d, &len) || read_u8(d, &prec) || read_u16(d, &h) || read_u16(d, &w) || read_u8(d, &n)) return -1;
    if (d->frame) return fail(d, "more than one frame");
    if (prec != 8) return fail(d, "%d-bit sample precision is not supported (8-bit only)", prec);
    if (h == 0 || w == 0) return fail(d, "image height or width 0 (a DNL marker) is not supported");
    if (n != 1 && n != 3)
        return fail(d, "%d-component JPEG is not supported (1 or 3 components; %s)", n,
                    n == 4 ? "CMYK/YCCK" : "unknown color space");
    if (len != 8 + 3 * n || d->pos + (size_t)(3 * n) > d->len) return fail(d, "bad SOF segment length");
    d->width = w;
    d->height = h;
    d->ncomp = n;
    d->hmax = d->vmax = 1;
    for (int i = 0; i < n; i++) {
        comp_t *c = &d->comp[i];
        c->id = d->data[d->pos];
        c->h = d->data[d->pos + 1] >> 4;
        c->v = d->data[d->pos + 1] & 15;
        c->tq = d->data[d->pos + 2];
        d->pos += 3;
        if (c->h < 1 || c->h > 2 || c->v < 1 || c->v > 2)
            return fail(d, "sampling factors %dx%d are not supported (1 or 2)", c->h, c->v);
        if (c->tq > 3) return fail(d, "bad quantization table index %d", c->tq);
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    d->mcux = (w + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcuy = (h + 8 * d->vmax - 1) / (8 * d->vmax);
    for (int i = 0; i < n; i++) {
        comp_t *c = &d->comp[i];
        c->width = (int)(((long)w * c->h + d->hmax - 1) / d->hmax);
        c->height = (int)(((long)h * c->v + d->vmax - 1) / d->vmax);
        c->bw = d->mcux * c->h;
        c->bh = d->mcuy * c->v;
        c->plane = (uint8_t *)calloc((size_t)c->bw * 8 * (size_t)c->bh * 8, 1);
        if (progressive) c->coef = (int16_t *)calloc((size_t)c->bw * (size_t)c->bh * 64, sizeof(int16_t));
        if (!c->plane || (progressive && !c->coef)) return fail(d, "out of memory");
        for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
    }
    d->frame = 1;
    d->progressive = progressive;
    return 0;
}

static int skip_segment(dec_t *d) {
    int len = 0;
    if (read_u16(d, &len)) return -1;
    if (len < 2 || d->pos + (size_t)len - 2 > d->len) return fail(d, "bad marker segment length");
    d->pos += (size_t)len - 2;
    return 0;
}

static int parse_app(dec_t *d, int marker) {
    int len = 0;
    if (read_u16(d, &len)) return -1;
    if (len < 2 || d->pos + (size_t)len - 2 > d->len) return fail(d, "bad APP segment length");
    const uint8_t *p = d->data + d->pos;
    if (marker == 0xE0 && len >= 2 + 5 && !memcmp(p, "JFIF\0", 5)) d->jfif = 1;
    if (marker == 0xEE && len >= 2 + 12 && !memcmp(p, "Adobe", 5)) {
        d->adobe = 1;
        d->adobe_transform = p[11];
    }
    d->pos += (size_t)len - 2;
    return 0;
}

/* ------------------------------------------------------------------------ */
/* entropy decoding */

static void fill_bits(dec_t *d) {
    while (d->bitcnt <= 56) {
        unsigned b = 0;
        if (!d->marker && d->bpos < d->len) {
            b = d->data[d->bpos++];
            if (b == 0xFF) {
                /* FF 00 is a data byte FF (FF FF ... 00 too, as libjpeg reads it); FF xx a marker */
                while (d->bpos < d->len && d->data[d->bpos] == 0xFF) d->bpos++;
                int c = d->bpos < d->len ? d->data[d->bpos++] : -1;
                if (c != 0) {
                    d->marker = c; /* -1: the data ended */
                    b = 0;
                    d->fake_bits += 8;
                }
            }
        } else {
            d->fake_bits += 8; /* past the segment: zeros, which a valid stream never reads */
        }
        d->bitbuf |= (uint64_t)b << (56 - d->bitcnt);
        d->bitcnt += 8;
    }
}

static inline int get_bits(dec_t *d, int n) {
    if (n == 0) return 0;
    if (d->bitcnt < n) fill_bits(d);
    int v = (int)(d->bitbuf >> (64 - n));
    d->bitbuf <<= n;
    d->bitcnt -= n;
    return v;
}

static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v; }

static int decode_huff(dec_t *d, const huff_t *t, int *sym) {
    if (d->bitcnt < 16) fill_bits(d);
    int look = (int)(d->bitbuf >> (64 - LOOKAHEAD));
    int l = t->look_len[look];
    if (l) {
        d->bitbuf <<= l;
        d->bitcnt -= l;
        *sym = t->look_sym[look];
        return 0;
    }
    l = LOOKAHEAD + 1;
    int code = (int)(d->bitbuf >> (64 - l));
    while (code > t->maxcode[l]) {
        if (++l > 16) return fail(d, "corrupt JPEG data: bad Huffman code");
        code = (int)(d->bitbuf >> (64 - l));
    }
    d->bitbuf <<= l;
    d->bitcnt -= l;
    *sym = t->huffval[(code + t->valoffset[l]) & 0xFF];
    return 0;
}

/* jidctint.c's jpeg_idct_islow for one block, into 8 rows of `stride` samples */
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* the post-IDCT range limit table of jdmaster.c, indexed by (x & 1023) where
 * x is the IDCT output before its +128: wraps as libjpeg's table does */
static inline uint8_t idct_limit(int64_t x) {
    int i = (int)(x & 1023);
    if (i < 128) return (uint8_t)(i + 128);
    if (i < 512) return 255;
    if (i < 896) return 0;
    return (uint8_t)(i - 896);
}

static void idct_islow(const int16_t *coef, const int16_t *quant, uint8_t *out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *in = coef + c;
        const int16_t *q = quant + c;
        int *w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int dc = (int)in[0] * q[0] * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = (int64_t)in[16] * q[16], z3 = (int64_t)in[48] * q[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)in[0] * q[0];
        z3 = (int64_t)in[32] * q[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int64_t)in[56] * q[56];
        tmp1 = (int64_t)in[40] * q[40];
        tmp2 = (int64_t)in[24] * q[24];
        tmp3 = (int64_t)in[8] * q[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * -FIX_0_899976223;
        z2 = z2 * -FIX_2_562915447;
        z3 = z3 * -FIX_1_961570560;
        z4 = z4 * -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
        w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
        w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
        w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
        w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
        w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
        w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
        w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int *w = ws + 8 * r;
        uint8_t *o = out + (size_t)r * stride;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = idct_limit(DESCALE((int64_t)w[0], PASS1_BITS + 3));
            for (int c = 0; c < 8; c++) o[c] = v;
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 = tmp0 * FIX_0_298631336;
        tmp1 = tmp1 * FIX_2_053119869;
        tmp2 = tmp2 * FIX_3_072711026;
        tmp3 = tmp3 * FIX_1_501321110;
        z1 = z1 * -FIX_0_899976223;
        z2 = z2 * -FIX_2_562915447;
        z3 = z3 * -FIX_1_961570560;
        z4 = z4 * -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        o[0] = idct_limit(DESCALE(tmp10 + tmp3, n));
        o[7] = idct_limit(DESCALE(tmp10 - tmp3, n));
        o[1] = idct_limit(DESCALE(tmp11 + tmp2, n));
        o[6] = idct_limit(DESCALE(tmp11 - tmp2, n));
        o[2] = idct_limit(DESCALE(tmp12 + tmp1, n));
        o[5] = idct_limit(DESCALE(tmp12 - tmp1, n));
        o[3] = idct_limit(DESCALE(tmp13 + tmp0, n));
        o[4] = idct_limit(DESCALE(tmp13 - tmp0, n));
    }
}

static inline int16_t *block_at(comp_t *c, int brow, int bcol) {
    return c->coef + ((size_t)brow * c->bw + bcol) * 64;
}

static inline uint8_t *plane_at(comp_t *c, int brow, int bcol) {
    return c->plane + ((size_t)brow * 8 * c->bw + bcol) * 8;
}

/* a sequential scan's block: its 64 coefficients (jdhuff.c decode_mcu),
 * then its IDCT into the plane */
static int decode_block(dec_t *d, comp_t *c, int brow, int bcol) {
    int16_t coef[64];
    int s = 0;
    memset(coef, 0, sizeof(coef));
    if (decode_huff(d, &d->dc[c->td], &s)) return -1;
    if (s) s = extend(get_bits(d, s), s);
    c->dc_pred += s;
    coef[0] = (int16_t)c->dc_pred;
    const huff_t *ac = &d->ac[c->ta];
    for (int k = 1; k < 64; k++) {
        int rs = 0;
        if (decode_huff(d, ac, &rs)) return -1;
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            coef[natural_order[k]] = (int16_t)extend(get_bits(d, s), s);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    idct_islow(coef, c->quant, plane_at(c, brow, bcol), c->bw * 8);
    return 0;
}

/* progressive scans, one block each (jdphuff.c): the DC coefficient's first
 * bits or its next bit; a band's first bits or its next bit, with EOB runs */
static int decode_dc_first(dec_t *d, comp_t *c, int brow, int bcol) {
    int s = 0;
    if (decode_huff(d, &d->dc[c->td], &s)) return -1;
    if (s) s = extend(get_bits(d, s), s);
    c->dc_pred += s;
    block_at(c, brow, bcol)[0] = (int16_t)((unsigned)c->dc_pred << d->al);
    return 0;
}

static int decode_dc_refine(dec_t *d, comp_t *c, int brow, int bcol) {
    if (get_bits(d, 1)) block_at(c, brow, bcol)[0] |= (int16_t)(1 << d->al);
    return 0;
}

static int decode_ac_first(dec_t *d, comp_t *c, int brow, int bcol) {
    if (d->eobrun > 0) {
        d->eobrun--;
        return 0;
    }
    int16_t *coef = block_at(c, brow, bcol);
    const huff_t *ac = &d->ac[c->ta];
    for (int k = d->ss; k <= d->se; k++) {
        int rs = 0;
        if (decode_huff(d, ac, &rs)) return -1;
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            coef[natural_order[k]] = (int16_t)((unsigned)extend(get_bits(d, s), s) << d->al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = 1 << r;
            if (r) d->eobrun += get_bits(d, r);
            d->eobrun--;
            break;
        }
    }
    return 0;
}

/* a correction bit for a coefficient that is already nonzero */
static inline void refine_bit(dec_t *d, int16_t *coef, int p1) {
    if (get_bits(d, 1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef - p1);
}

static int decode_ac_refine(dec_t *d, comp_t *c, int brow, int bcol) {
    int16_t *coef = block_at(c, brow, bcol);
    const int p1 = 1 << d->al;
    int k = d->ss;
    if (d->eobrun == 0) {
        const huff_t *ac = &d->ac[c->ta];
        for (; k <= d->se; k++) {
            int rs = 0;
            if (decode_huff(d, ac, &rs)) return -1;
            int r = rs >> 4, s = rs & 15;
            if (s) { /* a newly nonzero coefficient of magnitude p1 (libjpeg warns where s != 1) */
                s = get_bits(d, 1) ? p1 : -p1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) d->eobrun += get_bits(d, r);
                break; /* the rest of the band: below, with the EOB run */
            }
            /* skip r still-zero coefficients, refining the nonzero ones on the way */
            do {
                int16_t *t = coef + natural_order[k];
                if (*t != 0) refine_bit(d, t, p1);
                else if (--r < 0) break;
                k++;
            } while (k <= d->se);
            if (s) coef[natural_order[k]] = (int16_t)s;
        }
    }
    if (d->eobrun > 0) {
        for (; k <= d->se; k++) {
            int16_t *t = coef + natural_order[k];
            if (*t != 0) refine_bit(d, t, p1);
        }
        d->eobrun--;
    }
    return 0;
}

typedef int (*block_fn)(dec_t *, comp_t *, int, int);

/* after a restart interval: drop the padding bits, expect RSTn, reset the DC predictions */
static int restart(dec_t *d, comp_t **sc, int ns) {
    if (!d->marker) {
        size_t p = d->bpos;
        while (p + 1 < d->len && !(d->data[p] == 0xFF && d->data[p + 1] != 0 && d->data[p + 1] != 0xFF)) p++;
        if (p + 1 >= d->len) return fail(d, "truncated JPEG: no RST marker after a restart interval");
        d->marker = d->data[p + 1];
        d->bpos = p + 2;
    }
    if (d->marker < 0xD0 || d->marker > 0xD7)
        return fail(d, "corrupt JPEG data: marker 0x%02X where an RST marker was expected", d->marker & 0xFF);
    d->marker = 0;
    d->bitbuf = 0;
    d->bitcnt = 0;
    d->fake_bits = 0;
    d->eobrun = 0;
    for (int i = 0; i < ns; i++) sc[i]->dc_pred = 0;
    return 0;
}

static int parse_sos_and_decode(dec_t *d) {
    int len = 0, ns = 0;
    if (read_u16(d, &len) || read_u8(d, &ns)) return -1;
    if (!d->frame) return fail(d, "scan before the frame header");
    if (ns < 1 || ns > d->ncomp || len != 6 + 2 * ns || d->pos + (size_t)(2 * ns + 3) > d->len)
        return fail(d, "bad SOS segment");
    comp_t *sc[3];
    const uint8_t *ids = d->data + d->pos;
    d->ss = ids[2 * ns];
    d->se = ids[2 * ns + 1];
    d->ah = ids[2 * ns + 2] >> 4;
    d->al = ids[2 * ns + 2] & 15;
    block_fn fn = decode_block;
    if (d->progressive) { /* the checks of jdphuff.c start_pass_phuff_decoder */
        const int dc = d->ss == 0;
        if (dc ? d->se != 0 : (d->se < d->ss || d->se > 63 || ns != 1))
            return fail(d, "bad progressive scan: band %d..%d over %d components", d->ss, d->se, ns);
        if ((d->ah != 0 && d->al != d->ah - 1) || d->al > 13)
            return fail(d, "bad progressive scan: successive approximation Ah=%d Al=%d", d->ah, d->al);
        fn = dc ? (d->ah ? decode_dc_refine : decode_dc_first) : (d->ah ? decode_ac_refine : decode_ac_first);
    }
    for (int i = 0; i < ns; i++) {
        int id = ids[2 * i], tables = ids[2 * i + 1];
        sc[i] = NULL;
        for (int j = 0; j < d->ncomp; j++)
            if (d->comp[j].id == id) sc[i] = &d->comp[j];
        if (!sc[i]) return fail(d, "scan names an unknown component %d", id);
        sc[i]->td = tables >> 4;
        sc[i]->ta = tables & 15;
        /* tables a scan reads: DC for sequential scans and DC first, AC for sequential and AC scans */
        const int need_dc = !d->progressive || (d->ss == 0 && d->ah == 0);
        const int need_ac = !d->progressive || d->ss > 0;
        if (sc[i]->td > 3 || sc[i]->ta > 3 || (need_dc && !d->dc[sc[i]->td].defined) ||
            (need_ac && !d->ac[sc[i]->ta].defined))
            return fail(d, "scan uses an undefined Huffman table");
        if (!sc[i]->decoded) {
            if (!d->quant_defined[sc[i]->tq]) return fail(d, "component uses an undefined quantization table");
            memcpy(sc[i]->quant, d->quant[sc[i]->tq], sizeof(sc[i]->quant));
        }
        if (d->progressive) { /* each coefficient's bits must arrive in order (jdphuff.c's progression check) */
            if (d->ss > 0 && sc[i]->coef_bits[0] < 0)
                return fail(d, "bad progression: an AC scan of component %d before its DC scan", id);
            for (int k = d->ss; k <= d->se; k++) {
                const int known = sc[i]->coef_bits[k];
                if (d->ah != (known < 0 ? 0 : known))
                    return fail(d, "bad progression: component %d coefficient %d refined at bit %d, known to bit %d",
                                id, k, d->ah, known);
                sc[i]->coef_bits[k] = d->al;
            }
        }
        sc[i]->dc_pred = 0;
        sc[i]->decoded = 1;
    }
    d->pos += 2 * (size_t)ns + 3;
    d->bitbuf = 0;
    d->bitcnt = 0;
    d->fake_bits = 0;
    d->marker = 0;
    d->eobrun = 0;
    d->bpos = d->pos;

    long n_mcu, mcu_per_row;
    if (ns == 1) { /* a non-interleaved scan: one block an MCU, over the component's own blocks */
        mcu_per_row = (sc[0]->width + 7) / 8;
        n_mcu = mcu_per_row * ((sc[0]->height + 7) / 8);
    } else {
        mcu_per_row = d->mcux;
        n_mcu = (long)d->mcux * d->mcuy;
    }
    for (long m = 0; m < n_mcu; m++) {
        if (d->restart_interval && m > 0 && m % d->restart_interval == 0 && restart(d, sc, ns)) return -1;
        long my = m / mcu_per_row, mx = m % mcu_per_row;
        if (ns == 1) {
            if (fn(d, sc[0], (int)my, (int)mx)) return -1;
        } else {
            for (int i = 0; i < ns; i++)
                for (int by = 0; by < sc[i]->v; by++)
                    for (int bx = 0; bx < sc[i]->h; bx++)
                        if (fn(d, sc[i], (int)my * sc[i]->v + by, (int)mx * sc[i]->h + bx)) return -1;
        }
        if (d->bitcnt < d->fake_bits) return fail(d, "truncated JPEG: the scan's data ends early");
    }
    /* resume marker parsing at the marker that ended the segment */
    if (d->marker > 0) {
        d->pos = d->bpos - 2;
    } else {
        d->pos = d->bpos;
    }
    return 0;
}

/* ------------------------------------------------------------------------ */
/* upsampling (jdsample.c) and color conversion (jdcolor.c) */

/* the component's plane at the image's full resolution, into `out` (H x W) */
static int upsample(dec_t *d, const comp_t *c, uint8_t *out) {
    const int W = d->width, H = d->height, cw = c->width, ch = c->height, stride = c->bw * 8;
    const int sx = d->hmax / c->h, sy = d->vmax / c->v; /* 1 or 2 each */
    uint8_t *row = (uint8_t *)malloc((size_t)2 * cw + 2);
    if (!row) return fail(d, "out of memory");
    for (int y = 0; y < H; y++) {
        const int r = y / sy;
        const uint8_t *in0 = c->plane + (size_t)r * stride;
        uint8_t *o = out + (size_t)y * W;
        if (sx == 1 && sy == 1) {
            memcpy(o, in0, (size_t)W);
            continue;
        }
        if (sy == 2) {
            /* the nearer row, and the farther one above (even output rows) or below (odd) */
            const int v = y & 1;
            const int rn = v ? (r + 1 < ch ? r + 1 : ch - 1) : (r > 0 ? r - 1 : 0);
            const uint8_t *in1 = c->plane + (size_t)rn * stride;
            if (sx == 1) { /* h1v2 */
                const int bias = v ? 2 : 1;
                for (int x = 0; x < W; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
                continue;
            }
            if (cw > 2) { /* h2v2 fancy */
                int this_sum = in0[0] * 3 + in1[0], next_sum = in0[1] * 3 + in1[1], last_sum;
                row[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
                row[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
                last_sum = this_sum;
                this_sum = next_sum;
                for (int i = 2; i < cw; i++) {
                    next_sum = in0[i] * 3 + in1[i];
                    row[2 * i - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
                    row[2 * i - 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
                    last_sum = this_sum;
                    this_sum = next_sum;
                }
                row[2 * cw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
                row[2 * cw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
            } else { /* h2v2 box: libjpeg's plain replication at widths <= 2 */
                for (int i = 0; i < cw; i++) row[2 * i] = row[2 * i + 1] = in0[i];
            }
            memcpy(o, row, (size_t)W);
            continue;
        }
        /* h2v1 */
        if (cw > 2) {
            row[0] = in0[0];
            row[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
            for (int i = 1; i < cw - 1; i++) {
                int v3 = in0[i] * 3;
                row[2 * i] = (uint8_t)((v3 + in0[i - 1] + 1) >> 2);
                row[2 * i + 1] = (uint8_t)((v3 + in0[i + 1] + 2) >> 2);
            }
            row[2 * cw - 2] = (uint8_t)((in0[cw - 1] * 3 + in0[cw - 2] + 1) >> 2);
            row[2 * cw - 1] = in0[cw - 1];
        } else {
            for (int i = 0; i < cw; i++) row[2 * i] = row[2 * i + 1] = in0[i];
        }
        memcpy(o, row, (size_t)W);
    }
    free(row);
    return 0;
}

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

static void to_rgb(const dec_t *d, uint8_t *planes[3], uint8_t *out) {
    const size_t n = (size_t)d->width * d->height;
    if (d->ncomp == 1) {
        for (size_t i = 0; i < n; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[0][i];
        return;
    }
    int rgb = d->jfif ? 0 : d->adobe ? d->adobe_transform == 0
                                     : (d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66);
    if (rgb) {
        for (size_t i = 0; i < n; i++) {
            out[3 * i] = planes[0][i];
            out[3 * i + 1] = planes[1][i];
            out[3 * i + 2] = planes[2][i];
        }
        return;
    }
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
        cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        cr_g[i] = -FIX(0.71414) * x;
        cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
#undef FIX
    for (size_t i = 0; i < n; i++) {
        int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
        out[3 * i] = clamp255(y + cr_r[cr]);
        out[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        out[3 * i + 2] = clamp255(y + cb_b[cb]);
    }
}

/* ------------------------------------------------------------------------ */

static int decode(dec_t *d, uint8_t *out, int out_h, int out_w) {
    if (d->len < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8) return fail(d, "not a JPEG (no SOI marker)");
    d->pos = 2;
    int scans = 0;
    for (;;) {
        int m = next_marker(d);
        if (m < 0 || m == 0xD9) break; /* EOI, or the data ends */
        const char *unsupported = frame_name(m);
        if (unsupported) return fail(d, "%s JPEG is not supported (Huffman sequential or progressive only)", unsupported);
        int rc;
        if (m == 0xC0 || m == 0xC1 || m == 0xC2) rc = parse_sof(d, m == 0xC2);
        else if (m == 0xC4) rc = parse_dht(d);
        else if (m == 0xDB) rc = parse_dqt(d);
        else if (m == 0xDD) {
            int len = 0;
            rc = read_u16(d, &len) || read_u16(d, &d->restart_interval);
        } else if (m == 0xDA) {
            rc = parse_sos_and_decode(d);
            scans++;
        } else if (m >= 0xE0 && m <= 0xEF) rc = parse_app(d, m);
        else if ((m >= 0xD0 && m <= 0xD8) || m == 0x01) rc = 0; /* no segment */
        else rc = skip_segment(d);
        if (rc) return -1;
    }
    if (!d->frame) return fail(d, "no frame header (SOF) in the JPEG");
    if (!scans) return fail(d, "no scan in the JPEG");
    for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        if (!c->decoded) return fail(d, "component %d has no scan", c->id);
        for (int k = 0; d->progressive && k < 64; k++)
            if (c->coef_bits[k] < 0)
                return fail(d, "incomplete progressive JPEG: component %d coefficient %d has no scan "
                            "(libjpeg-turbo would smooth the blocks)", c->id, k);
            else if (c->coef_bits[k] > 0)
                return fail(d, "incomplete progressive JPEG: component %d coefficient %d lacks its lowest %d "
                            "bits (libjpeg-turbo would smooth the blocks)", c->id, k, c->coef_bits[k]);
    }
    if (d->height != out_h || d->width != out_w)
        return fail(d, "frame is %dx%d, the output %dx%d", d->height, d->width, out_h, out_w);
    for (int i = 0; d->progressive && i < d->ncomp; i++) { /* the IDCT of every buffered block (jdcoefct.c) */
        comp_t *c = &d->comp[i];
        for (int by = 0; by < c->bh; by++)
            for (int bx = 0; bx < c->bw; bx++) idct_islow(block_at(c, by, bx), c->quant, plane_at(c, by, bx), c->bw * 8);
    }

    const size_t n = (size_t)d->width * d->height;
    uint8_t *planes[3] = {NULL, NULL, NULL};
    int rc = 0;
    for (int i = 0; i < d->ncomp && !rc; i++) {
        planes[i] = (uint8_t *)malloc(n);
        if (!planes[i]) rc = fail(d, "out of memory");
        else rc = upsample(d, &d->comp[i], planes[i]);
    }
    if (!rc) to_rgb(d, planes, out);
    for (int i = 0; i < 3; i++) free(planes[i]);
    return rc;
}

/* Decode `len` bytes of a JPEG into `out`, an RGB [out_h, out_w, 3] uint8
 * buffer whose size the caller read from the header. 0 on success; -1 with
 * a message in `err` otherwise. */
int jpeg_decode_rgb(const uint8_t *data, size_t len, uint8_t *out, int out_h, int out_w, char *err, size_t errlen) {
    dec_t *d = (dec_t *)calloc(1, sizeof(dec_t));
    if (!d) {
        if (errlen) snprintf(err, errlen, "out of memory");
        return -1;
    }
    d->data = data;
    d->len = len;
    d->err = err;
    d->errlen = errlen;
    if (errlen) err[0] = 0;
    int rc = decode(d, out, out_h, out_w);
    for (int i = 0; i < 3; i++) {
        free(d->comp[i].plane);
        free(d->comp[i].coef);
    }
    free(d);
    return rc;
}

/* ------------------------------------------------------------------------ */
/* cv::resize(INTER_LINEAR) on uint8 images of `cn` interleaved channels */

#define COEF_BITS 11
#define COEF_SCALE (1 << COEF_BITS)

static int cv_floor(float v) {
    int i = (int)v;
    return i - (i > v);
}

int resize_bilinear_u8(const uint8_t *src, int sh, int sw, uint8_t *dst, int dh, int dw, int cn) {
    if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || cn <= 0) return -1;
    if (sh == dh && sw == dw) {
        memcpy(dst, src, (size_t)sh * sw * cn);
        return 0;
    }
    const double scale_x = 1. / ((double)dw / sw), scale_y = 1. / ((double)dh / sh);
    if (scale_x == 2.0 && scale_y == 2.0 && (cn == 1 || cn == 3 || cn == 4)) {
        /* OpenCV's INTER_AREA fast path, which it takes for INTER_LINEAR at an exact 2x */
        for (int y = 0; y < dh; y++) {
            const uint8_t *s0 = src + (size_t)(2 * y) * sw * cn, *s1 = s0 + (size_t)sw * cn;
            uint8_t *o = dst + (size_t)y * dw * cn;
            for (int x = 0; x < dw; x++)
                for (int k = 0; k < cn; k++) {
                    int i = 2 * x * cn + k;
                    o[x * cn + k] = (uint8_t)((s0[i] + s0[i + cn] + s1[i] + s1[i + cn] + 2) >> 2);
                }
        }
        return 0;
    }
    int *xofs = (int *)malloc(sizeof(int) * (size_t)dw);
    int16_t *alpha = (int16_t *)malloc(sizeof(int16_t) * 2 * (size_t)dw);
    int *rows = (int *)malloc(sizeof(int) * 2 * (size_t)dw * cn);
    if (!xofs || !alpha || !rows) {
        free(xofs);
        free(alpha);
        free(rows);
        return -1;
    }
    int xmax = dw;
    for (int dx = 0; dx < dw; dx++) {
        float fx = (float)((dx + 0.5) * scale_x - 0.5);
        int sx = cv_floor(fx);
        fx -= sx;
        if (sx < 0) {
            fx = 0;
            sx = 0;
        }
        if (sx + 1 >= sw) {
            if (dx < xmax) xmax = dx;
            if (sx >= sw - 1) {
                fx = 0;
                sx = sw - 1;
            }
        }
        xofs[dx] = sx;
        alpha[2 * dx] = (int16_t)lrintf((1.f - fx) * COEF_SCALE);
        alpha[2 * dx + 1] = (int16_t)lrintf(fx * COEF_SCALE);
    }
    int prev_sy[2] = {-1, -1};
    for (int dy = 0; dy < dh; dy++) {
        float fy = (float)((dy + 0.5) * scale_y - 0.5);
        int sy = cv_floor(fy);
        fy -= sy;
        const int b0 = (int16_t)lrintf((1.f - fy) * COEF_SCALE), b1 = (int16_t)lrintf(fy * COEF_SCALE);
        for (int k = 0; k < 2; k++) {
            int r = sy + k;
            r = r < 0 ? 0 : r >= sh ? sh - 1 : r;
            if (r == prev_sy[k]) continue;
            if (k == 0 && r == prev_sy[1]) { /* the row below became the row above */
                memcpy(rows, rows + (size_t)dw * cn, sizeof(int) * (size_t)dw * cn);
                prev_sy[0] = r;
                continue;
            }
            const uint8_t *s = src + (size_t)r * sw * cn;
            int *o = rows + (size_t)k * dw * cn;
            for (int dx = 0; dx < dw; dx++) {
                const int x0 = xofs[dx] * cn;
                if (dx < xmax) {
                    const int a0 = alpha[2 * dx], a1 = alpha[2 * dx + 1];
                    for (int c = 0; c < cn; c++) o[dx * cn + c] = s[x0 + c] * a0 + s[x0 + cn + c] * a1;
                } else {
                    for (int c = 0; c < cn; c++) o[dx * cn + c] = s[x0 + c] * COEF_SCALE;
                }
            }
            prev_sy[k] = r;
        }
        uint8_t *o = dst + (size_t)dy * dw * cn;
        const int *r0 = rows, *r1 = rows + (size_t)dw * cn;
        for (int i = 0; i < dw * cn; i++)
            o[i] = (uint8_t)((((b0 * (r0[i] >> 4)) >> 16) + ((b1 * (r1[i] >> 4)) >> 16) + 2) >> 2);
    }
    free(xofs);
    free(alpha);
    free(rows);
    return 0;
}
