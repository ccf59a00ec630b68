/* PNG's scanline filters undone (PNG specification, section 9: None, Sub,
 * Up, Average, Paeth), for `data/png.py`, which parses the chunks and
 * inflates the image data with Python's zlib.
 *
 * `png_unfilter` takes one (sub)image's inflated bytes, `rows` scanlines of
 * a filter-type byte and `stride` bytes each, and writes the `rows * stride`
 * reconstructed bytes to `out`. `bpp` is the bytes of one complete pixel,
 * rounded up to 1 for bit depths below 8, as the specification defines the
 * byte to the left. Each call owns its state: threads may run it in
 * parallel (the ctypes binding releases the GIL).
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

static inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    return (uint8_t)(pb <= pc ? b : c);
}

/* 0 on success; otherwise 1 + the index of the scanline whose filter type is not 0-4 */
int png_unfilter(const uint8_t *data, int rows, size_t stride, int bpp, uint8_t *out) {
    const uint8_t *prev = NULL; /* the reconstructed scanline above, none for the first */
    for (int y = 0; y < rows; y++) {
        const uint8_t *in = data + (size_t)y * (stride + 1);
        uint8_t *o = out + (size_t)y * stride;
        const int type = in[0];
        in++;
        switch (type) {
        case 0:
            for (size_t x = 0; x < stride; x++) o[x] = in[x];
            break;
        case 1:
            for (size_t x = 0; x < stride; x++) o[x] = (uint8_t)(in[x] + (x >= (size_t)bpp ? o[x - bpp] : 0));
            break;
        case 2:
            for (size_t x = 0; x < stride; x++) o[x] = (uint8_t)(in[x] + (prev ? prev[x] : 0));
            break;
        case 3:
            for (size_t x = 0; x < stride; x++) {
                const int a = x >= (size_t)bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
                o[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (size_t x = 0; x < stride; x++) {
                const int a = x >= (size_t)bpp ? o[x - bpp] : 0, b = prev ? prev[x] : 0;
                const int c = prev && x >= (size_t)bpp ? prev[x - bpp] : 0;
                o[x] = (uint8_t)(in[x] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
        prev = o;
    }
    return 0;
}
