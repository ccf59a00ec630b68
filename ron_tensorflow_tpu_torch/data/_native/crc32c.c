/* crc32c (Castagnoli, reflected 0x82F63B78) — slice-by-8 table kernel.
 *
 * Native replacement for the per-byte Python loop in data/tfrecord.py:
 * TFRecord framing checksums every record (write side) and optionally
 * verifies on read; at VOC-convert scale (~22k JPEG records, ~100 KB each)
 * the Python loop costs minutes while this runs at ~GB/s. Loaded via
 * ctypes (see data/native.py); the pure-Python path remains as fallback.
 *
 * Reference behavior: TF's Hadoop-style masked crc32c framing
 * (ref: tensorflow record_writer framing used by
 * datasets/pascalvoc_to_tfrecords.py — byte-compatible either way).
 */

#include <stddef.h>
#include <stdint.h>

static uint32_t table[8][256];
static int initialized = 0;

static void init_tables(void) {
    const uint32_t poly = 0x82F63B78u;
    for (int i = 0; i < 256; i++) {
        uint32_t crc = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            crc = (crc >> 1) ^ (crc & 1 ? poly : 0);
        table[0][i] = crc;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t crc = table[0][i];
        for (int t = 1; t < 8; t++) {
            crc = table[0][crc & 0xFF] ^ (crc >> 8);
            table[t][i] = crc;
        }
    }
    initialized = 1;
}

uint32_t crc32c(const uint8_t *buf, size_t len, uint32_t seed) {
    if (!initialized) init_tables();
    uint32_t crc = seed ^ 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo = (uint32_t)buf[0] | ((uint32_t)buf[1] << 8) |
                      ((uint32_t)buf[2] << 16) | ((uint32_t)buf[3] << 24);
        uint32_t hi = (uint32_t)buf[4] | ((uint32_t)buf[5] << 8) |
                      ((uint32_t)buf[6] << 16) | ((uint32_t)buf[7] << 24);
        lo ^= crc;
        crc = table[7][lo & 0xFF] ^ table[6][(lo >> 8) & 0xFF] ^
              table[5][(lo >> 16) & 0xFF] ^ table[4][(lo >> 24) & 0xFF] ^
              table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
              table[1][(hi >> 16) & 0xFF] ^ table[0][(hi >> 24) & 0xFF];
        buf += 8;
        len -= 8;
    }
    while (len--) crc = table[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}

/* Scan TFRecord framing in a memory buffer: fills offsets[i]/lengths[i] for
 * up to max_records payload spans, verifying both masked CRCs per record.
 * Returns the number of records found, or -(byte_position+1) on the first
 * corrupt record. */
int64_t scan_records(const uint8_t *buf, int64_t size, int verify,
                     int64_t *offsets, int64_t *lengths,
                     int64_t max_records) {
    const uint32_t mask_delta = 0xA282EAD8u;
    int64_t pos = 0, n = 0;
    while (pos + 12 <= size && n < max_records) {
        uint64_t len = 0;
        for (int i = 0; i < 8; i++) len |= (uint64_t)buf[pos + i] << (8 * i);
        if (pos + 12 + (int64_t)len + 4 > size) return -(pos + 1); /* truncated */
        if (verify) {
            uint32_t hcrc = (uint32_t)buf[pos + 8] |
                            ((uint32_t)buf[pos + 9] << 8) |
                            ((uint32_t)buf[pos + 10] << 16) |
                            ((uint32_t)buf[pos + 11] << 24);
            uint32_t c = crc32c(buf + pos, 8, 0);
            c = (((c >> 15) | (c << 17)) + mask_delta);
            if (c != hcrc) return -(pos + 1);
            const uint8_t *d = buf + pos + 12;
            uint32_t dcrc = (uint32_t)d[len] | ((uint32_t)d[len + 1] << 8) |
                            ((uint32_t)d[len + 2] << 16) |
                            ((uint32_t)d[len + 3] << 24);
            uint32_t cd = crc32c(d, (size_t)len, 0);
            cd = (((cd >> 15) | (cd << 17)) + mask_delta);
            if (cd != dcrc) return -(pos + 1);
        }
        offsets[n] = pos + 12;
        lengths[n] = (int64_t)len;
        n++;
        pos += 12 + (int64_t)len + 4;
    }
    return n;
}
