/* CRC32C (Castagnoli) for TFRecord framing: host code, not a device kernel.
 *
 * Slice-by-8 over a table built once by hgn_crc32c_init, which the loader
 * (data/tfrecord.py) calls under a lock before any hgn_crc32c call.  Plain C
 * interface, bound with ctypes; built by the host compiler at first use
 * (ops/build.load_host).
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static uint32_t table[8][256];

void hgn_crc32c_init(void) {
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
        table[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = table[0][i];
        for (int t = 1; t < 8; t++) {
            c = table[0][c & 0xFF] ^ (c >> 8);
            table[t][i] = c;
        }
    }
}

uint32_t hgn_crc32c(const uint8_t *data, size_t len) {
    uint32_t crc = 0xFFFFFFFFu;
    while (len >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, data, 4);
        memcpy(&hi, data + 4, 4);
        crc ^= lo;
        crc = table[7][crc & 0xFF] ^ table[6][(crc >> 8) & 0xFF] ^
              table[5][(crc >> 16) & 0xFF] ^ table[4][crc >> 24] ^
              table[3][hi & 0xFF] ^ table[2][(hi >> 8) & 0xFF] ^
              table[1][(hi >> 16) & 0xFF] ^ table[0][hi >> 24];
        data += 8;
        len -= 8;
    }
    while (len--) crc = table[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return crc ^ 0xFFFFFFFFu;
}
