/* CRC32-Castagnoli for the needle read/write path.
 *
 * Host replacement for the reference's klauspost/crc32 SSE4.2
 * dependency (weed/storage/needle/crc.go). Hardware CRC32C via SSE4.2 when
 * the CPU supports it, slicing-by-8 table fallback otherwise.
 *
 * Built by seaweedfs_tpu_torch/native/build.py, with gf256.c and
 * needle_map.c, into seaweedfs_tpu_torch/_build/libswtpu_native-<hash>.so
 */

#include <stdint.h>
#include <stddef.h>

#if defined(__x86_64__) || defined(__i386__)
#include <nmmintrin.h>
#define HAVE_SSE42_INTRIN 1
#endif

/* built with g++: exported symbols must not be C++-mangled or the ctypes
 * lookup in build.py fails and the whole library silently degrades to the
 * pure-Python fallbacks */
#ifdef __cplusplus
extern "C" {
#endif

#define POLY 0x82f63b78u /* reflected Castagnoli */

static uint32_t table[8][256];
static int table_ready = 0;

static void init_table(void) {
    for (int i = 0; i < 256; i++) {
        uint32_t c = (uint32_t)i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? (POLY ^ (c >> 1)) : (c >> 1);
        table[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = table[0][i];
        for (int s = 1; s < 8; s++) {
            c = table[0][c & 0xff] ^ (c >> 8);
            table[s][i] = c;
        }
    }
    table_ready = 1;
}

static uint32_t crc32c_sw(uint32_t crc, const uint8_t *buf, size_t len) {
    if (!table_ready) init_table();
    crc = ~crc;
    while (len && ((uintptr_t)buf & 7)) {
        crc = table[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
        len--;
    }
    while (len >= 8) {
        uint64_t w;
        __builtin_memcpy(&w, buf, 8);
        w ^= crc;
        crc = table[7][w & 0xff] ^ table[6][(w >> 8) & 0xff] ^
              table[5][(w >> 16) & 0xff] ^ table[4][(w >> 24) & 0xff] ^
              table[3][(w >> 32) & 0xff] ^ table[2][(w >> 40) & 0xff] ^
              table[1][(w >> 48) & 0xff] ^ table[0][(w >> 56) & 0xff];
        buf += 8;
        len -= 8;
    }
    while (len--) crc = table[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
    return ~crc;
}

#ifdef HAVE_SSE42_INTRIN
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t *buf, size_t len) {
    crc = ~crc;
    while (len && ((uintptr_t)buf & 7)) {
        crc = _mm_crc32_u8(crc, *buf++);
        len--;
    }
    uint64_t c64 = crc;
    while (len >= 8) {
        uint64_t w;
        __builtin_memcpy(&w, buf, 8);
        c64 = _mm_crc32_u64(c64, w);
        buf += 8;
        len -= 8;
    }
    crc = (uint32_t)c64;
    while (len--) crc = _mm_crc32_u8(crc, *buf++);
    return ~crc;
}
#endif

uint32_t swtpu_crc32c(uint32_t crc, const uint8_t *buf, size_t len) {
#ifdef HAVE_SSE42_INTRIN
    if (__builtin_cpu_supports("sse4.2")) return crc32c_hw(crc, buf, len);
#endif
    return crc32c_sw(crc, buf, len);
}

#ifdef __cplusplus
}
#endif
