/* GF(2^8) Reed-Solomon matrix transform — native host kernel.
 *
 * Host-side analog of the amd64 assembly inside klauspost/reedsolomon
 * (galois_amd64.s): the reference's only native-accelerated component
 * besides crc32 (SURVEY.md §2b). Field: x^8+x^4+x^3+x^2+1 (0x11D), the
 * same field as ec/gf.py, so outputs are bit-identical to the numpy
 * oracle and the CUDA kernel (ops/csrc/gf256_transform.cu).
 *
 * One generic entry point covers encode (consts = 4x10 parity matrix) and
 * reconstruct (consts = wanted-rows x present-rows recovery matrix):
 *
 *   out[r] = XOR_j gfmul(consts[r*k + j], in[j])     elementwise over n
 *
 * Fast path: AVX2 PSHUFB over 4-bit nibble lookup tables (the klauspost
 * idiom — two 16-byte tables per coefficient, 32 bytes per step). Portable
 * fallback: per-coefficient 256-byte multiplication tables.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define HAVE_X86 1
#endif

#ifdef __cplusplus
extern "C" {
#endif

static uint8_t GF_MUL[256][256];
static int gf_ready = 0;

/* Called once from build.py under its load lock BEFORE any transform is
 * reachable — the lazy gf_ready check alone would be a data race, since
 * ctypes drops the GIL and concurrent EC reads call in from two threads. */
void swtpu_gf256_init(void) {
    if (gf_ready) return;
    uint8_t exp[512];
    int log[256];
    int x = 1;
    for (int i = 0; i < 255; i++) {
        exp[i] = (uint8_t)x;
        log[x] = i;
        x <<= 1;
        if (x & 0x100) x ^= 0x11D;
    }
    memcpy(exp + 255, exp, 255);
    memset(GF_MUL, 0, sizeof(GF_MUL));
    for (int a = 1; a < 256; a++)
        for (int b = 1; b < 256; b++)
            GF_MUL[a][b] = exp[log[a] + log[b]];
    gf_ready = 1;
}

/* scalar fallback: table lookup per byte */
static void row_scalar(const uint8_t *coefs, int k,
                       const uint8_t *const *in, uint8_t *out, size_t n) {
    memset(out, 0, n);
    for (int j = 0; j < k; j++) {
        uint8_t c = coefs[j];
        if (c == 0) continue;
        const uint8_t *tbl = GF_MUL[c];
        const uint8_t *src = in[j];
        if (c == 1) {
            for (size_t i = 0; i < n; i++) out[i] ^= src[i];
        } else {
            for (size_t i = 0; i < n; i++) out[i] ^= tbl[src[i]];
        }
    }
}

#ifdef HAVE_X86
__attribute__((target("avx2")))
static void row_avx2(const uint8_t *coefs, int k,
                     const uint8_t *const *in, uint8_t *out, size_t n) {
    /* nibble tables per coefficient: lo[x]=c*x, hi[x]=c*(x<<4), x in 0..15 */
    memset(out, 0, n);
    const __m256i mask = _mm256_set1_epi8(0x0f);
    for (int j = 0; j < k; j++) {
        uint8_t c = coefs[j];
        if (c == 0) continue;
        const uint8_t *src = in[j];
        uint8_t lo[16], hi[16];
        for (int x = 0; x < 16; x++) {
            lo[x] = GF_MUL[c][x];
            hi[x] = GF_MUL[c][x << 4];
        }
        const __m256i tlo = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)lo));
        const __m256i thi = _mm256_broadcastsi128_si256(
            _mm_loadu_si128((const __m128i *)hi));
        size_t i = 0;
        for (; i + 32 <= n; i += 32) {
            __m256i v = _mm256_loadu_si256((const __m256i *)(src + i));
            __m256i o = _mm256_loadu_si256((const __m256i *)(out + i));
            __m256i vl = _mm256_and_si256(v, mask);
            __m256i vh = _mm256_and_si256(_mm256_srli_epi64(v, 4), mask);
            o = _mm256_xor_si256(o, _mm256_shuffle_epi8(tlo, vl));
            o = _mm256_xor_si256(o, _mm256_shuffle_epi8(thi, vh));
            _mm256_storeu_si256((__m256i *)(out + i), o);
        }
        const uint8_t *tbl = GF_MUL[c];
        for (; i < n; i++) out[i] ^= tbl[src[i]];
    }
}
#endif

void swtpu_gf256_transform(const uint8_t *consts, int rows, int k,
                           const uint8_t *const *in, uint8_t *const *out,
                           size_t n) {
    swtpu_gf256_init();
    /* runtime dispatch: the .so may have been built on a different host
     * (it is cached on disk), so never assume AVX2 from compile flags */
#ifdef HAVE_X86
    if (__builtin_cpu_supports("avx2")) {
        for (int r = 0; r < rows; r++)
            row_avx2(consts + (size_t)r * k, k, in, out[r], n);
        return;
    }
#endif
    for (int r = 0; r < rows; r++)
        row_scalar(consts + (size_t)r * k, k, in, out[r], n);
}

/* Keep the scalar path linked even in AVX2 builds (used by tests via
 * swtpu_gf256_transform_scalar to cross-check the vector path). */
void swtpu_gf256_transform_scalar(const uint8_t *consts, int rows, int k,
                                  const uint8_t *const *in,
                                  uint8_t *const *out, size_t n) {
    swtpu_gf256_init();
    for (int r = 0; r < rows; r++)
        row_scalar(consts + (size_t)r * k, k, in, out[r], n);
}

#ifdef __cplusplus
}
#endif
