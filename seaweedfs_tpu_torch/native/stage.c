/* The staging copy of a card recover's chain (ops/gf256_cuda.py,
 * stage_pieces): k survivor rows of `length` bytes into one pinned
 * buffer, piece-major. Piece p covers bytes [bounds[p], bounds[p + 1]) of
 * every row; its k rows lie one after another at k x bounds[p] of `out`,
 * so the chain copies each piece in with one contiguous copy.
 *
 * One call copies the whole window, so the interpreter's lock is given up
 * once for it (ctypes), not once a row and piece as numpy would.
 */

#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

void swtpu_stage_pieces(const uint8_t *const *rows, int k,
                        const long long *bounds, int pieces, uint8_t *out) {
    for (int p = 0; p < pieces; ++p) {
        const long long a = bounds[p];
        const size_t w = (size_t)(bounds[p + 1] - a);
        uint8_t *dst = out + (long long)k * a;
        for (int i = 0; i < k; ++i) {
            memcpy(dst + (size_t)i * w, rows[i] + a, w);
        }
    }
}

#ifdef __cplusplus
}
#endif
