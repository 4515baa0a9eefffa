/* PNG row unfiltering (PNG specification, section 9), host code.
 *
 * The five filter types reverse row by row: Sub, Average and Paeth carry
 * a dependency from each byte to the one `bpp` bytes before it, so a row
 * is a sequential scan; a byte loop in C runs at memory speed where the
 * same loop in Python costs ~0.5 ms a KITTI row. Built by
 * iv_slam_tpu_torch/_kernels.py with the host C compiler and called
 * through ctypes, which releases the interpreter lock for the call.
 * io/png.py::unfilter_plain is its plain NumPy version.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* src: h rows of 1 filter byte + `stride` bytes; dst: h * stride bytes;
 * bpp: bytes a complete pixel (at least 1). Returns 0, or 1 + the index of
 * the first row whose filter byte is not 0-4 (rows before it are done). */
#ifdef __cplusplus
extern "C"
#endif
int png_unfilter(const uint8_t *src, uint8_t *dst, int h, int stride, int bpp) {
    const uint8_t *prev = NULL; /* the row above; none for the first row */
    for (int y = 0; y < h; y++) {
        const uint8_t *line = src + (size_t)y * (size_t)(stride + 1);
        const int ft = line[0];
        const uint8_t *in = line + 1;
        uint8_t *out = dst + (size_t)y * (size_t)stride;
        int x;
        switch (ft) {
        case 0:
            memcpy(out, in, (size_t)stride);
            break;
        case 1: /* Sub */
            for (x = 0; x < stride && x < bpp; x++) out[x] = in[x];
            for (; x < stride; x++) out[x] = (uint8_t)(in[x] + out[x - bpp]);
            break;
        case 2: /* Up */
            if (prev == NULL) {
                memcpy(out, in, (size_t)stride);
            } else {
                for (x = 0; x < stride; x++) out[x] = (uint8_t)(in[x] + prev[x]);
            }
            break;
        case 3: /* Average */
            for (x = 0; x < stride; x++) {
                const int a = x >= bpp ? out[x - bpp] : 0;
                const int b = prev != NULL ? prev[x] : 0;
                out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4: /* Paeth */
            for (x = 0; x < stride; x++) {
                const int a = x >= bpp ? out[x - bpp] : 0;
                const int b = prev != NULL ? prev[x] : 0;
                const int c = (x >= bpp && prev != NULL) ? prev[x - bpp] : 0;
                const int p = a + b - c;
                const int pa = p > a ? p - a : a - p;
                const int pb = p > b ? p - b : b - p;
                const int pc = p > c ? p - c : c - p;
                const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[x] = (uint8_t)(in[x] + pred);
            }
            break;
        default:
            return y + 1;
        }
        prev = out;
    }
    return 0;
}
