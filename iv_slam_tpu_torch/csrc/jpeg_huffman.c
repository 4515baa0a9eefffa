/* Baseline JPEG entropy coding (ITU T.81 annex F), host code.
 *
 * The Huffman decoder and encoder of io/jpeg.py's scans: bit-serial work
 * with a dependency from each symbol to the next, which costs ~1 us a
 * symbol in Python and a few ns here. Everything else of the codec (the
 * markers, DCTs, colour conversion and resampling) stays in io/jpeg.py,
 * vectorised. Built by iv_slam_tpu_torch/_kernels.py with the host C
 * compiler and called through ctypes, which releases the interpreter lock
 * for the call. io/jpeg.py's huffman_decode_plain / huffman_encode_plain
 * are its plain Python versions.
 *
 * Coefficients are int16 in natural (row-major) order, 64 a block; each
 * component's blocks form a (rows, cols, 64) array in the frame's padded
 * MCU grid.
 */
#include <stddef.h>
#include <stdint.h>

static const int natural_order[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ------------------------------------------------------------------ decode */

typedef struct {
    const uint8_t *p, *end;
    uint32_t acc;   /* bits, most significant first */
    int nbits;
    int marker;     /* a marker (not stuffing) was met: feed zeros */
} reader;

static void fill(reader *r) {
    while (r->nbits <= 24) {
        int byte = 0;
        if (!r->marker && r->p < r->end) {
            byte = *r->p;
            if (byte == 0xFF) {
                int next = r->p + 1 < r->end ? r->p[1] : 0xD9;
                if (next == 0x00) {
                    r->p += 2;
                } else {
                    r->marker = 1; /* leave the marker for the caller */
                    byte = 0;
                }
            } else {
                r->p++;
            }
        }
        r->acc |= (uint32_t)byte << (24 - r->nbits);
        r->nbits += 8;
    }
}

static int get_bits(reader *r, int n) {
    if (n == 0) return 0;
    fill(r);
    int v = (int)(r->acc >> (32 - n));
    r->acc <<= n;
    r->nbits -= n;
    return v;
}

/* One Huffman symbol: tables per T.81 F.2.2.3 (maxcode[17] with -1 for no
 * code of that length, valptr[17], mincode[17], huffval[256]). */
static int decode_symbol(reader *r, const int32_t *tab) {
    const int32_t *maxcode = tab, *valptr = tab + 17, *mincode = tab + 34, *huffval = tab + 51;
    int code = get_bits(r, 1);
    for (int l = 1; l <= 16; l++) {
        if (code <= maxcode[l]) return huffval[valptr[l] + code - mincode[l]];
        code = (code << 1) | get_bits(r, 1);
    }
    return -1;
}

static int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

/* Decode one scan.
 * data/len: the entropy-coded bytes of the scan (from after SOS to the
 * marker that ends it, RST markers included);
 * ncomp: components in the scan; for each c: h[c], v[c] blocks an MCU
 * (1, 1 for a non-interleaved scan), cols[c] blocks a row of its array,
 * out[c] its coefficient array, dc[c]/ac[c] tables (see decode_symbol);
 * mcux, mcuy: MCUs of the scan; restart: MCUs between RST markers (0:
 * none). Returns 0, -1 for a bad Huffman code or -2 for a missing restart
 * marker. Data that ends early reads as zero bits, as libjpeg reads it. */
#ifdef __cplusplus
extern "C"
#endif
long jpeg_decode_scan(const uint8_t *data, long len, int ncomp, const int32_t *h,
                      const int32_t *v, const int32_t *cols, int16_t **out,
                      const int32_t **dc, const int32_t **ac, int mcux, int mcuy,
                      int restart) {
    reader r = {data, data + len, 0, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    long n_mcu = (long)mcux * mcuy, todo = restart;
    int rst = 0;
    for (long m = 0; m < n_mcu; m++) {
        if (restart && todo == 0) {
            /* byte-align, expect RSTn, reset the predictors */
            r.acc = 0;
            r.nbits = 0;
            r.marker = 0;
            if (r.p + 1 >= r.end || r.p[0] != 0xFF || r.p[1] != (0xD0 | rst)) return -2;
            r.p += 2;
            rst = (rst + 1) & 7;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            todo = restart;
        }
        long my = m / mcux, mx = m % mcux;
        for (int c = 0; c < ncomp; c++) {
            for (int by = 0; by < v[c]; by++) {
                for (int bx = 0; bx < h[c]; bx++) {
                    int16_t *blk = out[c] + ((my * v[c] + by) * (long)cols[c] + mx * h[c] + bx) * 64;
                    int t = decode_symbol(&r, dc[c]);
                    if (t < 0) return -1;
                    int diff = t ? extend(get_bits(&r, t), t) : 0;
                    pred[c] += diff;
                    blk[0] = (int16_t)pred[c];
                    for (int k = 1; k < 64;) {
                        int rs = decode_symbol(&r, ac[c]);
                        if (rs < 0) return -1;
                        int run = rs >> 4, s = rs & 15;
                        if (s == 0) {
                            if (run != 15) break; /* EOB */
                            k += 16;
                            continue;
                        }
                        k += run;
                        if (k > 63) break;
                        blk[natural_order[k]] = (int16_t)extend(get_bits(&r, s), s);
                        k++;
                    }
                }
            }
        }
        if (restart) todo--;
    }
    return 0;
}

/* ------------------------------------------------------------------ encode */

typedef struct {
    uint8_t *p, *end;
    uint32_t acc;
    int nbits;
    int overflow;
} writer;

static void emit(writer *w, uint32_t code, int size) {
    if (size == 0) return;
    w->acc = (w->acc << size) | (code & ((1u << size) - 1));
    w->nbits += size;
    while (w->nbits >= 8) {
        uint8_t byte = (uint8_t)(w->acc >> (w->nbits - 8));
        w->nbits -= 8;
        if (w->p + 2 > w->end) {
            w->overflow = 1;
            return;
        }
        *w->p++ = byte;
        if (byte == 0xFF) *w->p++ = 0x00;
    }
}

/* Encode one interleaved scan without restarts: the arguments as for the
 * decoder, with (code, size) tables: dcco/dcsi[c] (12 entries) and
 * acco/acsi[c] (256). Writes into buf (cap bytes); returns the bytes
 * written, the last byte padded with 1 bits, or -1 when buf is too small. */
#ifdef __cplusplus
extern "C"
#endif
long jpeg_encode_scan(uint8_t *buf, long cap, int ncomp, const int32_t *h, const int32_t *v,
                      const int32_t *cols, const int16_t **in, const int32_t **dcco,
                      const int32_t **dcsi, const int32_t **acco, const int32_t **acsi,
                      int mcux, int mcuy) {
    writer w = {buf, buf + cap, 0, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    for (long my = 0; my < mcuy; my++) {
        for (long mx = 0; mx < mcux; mx++) {
            for (int c = 0; c < ncomp; c++) {
                for (int by = 0; by < v[c]; by++) {
                    for (int bx = 0; bx < h[c]; bx++) {
                        const int16_t *blk =
                            in[c] + ((my * v[c] + by) * (long)cols[c] + mx * h[c] + bx) * 64;
                        int temp = blk[0] - pred[c], temp2 = temp;
                        pred[c] = blk[0];
                        if (temp < 0) {
                            temp = -temp;
                            temp2--;
                        }
                        int nbits = 0;
                        while (temp) {
                            nbits++;
                            temp >>= 1;
                        }
                        emit(&w, (uint32_t)dcco[c][nbits], dcsi[c][nbits]);
                        emit(&w, (uint32_t)temp2, nbits);
                        int run = 0;
                        for (int k = 1; k < 64; k++) {
                            temp = blk[natural_order[k]];
                            if (temp == 0) {
                                run++;
                                continue;
                            }
                            while (run > 15) {
                                emit(&w, (uint32_t)acco[c][0xF0], acsi[c][0xF0]);
                                run -= 16;
                            }
                            temp2 = temp;
                            if (temp < 0) {
                                temp = -temp;
                                temp2--;
                            }
                            nbits = 1;
                            while ((temp >>= 1)) nbits++;
                            int i = (run << 4) + nbits;
                            emit(&w, (uint32_t)acco[c][i], acsi[c][i]);
                            emit(&w, (uint32_t)temp2, nbits);
                            run = 0;
                        }
                        if (run > 0) emit(&w, (uint32_t)acco[c][0], acsi[c][0]);
                        if (w.overflow) return -1;
                    }
                }
            }
        }
    }
    emit(&w, 0x7F, 7); /* fill the last byte with 1 bits */
    return w.overflow ? -1 : (long)(w.p - buf);
}
