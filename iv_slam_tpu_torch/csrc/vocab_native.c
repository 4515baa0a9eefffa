/* The vocabulary's host helpers, host code: the DBoW2 text parser, the
 * dense Hamming matrix and the vocabulary-tree descent.
 *
 * Semantics of the reference's host extension (ivslam_native.cpp) and of
 * slam/vocabulary.py's plain NumPy versions, which they equal exactly:
 *   - parse_vocab_text reads a DBoW2 text file line by line as Python
 *     does (lines end at \n, \r or \r\n; fields split on whitespace): the
 *     header's first four integers, then one node per line with at least
 *     35 fields, "parent is_leaf d0 .. d31 weight" (fields past the 35th
 *     ignored, shorter lines skipped); the weight is parsed as a double
 *     (strtod, correctly rounded) and rounded to float;
 *   - hamming_matrix counts differing bits of 256-bit descriptors;
 *   - vocab_transform descends from the root to the child at the least
 *     Hamming distance, the first of equals, until a node's first child
 *     slot is empty.
 * Built by iv_slam_tpu_torch/_kernels.py with the host C compiler and
 * called through ctypes, which releases the interpreter lock for the call.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __cplusplus
#define IVT_EXPORT extern "C"
#else
#define IVT_EXPORT
#endif

static int popcount256(const uint8_t *a, const uint8_t *b) {
    uint64_t x[4], y[4];
    memcpy(x, a, 32);
    memcpy(y, b, 32);
    return __builtin_popcountll(x[0] ^ y[0]) + __builtin_popcountll(x[1] ^ y[1]) +
           __builtin_popcountll(x[2] ^ y[2]) + __builtin_popcountll(x[3] ^ y[3]);
}

/* Python's str.split() whitespace, ASCII part */
static int is_space(char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r' ||
           (c >= '\x1c' && c <= '\x1f');
}

/* One line's field spans: up to `max` starts and ends; returns the number of
 * fields (counting past `max`). */
static int split(const char *s, const char *end, const char **st, const char **en, int max) {
    int n = 0;
    while (s < end) {
        while (s < end && is_space(*s)) s++;
        if (s >= end) break;
        const char *b = s;
        while (s < end && !is_space(*s)) s++;
        if (n < max) {
            st[n] = b;
            en[n] = s;
        }
        n++;
    }
    return n;
}

/* A signed decimal integer spanning [b, e) exactly (an optional sign, then
 * digits, as Python's int() reads them); 0 when the field is not one. */
static int parse_int(const char *b, const char *e, long long *out) {
    const char *p = b;
    int neg = 0;
    if (p < e && (*p == '+' || *p == '-')) neg = *p++ == '-';
    if (p >= e || e - p > 18) return 0;   /* 18 digits cannot overflow */
    long long v = 0;
    for (; p < e; p++) {
        if (*p < '0' || *p > '9') return 0;
        v = v * 10 + (*p - '0');
    }
    *out = neg ? -v : v;
    return 1;
}

static int parse_double(const char *b, const char *e, double *out) {
    char tmp[64];
    if (e - b >= (long)sizeof(tmp)) return 0;
    memcpy(tmp, b, (size_t)(e - b));
    tmp[e - b] = 0;
    char *stop;
    *out = strtod(tmp, &stop);
    return stop == tmp + (e - b) && stop != tmp;
}

/* The next line of [s, end): its end in *le; returns the start of the
 * following line. */
static const char *next_line(const char *s, const char *end, const char **le) {
    const char *p = s;
    while (p < end && *p != '\n' && *p != '\r') p++;
    *le = p;
    if (p < end && *p == '\r' && p + 1 < end && p[1] == '\n') return p + 2;
    return p < end ? p + 1 : p;
}

/* buf: the file's n bytes. header: the four header integers. Node arrays
 * of `cap` entries; node 0 is the implicit root (parent -1, zero
 * descriptor, weight 0, not a leaf). *n_nodes: the nodes written;
 * *bad_line: the 1-based line of a field that does not parse. Returns 0,
 * 1 (a header with fewer than four integer fields), 2 (a bad node field),
 * 3 (more nodes than cap). */
IVT_EXPORT int parse_vocab_text(const char *buf, long n, int32_t *header, int32_t *parents,
                                uint8_t *descs, float *weights, uint8_t *leaves, long cap,
                                long *n_nodes, long *bad_line) {
    const char *s = buf, *end = buf + n, *le;
    const char *st[35], *en[35];
    long line = 1;
    *n_nodes = 0;
    *bad_line = 0;
    const char *next = next_line(s, end, &le);
    if (split(s, le, st, en, 35) < 4) return 1;
    for (int i = 0; i < 4; i++) {
        long long v;
        if (!parse_int(st[i], en[i], &v) || v < INT32_MIN || v > INT32_MAX) return 1;
        header[i] = (int32_t)v;
    }
    if (cap < 1) return 3;
    parents[0] = -1;
    memset(descs, 0, 32);
    weights[0] = 0.0f;
    leaves[0] = 0;
    long k = 1;
    for (s = next; s < end; s = next) {
        line++;
        next = next_line(s, end, &le);
        if (split(s, le, st, en, 35) < 35) continue;
        long long parent, leaf, d;
        double w;
        if (!parse_int(st[0], en[0], &parent) || parent < INT32_MIN || parent > INT32_MAX ||
            !parse_int(st[1], en[1], &leaf) || leaf < 0 || leaf > 255 ||
            !parse_double(st[34], en[34], &w)) {
            *bad_line = line;
            return 2;
        }
        if (k >= cap) return 3;
        for (int i = 0; i < 32; i++) {
            if (!parse_int(st[2 + i], en[2 + i], &d) || d < 0 || d > 255) {
                *bad_line = line;
                return 2;
            }
            descs[32 * k + i] = (uint8_t)d;
        }
        parents[k] = (int32_t)parent;
        leaves[k] = (uint8_t)leaf;
        weights[k] = (float)w;
        k++;
    }
    *n_nodes = k;
    return 0;
}

/* a: (n, 32), b: (m, 32) uint8 -> out (n, m) int32 Hamming distances */
IVT_EXPORT int hamming_matrix(const uint8_t *a, long n, const uint8_t *b, long m,
                              int32_t *out) {
    for (long i = 0; i < n; i++)
        for (long j = 0; j < m; j++)
            out[i * m + j] = popcount256(a + 32 * i, b + 32 * j);
    return 0;
}

/* children: (nodes, k) int32, -1 = none; node_desc: (nodes, 32); desc: (n,
 * 32) -> out (n,) leaf node ids. Returns 0, or 1 when a child id lies
 * outside [0, nodes). */
IVT_EXPORT int vocab_transform(const int32_t *children, long nodes, long k,
                               const uint8_t *node_desc, const uint8_t *desc, long n,
                               int32_t *out) {
    for (long i = 0; i < n; i++) {
        const uint8_t *d = desc + 32 * i;
        int32_t node = 0;
        for (;;) {
            const int32_t *kids = children + (long)node * k;
            if (kids[0] < 0) break;
            int32_t best = -1;
            int best_d = 0;
            for (long j = 0; j < k; j++) {
                int32_t c = kids[j];
                if (c < 0) continue;
                if (c >= nodes) return 1;
                int dd = popcount256(d, node_desc + 32 * (long)c);
                if (best < 0 || dd < best_d) {
                    best_d = dd;
                    best = c;
                }
            }
            node = best;
        }
        out[i] = node;
    }
    return 0;
}
