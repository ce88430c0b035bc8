/* COCO RLE mask codec for the data loader's read stage.
 *
 * The port's own copy of planerecnet_tpu/native/rle.c: decodes the COCO
 * 6-bit-varint compressed counts string and expands runs into a
 * column-major binary mask, and encodes a mask into runs. Built by
 * rle_native.py with the system C compiler into
 * planerecnet_tpu_torch/_build/ and loaded with ctypes; the numpy codec of
 * data/coco.py is its plain version.
 *
 * Against the JAX package's copy, rle_fill also refuses runs that do not
 * fill the mask (returns -2), as the port's numpy codec does.
 */

#include <stddef.h>
#include <stdint.h>

/* Decode a compressed counts string into int64 runs.
 * Returns the number of runs written, -1 if out_cap is too small, -2 if
 * the string ends inside a varint. */
long long rle_decode_counts(const char *s, long long n, long long *out,
                            long long out_cap) {
    long long m = 0;
    long long i = 0;
    while (i < n) {
        long long x = 0;
        int k = 0;
        int more = 1;
        while (more) {
            if (i >= n) return -2;
            long long c = (long long)(s[i]) - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            i++;
            k++;
            if (!more && (c & 0x10)) {
                x |= -1LL << (5 * k);
            }
        }
        if (m > 2) x += out[m - 2];
        if (m >= out_cap) return -1;
        out[m++] = x;
    }
    return m;
}

/* Expand runs into a flat column-major uint8 mask of size total, which the
 * caller zeroed. Returns 0 on success, -1 if a run is negative or the runs
 * overflow the mask, -2 if they do not fill it. */
int rle_fill(const long long *counts, long long n_counts, uint8_t *flat,
             long long total) {
    long long pos = 0;
    int val = 0;
    for (long long r = 0; r < n_counts; r++) {
        long long run = counts[r];
        if (run < 0 || pos + run > total) return -1;
        if (val) {
            for (long long j = 0; j < run; j++) flat[pos + j] = 1;
        }
        pos += run;
        val ^= 1;
    }
    return pos == total ? 0 : -2;
}

/* Encode a flat column-major uint8 mask into runs, starting with a run of
 * zeros (of length 0 where the mask starts with a one). Returns the run
 * count, or -1 if out_cap is too small. */
long long rle_encode_mask(const uint8_t *flat, long long total,
                          long long *out, long long out_cap) {
    long long m = 0;
    long long pos = 0;
    int val = 0;
    while (pos < total) {
        long long start = pos;
        while (pos < total && (flat[pos] != 0) == val) pos++;
        if (m >= out_cap) return -1;
        out[m++] = pos - start;
        val ^= 1;
    }
    return m;
}
