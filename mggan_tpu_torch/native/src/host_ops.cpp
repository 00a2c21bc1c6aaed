// Native host-side data ops of mggan_tpu_torch (a copy of the JAX
// package's mggan_tpu/native/src/host_ops.cpp; the port imports nothing of
// that package).
//
// The reference does all ingestion in Python: pandas.read_csv per file
// (BaseTrajectories.py:130-155) and a per-ped PIL crop loop for scene
// patches (BaseTrajectories.py:254-288, trajectories_scene.py:349-359).
// Here they are native code bound with ctypes
// (mggan_tpu_torch/native/__init__.py), which builds this file with g++ at
// first use into mggan_tpu_torch/_build/. The numpy versions beside the
// bindings are the plain references the tests compare with.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// Parse a whitespace/tab/comma-delimited numeric text file into doubles.
// Returns the number of values written, or -1 on open failure, -2 if a
// non-numeric token is found (the caller reads the file as a delimited
// table instead, data/table.py), -3 if the
// output buffer is too small.
int64_t parse_numeric_txt(const char* path, double* out, int64_t max_vals) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) { fclose(f); return -1; }
    size_t rd = fread(buf, 1, size, f);
    fclose(f);
    buf[rd] = '\0';

    int64_t n = 0;
    char* p = buf;
    char* end = buf + rd;
    while (p < end) {
        // skip delimiters / whitespace
        while (p < end && (*p == ' ' || *p == '\t' || *p == ',' ||
                           *p == '\n' || *p == '\r')) p++;
        if (p >= end) break;
        char* tok_end;
        double v = strtod(p, &tok_end);
        if (tok_end == p) { free(buf); return -2; }  // non-numeric token
        // token must terminate at a delimiter
        if (tok_end < end && !(*tok_end == ' ' || *tok_end == '\t' ||
                               *tok_end == ',' || *tok_end == '\n' ||
                               *tok_end == '\r' || *tok_end == '\0')) {
            free(buf);
            return -2;
        }
        if (n >= max_vals) { free(buf); return -3; }
        out[n++] = v;
        p = tok_end;
    }
    free(buf);
    return n;
}

// Crop n (side x side x 3) uint8 patches around integer centres from an
// (H x W x 3) uint8 image; out-of-bounds pixels are zero.
// out must hold n*side*side*3 bytes; side = 2*margin + 1.
void extract_patches(const uint8_t* img, int64_t H, int64_t W,
                     const int64_t* cx, const int64_t* cy, int64_t n,
                     int64_t margin, uint8_t* out) {
    const int64_t side = 2 * margin + 1;
    const int64_t patch_bytes = side * side * 3;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t* dst = out + i * patch_bytes;
        memset(dst, 0, patch_bytes);
        const int64_t x0 = cx[i] - margin, y0 = cy[i] - margin;
        int64_t sy0 = y0 < 0 ? 0 : y0;
        int64_t sy1 = y0 + side > H ? H : y0 + side;
        int64_t sx0 = x0 < 0 ? 0 : x0;
        int64_t sx1 = x0 + side > W ? W : x0 + side;
        if (sy1 <= sy0 || sx1 <= sx0) continue;
        const int64_t row_bytes = (sx1 - sx0) * 3;
        for (int64_t y = sy0; y < sy1; ++y) {
            memcpy(dst + ((y - y0) * side + (sx0 - x0)) * 3,
                   img + (y * W + sx0) * 3, row_bytes);
        }
    }
}

// Sliding-window full-presence filter (trajectories_scene.py:149-181).
// Inputs: presence (P x F) uint8, num windows = nw, stride skip.
// Output: keep (nw x P) uint8 with 1 where ped p is present in all
// SEQ frames of window w. Returns total kept (ped, window) pairs.
int64_t window_presence(const uint8_t* present, int64_t P, int64_t F,
                        int64_t seq_len, int64_t skip, uint8_t* keep) {
    int64_t nw = F >= seq_len ? (F - seq_len) / skip + 1 : 0;
    int64_t total = 0;
    // prefix sums per ped for O(1) window queries
    int32_t* psum = (int32_t*)malloc(sizeof(int32_t) * (F + 1));
    for (int64_t p = 0; p < P; ++p) {
        psum[0] = 0;
        const uint8_t* row = present + p * F;
        for (int64_t f = 0; f < F; ++f) psum[f + 1] = psum[f] + row[f];
        for (int64_t w = 0; w < nw; ++w) {
            int64_t s = w * skip;
            uint8_t ok = (psum[s + seq_len] - psum[s]) == seq_len;
            keep[w * P + p] = ok;
            total += ok;
        }
    }
    free(psum);
    return total;
}

}  // extern "C"
