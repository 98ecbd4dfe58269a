// Native data-path routines of meant_tpu_torch (host C++, no device code;
// a copy of the JAX package's meant_tpu/native/collate.cpp).
//
// The reference's input pipeline hot spots (SURVEY.md §3): per-item HF
// tokenizer calls inside Dataset.__getitem__ and two-level python-loop
// padding in the lag collators (`src/utils/custom_datasets.py:238-277`).
// These run on the host while the card computes, so they must be faster than
// a training step at production batch sizes — hence C++ with OpenMP-free
// plain loops (memory-bandwidth bound; compiler vectorizes).
//
// Exposed via ctypes (see meant_tpu_torch/native/__init__.py):
//   fnv1a_tokenize   whitespace tokenizer hashing each token into a vocab
//                    range (its numpy fallback is in __init__.py)
//   pad_two_level    lag collation: ragged [n x lag] token lists ->
//                    (n, lag, max_len) int32 ids + float32 mask
//                    (pad-id convention `input_ids != pad` =>
//                     mask, `src/utils/custom_datasets.py:263`)
//   center_pad_images center-pad variable-size images into a fixed
//                    (n, c, H, W) canvas + pixel mask
//                    (`utils/custom_datasets.py:144-160`)

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// FNV-1a 64-bit over a byte range.
static inline uint64_t fnv1a(const char* s, int len) {
    uint64_t h = 1469598103934665603ULL;
    for (int i = 0; i < len; ++i) {
        h ^= (uint64_t)(unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

// Tokenize `n` NUL-terminated strings (concatenated in `buf` with offsets)
// into fixed (n, max_len) ids with BOS/EOS id 2, pad id `pad_id`, token ids
// in [4, vocab). Returns nothing; writes ids and mask.
void fnv1a_tokenize(const char* buf, const int64_t* offsets, int n,
                    int max_len, int64_t vocab, int32_t pad_id,
                    int32_t* out_ids, float* out_mask) {
    for (int i = 0; i < n; ++i) {
        const char* s = buf + offsets[i];
        const char* end = buf + offsets[i + 1];
        int32_t* row = out_ids + (int64_t)i * max_len;
        float* mrow = out_mask + (int64_t)i * max_len;
        for (int j = 0; j < max_len; ++j) { row[j] = pad_id; mrow[j] = 0.f; }
        int pos = 0;
        row[pos] = 2; mrow[pos] = 1.f; ++pos;  // BOS
        const char* tok = s;
        while (tok < end && pos < max_len - 1) {
            while (tok < end && *tok == ' ') ++tok;
            const char* te = tok;
            while (te < end && *te != ' ') ++te;
            if (te > tok) {
                uint64_t h = fnv1a(tok, (int)(te - tok));
                row[pos] = (int32_t)(4 + (h % (uint64_t)(vocab - 4)));
                mrow[pos] = 1.f;
                ++pos;
            }
            tok = te;
        }
        if (pos < max_len) { row[pos] = 2; mrow[pos] = 1.f; }  // EOS
    }
}

// Two-level lag padding: `ids` is a flat int32 array of all tokens;
// `lengths` is (n*lag) per-day token counts (ids laid out day-major).
// Output: (n, lag, max_len) ids padded with pad_id + float mask.
void pad_two_level(const int32_t* ids, const int32_t* lengths, int n,
                   int lag, int max_len, int32_t pad_id,
                   int32_t* out_ids, float* out_mask) {
    int64_t src = 0;
    for (int i = 0; i < n * lag; ++i) {
        int L = lengths[i];
        int keep = std::min(L, max_len);
        int32_t* row = out_ids + (int64_t)i * max_len;
        float* mrow = out_mask + (int64_t)i * max_len;
        std::memcpy(row, ids + src, keep * sizeof(int32_t));
        for (int j = 0; j < keep; ++j) mrow[j] = 1.f;
        for (int j = keep; j < max_len; ++j) { row[j] = pad_id; mrow[j] = 0.f; }
        src += L;
    }
}

// Center-pad images: `imgs` is a flat float32 buffer of n images with
// per-image (c, h_i, w_i) given in dims (n x 3); output (n, c, H, W) zeros
// with the image centered + (n, H, W) pixel mask.
void center_pad_images(const float* imgs, const int32_t* dims, int n,
                       int H, int W, float* out, float* pixel_mask) {
    int64_t src = 0;
    for (int i = 0; i < n; ++i) {
        int c = dims[i * 3], h = dims[i * 3 + 1], w = dims[i * 3 + 2];
        int hh = std::min(h, H), ww = std::min(w, W);
        int top = (H - hh) / 2, left = (W - ww) / 2;
        float* ob = out + (int64_t)i * c * H * W;
        std::memset(ob, 0, sizeof(float) * (int64_t)c * H * W);
        for (int ch = 0; ch < c; ++ch)
            for (int y = 0; y < hh; ++y)
                std::memcpy(ob + ((int64_t)ch * H + top + y) * W + left,
                            imgs + src + ((int64_t)ch * h + y) * w,
                            ww * sizeof(float));
        float* mb = pixel_mask + (int64_t)i * H * W;
        std::memset(mb, 0, sizeof(float) * (int64_t)H * W);
        for (int y = 0; y < hh; ++y)
            for (int x = 0; x < ww; ++x)
                mb[(int64_t)(top + y) * W + left + x] = 1.f;
        src += (int64_t)c * h * w;
    }
}

}  // extern "C"
