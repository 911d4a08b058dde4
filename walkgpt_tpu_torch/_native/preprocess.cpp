// WalkGPT native preprocessing library (the PyTorch port's copy of
// walkgpt_tpu/_native/preprocess.cpp, built from this directory only).
//
// The reference's data loader leans on torchvision/PIL C extensions for image
// resampling (segment_anything/utils/transforms.py apply_image). This library
// is the host path of the data loader: Pillow-compatible separable
// triangle-filter (BILINEAR, antialiased) resampling with Pillow's exact
// fixed-point arithmetic (PRECISION_BITS=32-8-2, 8bpc intermediate rounding),
// plus fused normalize+pad into float32 NHWC canvases, so outputs are
// byte/bit-identical to the PIL pipeline the trained weights saw while
// avoiding Python/PIL overhead on the single-core data host.
//
// Exposed C ABI (ctypes):
//   wg_resize_bilinear_u8(src, h, w, c, dst, oh, ow)
//   wg_normalize_pad_f32(src, h, w, mean3, std3, dst, size)  // HWC u8 -> SxSx3 f32
//   wg_preprocess_stream(src, h, w, target_long, pad, mean3, std3, dst, &rh, &rw)
//
// Build: data/native_loader.py runs g++ at first use (into build/native/);
// by hand: make -C walkgpt_tpu_torch/_native

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

#define PRECISION_BITS (32 - 8 - 2)

static inline uint8_t clip8(int64_t in) {
    if (in >= (1LL << (PRECISION_BITS + 8))) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

struct Coeffs {
    std::vector<int> bounds;   // 2 per output pixel: xmin, xsize
    std::vector<int32_t> kk;   // ksize per output pixel
    int ksize;
};

// Pillow's precompute_coeffs for the triangle (BILINEAR) filter, support=1.0.
static Coeffs precompute(int in_size, int out_size) {
    Coeffs c;
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;
    int ksize = (int)ceil(support) * 2 + 1;
    c.ksize = ksize;
    c.bounds.resize(out_size * 2);
    c.kk.resize((size_t)out_size * ksize);
    std::vector<double> k(ksize);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        int x;
        for (x = 0; x < xmax; x++) {
            double w = (x + xmin - center + 0.5) * ss;  // triangle filter arg
            w = w < 0 ? -w : w;
            w = w < 1.0 ? 1.0 - w : 0.0;
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        for (x = 0; x < ksize; x++) {
            double v = k[x] * (1 << PRECISION_BITS);
            c.kk[(size_t)xx * ksize + x] =
                (int32_t)(v < 0 ? v - 0.5 : v + 0.5);
        }
        c.bounds[xx * 2 + 0] = xmin;
        c.bounds[xx * 2 + 1] = xmax;
    }
    return c;
}

extern "C" {

// src: [h, w, c] uint8; dst: [oh, ow, c] uint8. Pillow-exact BILINEAR.
void wg_resize_bilinear_u8(const uint8_t* src, int h, int w, int ch,
                           uint8_t* dst, int oh, int ow) {
    // horizontal pass: [h, w, c] -> [h, ow, c]
    Coeffs cx = precompute(w, ow);
    std::vector<uint8_t> tmp((size_t)h * ow * ch);
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src + (size_t)y * w * ch;
        uint8_t* orow = tmp.data() + (size_t)y * ow * ch;
        for (int xx = 0; xx < ow; xx++) {
            int xmin = cx.bounds[xx * 2 + 0];
            int xmax = cx.bounds[xx * 2 + 1];
            const int32_t* k = &cx.kk[(size_t)xx * cx.ksize];
            for (int b = 0; b < ch; b++) {
                int64_t ss = 1LL << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; x++)
                    ss += (int64_t)row[(size_t)(x + xmin) * ch + b] * k[x];
                orow[(size_t)xx * ch + b] = clip8(ss);
            }
        }
    }
    // vertical pass: [h, ow, c] -> [oh, ow, c]
    Coeffs cy = precompute(h, oh);
    for (int yy = 0; yy < oh; yy++) {
        int ymin = cy.bounds[yy * 2 + 0];
        int ymax = cy.bounds[yy * 2 + 1];
        const int32_t* k = &cy.kk[(size_t)yy * cy.ksize];
        uint8_t* orow = dst + (size_t)yy * ow * ch;
        for (int xx = 0; xx < ow * ch; xx++) {
            int64_t ss = 1LL << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                ss += (int64_t)tmp[(size_t)(y + ymin) * ow * ch + xx] * k[y];
            orow[xx] = clip8(ss);
        }
    }
}

// (x - mean)/std then zero-pad bottom/right into a [size, size, 3] f32 canvas.
void wg_normalize_pad_f32(const uint8_t* src, int h, int w,
                          const float* mean, const float* stdv,
                          float* dst, int size) {
    float inv[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};
    std::memset(dst, 0, (size_t)size * size * 3 * sizeof(float));
    for (int y = 0; y < h; y++) {
        const uint8_t* row = src + (size_t)y * w * 3;
        float* orow = dst + (size_t)y * size * 3;
        for (int x = 0; x < w; x++) {
            orow[x * 3 + 0] = ((float)row[x * 3 + 0] - mean[0]) * inv[0];
            orow[x * 3 + 1] = ((float)row[x * 3 + 1] - mean[1]) * inv[1];
            orow[x * 3 + 2] = ((float)row[x * 3 + 2] - mean[2]) * inv[2];
        }
    }
}

// fused: resize-longest-side + normalize + pad, one call per stream.
// Returns resized (rh, rw) through out params.
void wg_preprocess_stream(const uint8_t* src, int h, int w,
                          int target_long, int pad_size,
                          const float* mean, const float* stdv,
                          float* dst, int* rh_out, int* rw_out) {
    double scale = (double)target_long / (h > w ? h : w);
    int rh = (int)(h * scale + 0.5);
    int rw = (int)(w * scale + 0.5);
    std::vector<uint8_t> resized((size_t)rh * rw * 3);
    wg_resize_bilinear_u8(src, h, w, 3, resized.data(), rh, rw);
    wg_normalize_pad_f32(resized.data(), rh, rw, mean, stdv, dst, pad_size);
    *rh_out = rh;
    *rw_out = rw;
}

}  // extern "C"
