// Native ingest path: JPEG decode + Pillow-bit-exact BILINEAR resize.
//
// The reference's data path decodes with PIL and resizes with
// torchvision's T.Resize (= PIL BILINEAR) — see
// reference datasets/transforms/build.py and datasets/bases.py:22-31.
// This component reproduces those bytes EXACTLY (same libjpeg-turbo
// decode settings PIL uses; the resize is a faithful port of Pillow's
// fixed-point resample for the triangle filter), so converted-checkpoint
// eval parity is unaffected by which path decoded the image. Python
// falls back to PIL when this library is unavailable or a file is not a
// baseline/progressive RGB/grayscale JPEG (decode_resize returns != 0).
//
// Built on demand by centroids_reid_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC decode.cpp -ljpeg
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <setjmp.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Pillow-exact BILINEAR resample, packed uint8, C channels.
// Algorithm and constants from Pillow's Resample.c (triangle filter,
// support=1.0, PRECISION_BITS fixed-point, per-axis two-pass).
// ---------------------------------------------------------------------
constexpr int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(int in) {
    if (in >= (1 << (PRECISION_BITS + 8))) return 255;
    if (in <= 0) return 0;
    return static_cast<uint8_t>(in >> PRECISION_BITS);
}

inline double triangle_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

// Pillow precompute_coeffs with box = (0, inSize), then
// normalize_coeffs_8bpc. Returns ksize; fills bounds[out*2], kk[out*ksize].
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // triangle filter support = 1.0
    int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

    bounds.assign(static_cast<size_t>(out_size) * 2, 0);
    std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);

    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &prekk[static_cast<size_t>(xx) * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = triangle_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[static_cast<size_t>(xx) * 2 + 0] = xmin;
        bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
    }
    // normalize_coeffs_8bpc: double -> fixed point with +-0.5 rounding
    kk.assign(prekk.size(), 0);
    for (size_t i = 0; i < prekk.size(); i++) {
        if (prekk[i] < 0.0)
            kk[i] = static_cast<int32_t>(-0.5 + prekk[i] * (1 << PRECISION_BITS));
        else
            kk[i] = static_cast<int32_t>(0.5 + prekk[i] * (1 << PRECISION_BITS));
    }
    return ksize;
}

// Packed-RGB only (3 channels unrolled into the accumulators).
void resample_horizontal_rgb(const uint8_t* in, int in_w, int rows,
                             uint8_t* out, int out_w, int ksize,
                             const std::vector<int>& bounds,
                             const std::vector<int32_t>& kk) {
    for (int yy = 0; yy < rows; yy++) {
        const uint8_t* row = in + static_cast<size_t>(yy) * in_w * 3;
        uint8_t* orow = out + static_cast<size_t>(yy) * out_w * 3;
        for (int xx = 0; xx < out_w; xx++) {
            int xmin = bounds[static_cast<size_t>(xx) * 2 + 0];
            int xmax = bounds[static_cast<size_t>(xx) * 2 + 1];
            const int32_t* k = &kk[static_cast<size_t>(xx) * ksize];
            const uint8_t* px = row + static_cast<size_t>(xmin) * 3;
            int ss0 = 1 << (PRECISION_BITS - 1), ss1 = ss0, ss2 = ss0;
            for (int x = 0; x < xmax; x++) {
                const int32_t w = k[x];
                ss0 += static_cast<int32_t>(px[x * 3 + 0]) * w;
                ss1 += static_cast<int32_t>(px[x * 3 + 1]) * w;
                ss2 += static_cast<int32_t>(px[x * 3 + 2]) * w;
            }
            orow[xx * 3 + 0] = clip8(ss0);
            orow[xx * 3 + 1] = clip8(ss1);
            orow[xx * 3 + 2] = clip8(ss2);
        }
    }
}

void resample_vertical(const uint8_t* in, int width, int ch, uint8_t* out,
                       int out_h, int ksize, const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk) {
    for (int yy = 0; yy < out_h; yy++) {
        int ymin = bounds[static_cast<size_t>(yy) * 2 + 0];
        int ymax = bounds[static_cast<size_t>(yy) * 2 + 1];
        const int32_t* k = &kk[static_cast<size_t>(yy) * ksize];
        uint8_t* orow = out + static_cast<size_t>(yy) * width * ch;
        for (int xx = 0; xx < width * ch; xx++) {
            int ss = 1 << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                ss += static_cast<int32_t>(
                          in[(static_cast<size_t>(y + ymin) * width * ch) + xx]) *
                      k[y];
            orow[xx] = clip8(ss);
        }
    }
}

// Pillow ImagingResampleInner: horizontal pass first, then vertical.
void resize_pillow_bilinear(const uint8_t* in, int in_h, int in_w, int ch,
                            uint8_t* out, int out_h, int out_w) {
    const bool need_h = out_w != in_w;
    const bool need_v = out_h != in_h;
    if (!need_h && !need_v) {
        std::memcpy(out, in, static_cast<size_t>(in_h) * in_w * ch);
        return;
    }
    std::vector<int> hb, vb;
    std::vector<int32_t> hk, vk;
    std::vector<uint8_t> temp;
    const uint8_t* cur = in;
    int cur_h = in_h, cur_w = in_w;
    if (need_h) {
        int ks = precompute_coeffs(in_w, out_w, hb, hk);
        uint8_t* dst = out;
        if (need_v) {
            temp.resize(static_cast<size_t>(in_h) * out_w * ch);
            dst = temp.data();
        }
        resample_horizontal_rgb(cur, cur_w, cur_h, dst, out_w, ks, hb, hk);
        cur = dst;
        cur_w = out_w;
    }
    if (need_v) {
        int ks = precompute_coeffs(in_h, out_h, vb, vk);
        resample_vertical(cur, cur_w, ch, out, out_h, ks, vb, vk);
    }
    (void)cur_h;
}

// ---------------------------------------------------------------------
// libjpeg decode (same settings PIL uses: islow DCT, fancy upsampling —
// both libjpeg defaults) with setjmp error recovery.
// ---------------------------------------------------------------------
struct JpegError {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
    longjmp(err->jump, 1);
}

void jpeg_output_silence(j_common_ptr) {}

// Decode JPEG bytes to packed RGB uint8. Returns 0 on success.
//
// When min_h/min_w > 0, requests libjpeg DCT scaling (scale_num/8) at the
// smallest factor whose output still covers (min_h, min_w) — decoding a
// 1024x512 source for a 256x128 target runs the IDCT at 2/8 scale, ~an
// order of magnitude less IDCT + colour-convert work. The scaled image is
// NOT byte-identical to full-decode-then-resize, so callers on the
// bit-exact parity path must pass 0 (serving-only divergence; see
// reference datasets/bases.py:29-33 for the decode path this
// deliberately diverges from).
int decode_rgb(const unsigned char* data, size_t len,
               std::vector<uint8_t>& pixels, int* h, int* w,
               int min_h = 0, int min_w = 0) {
    jpeg_decompress_struct cinfo;
    JpegError jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    jerr.mgr.output_message = jpeg_output_silence;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    if (cinfo.jpeg_color_space != JCS_YCbCr &&
        cinfo.jpeg_color_space != JCS_GRAYSCALE &&
        cinfo.jpeg_color_space != JCS_RGB) {
        // CMYK/YCCK etc.: PIL has bespoke handling; defer to the fallback.
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    cinfo.out_color_space = JCS_RGB;
    if (min_h > 0 && min_w > 0) {
        // Smallest scale_num/8 whose output covers the target in both
        // dims; jpeg_calc_output_dimensions gives libjpeg's exact
        // ceil(dim * num / 8) so the choice matches what start_decompress
        // will produce.
        for (unsigned int num = 1; num <= 8; num++) {
            cinfo.scale_num = num;
            cinfo.scale_denom = 8;
            jpeg_calc_output_dimensions(&cinfo);
            if (static_cast<int>(cinfo.output_height) >= min_h &&
                static_cast<int>(cinfo.output_width) >= min_w)
                break;
        }
        // If even 8/8 is smaller than the target we upscale from the
        // full-size decode, same as the exact path.
    }
    jpeg_start_decompress(&cinfo);
    *h = static_cast<int>(cinfo.output_height);
    *w = static_cast<int>(cinfo.output_width);
    if (*h <= 0 || *w <= 0 || cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }
    // Decompression-bomb guard mirroring PIL's Image.MAX_IMAGE_PIXELS
    // (178,956,970): larger declared dimensions defer to the PIL path,
    // which warns/raises — keeping raise-vs-decode behaviour identical
    // across the two "interchangeable" paths (and protecting CPU-poor
    // TPU hosts from multi-GB allocations driven by a 200-byte header).
    if (static_cast<uint64_t>(*h) * static_cast<uint64_t>(*w) >
        178956970ULL) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 6;
    }
    pixels.resize(static_cast<size_t>(*h) * (*w) * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row =
            pixels.data() + static_cast<size_t>(cinfo.output_scanline) * (*w) * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    // Truncated/corrupt streams decode "successfully" with warnings and
    // gray padding; PIL raises instead — defer those to the fallback so
    // behaviour (and therefore error reporting) matches the PIL path.
    const long warnings = cinfo.err->num_warnings;
    jpeg_destroy_decompress(&cinfo);
    return warnings > 0 ? 5 : 0;
}

// ---------------------------------------------------------------------
// RGB -> planar YUV420 (full-range BT.601, the JPEG convention).
//
// Serving-path wire format: Y at full resolution, Cb/Cr averaged over
// 2x2 blocks — 1.5 bytes/px instead of 3, halving host->device transfer
// (the e2e bottleneck through thin links). The device inverts this
// (triangle chroma upsample + YCbCr->RGB) inside the embed program —
// see centroids_reid_tpu/data/transforms.py::yuv420_to_rgb. Fixed-point
// constants are mirrored bit-exactly by the numpy oracle
// rgb_to_yuv420_np (tests/test_fast_ingest.py).
// ---------------------------------------------------------------------
inline uint8_t clamp_u8(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void rgb_to_yuv420(const uint8_t* rgb, int h, int w, uint8_t* out) {
    // h, w must be even (checked by the caller).
    uint8_t* yp = out;
    uint8_t* up = out + static_cast<size_t>(h) * w;
    uint8_t* vp = up + static_cast<size_t>(h / 2) * (w / 2);
    for (int y = 0; y < h; y++) {
        const uint8_t* row = rgb + static_cast<size_t>(y) * w * 3;
        uint8_t* yrow = yp + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; x++) {
            const int r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
            yrow[x] = clamp_u8((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
        }
    }
    const int cw = w / 2;
    for (int cy = 0; cy < h / 2; cy++) {
        const uint8_t* r0 = rgb + static_cast<size_t>(2 * cy) * w * 3;
        const uint8_t* r1 = r0 + static_cast<size_t>(w) * 3;
        for (int cx = 0; cx < cw; cx++) {
            const int o = cx * 6;
            // 2x2 block mean per channel (round-half-up), then convert
            const int r = (r0[o] + r0[o + 3] + r1[o] + r1[o + 3] + 2) >> 2;
            const int g =
                (r0[o + 1] + r0[o + 4] + r1[o + 1] + r1[o + 4] + 2) >> 2;
            const int b =
                (r0[o + 2] + r0[o + 5] + r1[o + 2] + r1[o + 5] + 2) >> 2;
            // floor-shift on a sum biased by +32768 == round-half-up
            up[static_cast<size_t>(cy) * cw + cx] =
                clamp_u8(128 + ((-11059 * r - 21709 * g + 32768 * b + 32768) >> 16));
            vp[static_cast<size_t>(cy) * cw + cx] =
                clamp_u8(128 + ((32768 * r - 27440 * g - 5328 * b + 32768) >> 16));
        }
    }
}

}  // namespace

extern "C" {

// Decode one JPEG and resize to [out_h, out_w, 3] into out. 0 = success.
// No C++ exception may escape the extern "C" boundary into ctypes
// (std::terminate would abort the whole Python process); any throw
// (e.g. bad_alloc) becomes a nonzero rc and the caller's PIL fallback.
int crt_decode_resize(const unsigned char* data, size_t len, int out_h,
                      int out_w, unsigned char* out) {
    try {
        std::vector<uint8_t> pixels;
        int h = 0, w = 0;
        int rc = decode_rgb(data, len, pixels, &h, &w);
        if (rc != 0) return rc;
        resize_pillow_bilinear(pixels.data(), h, w, 3, out, out_h, out_w);
        return 0;
    } catch (...) {
        return 7;
    }
}

// Batch variant: n images into out [n, out_h, out_w, 3]; rcs[i] per-image
// status (0 = ok; caller re-decodes failures via the fallback).
// n_threads <= 1 runs inline.
void crt_decode_resize_batch(const unsigned char** datas, const size_t* lens,
                             int n, int out_h, int out_w, unsigned char* out,
                             int* rcs, int n_threads) {
    const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
    auto work = [&](int start, int step) {
        for (int i = start; i < n; i += step)
            rcs[i] = crt_decode_resize(datas[i], lens[i], out_h, out_w,
                                       out + stride * i);
    };
    if (n_threads <= 1 || n <= 1) {
        work(0, 1);
        return;
    }
    if (n_threads > n) n_threads = n;
    // No exception may unwind past joinable std::threads (their dtor
    // terminates) or the extern "C" boundary: spawn with an explicit
    // count, cover any un-spawned strides inline, then join.
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    int spawned = 0;
    try {
        for (; spawned < n_threads; spawned++)
            threads.emplace_back(work, spawned, n_threads);
    } catch (...) {
        // std::system_error under thread exhaustion: fall through
    }
    for (int t = spawned; t < n_threads; t++) work(t, n_threads);
    for (auto& th : threads) th.join();
}

// Serving-path fast ingest: DCT-scaled decode -> Pillow-bilinear resize
// to (out_h, out_w) -> planar YUV420 pack into out
// [out_h*out_w + 2*(out_h/2)*(out_w/2)] bytes. 0 = success. Requires even
// target dims (rc 8 otherwise). NOT bit-exact vs the parity path: both
// the scaled IDCT and the 4:2:0 chroma subsample are lossy — serving-only
// (gated behind TPU.FAST_DECODE on the Python side).
int crt_decode_fast(const unsigned char* data, size_t len, int out_h,
                    int out_w, unsigned char* out) {
    try {
        if (out_h <= 0 || out_w <= 0 || (out_h % 2) || (out_w % 2)) return 8;
        std::vector<uint8_t> pixels;
        int h = 0, w = 0;
        int rc = decode_rgb(data, len, pixels, &h, &w, out_h, out_w);
        if (rc != 0) return rc;
        std::vector<uint8_t> resized;
        const uint8_t* rgb = pixels.data();
        if (h != out_h || w != out_w) {
            resized.resize(static_cast<size_t>(out_h) * out_w * 3);
            resize_pillow_bilinear(pixels.data(), h, w, 3, resized.data(),
                                   out_h, out_w);
            rgb = resized.data();
        }
        rgb_to_yuv420(rgb, out_h, out_w, out);
        return 0;
    } catch (...) {
        return 7;
    }
}

// Batch variant; same threading discipline as crt_decode_resize_batch.
void crt_decode_fast_batch(const unsigned char** datas, const size_t* lens,
                           int n, int out_h, int out_w, unsigned char* out,
                           int* rcs, int n_threads) {
    const size_t stride = static_cast<size_t>(out_h) * out_w +
                          2 * (static_cast<size_t>(out_h / 2) * (out_w / 2));
    auto work = [&](int start, int step) {
        for (int i = start; i < n; i += step)
            rcs[i] = crt_decode_fast(datas[i], lens[i], out_h, out_w,
                                     out + stride * i);
    };
    if (n_threads <= 1 || n <= 1) {
        work(0, 1);
        return;
    }
    if (n_threads > n) n_threads = n;
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    int spawned = 0;
    try {
        for (; spawned < n_threads; spawned++)
            threads.emplace_back(work, spawned, n_threads);
    } catch (...) {
    }
    for (int t = spawned; t < n_threads; t++) work(t, n_threads);
    for (auto& th : threads) th.join();
}

int crt_abi_version() { return 2; }

}  // extern "C"
