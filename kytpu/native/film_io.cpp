// Native film encoders: 24-bit BMP and Radiance HDR (flat RGBE).
//
// Host-side equivalent of the reference's host-side image writers
// (store_bmp_impl ky.cpp:1661-1737, store_hdr_impl ky.cpp:1739-1782),
// re-implemented from the file-format specs. Byte-identical to the numpy
// fallbacks in kytpu/film/io.py: gamma encode pow(x, 1/2.2)*255+0.5 in
// double precision, bottom-up BGR rows with 4-byte row padding for BMP,
// frexp-based RGBE for HDR.
//
// Exported as a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline uint8_t gamma_u8(float v) {
    double x = static_cast<double>(v);
    if (x < 0.0) x = 0.0;
    if (x > 1.0) x = 1.0;
    return static_cast<uint8_t>(std::pow(x, 1.0 / 2.2) * 255.0 + 0.5);
}

void put_u32(std::vector<uint8_t>& b, uint32_t v) {
    b.push_back(v & 0xff); b.push_back((v >> 8) & 0xff);
    b.push_back((v >> 16) & 0xff); b.push_back((v >> 24) & 0xff);
}

void put_u16(std::vector<uint8_t>& b, uint16_t v) {
    b.push_back(v & 0xff); b.push_back((v >> 8) & 0xff);
}

}  // namespace

extern "C" {

// img: row-major (h, w, 3) float32, linear radiance. Returns 0 on success.
int ky_write_bmp(const char* path, const float* img, int w, int h) {
    const int row_bytes = w * 3;
    const int pad = (4 - (row_bytes % 4)) % 4;
    const uint32_t body = static_cast<uint32_t>((row_bytes + pad)) * h;
    const uint32_t file_size = 54 + body;

    std::vector<uint8_t> out;
    out.reserve(file_size);
    out.push_back('B'); out.push_back('M');
    put_u32(out, file_size);
    put_u32(out, 0);        // reserved
    put_u32(out, 54);       // pixel-data offset
    put_u32(out, 40);       // BITMAPINFOHEADER size
    put_u32(out, static_cast<uint32_t>(w));
    put_u32(out, static_cast<uint32_t>(h));   // positive: bottom-up
    put_u16(out, 1);        // planes
    put_u16(out, 24);       // bpp
    put_u32(out, 0); put_u32(out, 0);  // compression, image size
    put_u32(out, 0); put_u32(out, 0);  // ppm resolution
    put_u32(out, 0); put_u32(out, 0);  // palette colors

    for (int y = h - 1; y >= 0; --y) {
        const float* row = img + static_cast<size_t>(y) * w * 3;
        for (int x = 0; x < w; ++x) {
            out.push_back(gamma_u8(row[x * 3 + 2]));  // B
            out.push_back(gamma_u8(row[x * 3 + 1]));  // G
            out.push_back(gamma_u8(row[x * 3 + 0]));  // R
        }
        for (int p = 0; p < pad; ++p) out.push_back(0);
    }

    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    size_t n = std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return n == out.size() ? 0 : 2;
}

// Flat (non-RLE) RGBE scanlines, "-Y h +X w" orientation.
int ky_write_hdr(const char* path, const float* img, int w, int h) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::fprintf(f, "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n");
    std::fprintf(f, "-Y %d +X %d\n", h, w);

    std::vector<uint8_t> buf(static_cast<size_t>(w) * 4);
    for (int y = 0; y < h; ++y) {
        const float* row = img + static_cast<size_t>(y) * w * 3;
        for (int x = 0; x < w; ++x) {
            float r = row[x * 3], g = row[x * 3 + 1], b = row[x * 3 + 2];
            float v = r > g ? r : g;
            if (b > v) v = b;
            uint8_t* px = buf.data() + static_cast<size_t>(x) * 4;
            if (v < 1e-32f) {
                px[0] = px[1] = px[2] = px[3] = 0;
            } else {
                int e;
                float m = std::frexp(v, &e);       // v = m * 2^e, m in [.5,1)
                float scale = m * 256.0f / v;
                auto enc = [&](float c) -> uint8_t {
                    float s = c * scale;
                    if (s < 0.0f) s = 0.0f;
                    if (s > 255.0f) s = 255.0f;
                    return static_cast<uint8_t>(s);
                };
                px[0] = enc(r); px[1] = enc(g); px[2] = enc(b);
                px[3] = static_cast<uint8_t>(e + 128);
            }
        }
        if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
            std::fclose(f);
            return 2;
        }
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
