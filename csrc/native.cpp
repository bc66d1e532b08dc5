// Native host runtime for the voxel renderer.
//
// Plays the role of the reference's C++ host layer (prlib image IO,
// hipUtil buffers, pmjSampler host generation): the device compute path
// is JAX/XLA, but IO-bound and generation-bound host work stays native.
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: see csrc/Makefile (g++ -O3 -shared -fPIC, links zlib).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG encode (RGB8/RGBA8) -- saveAsPngUncompressed-style fast writeback
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back((x >> 24) & 0xFF);
    v.push_back((x >> 16) & 0xFF);
    v.push_back((x >> 8) & 0xFF);
    v.push_back(x & 0xFF);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t n) {
    put_be32(out, (uint32_t)n);
    size_t start = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + n);
    uint32_t crc = crc32(0, out.data() + start, (uInt)(n + 4));
    put_be32(out, crc);
}

// Returns number of bytes written to dst (dst must hold >= bound bytes,
// query with mvrt_png_bound). channels: 3 or 4. level: 0..9.
int64_t mvrt_png_encode(const uint8_t* img, int32_t w, int32_t h,
                        int32_t channels, int32_t level, uint8_t* dst,
                        int64_t dst_cap) {
    if (channels != 3 && channels != 4) return -1;
    std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * channels));
    for (int y = 0; y < h; y++) {
        uint8_t* row = raw.data() + (size_t)y * (1 + (size_t)w * channels);
        row[0] = 0;  // filter none
        memcpy(row + 1, img + (size_t)y * w * channels, (size_t)w * channels);
    }
    uLongf zcap = compressBound((uLong)raw.size());
    std::vector<uint8_t> z(zcap);
    if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), level) != Z_OK)
        return -2;

    std::vector<uint8_t> out;
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    out.insert(out.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
    ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
    ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
    ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
    ihdr[8] = 8;                        // bit depth
    ihdr[9] = channels == 3 ? 2 : 6;    // color type
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    put_chunk(out, "IHDR", ihdr, 13);
    put_chunk(out, "IDAT", z.data(), zcap);
    put_chunk(out, "IEND", nullptr, 0);

    if ((int64_t)out.size() > dst_cap) return -3;
    memcpy(dst, out.data(), out.size());
    return (int64_t)out.size();
}

int64_t mvrt_png_bound(int32_t w, int32_t h, int32_t channels) {
    return 1024 + (int64_t)compressBound((uLong)((size_t)h * (1 + (size_t)w * channels)));
}

// ---------------------------------------------------------------------------
// Radiance RGBE decode (RLE) -- the hot inner loop of .hdr loading
// ---------------------------------------------------------------------------

// pix: raw bytes after the resolution line; out: float32 [h*w*3].
// Returns 0 on success.
int32_t mvrt_hdr_decode(const uint8_t* pix, int64_t n, int32_t w, int32_t h,
                        float* out) {
    int64_t p = 0;
    std::vector<uint8_t> row((size_t)w * 4);
    for (int y = 0; y < h; y++) {
        if (n - p >= 4 && pix[p] == 2 && pix[p + 1] == 2 &&
            ((pix[p + 2] << 8) | pix[p + 3]) == w) {
            p += 4;
            for (int c = 0; c < 4; c++) {
                int x = 0;
                while (x < w) {
                    if (p >= n) return -1;
                    int cnt = pix[p++];
                    if (cnt > 128) {
                        cnt -= 128;
                        if (p >= n || x + cnt > w) return -2;
                        for (int k = 0; k < cnt; k++) row[(size_t)(x + k) * 4 + c] = pix[p];
                        p++;
                        x += cnt;
                    } else {
                        if (p + cnt > n || x + cnt > w) return -3;
                        for (int k = 0; k < cnt; k++) row[(size_t)(x + k) * 4 + c] = pix[p + k];
                        p += cnt;
                        x += cnt;
                    }
                }
            }
        } else {
            if (p + 4 * (int64_t)w > n) return -4;
            for (int x = 0; x < w; x++)
                for (int c = 0; c < 4; c++) row[(size_t)x * 4 + c] = pix[p + (int64_t)x * 4 + c];
            p += 4 * (int64_t)w;
        }
        for (int x = 0; x < w; x++) {
            uint8_t e = row[(size_t)x * 4 + 3];
            float scale = e ? ldexpf(1.0f, (int)e - 136) : 0.0f;
            for (int c = 0; c < 3; c++)
                out[((size_t)y * w + x) * 3 + c] =
                    e ? (row[(size_t)x * 4 + c] + 0.5f) * scale : 0.0f;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// OBJ triangle-soup parse (v / f lines, fan triangulation)
// ---------------------------------------------------------------------------

// First call with tris == nullptr to get the triangle count; then call again
// with a buffer of size n_tris * 9 floats.
int64_t mvrt_obj_parse(const char* text, int64_t len, float* tris,
                       int64_t cap_tris) {
    std::vector<float> verts;
    verts.reserve(1 << 16);
    int64_t n_out = 0;
    const char* p = text;
    const char* end = text + len;
    std::vector<int64_t> face;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        if (!eol) eol = end;
        if (p[0] == 'v' && p[1] == ' ') {
            char* q = (char*)p + 2;
            float x = strtof(q, &q);
            float y = strtof(q, &q);
            float z = strtof(q, &q);
            verts.push_back(x); verts.push_back(y); verts.push_back(z);
        } else if (p[0] == 'f' && p[1] == ' ') {
            face.clear();
            const char* q = p + 2;
            while (q < eol) {
                while (q < eol && *q == ' ') q++;
                if (q >= eol) break;
                char* qe;
                long idx = strtol(q, &qe, 10);
                if (qe == q) break;
                q = qe;
                while (q < eol && *q != ' ') q++;  // skip /vt/vn
                int64_t nv = (int64_t)verts.size() / 3;
                face.push_back(idx > 0 ? idx - 1 : nv + idx);
            }
            for (size_t k = 1; k + 1 < face.size(); k++) {
                if (tris) {
                    if (n_out >= cap_tris) return -1;
                    float* t = tris + n_out * 9;
                    const int64_t ids[3] = {face[0], face[k], face[k + 1]};
                    for (int j = 0; j < 3; j++) {
                        t[j * 3 + 0] = verts[(size_t)ids[j] * 3 + 0];
                        t[j * 3 + 1] = verts[(size_t)ids[j] * 3 + 1];
                        t[j * 3 + 2] = verts[(size_t)ids[j] * 3 + 2];
                    }
                }
                n_out++;
            }
        }
        p = eol + 1;
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// Triangle split-to-cap (utils/meshprep.py hot path)
//
// The device voxelizer evaluates a static cap^3 candidate grid per triangle;
// triangles whose voxel bbox exceeds the cap are bisected at their longest
// edge until they fit (same rule as the numpy implementation: coverage is
// exact, duplicate voxels merge in the sort+unique pass). Worklist form,
// one triangle at a time, no per-round reallocation.
// ---------------------------------------------------------------------------

namespace {

struct Tri9 {
    float v[9], c[9], e[9];
};

static inline int64_t bbox_ext(const float* v, const float* origin, float dps,
                               int64_t grid_res) {
    float lo[3], hi[3];
    for (int a = 0; a < 3; a++) {
        lo[a] = v[a] < v[3 + a] ? v[a] : v[3 + a];
        if (v[6 + a] < lo[a]) lo[a] = v[6 + a];
        hi[a] = v[a] > v[3 + a] ? v[a] : v[3 + a];
        if (v[6 + a] > hi[a]) hi[a] = v[6 + a];
    }
    int64_t ext = 0;
    for (int a = 0; a < 3; a++) {
        int64_t l = (int64_t)floorf((lo[a] - origin[a]) / dps);
        int64_t u = (int64_t)floorf((hi[a] - origin[a]) / dps);
        if (l < 0) l = 0;
        if (u > grid_res - 1) u = grid_res - 1;
        int64_t x = u - l + 1;
        if (x < 0) x = 0;
        if (x > ext) ext = x;
    }
    return ext;
}

}  // namespace

// out_*: may be nullptr with out_cap == 0 to query the output count.
// Returns the total output triangle count (call again with a big enough
// buffer if it exceeds out_cap; buffers are only written up to out_cap).
int64_t mvrt_split_to_cap(const float* v, const float* c, const float* e,
                          int64_t n, const float* origin, float dps,
                          int64_t grid_res, int64_t cap,
                          float* out_v, float* out_c, float* out_e,
                          int64_t out_cap) {
    std::vector<Tri9> stack;
    stack.reserve(128);
    int64_t n_out = 0;
    for (int64_t i = 0; i < n; i++) {
        Tri9 t;
        memcpy(t.v, v + i * 9, 36);
        memcpy(t.c, c + i * 9, 36);
        memcpy(t.e, e + i * 9, 36);
        stack.push_back(t);
        while (!stack.empty()) {
            Tri9 cur = stack.back();
            stack.pop_back();
            if (bbox_ext(cur.v, origin, dps, grid_res) <= cap) {
                if (n_out < out_cap) {
                    memcpy(out_v + n_out * 9, cur.v, 36);
                    memcpy(out_c + n_out * 9, cur.c, 36);
                    memcpy(out_e + n_out * 9, cur.e, 36);
                }
                n_out++;
                continue;
            }
            // longest edge (first max wins, matching numpy argmax)
            float el[3];
            for (int k = 0; k < 3; k++) {
                int a = k, b = (k + 1) % 3;
                float dx = cur.v[b * 3] - cur.v[a * 3];
                float dy = cur.v[b * 3 + 1] - cur.v[a * 3 + 1];
                float dz = cur.v[b * 3 + 2] - cur.v[a * 3 + 2];
                el[k] = sqrtf(dx * dx + dy * dy + dz * dz);
            }
            int w = 0;
            if (el[1] > el[w]) w = 1;
            if (el[2] > el[w]) w = 2;
            int a = w, b = (w + 1) % 3, o = (w + 2) % 3;
            Tri9 t1, t2;
            for (int j = 0; j < 3; j++) {
                float vm = (cur.v[a * 3 + j] + cur.v[b * 3 + j]) * 0.5f;
                float cm = (cur.c[a * 3 + j] + cur.c[b * 3 + j]) * 0.5f;
                float em = (cur.e[a * 3 + j] + cur.e[b * 3 + j]) * 0.5f;
                t1.v[j] = cur.v[a * 3 + j];  t1.v[3 + j] = vm;
                t1.v[6 + j] = cur.v[o * 3 + j];
                t2.v[j] = vm;  t2.v[3 + j] = cur.v[b * 3 + j];
                t2.v[6 + j] = cur.v[o * 3 + j];
                t1.c[j] = cur.c[a * 3 + j];  t1.c[3 + j] = cm;
                t1.c[6 + j] = cur.c[o * 3 + j];
                t2.c[j] = cm;  t2.c[3 + j] = cur.c[b * 3 + j];
                t2.c[6 + j] = cur.c[o * 3 + j];
                t1.e[j] = cur.e[a * 3 + j];  t1.e[3 + j] = em;
                t1.e[6 + j] = cur.e[o * 3 + j];
                t2.e[j] = em;  t2.e[3 + j] = cur.e[b * 3 + j];
                t2.e[6 + j] = cur.e[o * 3 + j];
            }
            stack.push_back(t2);
            stack.push_back(t1);
        }
    }
    return n_out;
}

// ---------------------------------------------------------------------------
// PCG32 + PMJ(0,2) table generation (pmjSampler.hpp host side)
// ---------------------------------------------------------------------------

struct PCG32 {
    uint64_t state, inc;
    void setup(uint64_t seed, uint64_t stream) {
        state = 0;
        inc = stream * 2 + 1;
        next();
        state += seed;
        next();
    }
    uint32_t next() {
        uint64_t old = state;
        state = old * 6364136223846793005ULL + inc;
        uint32_t xs = (uint32_t)(((old >> 18u) ^ old) >> 27u);
        uint32_t rot = (uint32_t)(old >> 59u);
        return (xs >> rot) | (xs << ((-rot) & 31));
    }
    float uniformf() {
        uint32_t bits = (next() >> 9) | 0x3f800000u;
        float v;
        memcpy(&v, &bits, 4);
        return v - 1.0f;
    }
};

static const uint32_t PMJ_XORS[2][32] = {
    {0x0, 0x0, 0x2, 0x6, 0x6, 0xe, 0x36, 0x4e, 0x16, 0x2e, 0x276, 0x6ce,
     0x716, 0xc2e, 0x3076, 0x40ce, 0x116, 0x22e, 0x20676, 0x60ece, 0x61716,
     0xe2c2e, 0x367076, 0x4ec0ce, 0x170116, 0x2c022e, 0x2700676, 0x6c00ece,
     0x7001716, 0xc002c2e, 0x30007076, 0x4000c0ce},
    {0x0, 0x1, 0x3, 0x3, 0x7, 0x1b, 0x27, 0xb, 0x17, 0x13b, 0x367, 0x38b,
     0x617, 0x183b, 0x2067, 0x8b, 0x117, 0x1033b, 0x30767, 0x30b8b, 0x71617,
     0x1b383b, 0x276067, 0xb808b, 0x160117, 0x138033b, 0x3600767, 0x3800b8b,
     0x6001617, 0x1800383b, 0x20006067, 0x808b}};

// out: float32 [n_sequence * length * 2]
void mvrt_pmj02_table(int32_t n_sequence, int32_t length, uint64_t seed,
                      uint64_t stream, float* out) {
    PCG32 rng;
    rng.setup(seed, stream);
    std::vector<double> s((size_t)length * 2);
    for (int i = 0; i < n_sequence; i++) {
        s[0] = rng.uniformf();
        s[1] = rng.uniformf();
        int log_n = 0;
        while ((1 << log_n) < length) {
            int prev_len = 1 << log_n;
            int n_strata = prev_len * 2;
            double i_strata = 1.0 / n_strata;
            for (int k = 0; k < prev_len && prev_len + k < length; k++) {
                int px = k ^ PMJ_XORS[0][log_n];
                int xs = ((int)(s[(size_t)px * 2] * n_strata)) ^ 1;
                int py = k ^ PMJ_XORS[1][log_n];
                int ys = ((int)(s[(size_t)py * 2 + 1] * n_strata)) ^ 1;
                s[(size_t)(prev_len + k) * 2] = (rng.uniformf() + xs) * i_strata;
                s[(size_t)(prev_len + k) * 2 + 1] = (rng.uniformf() + ys) * i_strata;
            }
            log_n++;
        }
        float* dst = out + (size_t)i * length * 2;
        for (int k = 0; k < length * 2; k++) dst[k] = (float)s[k];
    }
}

// ---------------------------------------------------------------------------
// Morton + Murmur oracles (unittest.cpp's benchmark/oracle roles)
// ---------------------------------------------------------------------------

static inline uint64_t split_by_3(uint32_t a) {
    uint64_t x = a & 0x1FFFFF;
    x = (x | x << 32) & 0x1f00000000ffffull;
    x = (x | x << 16) & 0x1f0000ff0000ffull;
    x = (x | x << 8) & 0x100f00f00f00f00full;
    x = (x | x << 4) & 0x10c30c30c30c30c3ull;
    x = (x | x << 2) & 0x1249249249249249ull;
    return x;
}

void mvrt_morton_encode(const uint32_t* x, const uint32_t* y,
                        const uint32_t* z, int64_t n, uint64_t* out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = split_by_3(x[i]) | (split_by_3(y[i]) << 1) | (split_by_3(z[i]) << 2);
}

static inline uint32_t third_bits(uint64_t m) {
    uint64_t x = m & 0x1249249249249249ull;
    x = (x ^ (x >> 2)) & 0x10c30c30c30c30c3ull;
    x = (x ^ (x >> 4)) & 0x100f00f00f00f00full;
    x = (x ^ (x >> 8)) & 0x1f0000ff0000ffull;
    x = (x ^ (x >> 16)) & 0x1f00000000ffffull;
    x = (x ^ (x >> 32)) & 0x1fffffull;
    return (uint32_t)x;
}

void mvrt_morton_decode(const uint64_t* m, int64_t n, uint32_t* x,
                        uint32_t* y, uint32_t* z) {
    for (int64_t i = 0; i < n; i++) {
        x[i] = third_bits(m[i]);
        y[i] = third_bits(m[i] >> 1);
        z[i] = third_bits(m[i] >> 2);
    }
}

uint32_t mvrt_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
    uint32_t h1 = seed;
    const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
    int64_t nblocks = len / 4;
    for (int64_t i = 0; i < nblocks; i++) {
        uint32_t k1;
        memcpy(&k1, data + i * 4, 4);
        k1 *= c1;
        k1 = (k1 << 15) | (k1 >> 17);
        k1 *= c2;
        h1 ^= k1;
        h1 = (h1 << 13) | (h1 >> 19);
        h1 = h1 * 5 + 0xe6546b64;
    }
    uint32_t k1 = 0;
    const uint8_t* tail = data + nblocks * 4;
    switch (len & 3) {
        case 3: k1 ^= tail[2] << 16; [[fallthrough]];
        case 2: k1 ^= tail[1] << 8; [[fallthrough]];
        case 1:
            k1 ^= tail[0];
            k1 *= c1;
            k1 = (k1 << 15) | (k1 >> 17);
            k1 *= c2;
            h1 ^= k1;
    }
    h1 ^= (uint32_t)len;
    h1 ^= h1 >> 16;
    h1 *= 0x85ebca6b;
    h1 ^= h1 >> 13;
    h1 *= 0xc2b2ae35;
    h1 ^= h1 >> 16;
    return h1;
}

}  // extern "C"
