// Native feature-hashing text encoder — the writer-side embedding hot
// loop when no trained model is configured (embeddings/__init__.py
// hash_encode is the semantic oracle; tests enforce parity).
//
// Algorithm (must match the Python implementation exactly):
//   - words = [a-z0-9]+ over lowercased text
//   - word feature:        h64 = blake2b_8("w:" + w)     weight ±1.0
//   - char-trigram feats:  h64 = blake2b_8("c:" + w[j:j+3]) weight ±0.35
//   - word-bigram feats:   splitmix64(h_prev * GOLDEN + h_next) weight ±0.5
//   sign = +1 when bit 63 of the hash is set, else -1; bucket = h % dim;
//   accumulate, then L2-normalize.
//
// blake2b is implemented per RFC 7693 (digest_size=8 → the first 8
// little-endian bytes of h[0], i.e. h[0] itself).
//
// C ABI:
//   he_encode(text, dim, out_f32)                  -> 0
//   he_encode_batch(texts, offs, n, dim, out_f32)  -> 0
//     texts: concatenated UTF-8 bytes, offs: int64[n+1] boundaries,
//     out: float32[n * dim]. Releases the GIL for the whole batch
//     (ctypes drops it around the call).
//
// Build: native/_build.py (g++ -O2 -shared -fPIC) into build/native/.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <cmath>

namespace {

// ---------------------------------------------------------------------------
// blake2b (RFC 7693), 8-byte digest
// ---------------------------------------------------------------------------

const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL,
    0x3c6ef372fe94f82bULL, 0xa54ff53a5f1d36f1ULL,
    0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

inline void G(uint64_t* v, int a, int b, int c, int d,
              uint64_t x, uint64_t y) {
    v[a] = v[a] + v[b] + x;
    v[d] = rotr64(v[d] ^ v[a], 32);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 24);
    v[a] = v[a] + v[b] + y;
    v[d] = rotr64(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 63);
}

void compress(uint64_t h[8], const uint8_t block[128],
              uint64_t t, bool last) {
    uint64_t m[16];
    std::memcpy(m, block, 128);  // little-endian host assumed (x86/ARM)
    uint64_t v[16];
    std::memcpy(v, h, 64);
    std::memcpy(v + 8, IV, 64);
    v[12] ^= t;       // t0 (messages here are < 2^64 bytes)
    // v[13] ^= 0;    // t1
    if (last) v[14] = ~v[14];
    for (int r = 0; r < 12; r++) {
        const uint8_t* s = SIGMA[r];
        G(v, 0, 4, 8, 12, m[s[0]], m[s[1]]);
        G(v, 1, 5, 9, 13, m[s[2]], m[s[3]]);
        G(v, 2, 6, 10, 14, m[s[4]], m[s[5]]);
        G(v, 3, 7, 11, 15, m[s[6]], m[s[7]]);
        G(v, 0, 5, 10, 15, m[s[8]], m[s[9]]);
        G(v, 1, 6, 11, 12, m[s[10]], m[s[11]]);
        G(v, 2, 7, 8, 13, m[s[12]], m[s[13]]);
        G(v, 3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

uint64_t blake2b64(const uint8_t* data, size_t len) {
    uint64_t h[8];
    std::memcpy(h, IV, 64);
    h[0] ^= 0x01010000ULL ^ 8ULL;  // depth=1, fanout=1, keylen=0, outlen=8
    size_t off = 0;
    uint64_t t = 0;
    while (len - off > 128) {
        t += 128;
        compress(h, data + off, t, false);
        off += 128;
    }
    uint8_t block[128] = {0};
    size_t rem = len - off;
    if (rem) std::memcpy(block, data + off, rem);
    t += rem;
    compress(h, block, t, true);
    return h[0];  // first 8 LE digest bytes == h[0]
}

// ---------------------------------------------------------------------------
// splitmix64 finalizer (must match embeddings._mix64)
// ---------------------------------------------------------------------------

constexpr uint64_t GOLDEN = 0x9E3779B97F4A7C15ULL;

inline uint64_t mix64(uint64_t x) {
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

inline bool word_char(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
}

inline float hsign(uint64_t h) { return (h >> 63) ? 1.0f : -1.0f; }

void encode_one(const char* text, size_t len, int dim, float* out) {
    std::vector<double> acc(dim, 0.0);
    std::vector<uint64_t> hs;
    hs.reserve(32);
    std::string key;
    key.reserve(64);
    std::string word;
    word.reserve(32);
    const unsigned char* p = (const unsigned char*)text;
    size_t i = 0;
    bool any = false;
    auto flush = [&]() {
        if (word.empty()) return;
        any = true;
        key.assign("w:");
        key += word;
        uint64_t h = blake2b64((const uint8_t*)key.data(), key.size());
        acc[h % (uint64_t)dim] += hsign(h);
        hs.push_back(h);
        for (size_t j = 0; j + 3 <= word.size(); j++) {
            key.assign("c:");
            key.append(word, j, 3);
            uint64_t h2 = blake2b64((const uint8_t*)key.data(), key.size());
            acc[h2 % (uint64_t)dim] += 0.35 * (double)hsign(h2);
        }
        word.clear();
    };
    while (i < len) {
        unsigned char c = p[i];
        if (c >= 'A' && c <= 'Z') c += 32;  // ASCII lower (callers gate
                                            // non-ASCII to the oracle)
        if (word_char(c)) word += (char)c;
        else flush();
        i++;
    }
    flush();
    if (!any) {
        std::memset(out, 0, sizeof(float) * dim);
        return;
    }
    for (size_t k = 0; k + 1 < hs.size(); k++) {
        uint64_t hb = mix64(hs[k] * GOLDEN + hs[k + 1]);
        acc[hb % (uint64_t)dim] += 0.5 * (double)hsign(hb);
    }
    double n2 = 0.0;
    for (int d = 0; d < dim; d++) {
        float f = (float)acc[d];
        out[d] = f;
        n2 += (double)f * (double)f;
    }
    double n = std::sqrt(n2);
    if (n > 0.0) {
        for (int d = 0; d < dim; d++) out[d] = (float)(out[d] / n);
    }
}

}  // namespace

extern "C" {

int he_encode(const char* text, int32_t dim, float* out) {
    encode_one(text, std::strlen(text), dim, out);
    return 0;
}

int he_encode_batch(const char* texts, const int64_t* offs, int32_t n,
                    int32_t dim, float* out) {
    for (int32_t k = 0; k < n; k++) {
        encode_one(texts + offs[k], (size_t)(offs[k + 1] - offs[k]), dim,
                   out + (int64_t)k * dim);
    }
    return 0;
}

}  // extern "C"
