// Decoders of the Parquet page codecs that the standard library lacks:
// ZSTD frames (RFC 8878), LZ4 blocks (raw, and in Hadoop's framing) and
// BROTLI streams (RFC 7932).
// Host code, built with the host compiler and loaded with ctypes by
// data/parquet.py.
//
// Every function writes at most `capacity` bytes to `dst` (the page
// header's uncompressed size) and returns the bytes written, or -1 with a
// message in `err`. Every table read, offset and length is checked against
// its buffer, so a corrupt page fails with a message and never reads or
// writes out of bounds.
//
// ZSTD: raw, RLE and compressed blocks; literals raw, RLE, Huffman-coded
// (one or four streams) or treeless (the previous block's table); Huffman
// weights direct or FSE-coded; the three sequence tables predefined, RLE,
// FSE-coded or repeated; the repeat offsets; frames one after another,
// skippable frames; the content checksum (XXH64's low 32 bits) where the
// frame has one. A frame with a dictionary ID is refused: Parquet writes
// none.
//
// BROTLI: see the section below; no brotli library is linked or loaded.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
    std::string message;
};

[[noreturn]] void fail(const char* message) { throw Error{message}; }

inline uint32_t read_le32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

inline uint64_t read_le64(const uint8_t* p) {
    return (uint64_t)read_le32(p) | ((uint64_t)read_le32(p + 4) << 32);
}

inline int highest_bit(uint64_t v) {  // v > 0
    return 63 - __builtin_clzll(v);
}

// -- XXH64 ------------------------------------------------------------------

const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl(acc, 31);
    return acc * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
    acc ^= xxh_round(0, v);
    return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh_round(v1, read_le64(p));
            v2 = xxh_round(v2, read_le64(p + 8));
            v3 = xxh_round(v3, read_le64(p + 16));
            v4 = xxh_round(v4, read_le64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = P5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= xxh_round(0, read_le64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read_le32(p) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (uint64_t)(*p) * P5;
        h = rotl(h, 11) * P1;
        ++p;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// -- bit streams --------------------------------------------------------------

// A forward stream of little-endian bits (FSE table descriptions).
struct ForwardBits {
    const uint8_t* p;
    size_t size;
    size_t bit = 0;

    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++bit) {
            if ((bit >> 3) >= size) fail("an FSE table description ends early");
            v |= (uint32_t)((p[bit >> 3] >> (bit & 7)) & 1) << i;
        }
        return v;
    }
    void rewind(int n) { bit -= n; }
    size_t bytes_used() const { return (bit + 7) >> 3; }
};

// A backward stream (Huffman and FSE payloads): it starts after the last
// byte's highest set bit and reads towards the first byte. Reads past the
// start give zero bits and leave `offset` negative.
struct BackwardBits {
    const uint8_t* p;
    int64_t offset;  // bits still to read

    BackwardBits(const uint8_t* src, size_t size) : p(src) {
        if (size == 0) fail("an empty bit stream");
        uint8_t last = src[size - 1];
        if (last == 0) fail("a bit stream without its end marker");
        offset = (int64_t)size * 8 - 8 + highest_bit(last);
    }

    // n <= 56 (the widest read is an offset's 31 bits)
    uint64_t read(int n) {
        if (n == 0) return 0;
        offset -= n;
        int64_t start = offset;
        int width = n;
        if (start < 0) {
            width += (int)start;
            start = 0;
        }
        if (width <= 0) return 0;
        // the bits [start, start + width), which lie inside the stream
        size_t byte = (size_t)start >> 3;
        int shift = (int)(start & 7);
        int nbytes = (shift + width + 7) >> 3;
        uint64_t w = 0;
        for (int k = 0; k < nbytes; ++k) w |= (uint64_t)p[byte + k] << (8 * k);
        uint64_t v = (w >> shift) & (((uint64_t)1 << width) - 1);
        return offset < 0 ? v << -offset : v;
    }
};

// -- FSE --------------------------------------------------------------------

const int FSE_MAX_SYMBOLS = 256;
const int FSE_MAX_LOG = 9;

struct FseTable {
    int log = 0;
    uint8_t symbol[1 << FSE_MAX_LOG];
    uint8_t bits[1 << FSE_MAX_LOG];
    uint16_t base[1 << FSE_MAX_LOG];
};

void fse_build(FseTable& t, const int16_t* freqs, int n_symbols, int log) {
    if (log > FSE_MAX_LOG) fail("an FSE accuracy log past its maximum");
    int size = 1 << log;
    t.log = log;
    uint16_t next[FSE_MAX_SYMBOLS];
    int high = size;
    int64_t total = 0;
    for (int s = 0; s < n_symbols; ++s) {
        if (freqs[s] == -1) {
            if (high <= 0) fail("an FSE table overflows");
            t.symbol[--high] = (uint8_t)s;
            next[s] = 1;
            total += 1;
        } else {
            total += freqs[s];
        }
    }
    if (total != size) fail("FSE probabilities that do not sum to the table");
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < n_symbols; ++s) {
        if (freqs[s] <= 0) continue;
        next[s] = (uint16_t)freqs[s];
        for (int i = 0; i < freqs[s]; ++i) {
            t.symbol[pos] = (uint8_t)s;
            do {
                pos = (pos + step) & mask;
            } while (pos >= high);
        }
    }
    if (pos != 0) fail("a corrupt FSE table");
    for (int i = 0; i < size; ++i) {
        uint16_t state = next[t.symbol[i]]++;
        int nb = log - highest_bit(state);
        t.bits[i] = (uint8_t)nb;
        t.base[i] = (uint16_t)(((uint32_t)state << nb) - size);
    }
}

// Read an FSE table description; return the bytes it took.
size_t fse_read(FseTable& t, const uint8_t* src, size_t size, int max_log,
                int max_symbols) {
    ForwardBits in{src, size};
    int log = (int)in.read(4) + 5;
    if (log > max_log) fail("an FSE accuracy log past its maximum");
    int32_t remaining = 1 << log;
    int16_t freqs[FSE_MAX_SYMBOLS];
    int s = 0;
    while (remaining > 0 && s < max_symbols) {
        int nb = highest_bit((uint64_t)remaining + 1) + 1;
        uint32_t val = in.read(nb);
        uint32_t lower_mask = ((uint32_t)1 << (nb - 1)) - 1;
        uint32_t threshold = ((uint32_t)1 << nb) - 1 - ((uint32_t)remaining + 1);
        if ((val & lower_mask) < threshold) {
            in.rewind(1);
            val &= lower_mask;
        } else if (val > lower_mask) {
            val -= threshold;
        }
        int16_t proba = (int16_t)((int)val - 1);
        remaining -= proba < 0 ? -proba : proba;
        freqs[s++] = proba;
        if (proba == 0) {
            uint32_t repeat = in.read(2);
            while (true) {
                for (uint32_t i = 0; i < repeat && s < max_symbols; ++i)
                    freqs[s++] = 0;
                if (repeat != 3) break;
                repeat = in.read(2);
            }
        }
    }
    if (remaining != 0) fail("a corrupt FSE table description");
    fse_build(t, freqs, s, log);
    return in.bytes_used();
}

void fse_rle(FseTable& t, uint8_t symbol) {
    t.log = 0;
    t.symbol[0] = symbol;
    t.bits[0] = 0;
    t.base[0] = 0;
}

struct FseState {
    const FseTable* t;
    uint32_t state;
    void init(const FseTable& table, BackwardBits& in) {
        t = &table;
        state = (uint32_t)in.read(table.log);
    }
    uint8_t peek() const { return t->symbol[state]; }
    void update(BackwardBits& in) {
        state = t->base[state] + (uint32_t)in.read(t->bits[state]);
    }
};

// -- Huffman ----------------------------------------------------------------

const int HUF_MAX_BITS = 11;

struct HufTable {
    int max_bits = 0;
    uint8_t symbol[1 << HUF_MAX_BITS];
    uint8_t bits[1 << HUF_MAX_BITS];
};

void huf_from_weights(HufTable& t, const uint8_t* weights, int n) {
    // n weights given; the last symbol's is implied
    uint64_t sum = 0;
    for (int i = 0; i < n; ++i) {
        if (weights[i] > HUF_MAX_BITS) fail("a Huffman weight past 11");
        if (weights[i]) sum += (uint64_t)1 << (weights[i] - 1);
    }
    if (sum == 0) fail("Huffman weights that are all zero");
    int max_bits = highest_bit(sum) + 1;
    uint64_t left = ((uint64_t)1 << max_bits) - sum;
    if (left & (left - 1)) fail("Huffman weights that do not sum to a power of two");
    if (max_bits > HUF_MAX_BITS) fail("a Huffman code past 11 bits");
    uint8_t all[256];
    int count = n + 1;
    if (count > 256) fail("too many Huffman weights");
    std::memcpy(all, weights, n);
    all[n] = (uint8_t)(highest_bit(left) + 1);
    uint8_t nbits[256];
    int rank_count[HUF_MAX_BITS + 2] = {0};
    for (int i = 0; i < count; ++i) {
        nbits[i] = all[i] ? (uint8_t)(max_bits + 1 - all[i]) : 0;
        rank_count[nbits[i]]++;
    }
    uint32_t rank_idx[HUF_MAX_BITS + 2];
    rank_idx[max_bits] = 0;
    for (int i = max_bits; i >= 1; --i) {
        rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
        for (uint32_t j = rank_idx[i]; j < rank_idx[i - 1]; ++j)
            t.bits[j] = (uint8_t)i;
    }
    if (rank_idx[0] != (1u << max_bits)) fail("a corrupt Huffman table");
    for (int i = 0; i < count; ++i) {
        if (!nbits[i]) continue;
        uint32_t code = rank_idx[nbits[i]];
        uint32_t len = 1u << (max_bits - nbits[i]);
        std::memset(&t.symbol[code], i, len);
        rank_idx[nbits[i]] += len;
    }
    t.max_bits = max_bits;
}

// Read a Huffman tree description; return the bytes it took.
size_t huf_read(HufTable& t, const uint8_t* src, size_t size) {
    if (size < 1) fail("a Huffman tree description ends early");
    uint8_t header = src[0];
    uint8_t weights[256];
    int n = 0;
    size_t used;
    if (header >= 128) {
        n = header - 127;
        size_t bytes = (size_t)(n + 1) / 2;
        if (1 + bytes > size) fail("a Huffman tree description ends early");
        for (int i = 0; i < n; ++i) {
            uint8_t b = src[1 + i / 2];
            weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
        }
        used = 1 + bytes;
    } else {
        size_t csize = header;
        if (csize == 0 || 1 + csize > size)
            fail("a Huffman tree description ends early");
        const uint8_t* p = src + 1;
        FseTable table;
        size_t desc = fse_read(table, p, csize, 6, FSE_MAX_SYMBOLS);
        if (desc >= csize) fail("a corrupt Huffman weight stream");
        BackwardBits in(p + desc, csize - desc);
        FseState s1, s2;
        s1.init(table, in);
        s2.init(table, in);
        while (true) {
            if (n >= 255) fail("too many Huffman weights");
            weights[n++] = s1.peek();
            s1.update(in);
            if (in.offset < 0) {
                if (n >= 255) fail("too many Huffman weights");
                weights[n++] = s2.peek();
                break;
            }
            if (n >= 255) fail("too many Huffman weights");
            weights[n++] = s2.peek();
            s2.update(in);
            if (in.offset < 0) {
                if (n >= 255) fail("too many Huffman weights");
                weights[n++] = s1.peek();
                break;
            }
        }
        used = 1 + csize;
    }
    huf_from_weights(t, weights, n);
    return used;
}

void huf_stream(const HufTable& t, const uint8_t* src, size_t size,
                uint8_t* out, size_t n) {
    BackwardBits in(src, size);
    uint32_t mask = (1u << t.max_bits) - 1;
    uint32_t state = (uint32_t)in.read(t.max_bits);
    for (size_t i = 0; i < n; ++i) {
        out[i] = t.symbol[state];
        int nb = t.bits[state];
        state = ((state << nb) | (uint32_t)in.read(nb)) & mask;
    }
    // every bit used: the state's max_bits were read ahead of the last
    // symbol's code, so the stream ends max_bits under its end
    if (in.offset != -(int64_t)t.max_bits)
        fail("a Huffman stream of the wrong length");
}

// -- sequences ----------------------------------------------------------------

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,   10,  11,   12,   13,   14,   15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
    HufTable huf;
    bool have_huf = false;
    FseTable ll, of, ml;
    bool have_ll = false, have_of = false, have_ml = false;
    uint64_t rep[3] = {1, 4, 8};
};

// One of the three sequence tables by its mode; return the bytes it took.
size_t seq_table(FseTable& t, bool& have, int mode, const uint8_t* src,
                 size_t size, const int16_t* defaults, int n_defaults,
                 int default_log, int max_log, int max_symbol) {
    switch (mode) {
    case 0:
        fse_build(t, defaults, n_defaults, default_log);
        have = true;
        return 0;
    case 1:
        if (size < 1) fail("a sequence section ends early");
        if (src[0] > max_symbol) fail("an RLE sequence code past its maximum");
        fse_rle(t, src[0]);
        have = true;
        return 1;
    case 2: {
        size_t used = fse_read(t, src, size, max_log, max_symbol + 1);
        if (used > size) fail("a sequence section ends early");
        have = true;
        return used;
    }
    default:
        if (!have) fail("a repeated sequence table with none before it");
        return 0;
    }
}

struct Output {
    uint8_t* dst;
    size_t capacity;
    size_t pos;
    size_t frame_start;

    void need(size_t n) {
        if (n > capacity - pos)
            fail("the page decompresses past its uncompressed size");
    }
    void put(const uint8_t* src, size_t n) {
        need(n);
        std::memcpy(dst + pos, src, n);
        pos += n;
    }
    void fill(uint8_t b, size_t n) {
        need(n);
        std::memset(dst + pos, b, n);
        pos += n;
    }
    void copy_match(uint64_t offset, size_t n) {
        if (offset == 0 || offset > pos - frame_start)
            fail("a match reaches before the frame's start");
        need(n);
        uint8_t* o = dst + pos;
        const uint8_t* m = o - offset;
        if (offset >= n) {
            std::memcpy(o, m, n);
        } else {
            for (size_t i = 0; i < n; ++i) o[i] = m[i];  // overlapping
        }
        pos += n;
    }
};

void compressed_block(FrameState& fs, const uint8_t* src, size_t size,
                      Output& out) {
    // literals section
    if (size < 1) fail("an empty compressed block");
    int type = src[0] & 3;
    int format = (src[0] >> 2) & 3;
    size_t regen = 0, csize = 0, header = 0;
    int streams = 1;
    if (type < 2) {
        if (format == 0 || format == 2) {
            header = 1;
            regen = src[0] >> 3;
        } else if (format == 1) {
            header = 2;
            if (size < 2) fail("a literals header ends early");
            regen = (src[0] >> 4) + ((size_t)src[1] << 4);
        } else {
            header = 3;
            if (size < 3) fail("a literals header ends early");
            regen = (src[0] >> 4) + ((size_t)src[1] << 4) +
                    ((size_t)src[2] << 12);
        }
    } else {
        int nbits;
        if (format < 2) {
            header = 3;
            nbits = 10;
            streams = format == 0 ? 1 : 4;
        } else {
            header = format == 2 ? 4 : 5;
            nbits = format == 2 ? 14 : 18;
            streams = 4;
        }
        if (size < header) fail("a literals header ends early");
        uint64_t h = 0;
        for (size_t i = 0; i < header; ++i) h |= (uint64_t)src[i] << (8 * i);
        h >>= 4;
        regen = (size_t)(h & ((1u << nbits) - 1));
        csize = (size_t)((h >> nbits) & ((1u << nbits) - 1));
    }
    if (regen > (1u << 17)) fail("a block's literals past 128 KiB");
    static thread_local uint8_t literals[(1 << 17) + 32];
    size_t pos = header;
    if (type == 0) {
        if (pos + regen > size) fail("raw literals end early");
        std::memcpy(literals, src + pos, regen);
        pos += regen;
    } else if (type == 1) {
        if (pos + 1 > size) fail("RLE literals end early");
        std::memset(literals, src[pos], regen);
        pos += 1;
    } else {
        if (pos + csize > size) fail("compressed literals end early");
        const uint8_t* p = src + pos;
        size_t n = csize;
        if (type == 2) {
            size_t used = huf_read(fs.huf, p, n);
            fs.have_huf = true;
            p += used;
            n -= used;
        } else if (!fs.have_huf) {
            fail("treeless literals with no Huffman table before them");
        }
        if (streams == 1) {
            huf_stream(fs.huf, p, n, literals, regen);
        } else {
            if (n < 6) fail("a jump table ends early");
            size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8),
                   s3 = p[4] | (p[5] << 8);
            if (6 + s1 + s2 + s3 > n) fail("a jump table past its literals");
            size_t s4 = n - 6 - s1 - s2 - s3;
            size_t per = (regen + 3) / 4;
            if (3 * per > regen) fail("too few literals for four streams");
            const uint8_t* q = p + 6;
            huf_stream(fs.huf, q, s1, literals, per);
            huf_stream(fs.huf, q + s1, s2, literals + per, per);
            huf_stream(fs.huf, q + s1 + s2, s3, literals + 2 * per, per);
            huf_stream(fs.huf, q + s1 + s2 + s3, s4, literals + 3 * per,
                       regen - 3 * per);
        }
        pos += csize;
    }

    // sequences section
    if (pos >= size) fail("a block without its sequences section");
    uint32_t n_seq;
    uint8_t b0 = src[pos];
    if (b0 < 128) {
        n_seq = b0;
        pos += 1;
    } else if (b0 < 255) {
        if (pos + 2 > size) fail("a sequence count ends early");
        n_seq = ((uint32_t)(b0 - 128) << 8) + src[pos + 1];
        pos += 2;
    } else {
        if (pos + 3 > size) fail("a sequence count ends early");
        n_seq = src[pos + 1] + ((uint32_t)src[pos + 2] << 8) + 0x7F00;
        pos += 3;
    }
    const uint8_t* lit = literals;
    size_t lit_left = regen;
    if (n_seq == 0) {
        if (pos != size) fail("bytes after an empty sequence section");
        out.put(lit, lit_left);
        return;
    }
    if (pos >= size) fail("a sequence section ends early");
    uint8_t modes = src[pos++];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    pos += seq_table(fs.ll, fs.have_ll, modes >> 6, src + pos, size - pos,
                     LL_DEFAULT, 36, 6, 9, 35);
    pos += seq_table(fs.of, fs.have_of, (modes >> 4) & 3, src + pos,
                     size - pos, OF_DEFAULT, 29, 5, 8, 31);
    pos += seq_table(fs.ml, fs.have_ml, (modes >> 2) & 3, src + pos,
                     size - pos, ML_DEFAULT, 53, 6, 9, 52);
    if (pos >= size) fail("a sequence section without its bit stream");
    BackwardBits in(src + pos, size - pos);
    FseState ll, of, ml;
    ll.init(fs.ll, in);
    of.init(fs.of, in);
    ml.init(fs.ml, in);
    for (uint32_t i = 0; i < n_seq; ++i) {
        uint8_t of_code = of.peek(), ml_code = ml.peek(), ll_code = ll.peek();
        if (of_code > 31 || ml_code > 52 || ll_code > 35)
            fail("a sequence code past its maximum");
        uint64_t of_value = ((uint64_t)1 << of_code) + in.read(of_code);
        uint64_t match = ML_BASE[ml_code] + in.read(ML_BITS[ml_code]);
        uint64_t length = LL_BASE[ll_code] + in.read(LL_BITS[ll_code]);
        uint64_t offset;
        if (of_value > 3) {
            offset = of_value - 3;
            fs.rep[2] = fs.rep[1];
            fs.rep[1] = fs.rep[0];
            fs.rep[0] = offset;
        } else {
            uint64_t idx = of_value - 1;
            if (length == 0) idx++;
            if (idx == 0) {
                offset = fs.rep[0];
            } else {
                offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
                if (idx > 1) fs.rep[2] = fs.rep[1];
                fs.rep[1] = fs.rep[0];
                fs.rep[0] = offset;
            }
        }
        if (i + 1 < n_seq) {
            ll.update(in);
            ml.update(in);
            of.update(in);
        }
        if (in.offset < 0) fail("a sequence bit stream ends early");
        if (length > lit_left) fail("a sequence takes more literals than there are");
        out.put(lit, (size_t)length);
        lit += length;
        lit_left -= (size_t)length;
        out.copy_match(offset, (size_t)match);
    }
    if (in.offset != 0) fail("a sequence bit stream of the wrong length");
    out.put(lit, lit_left);
}

size_t zstd_frame(const uint8_t* src, size_t size, Output& out) {
    // after the magic number
    size_t pos = 0;
    if (size < 1) fail("a ZSTD frame header ends early");
    uint8_t fhd = src[pos++];
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    bool checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    if (fhd & 8) fail("a reserved bit set in a ZSTD frame header");
    if (!single) pos += 1;  // the window descriptor: one buffer holds it all
    static const int DICT_BYTES[4] = {0, 1, 2, 4};
    int dict_bytes = DICT_BYTES[dict_flag];
    if (pos + dict_bytes > size) fail("a ZSTD frame header ends early");
    uint32_t dict_id = 0;
    for (int i = 0; i < dict_bytes; ++i)
        dict_id |= (uint32_t)src[pos + i] << (8 * i);
    if (dict_id != 0)
        fail("a ZSTD frame with a dictionary ID (Parquet writes none)");
    pos += dict_bytes;
    int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
    if (pos + fcs_bytes > size) fail("a ZSTD frame header ends early");
    uint64_t content = 0;
    for (int i = 0; i < fcs_bytes; ++i)
        content |= (uint64_t)src[pos + i] << (8 * i);
    if (fcs_bytes == 2) content += 256;
    pos += fcs_bytes;
    out.frame_start = out.pos;
    FrameState fs;
    while (true) {
        if (pos + 3 > size) fail("a ZSTD block header ends early");
        uint32_t bh = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
        pos += 3;
        bool last = bh & 1;
        int type = (bh >> 1) & 3;
        size_t bsize = bh >> 3;
        if (type == 0) {
            if (pos + bsize > size) fail("a raw ZSTD block ends early");
            out.put(src + pos, bsize);
            pos += bsize;
        } else if (type == 1) {
            if (pos + 1 > size) fail("an RLE ZSTD block ends early");
            out.fill(src[pos], bsize);
            pos += 1;
        } else if (type == 2) {
            if (pos + bsize > size) fail("a compressed ZSTD block ends early");
            if (bsize > (1u << 17)) fail("a ZSTD block past 128 KiB");
            compressed_block(fs, src + pos, bsize, out);
            pos += bsize;
        } else {
            fail("a reserved ZSTD block type");
        }
        if (last) break;
    }
    size_t produced = out.pos - out.frame_start;
    if (fcs_bytes && content != produced)
        fail("a ZSTD frame's content size disagrees with its blocks");
    if (checksum) {
        if (pos + 4 > size) fail("a ZSTD checksum ends early");
        uint32_t want = read_le32(src + pos);
        uint32_t got = (uint32_t)xxh64(out.dst + out.frame_start, produced);
        if (want != got) fail("a ZSTD frame's checksum does not match");
        pos += 4;
    }
    return pos;
}

size_t zstd_decompress(const uint8_t* src, size_t size, uint8_t* dst,
                       size_t capacity) {
    Output out{dst, capacity, 0, 0};
    size_t pos = 0;
    while (pos < size) {
        if (size - pos < 4) fail("bytes after the last ZSTD frame");
        uint32_t magic = read_le32(src + pos);
        pos += 4;
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
            if (size - pos < 4) fail("a skippable frame ends early");
            uint32_t n = read_le32(src + pos);
            pos += 4;
            if (n > size - pos) fail("a skippable frame ends early");
            pos += n;
        } else if (magic == 0xFD2FB528u) {
            pos += zstd_frame(src + pos, size - pos, out);
        } else {
            fail("not a ZSTD frame (bad magic number)");
        }
    }
    return out.pos;
}

// -- LZ4 --------------------------------------------------------------------

size_t lz4_block(const uint8_t* src, size_t size, uint8_t* dst,
                 size_t capacity) {
    Output out{dst, capacity, 0, 0};
    size_t pos = 0;
    if (size == 0) return 0;
    while (true) {
        if (pos >= size) fail("an LZ4 block ends early");
        uint8_t token = src[pos++];
        size_t length = token >> 4;
        if (length == 15) {
            uint8_t b;
            do {
                if (pos >= size) fail("an LZ4 literal length ends early");
                b = src[pos++];
                length += b;
            } while (b == 255);
        }
        if (length > size - pos) fail("LZ4 literals end early");
        out.put(src + pos, length);
        pos += length;
        if (pos == size) break;  // the last sequence has literals only
        if (size - pos < 2) fail("an LZ4 offset ends early");
        uint32_t offset = src[pos] | (src[pos + 1] << 8);
        pos += 2;
        size_t match = (token & 15);
        if (match == 15) {
            uint8_t b;
            do {
                if (pos >= size) fail("an LZ4 match length ends early");
                b = src[pos++];
                match += b;
            } while (b == 255);
        }
        out.copy_match(offset, match + 4);
    }
    return out.pos;
}

// Arrow's Lz4HadoopCodec: frames of (big-endian uncompressed length,
// big-endian compressed length, block); -1 where they do not account for
// the whole input.
int64_t lz4_hadoop(const uint8_t* src, size_t size, uint8_t* dst,
                   size_t capacity) {
    size_t pos = 0, written = 0;
    while (size - pos >= 8) {
        uint32_t raw = ((uint32_t)src[pos] << 24) | (src[pos + 1] << 16) |
                       (src[pos + 2] << 8) | src[pos + 3];
        uint32_t packed = ((uint32_t)src[pos + 4] << 24) |
                          (src[pos + 5] << 16) | (src[pos + 6] << 8) |
                          src[pos + 7];
        pos += 8;
        if (packed > size - pos || raw > capacity - written) return -1;
        size_t got;
        try {
            got = lz4_block(src + pos, packed, dst + written, capacity - written);
        } catch (const Error&) {
            return -1;
        }
        if (got != raw) return -1;
        pos += packed;
        written += got;
    }
    return pos == size ? (int64_t)written : -1;
}

// -- BROTLI (RFC 7932) ------------------------------------------------------
//
// One stream into a flat output buffer (a page's whole size is known, so
// the window is the output itself): meta-blocks uncompressed, metadata or
// compressed; simple and complex prefix codes; block types and counts for
// literals, insert-and-copy commands and distances; NPOSTFIX/NDIRECT; the
// four literal context modes and the context maps (zero runs, inverse
// move-to-front); the last-four-distances ring; references past the window
// into the static dictionary with Appendix B's 121 transforms. The
// dictionary (Appendix A, 122,784 bytes) is handed over once by the caller
// (pq_brotli_set_dictionary), which checks its digest.

namespace brotli {

struct Transform {
    const char* prefix;
    int type;
    const char* suffix;
};

enum {
    kIdentity = 0,
    kOmitLast1, kOmitLast2, kOmitLast3, kOmitLast4, kOmitLast5, kOmitLast6,
    kOmitLast7, kOmitLast8, kOmitLast9,
    kUppercaseFirst, kUppercaseAll,
    kOmitFirst1, kOmitFirst2, kOmitFirst3, kOmitFirst4, kOmitFirst5,
    kOmitFirst6, kOmitFirst7, kOmitFirst8, kOmitFirst9
};

// Section 7.1: the context lookup tables of the UTF8 and signed modes, and
// below Appendix B's transforms, as libbrotlicommon 1.0.9 holds them
const uint8_t kLut0[256] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 0, 0, 4, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    8, 12, 16, 12, 12, 20, 12, 16, 24, 28, 12, 12, 32, 12, 36, 12,
    44, 44, 44, 44, 44, 44, 44, 44, 44, 44, 32, 32, 24, 40, 28, 12,
    12, 48, 52, 52, 52, 48, 52, 52, 52, 48, 52, 52, 52, 52, 52, 48,
    52, 52, 52, 52, 52, 48, 52, 52, 52, 52, 52, 24, 12, 28, 12, 12,
    12, 56, 60, 60, 60, 56, 60, 60, 60, 56, 60, 60, 60, 60, 60, 56,
    60, 60, 60, 60, 60, 56, 60, 60, 60, 60, 60, 24, 12, 28, 12, 0,
    0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1,
    2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3,
    2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3,
    2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3,
    2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3,
};
const uint8_t kLut1[256] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,
    1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
    1, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 1, 1, 1, 1, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
};
const uint8_t kLut2[256] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7,
};
const Transform kTransforms[121] = {
    {"", kIdentity, ""},  // 0
    {"", kIdentity, " "},  // 1
    {" ", kIdentity, " "},  // 2
    {"", kOmitFirst1, ""},  // 3
    {"", kUppercaseFirst, " "},  // 4
    {"", kIdentity, " the "},  // 5
    {" ", kIdentity, ""},  // 6
    {"s ", kIdentity, " "},  // 7
    {"", kIdentity, " of "},  // 8
    {"", kUppercaseFirst, ""},  // 9
    {"", kIdentity, " and "},  // 10
    {"", kOmitFirst2, ""},  // 11
    {"", kOmitLast1, ""},  // 12
    {", ", kIdentity, " "},  // 13
    {"", kIdentity, ", "},  // 14
    {" ", kUppercaseFirst, " "},  // 15
    {"", kIdentity, " in "},  // 16
    {"", kIdentity, " to "},  // 17
    {"e ", kIdentity, " "},  // 18
    {"", kIdentity, "\""},  // 19
    {"", kIdentity, "."},  // 20
    {"", kIdentity, "\">"},  // 21
    {"", kIdentity, "\x0a"},  // 22
    {"", kOmitLast3, ""},  // 23
    {"", kIdentity, "]"},  // 24
    {"", kIdentity, " for "},  // 25
    {"", kOmitFirst3, ""},  // 26
    {"", kOmitLast2, ""},  // 27
    {"", kIdentity, " a "},  // 28
    {"", kIdentity, " that "},  // 29
    {" ", kUppercaseFirst, ""},  // 30
    {"", kIdentity, ". "},  // 31
    {".", kIdentity, ""},  // 32
    {" ", kIdentity, ", "},  // 33
    {"", kOmitFirst4, ""},  // 34
    {"", kIdentity, " with "},  // 35
    {"", kIdentity, "'"},  // 36
    {"", kIdentity, " from "},  // 37
    {"", kIdentity, " by "},  // 38
    {"", kOmitFirst5, ""},  // 39
    {"", kOmitFirst6, ""},  // 40
    {" the ", kIdentity, ""},  // 41
    {"", kOmitLast4, ""},  // 42
    {"", kIdentity, ". The "},  // 43
    {"", kUppercaseAll, ""},  // 44
    {"", kIdentity, " on "},  // 45
    {"", kIdentity, " as "},  // 46
    {"", kIdentity, " is "},  // 47
    {"", kOmitLast7, ""},  // 48
    {"", kOmitLast1, "ing "},  // 49
    {"", kIdentity, "\x0a" "\x09"},  // 50
    {"", kIdentity, ":"},  // 51
    {" ", kIdentity, ". "},  // 52
    {"", kIdentity, "ed "},  // 53
    {"", kOmitFirst9, ""},  // 54
    {"", kOmitFirst7, ""},  // 55
    {"", kOmitLast6, ""},  // 56
    {"", kIdentity, "("},  // 57
    {"", kUppercaseFirst, ", "},  // 58
    {"", kOmitLast8, ""},  // 59
    {"", kIdentity, " at "},  // 60
    {"", kIdentity, "ly "},  // 61
    {" the ", kIdentity, " of "},  // 62
    {"", kOmitLast5, ""},  // 63
    {"", kOmitLast9, ""},  // 64
    {" ", kUppercaseFirst, ", "},  // 65
    {"", kUppercaseFirst, "\""},  // 66
    {".", kIdentity, "("},  // 67
    {"", kUppercaseAll, " "},  // 68
    {"", kUppercaseFirst, "\">"},  // 69
    {"", kIdentity, "=\""},  // 70
    {" ", kIdentity, "."},  // 71
    {".com/", kIdentity, ""},  // 72
    {" the ", kIdentity, " of the "},  // 73
    {"", kUppercaseFirst, "'"},  // 74
    {"", kIdentity, ". This "},  // 75
    {"", kIdentity, ","},  // 76
    {".", kIdentity, " "},  // 77
    {"", kUppercaseFirst, "("},  // 78
    {"", kUppercaseFirst, "."},  // 79
    {"", kIdentity, " not "},  // 80
    {" ", kIdentity, "=\""},  // 81
    {"", kIdentity, "er "},  // 82
    {" ", kUppercaseAll, " "},  // 83
    {"", kIdentity, "al "},  // 84
    {" ", kUppercaseAll, ""},  // 85
    {"", kIdentity, "='"},  // 86
    {"", kUppercaseAll, "\""},  // 87
    {"", kUppercaseFirst, ". "},  // 88
    {" ", kIdentity, "("},  // 89
    {"", kIdentity, "ful "},  // 90
    {" ", kUppercaseFirst, ". "},  // 91
    {"", kIdentity, "ive "},  // 92
    {"", kIdentity, "less "},  // 93
    {"", kUppercaseAll, "'"},  // 94
    {"", kIdentity, "est "},  // 95
    {" ", kUppercaseFirst, "."},  // 96
    {"", kUppercaseAll, "\">"},  // 97
    {" ", kIdentity, "='"},  // 98
    {"", kUppercaseFirst, ","},  // 99
    {"", kIdentity, "ize "},  // 100
    {"", kUppercaseAll, "."},  // 101
    {"\xc2" "\xa0", kIdentity, ""},  // 102
    {" ", kIdentity, ","},  // 103
    {"", kUppercaseFirst, "=\""},  // 104
    {"", kUppercaseAll, "=\""},  // 105
    {"", kIdentity, "ous "},  // 106
    {"", kUppercaseAll, ", "},  // 107
    {"", kUppercaseFirst, "='"},  // 108
    {" ", kUppercaseFirst, ","},  // 109
    {" ", kUppercaseAll, "=\""},  // 110
    {" ", kUppercaseAll, ", "},  // 111
    {"", kUppercaseAll, ","},  // 112
    {"", kUppercaseAll, "("},  // 113
    {"", kUppercaseAll, ". "},  // 114
    {" ", kUppercaseAll, "."},  // 115
    {"", kUppercaseAll, "='"},  // 116
    {" ", kUppercaseAll, ". "},  // 117
    {" ", kUppercaseFirst, "=\""},  // 118
    {" ", kUppercaseAll, "='"},  // 119
    {" ", kUppercaseFirst, "='"},  // 120
};

const size_t kDictionarySize = 122784;
// Appendix A: log2 of the number of words of each length 4..24
const int kSizeBitsByLength[25] = {0,  0,  0,  0,  10, 10, 11, 11, 10,
                                   10, 10, 10, 10, 9,  9,  8,  7,  7,
                                   8,  7,  7,  6,  6,  5,  5};
const uint8_t* dictionary = nullptr;
uint32_t offsets_by_length[25];

// Section 4: the insert and copy length codes' bases and extra bits
const uint32_t kInsertBase[24] = {0,   1,   2,   3,    4,    5,    6,    8,
                                  10,  14,  18,  26,   34,   50,   66,   98,
                                  130, 194, 322, 578,  1090, 2114, 6210, 22594};
const int kInsertExtra[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2,  3,  3,
                              4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
const uint32_t kCopyBase[24] = {2,   3,   4,   5,   6,   7,    8,    9,
                                10,  12,  14,  18,  22,  30,   38,   54,
                                70,  102, 134, 198, 326, 582, 1094, 2118};
const int kCopyExtra[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  2,  2,
                            3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};
// Section 6: block count codes
const uint32_t kBlockBase[26] = {1,    5,    9,    13,   17,   25,  33,
                                 41,   49,   65,   81,   97,   113, 145,
                                 177,  209,  241,  305,  369,  497, 753,
                                 1265, 2289, 4337, 8433, 16625};
const int kBlockExtra[26] = {2, 2, 2, 2, 3, 3, 3, 3, 4,  4,  4,  4,  5,
                             5, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 24};
// Section 3.5: the order of the code length code lengths, and the static
// prefix code they are written in (indexed by the next four bits)
const int kCodeLengthOrder[18] = {1, 2,  3, 4,  0,  5,  17, 6,  16,
                                  7, 8,  9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeLengthPrefixLength[16] = {2, 2, 2, 3, 2, 2, 2, 4,
                                             2, 2, 2, 3, 2, 2, 2, 4};
const uint8_t kCodeLengthPrefixValue[16] = {0, 4, 3, 2, 0, 4, 3, 1,
                                            0, 4, 3, 2, 0, 4, 3, 5};

// Bits read least significant first; a read past the end fails.
struct BitReader {
    const uint8_t* src;
    size_t size;
    size_t pos = 0;  // next byte to load
    uint64_t acc = 0;
    int avail = 0;   // bits in acc
    size_t loaded_past_end = 0;  // zero bytes loaded past the end

    BitReader(const uint8_t* s, size_t n) : src(s), size(n) {}

    void fill(int need) {
        while (avail < need) {
            uint64_t byte = 0;
            if (pos < size) {
                byte = src[pos];
            } else {
                ++loaded_past_end;
            }
            ++pos;
            acc |= byte << avail;
            avail += 8;
        }
    }
    void check() const {
        // the zero bytes loaded past the end must not have been consumed
        if (loaded_past_end * 8 > (size_t)avail)
            fail("BROTLI: stream cut short");
    }
    uint32_t peek(int n) {
        fill(n);
        return (uint32_t)(acc & ((1ULL << n) - 1));
    }
    void drop(int n) {
        acc >>= n;
        avail -= n;
        check();
    }
    uint32_t read(int n) {
        if (n == 0) return 0;
        uint32_t v = peek(n);
        drop(n);
        return v;
    }
    // to the next byte boundary; the skipped bits must be zero
    void align() {
        int skip = avail & 7;
        if (read(skip) != 0) fail("BROTLI: nonzero padding bits");
    }
    // the next byte of the stream at a byte boundary
    size_t byte_position() const { return pos - (size_t)(avail / 8); }
    void skip_bytes(size_t n) {
        size_t at = byte_position();
        if (n > size - std::min(at, size) || at > size)
            fail("BROTLI: stream cut short");
        pos = at + n;
        acc = 0;
        avail = 0;
    }
};

// A canonical prefix code: codes assigned in order of (length, symbol),
// read one bit at a time from the code's most significant bit.
struct PrefixCode {
    uint16_t count[16] = {0};
    std::vector<uint16_t> symbols;
    int single = -1;  // the one symbol of a code of no bits

    void build(const uint8_t* lengths, int alphabet) {
        std::fill(count, count + 16, 0);
        symbols.clear();
        for (int s = 0; s < alphabet; ++s) ++count[lengths[s]];
        count[0] = 0;
        for (int len = 1; len < 16; ++len)
            for (int s = 0; s < alphabet; ++s)
                if (lengths[s] == len) symbols.push_back((uint16_t)s);
    }
    int decode(BitReader& br) const {
        if (single >= 0) return single;
        int code = 0, first = 0, index = 0;
        for (int len = 1; len < 16; ++len) {
            code |= (int)br.read(1);
            int n = count[len];
            if (code - n < first) return symbols[index + (code - first)];
            index += n;
            first = (first + n) << 1;
            code <<= 1;
        }
        fail("BROTLI: invalid prefix code");
    }
};

int bit_width(uint32_t v) {  // bits to write v
    int n = 0;
    while (v) {
        ++n;
        v >>= 1;
    }
    return n;
}

// Section 3.4 and 3.5: a prefix code over `alphabet` symbols
void read_prefix_code(BitReader& br, int alphabet, PrefixCode& code) {
    std::vector<uint8_t> lengths((size_t)alphabet, 0);
    code.single = -1;
    uint32_t hskip = br.read(2);
    if (hskip == 1) {  // simple
        int nsym = (int)br.read(2) + 1;
        int bits = bit_width((uint32_t)alphabet - 1);
        int sym[4];
        for (int i = 0; i < nsym; ++i) {
            sym[i] = (int)br.read(bits);
            if (sym[i] >= alphabet) fail("BROTLI: simple code symbol too big");
            for (int j = 0; j < i; ++j)
                if (sym[j] == sym[i]) fail("BROTLI: simple code repeats a symbol");
        }
        if (nsym == 1) {
            code.single = sym[0];
            return;
        }
        if (nsym == 2) {
            lengths[sym[0]] = lengths[sym[1]] = 1;
        } else if (nsym == 3) {
            lengths[sym[0]] = 1;
            lengths[sym[1]] = lengths[sym[2]] = 2;
        } else if (br.read(1) == 0) {
            for (int i = 0; i < 4; ++i) lengths[sym[i]] = 2;
        } else {
            lengths[sym[0]] = 1;
            lengths[sym[1]] = 2;
            lengths[sym[2]] = lengths[sym[3]] = 3;
        }
        code.build(lengths.data(), alphabet);
        return;
    }
    // complex: the code length code first
    uint8_t cl_lengths[18] = {0};
    int space = 32, num_codes = 0;
    for (int i = (int)hskip; i < 18; ++i) {
        uint32_t ix = br.peek(4);
        br.drop(kCodeLengthPrefixLength[ix]);
        int v = kCodeLengthPrefixValue[ix];
        cl_lengths[kCodeLengthOrder[i]] = (uint8_t)v;
        if (v != 0) {
            space -= 32 >> v;
            ++num_codes;
            if (space <= 0) break;
        }
    }
    if (!(num_codes == 1 || space == 0))
        fail("BROTLI: invalid code length code");
    PrefixCode cl_code;
    if (num_codes == 1) {
        for (int s = 0; s < 18; ++s)
            if (cl_lengths[s]) cl_code.single = s;
    } else {
        cl_code.build(cl_lengths, 18);
    }
    int symbol = 0, prev_len = 8, repeat = 0, repeat_len = 0;
    int left = 32768;
    while (symbol < alphabet && left > 0) {
        int len = cl_code.decode(br);
        if (len < 16) {
            repeat = 0;
            lengths[(size_t)symbol++] = (uint8_t)len;
            if (len != 0) {
                prev_len = len;
                left -= 32768 >> len;
            }
            continue;
        }
        int extra = len == 16 ? 2 : 3;
        int new_len = len == 16 ? prev_len : 0;
        if (repeat_len != new_len) {
            repeat = 0;
            repeat_len = new_len;
        }
        int old = repeat;
        if (repeat > 0) repeat = (repeat - 2) << extra;
        repeat += (int)br.read(extra) + 3;
        int delta = repeat - old;
        if (symbol + delta > alphabet) fail("BROTLI: code lengths overrun");
        for (int i = 0; i < delta; ++i) lengths[(size_t)symbol++] = (uint8_t)repeat_len;
        if (repeat_len != 0) left -= delta << (15 - repeat_len);
    }
    if (left != 0) fail("BROTLI: incomplete prefix code");
    code.build(lengths.data(), alphabet);
}

uint32_t read_var_uint8(BitReader& br) {  // Section 9.2: 0..255
    if (br.read(1) == 0) return 0;
    uint32_t n = br.read(3);
    if (n == 0) return 1;
    return br.read((int)n) + (1u << n);
}

uint32_t read_block_count(BitReader& br, const PrefixCode& code) {
    int c = code.decode(br);
    return kBlockBase[c] + br.read(kBlockExtra[c]);
}

// Section 7.3: a context map of `size` entries over `ntrees` trees
void read_context_map(BitReader& br, int ntrees, std::vector<uint8_t>& map) {
    std::fill(map.begin(), map.end(), 0);
    if (ntrees < 2) return;
    int rlemax = br.read(1) ? (int)br.read(4) + 1 : 0;
    PrefixCode code;
    read_prefix_code(br, ntrees + rlemax, code);
    size_t i = 0;
    while (i < map.size()) {
        int c = code.decode(br);
        if (c == 0) {
            map[i++] = 0;
        } else if (c <= rlemax) {
            size_t reps = ((size_t)1 << c) + br.read(c);
            if (reps > map.size() - i) fail("BROTLI: context map overrun");
            for (size_t k = 0; k < reps; ++k) map[i++] = 0;
        } else {
            map[i++] = (uint8_t)(c - rlemax);
        }
    }
    if (br.read(1)) {  // inverse move-to-front
        uint8_t mtf[256];
        for (int k = 0; k < 256; ++k) mtf[k] = (uint8_t)k;
        for (auto& v : map) {
            uint8_t index = v, value = mtf[index];
            v = value;
            std::memmove(mtf + 1, mtf, index);
            mtf[0] = value;
        }
    }
    for (auto v : map)
        if (v >= ntrees) fail("BROTLI: context map names a missing tree");
}

// Block types and counts of one category (Section 6)
struct Blocks {
    uint32_t ntypes = 1, type = 0, prev = 1, left = 1u << 24;
    PrefixCode types, counts;

    void read(BitReader& br) {
        ntypes = read_var_uint8(br) + 1;
        type = 0;
        prev = 1;
        left = 1u << 24;
        if (ntypes >= 2) {
            read_prefix_code(br, (int)ntypes + 2, types);
            read_prefix_code(br, 26, counts);
            left = read_block_count(br, counts);
        }
    }
    void next(BitReader& br) {  // one symbol of this category
        if (left == 0) {
            int c = types.decode(br);
            uint32_t t = c == 0 ? prev : c == 1 ? type + 1 : (uint32_t)c - 2;
            if (t >= ntypes) t -= ntypes;
            if (t >= ntypes) fail("BROTLI: invalid block type");
            prev = type;
            type = t;
            left = read_block_count(br, counts);
        }
        --left;
    }
};

struct Output {
    uint8_t* dst;
    size_t capacity;
    size_t pos = 0;

    void put(uint8_t b) {
        if (pos >= capacity) fail("BROTLI: more bytes than the page holds");
        dst[pos++] = b;
    }
};

int to_upper(uint8_t* p) {  // Appendix B's uppercase of one character
    if (p[0] < 0xc0) {
        if (p[0] >= 'a' && p[0] <= 'z') p[0] ^= 32;
        return 1;
    }
    if (p[0] < 0xe0) {
        p[1] ^= 32;
        return 2;
    }
    p[2] ^= 5;
    return 3;
}

// A dictionary word of `len` bytes, transformed (Appendix B)
void dictionary_word(Output& out, int len, uint32_t word_id) {
    if (dictionary == nullptr) fail("BROTLI: the static dictionary is not loaded");
    if (len < 4 || len > 24) fail("BROTLI: invalid distance");
    int bits = kSizeBitsByLength[len];
    uint32_t index = word_id & ((1u << bits) - 1);
    uint32_t transform_id = word_id >> bits;
    if (transform_id >= 121) fail("BROTLI: invalid dictionary transform");
    const Transform& t = kTransforms[transform_id];
    const uint8_t* word = dictionary + offsets_by_length[len] + (size_t)index * len;
    uint8_t buf[64];  // the word and three bytes the uppercasing may touch
    int n = 0, skip = 0;
    if (t.type >= kOmitLast1 && t.type <= kOmitLast9) n = len - t.type;
    else if (t.type >= kOmitFirst1) {
        skip = t.type - kOmitFirst1 + 1;
        n = len - skip;
    } else n = len;
    if (n < 0) n = 0;
    std::memset(buf, 0, sizeof(buf));
    std::memcpy(buf, word + skip, (size_t)n);
    if (t.type == kUppercaseFirst && n > 0) {
        to_upper(buf);
    } else if (t.type == kUppercaseAll) {
        for (int i = 0; i < n;) i += to_upper(buf + i);
    }
    for (const char* p = t.prefix; *p; ++p) out.put((uint8_t)*p);
    for (int i = 0; i < n; ++i) out.put(buf[i]);
    for (const char* p = t.suffix; *p; ++p) out.put((uint8_t)*p);
}

size_t decompress(const uint8_t* src, size_t size, uint8_t* dst,
                  size_t capacity) {
    BitReader br(src, size);
    Output out{dst, capacity};
    // Section 9.1: the window
    int wbits;
    if (br.read(1) == 0) {
        wbits = 16;
    } else {
        uint32_t n = br.read(3);
        if (n != 0) {
            wbits = 17 + (int)n;
        } else {
            n = br.read(3);
            if (n == 1) fail("BROTLI: large-window streams are not read");
            wbits = n == 0 ? 17 : 8 + (int)n;
        }
    }
    const size_t window = ((size_t)1 << wbits) - 16;
    uint32_t ring[4] = {16, 15, 11, 4};  // ring[idx & 3] is the last
    uint32_t ring_idx = 3;
    std::vector<PrefixCode> literal_codes, command_codes, distance_codes;
    std::vector<uint8_t> literal_map, distance_map, modes;
    bool last = false;
    while (!last) {
        last = br.read(1) != 0;
        if (last && br.read(1)) break;  // ISLASTEMPTY
        uint32_t nibbles_code = br.read(2);
        if (nibbles_code == 3) {  // metadata
            if (br.read(1) != 0) fail("BROTLI: reserved bit set");
            int skip_bytes = (int)br.read(2);
            size_t skip = 0;
            for (int i = 0; i < skip_bytes; ++i) {
                uint32_t b = br.read(8);
                if (i + 1 == skip_bytes && skip_bytes > 1 && b == 0)
                    fail("BROTLI: invalid metadata length");
                skip |= (size_t)b << (8 * i);
            }
            if (skip_bytes) ++skip;
            br.align();
            br.skip_bytes(skip);
            continue;
        }
        int nibbles = 4 + (int)nibbles_code;
        size_t mlen = 0;
        for (int i = 0; i < nibbles; ++i) {
            uint32_t v = br.read(4);
            if (i + 1 == nibbles && nibbles > 4 && v == 0)
                fail("BROTLI: invalid meta-block length");
            mlen |= (size_t)v << (4 * i);
        }
        ++mlen;
        if (!last && br.read(1)) {  // uncompressed
            br.align();
            size_t at = br.byte_position();
            if (at > size || mlen > size - at) fail("BROTLI: stream cut short");
            if (mlen > out.capacity - out.pos)
                fail("BROTLI: more bytes than the page holds");
            std::memcpy(out.dst + out.pos, src + at, mlen);
            out.pos += mlen;
            br.skip_bytes(mlen);
            continue;
        }
        // a compressed meta-block: its header (Section 9.2)
        Blocks lit, cmd, dist;
        lit.read(br);
        cmd.read(br);
        dist.read(br);
        uint32_t npostfix = br.read(2);
        uint32_t ndirect = br.read(4) << npostfix;
        modes.assign(lit.ntypes, 0);
        for (auto& m : modes) m = (uint8_t)br.read(2);
        int ntrees_l = (int)read_var_uint8(br) + 1;
        literal_map.assign((size_t)64 * lit.ntypes, 0);
        read_context_map(br, ntrees_l, literal_map);
        int ntrees_d = (int)read_var_uint8(br) + 1;
        distance_map.assign((size_t)4 * dist.ntypes, 0);
        read_context_map(br, ntrees_d, distance_map);
        literal_codes.assign((size_t)ntrees_l, PrefixCode());
        for (auto& c : literal_codes) read_prefix_code(br, 256, c);
        command_codes.assign(cmd.ntypes, PrefixCode());
        for (auto& c : command_codes) read_prefix_code(br, 704, c);
        const int dist_alphabet = 16 + (int)ndirect + (48 << npostfix);
        distance_codes.assign((size_t)ntrees_d, PrefixCode());
        for (auto& c : distance_codes) read_prefix_code(br, dist_alphabet, c);
        const uint32_t postfix_mask = (1u << npostfix) - 1;

        // the commands (Section 9.3)
        size_t left = mlen;
        while (left > 0) {
            cmd.next(br);
            int code = command_codes[cmd.type].decode(br);
            static const int ins_base[11] = {0, 0, 0, 0, 8, 8, 0, 16, 8, 16, 16};
            static const int copy_base[11] = {0, 8, 0, 8, 0, 8, 16, 0, 16, 8, 16};
            int cell = code >> 6;
            int ins_code = ins_base[cell] + ((code >> 3) & 7);
            int copy_code = copy_base[cell] + (code & 7);
            size_t insert = kInsertBase[ins_code] + br.read(kInsertExtra[ins_code]);
            size_t copy = kCopyBase[copy_code] + br.read(kCopyExtra[copy_code]);
            if (insert > left) fail("BROTLI: insert past the meta-block");
            for (size_t i = 0; i < insert; ++i) {
                lit.next(br);
                uint8_t p1 = out.pos >= 1 ? out.dst[out.pos - 1] : 0;
                uint8_t p2 = out.pos >= 2 ? out.dst[out.pos - 2] : 0;
                int ctx;
                switch (modes[lit.type]) {
                    case 0: ctx = p1 & 0x3f; break;
                    case 1: ctx = p1 >> 2; break;
                    case 2: ctx = kLut0[p1] | kLut1[p2]; break;
                    default: ctx = (kLut2[p1] << 3) | kLut2[p2]; break;
                }
                int tree = literal_map[(size_t)64 * lit.type + ctx];
                out.put((uint8_t)literal_codes[(size_t)tree].decode(br));
            }
            left -= insert;
            if (left == 0) break;
            uint32_t distance;
            bool push = true;
            if (cell < 2) {  // the implicit distance code 0
                distance = ring[ring_idx & 3];
                push = false;
            } else {
                dist.next(br);
                int dctx = copy > 4 ? 3 : (int)copy - 2;
                int tree = distance_map[(size_t)4 * dist.type + dctx];
                uint32_t dcode = (uint32_t)distance_codes[(size_t)tree].decode(br);
                if (dcode < 16) {
                    static const int which[16] = {0, 1, 2, 3, 0, 0, 0, 0,
                                                  0, 0, 1, 1, 1, 1, 1, 1};
                    static const int delta[16] = {0, 0, 0, 0, -1, 1, -2, 2,
                                                  -3, 3, -1, 1, -2, 2, -3, 3};
                    int64_t d = (int64_t)ring[(ring_idx - which[dcode]) & 3] +
                                delta[dcode];
                    if (d <= 0) fail("BROTLI: invalid distance");
                    distance = (uint32_t)d;
                    push = dcode != 0;
                } else if (dcode < 16 + ndirect) {
                    distance = dcode - 15;
                } else {
                    uint32_t x = dcode - ndirect - 16;
                    int ndistbits = 1 + (int)(x >> (npostfix + 1));
                    uint32_t dextra = br.read(ndistbits);
                    uint32_t hcode = x >> npostfix, lcode = x & postfix_mask;
                    uint64_t offset = ((uint64_t)(2 + (hcode & 1)) << ndistbits) - 4;
                    uint64_t d = ((offset + dextra) << npostfix) + lcode + ndirect + 1;
                    if (d > 0x7FFFFFFCu) fail("BROTLI: invalid distance");
                    distance = (uint32_t)d;
                }
            }
            size_t max_distance = std::min(window, out.pos);
            size_t before = out.pos;
            if (distance > max_distance) {  // a static dictionary word
                dictionary_word(out, (int)copy, distance - (uint32_t)max_distance - 1);
                push = false;
            } else {
                if (copy > out.capacity - out.pos)
                    fail("BROTLI: more bytes than the page holds");
                uint8_t* d = out.dst + out.pos;
                const uint8_t* s = d - distance;
                for (size_t i = 0; i < copy; ++i) d[i] = s[i];
                out.pos += copy;
            }
            size_t wrote = out.pos - before;
            if (wrote > left) fail("BROTLI: copy past the meta-block");
            left -= wrote;
            if (push) ring[++ring_idx & 3] = distance;
        }
    }
    return out.pos;
}

}  // namespace brotli

void set_error(char* err, int64_t cap, const std::string& message) {
    if (cap <= 0) return;
    std::snprintf(err, (size_t)cap, "%s", message.c_str());
}

}  // namespace

extern "C" {

int64_t pq_zstd_decompress(const uint8_t* src, int64_t size, uint8_t* dst,
                           int64_t capacity, char* err, int64_t err_cap) {
    try {
        return (int64_t)zstd_decompress(src, (size_t)size, dst,
                                        (size_t)capacity);
    } catch (const Error& e) {
        set_error(err, err_cap, e.message);
        return -1;
    }
}

int64_t pq_lz4_raw_decompress(const uint8_t* src, int64_t size, uint8_t* dst,
                              int64_t capacity, char* err, int64_t err_cap) {
    try {
        return (int64_t)lz4_block(src, (size_t)size, dst, (size_t)capacity);
    } catch (const Error& e) {
        set_error(err, err_cap, e.message);
        return -1;
    }
}

// Parquet's LZ4 (codec 5) as Arrow reads it: Hadoop's framing, else one
// bare block.
int64_t pq_lz4_hadoop_decompress(const uint8_t* src, int64_t size,
                                 uint8_t* dst, int64_t capacity, char* err,
                                 int64_t err_cap) {
    int64_t got = lz4_hadoop(src, (size_t)size, dst, (size_t)capacity);
    if (got >= 0) return got;
    return pq_lz4_raw_decompress(src, size, dst, capacity, err, err_cap);
}

// The static dictionary (RFC 7932 Appendix A), copied once; the caller
// checks its digest. Returns 0, or -1 for a buffer of another size.
int64_t pq_brotli_set_dictionary(const uint8_t* data, int64_t size) {
    if (size != (int64_t)brotli::kDictionarySize) return -1;
    static std::vector<uint8_t> words;
    words.assign(data, data + size);
    uint32_t offset = 0;
    for (int len = 0; len < 25; ++len) {
        brotli::offsets_by_length[len] = offset;
        if (brotli::kSizeBitsByLength[len])
            offset += (uint32_t)len << brotli::kSizeBitsByLength[len];
    }
    if (offset != brotli::kDictionarySize) return -1;
    brotli::dictionary = words.data();
    return 0;
}

int64_t pq_brotli_decompress(const uint8_t* src, int64_t size, uint8_t* dst,
                             int64_t capacity, char* err, int64_t err_cap) {
    try {
        return (int64_t)brotli::decompress(src, (size_t)size, dst,
                                           (size_t)capacity);
    } catch (const Error& e) {
        set_error(err, err_cap, e.message);
        return -1;
    }
}

}  // extern "C"
