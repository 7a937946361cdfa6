// Decoders of the Parquet page codecs that the standard library lacks:
// ZSTD frames (RFC 8878) and LZ4 blocks (raw, and in Hadoop's framing).
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

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

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

}  // extern "C"
