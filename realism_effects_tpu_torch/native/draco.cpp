// From-scratch Draco triangular-mesh decoder (KHR_draco_mesh_compression,
// bitstream 2.2, standard EdgeBreaker traversal) — the production C++
// port of scene/draco.py (the Python reference
// implementation; see its docstring for the format notes and the parity
// evidence). Built on demand with g++ and bound via ctypes; the two
// implementations are asserted bit-identical in tests/test_draco.py.
//
// Scope mirrors the Python module: rANS entropy coding, EdgeBreaker
// CLERS replay with topology splits and interior start faces, attribute
// seams, depth-first attribute traversal, difference / parallelogram /
// constrained-multi-parallelogram / portable-texcoords prediction, wrap
// + canonicalized-octahedron transforms, quantization.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <utility>
#include <vector>
#include <unordered_map>

namespace {

struct Error {
    std::string msg;
};

static void fail(const std::string &m) { throw Error{m}; }

// ---------------------------------------------------------------------------
// Bitstream primitives
// ---------------------------------------------------------------------------

struct Buffer {
    const uint8_t *data;
    int64_t size;
    int64_t pos = 0;
    int64_t bit_base = -1;
    int64_t bit_offset = 0;

    uint8_t u8() {
        if (pos >= size) fail("buffer underrun");
        return data[pos++];
    }
    int8_t i8() { return (int8_t)u8(); }
    uint16_t u16() {
        uint16_t v = (uint16_t)(u8());
        v |= (uint16_t)u8() << 8;
        return v;
    }
    uint32_t u32() {
        uint32_t v = 0;
        for (int i = 0; i < 4; ++i) v |= (uint32_t)u8() << (8 * i);
        return v;
    }
    int32_t i32() { return (int32_t)u32(); }
    float f32() {
        uint32_t v = u32();
        float f;
        std::memcpy(&f, &v, 4);
        return f;
    }
    const uint8_t *raw(int64_t n) {
        if (pos + n > size) fail("buffer underrun");
        const uint8_t *p = data + pos;
        pos += n;
        return p;
    }
    uint64_t varint() {
        uint64_t v = 0;
        int shift = 0;
        while (true) {
            uint8_t b = u8();
            v |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
            if (shift > 70) fail("varint overflow");
        }
    }
    uint64_t start_bits(bool decode_size) {
        uint64_t sz = decode_size ? varint() : 0;
        bit_base = pos;
        bit_offset = 0;
        return sz;
    }
    uint32_t bits(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) {
            int64_t byte = bit_base + (bit_offset >> 3);
            if (byte >= size) fail("bit underrun");
            v |= (uint32_t)((data[byte] >> (bit_offset & 7)) & 1) << i;
            ++bit_offset;
        }
        return v;
    }
    void end_bits() {
        pos = bit_base + ((bit_offset + 7) >> 3);
        bit_base = -1;
    }
};

constexpr int64_t ANS_IO_BASE = 256;
constexpr int64_t ANS_P8_PRECISION = 256;
constexpr int64_t ANS_L_BASE = 4096;

struct RAnsBitDecoder {
    uint8_t prob_zero = 0;
    const uint8_t *buf = nullptr;
    int64_t offset = 0;
    uint64_t state = ANS_L_BASE;

    void init(Buffer &b) {
        prob_zero = b.u8();
        int64_t sz = (int64_t)b.varint();
        buf = b.raw(sz);
        offset = sz;
        if (offset < 1) {
            state = ANS_L_BASE;
            offset = 0;
            return;
        }
        int x = buf[offset - 1] >> 6;
        if (x == 0) {
            state = buf[offset - 1] & 0x3F;
            offset -= 1;
        } else if (x == 1) {
            if (offset < 2) fail("rans init underrun");
            state = ((uint64_t)buf[offset - 2] | ((uint64_t)buf[offset - 1] << 8)) & 0x3FFF;
            offset -= 2;
        } else if (x == 2) {
            if (offset < 3) fail("rans init underrun");
            state = ((uint64_t)buf[offset - 3] | ((uint64_t)buf[offset - 2] << 8) |
                     ((uint64_t)buf[offset - 1] << 16)) & 0x3FFFFF;
            offset -= 3;
        } else {
            fail("invalid rans bit-decoder init");
        }
        state += ANS_L_BASE;
    }

    int bit() {
        int64_t p0 = prob_zero;
        int64_t p1 = ANS_P8_PRECISION - p0;
        while (state < (uint64_t)ANS_L_BASE && offset > 0) {
            state = state * ANS_IO_BASE + buf[--offset];
        }
        uint64_t x = state % ANS_P8_PRECISION;
        uint64_t quot = state / ANS_P8_PRECISION;
        if ((int64_t)x < p1) {
            state = quot * p1 + x;
            return 1;
        }
        state = quot * p0 + (x - p1);
        return 0;
    }
};

struct RAnsSymbolDecoder {
    uint64_t precision = 0, l_base = 0;
    std::vector<uint32_t> probs, cum, lut;
    const uint8_t *buf = nullptr;
    int64_t offset = 0;
    uint64_t state = 0;

    void init(Buffer &b, int unique_symbols_bit_length) {
        int pb = (3 * unique_symbols_bit_length) / 2;
        if (pb < 12) pb = 12;
        if (pb > 20) pb = 20;
        precision = 1ull << pb;
        l_base = precision * 4;

        uint64_t num_symbols = b.varint();
        if (num_symbols > (1ull << 22)) fail("alphabet too large");
        probs.assign(num_symbols, 0);
        for (uint64_t i = 0; i < num_symbols; ++i) {
            uint8_t prob_data = b.u8();
            int token = prob_data & 3;
            if (token == 3) {
                uint64_t off = prob_data >> 2;
                if (i + off >= num_symbols) fail("prob table overflow");
                i += off;  // off+1 zero-probability symbols (incl. loop ++)
            } else {
                uint32_t prob = prob_data >> 2;
                for (int k = 0; k < token; ++k)
                    prob |= (uint32_t)b.u8() << (8 * (k + 1) - 2);
                probs[i] = prob;
            }
        }
        uint64_t total = 0;
        for (uint32_t p : probs) total += p;
        if (total != precision) fail("prob table sum != precision");
        cum.assign(num_symbols + 1, 0);
        for (uint64_t i = 0; i < num_symbols; ++i) cum[i + 1] = cum[i] + probs[i];
        lut.assign(precision, 0);
        for (uint64_t i = 0; i < num_symbols; ++i)
            for (uint32_t k = cum[i]; k < cum[i + 1]; ++k) lut[k] = (uint32_t)i;

        int64_t sz = (int64_t)b.varint();
        buf = b.raw(sz);
        offset = sz;
        if (offset < 1) fail("empty rans stream");
        int x = buf[offset - 1] >> 6;
        if (x == 0) {
            state = buf[offset - 1] & 0x3F;
            offset -= 1;
        } else if (x == 1) {
            if (offset < 2) fail("rans init underrun");
            state = ((uint64_t)buf[offset - 2] | ((uint64_t)buf[offset - 1] << 8)) & 0x3FFF;
            offset -= 2;
        } else if (x == 2) {
            if (offset < 3) fail("rans init underrun");
            state = ((uint64_t)buf[offset - 3] | ((uint64_t)buf[offset - 2] << 8) |
                     ((uint64_t)buf[offset - 1] << 16)) & 0x3FFFFF;
            offset -= 3;
        } else {
            if (offset < 4) fail("rans init underrun");
            state = ((uint64_t)buf[offset - 4] | ((uint64_t)buf[offset - 3] << 8) |
                     ((uint64_t)buf[offset - 2] << 16) | ((uint64_t)buf[offset - 1] << 24)) &
                    0x3FFFFFFF;
            offset -= 4;
        }
        state += l_base;
    }

    uint32_t symbol() {
        while (state < l_base && offset > 0) state = state * ANS_IO_BASE + buf[--offset];
        uint64_t rem = state % precision;
        uint64_t quot = state / precision;
        uint32_t s = lut[rem];
        state = quot * probs[s] + rem - cum[s];
        return s;
    }
};

static void decode_symbols(Buffer &b, int64_t num_values, int num_components,
                           std::vector<uint32_t> &out) {
    out.assign(num_values, 0);
    if (num_values == 0) return;
    int scheme = b.u8();
    if (scheme == 0) {  // TAGGED
        RAnsSymbolDecoder tag;
        tag.init(b, 5);
        b.start_bits(false);
        int64_t i = 0;
        while (i < num_values) {
            int bit_length = (int)tag.symbol();
            for (int c = 0; c < num_components && i < num_values; ++c)
                out[i++] = b.bits(bit_length);
        }
        b.end_bits();
    } else if (scheme == 1) {  // RAW
        int max_bit_length = b.u8();
        RAnsSymbolDecoder dec;
        dec.init(b, max_bit_length);
        for (int64_t i = 0; i < num_values; ++i) out[i] = dec.symbol();
    } else {
        fail("unknown symbol coding scheme");
    }
}

static inline int64_t zigzag(uint32_t v) {
    return (v & 1) ? -(int64_t)(v >> 1) - 1 : (int64_t)(v >> 1);
}

static inline int64_t next_c(int64_t c) { return c - (c % 3) + (c + 1) % 3; }
static inline int64_t prev_c(int64_t c) { return c - (c % 3) + (c + 2) % 3; }

// ---------------------------------------------------------------------------
// EdgeBreaker connectivity
// ---------------------------------------------------------------------------

enum { TOP_C = 0, TOP_S = 1, TOP_L = 3, TOP_R = 5, TOP_E = 7 };

struct Connectivity {
    int64_t num_faces, num_symbols;
    int num_attribute_data;
    std::vector<int64_t> opposite, cv, leftmost;
    std::vector<uint8_t> is_vert_hole;
    int64_t next_vert = 0;
    std::vector<int64_t> active_stack;
    std::unordered_map<int64_t, int64_t> split_corners;
    std::vector<std::vector<int64_t>> seam_corners;

    int64_t swing_right(int64_t c) const {
        int64_t o = opposite[prev_c(c)];
        return o < 0 ? -1 : prev_c(o);
    }

    void decode(const std::vector<int8_t> &symbols,
                const std::vector<std::array<int64_t, 3>> &events,
                RAnsBitDecoder &start_faces, std::vector<RAnsBitDecoder> &seams,
                int64_t num_encoded_vertices, int64_t num_split_symbols) {
        int64_t slots = num_encoded_vertices + num_split_symbols + 3;
        opposite.assign(3 * num_faces, -1);
        cv.assign(3 * num_faces, -1);
        leftmost.assign(slots, -1);
        is_vert_hole.assign(slots, 1);
        seam_corners.assign(num_attribute_data, {});

        std::unordered_map<int64_t, std::vector<std::pair<int64_t, int64_t>>> by_source;
        for (auto &e : events) {
            // encoder symbol ids count from the end of decode order
            by_source[num_symbols - e[0] - 1].push_back(
                {num_symbols - e[1] - 1, e[2]});
        }

        auto set_opp = [&](int64_t a, int64_t b) {
            opposite[a] = b;
            opposite[b] = a;
        };
        // Stream-declared counts are untrusted: every face allocation,
        // vertex allocation, and vertex id read out of cv[] is checked
        // before it indexes an array (a crafted stream can otherwise
        // declare num_faces=1 and emit 200k E symbols, writing far past
        // the allocations). The Python decoder fails cleanly on the
        // same inputs; the two paths must stay behaviorally identical.
        auto chk_vert = [&](int64_t v) -> int64_t {
            if (v < 0 || v >= slots) fail("vertex id out of range");
            return v;
        };
        auto alloc_vert = [&]() -> int64_t {
            if (next_vert >= slots) fail("vertex allocation overflow");
            return next_vert++;
        };

        int64_t face = 0;
        for (int64_t i = 0; i < num_symbols; ++i) {
            int sym = symbols[i];
            if (face >= num_faces) fail("more CLERS symbols than faces");
            int64_t corner = 3 * face;
            ++face;
            if (sym == TOP_C) {
                if (active_stack.empty()) fail("C on empty stack");
                int64_t corner_a = active_stack.back();
                int64_t vertex_x = chk_vert(cv[next_c(corner_a)]);
                int64_t lm = leftmost[vertex_x];
                if (lm < 0) fail("C without leftmost");
                int64_t corner_b = next_c(lm);
                set_opp(corner_a, corner + 1);
                set_opp(corner_b, corner + 2);
                cv[corner] = vertex_x;
                cv[corner + 1] = cv[next_c(corner_b)];
                cv[corner + 2] = cv[prev_c(corner_a)];
                leftmost[chk_vert(cv[corner + 2])] = corner + 2;
                active_stack.back() = corner;
                is_vert_hole[vertex_x] = 0;
            } else if (sym == TOP_R || sym == TOP_L) {
                if (active_stack.empty()) fail("R/L on empty stack");
                int64_t corner_a = active_stack.back();
                int64_t opp, corner_l, corner_r;
                if (sym == TOP_R) {
                    opp = corner + 2;
                    corner_l = corner + 1;
                    corner_r = corner;
                } else {
                    opp = corner + 1;
                    corner_l = corner;
                    corner_r = corner + 2;
                }
                set_opp(opp, corner_a);
                int64_t v_new = alloc_vert();
                cv[opp] = v_new;
                leftmost[v_new] = opp;
                int64_t vertex_r = chk_vert(cv[prev_c(corner_a)]);
                cv[corner_r] = vertex_r;
                leftmost[vertex_r] = corner_r;
                cv[corner_l] = cv[next_c(corner_a)];
                active_stack.back() = corner;
            } else if (sym == TOP_E) {
                for (int k = 0; k < 3; ++k) {
                    int64_t v = alloc_vert();
                    cv[corner + k] = v;
                    leftmost[v] = corner + k;
                }
                active_stack.push_back(corner);
            } else if (sym == TOP_S) {
                if (active_stack.empty()) fail("S on empty stack");
                int64_t corner_b = active_stack.back();
                active_stack.pop_back();
                auto it = split_corners.find(i);
                if (it != split_corners.end()) {
                    active_stack.push_back(it->second);
                    split_corners.erase(it);
                }
                if (active_stack.empty()) fail("S without second corner");
                int64_t corner_a = active_stack.back();
                set_opp(corner_a, corner + 2);
                set_opp(corner_b, corner + 1);
                int64_t vertex_p = chk_vert(cv[prev_c(corner_a)]);
                cv[corner] = vertex_p;
                cv[corner + 1] = cv[next_c(corner_a)];
                cv[corner + 2] = cv[prev_c(corner_b)];
                leftmost[chk_vert(cv[corner + 2])] = corner + 2;
                int64_t vertex_n = chk_vert(cv[next_c(corner_b)]);
                is_vert_hole[vertex_n] = 0;
                int64_t c = leftmost[vertex_n];
                int64_t start = c;
                int64_t steps = 0, max_steps = (int64_t)cv.size() + 1;
                while (c >= 0) {
                    cv[c] = vertex_p;
                    c = swing_right(c);
                    if (c == start) break;
                    if (++steps > max_steps) fail("vertex fan cycle");
                }
                leftmost[vertex_p] = leftmost[vertex_n];
                active_stack.back() = corner;
            } else {
                fail("bad CLERS symbol");
            }
            auto bs = by_source.find(i);
            if (bs != by_source.end()) {
                for (auto &se : bs->second) {
                    int64_t act = active_stack.back();
                    int64_t reg = se.second == 1 ? next_c(act) : prev_c(act);
                    split_corners[se.first] = reg;
                }
            }
        }
        // remaining boundaries: interior start faces or holes
        while (!active_stack.empty()) {
            int64_t corner_a = active_stack.back();
            active_stack.pop_back();
            int interior = start_faces.bit();
            if (!interior) continue;
            if (face >= num_faces) fail("too many interior faces");
            int64_t corner = 3 * face;
            ++face;
            int64_t steps = 0, max_steps = (int64_t)cv.size() + 1;
            int64_t corner_b = prev_c(corner_a);
            while (opposite[corner_b] >= 0) {
                corner_b = prev_c(opposite[corner_b]);
                if (++steps > max_steps) fail("boundary walk cycle");
            }
            int64_t corner_cc = next_c(corner_a);
            while (opposite[corner_cc] >= 0) {
                corner_cc = next_c(opposite[corner_cc]);
                if (++steps > max_steps) fail("boundary walk cycle");
            }
            set_opp(corner, corner_a);
            set_opp(corner + 1, corner_b);
            set_opp(corner + 2, corner_cc);
            int64_t vert_a = chk_vert(cv[next_c(corner_a)]);
            int64_t vert_b = chk_vert(cv[next_c(corner_b)]);
            int64_t vert_cc = chk_vert(cv[next_c(corner_cc)]);
            cv[corner] = vert_b;
            cv[corner + 1] = vert_cc;
            cv[corner + 2] = vert_a;
            is_vert_hole[vert_a] = 0;
            is_vert_hole[vert_b] = 0;
            is_vert_hole[vert_cc] = 0;
        }
        if (face != num_faces) fail("face count mismatch");
        // attribute seams: per attribute, one bit per interior edge, in
        // face order, each edge decoded at its lower-id face
        if (num_attribute_data > 0) {
            for (int64_t f = 0; f < num_faces; ++f) {
                for (int64_t c = 3 * f; c < 3 * f + 3; ++c) {
                    int64_t o = opposite[c];
                    if (o < 0 || o / 3 < f) continue;
                    for (int a = 0; a < num_attribute_data; ++a)
                        if (seams[a].bit()) seam_corners[a].push_back(c);
                }
            }
        }
    }
};

// ---------------------------------------------------------------------------
// Attribute corner-table views + depth-first traversal
// ---------------------------------------------------------------------------

struct View {
    std::vector<int64_t> opposite;  // may alias real table (copied)
    std::vector<int64_t> cv;
    int64_t num_vertices = 0;
    std::vector<uint8_t> boundary;

    void compute_boundary() {
        boundary.assign(num_vertices, 0);
        for (size_t c = 0; c < cv.size(); ++c) {
            if (cv[c] < 0) continue;
            if (opposite[next_c((int64_t)c)] < 0 || opposite[prev_c((int64_t)c)] < 0)
                boundary[cv[c]] = 1;
        }
    }
};

static View real_view(const Connectivity &conn) {
    View v;
    v.opposite = conn.opposite;
    v.cv = conn.cv;
    v.num_vertices = conn.next_vert;
    v.compute_boundary();
    return v;
}

static View attribute_view(const Connectivity &conn, const std::vector<int64_t> &seamc) {
    View v;
    v.opposite = conn.opposite;
    for (int64_t c : seamc) {
        int64_t o = v.opposite[c];
        if (o >= 0) v.opposite[o] = -1;
        v.opposite[c] = -1;
    }
    int64_t n = (int64_t)conn.cv.size();
    v.cv.assign(n, -1);
    std::vector<uint8_t> visited(n, 0);
    int64_t next_id = 0;
    for (int64_t c0 = 0; c0 < n; ++c0) {
        if (visited[c0] || conn.cv[c0] < 0) continue;
        // rewind CCW (swing left in the cut table) to sector start
        int64_t c = c0;
        while (true) {
            int64_t o = v.opposite[next_c(c)];
            if (o < 0) break;
            c = next_c(o);
            if (c == c0) break;
        }
        int64_t start = c;
        int64_t vid = next_id++;
        while (true) {
            visited[c] = 1;
            v.cv[c] = vid;
            int64_t o = v.opposite[prev_c(c)];
            if (o < 0) break;
            c = prev_c(o);
            if (c == start) break;
        }
    }
    v.num_vertices = next_id;
    v.compute_boundary();
    return v;
}

// Depth-first traversal (right corner = Opposite(Next(corner)))
static void depth_first(const View &view, std::vector<int64_t> &value_to_corner,
                        std::vector<int64_t> &vertex_to_value) {
    const auto &opposite = view.opposite;
    const auto &cv = view.cv;
    int64_t num_faces = (int64_t)cv.size() / 3;
    std::vector<uint8_t> fv(num_faces, 0), vv(view.num_vertices, 0);
    value_to_corner.clear();
    vertex_to_value.assign(view.num_vertices, -1);
    std::vector<int64_t> stack;

    auto onv = [&](int64_t v, int64_t c) {
        vertex_to_value[v] = (int64_t)value_to_corner.size();
        value_to_corner.push_back(c);
    };

    for (int64_t f = 0; f < num_faces; ++f) {
        int64_t seed = 3 * f;
        if (fv[f]) continue;
        stack.assign(1, seed);
        int64_t nvert = cv[next_c(seed)], pvert = cv[prev_c(seed)];
        if (!vv[nvert]) { vv[nvert] = 1; onv(nvert, next_c(seed)); }
        if (!vv[pvert]) { vv[pvert] = 1; onv(pvert, prev_c(seed)); }
        while (!stack.empty()) {
            int64_t corner = stack.back();
            if (corner < 0 || fv[corner / 3]) {
                stack.pop_back();
                continue;
            }
            while (true) {
                fv[corner / 3] = 1;
                int64_t vert = cv[corner];
                if (!vv[vert]) {
                    vv[vert] = 1;
                    onv(vert, corner);
                    if (!view.boundary[vert]) {
                        corner = opposite[next_c(corner)];
                        continue;
                    }
                }
                int64_t right = opposite[next_c(corner)];
                int64_t left = opposite[prev_c(corner)];
                bool rv = right < 0 || fv[right / 3];
                bool lv = left < 0 || fv[left / 3];
                if (rv && lv) {
                    stack.pop_back();
                    break;
                }
                if (rv) corner = left;
                else if (lv) corner = right;
                else {
                    stack.back() = left;
                    stack.push_back(right);
                    break;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Prediction transforms
// ---------------------------------------------------------------------------

static inline int64_t trunc_div2(int64_t x) { return x / 2; }  // C++ truncates

struct WrapTransform {
    int64_t minv, maxv, dif;
    void init(Buffer &b) {
        minv = b.i32();
        maxv = b.i32();
        dif = maxv - minv + 1;
    }
    inline int64_t original(int64_t pred, int64_t corr) const {
        if (pred < minv) pred = minv;
        else if (pred > maxv) pred = maxv;
        int64_t v = pred + corr;
        if (v > maxv) v -= dif;
        else if (v < minv) v += dif;
        return v;
    }
};

struct OctTransform {
    int64_t max_quantized, center, n;
    void init(Buffer &b) {
        max_quantized = b.i32();
        center = b.i32();
        n = max_quantized;  // ModMax folds by max_quantized_value itself
    }
    inline int64_t mod_max(int64_t x) const {
        if (x > center) return x - n;
        if (x < -center) return x + n;
        return x;
    }
    static inline void rotate(int64_t &s, int64_t &t, int count) {
        count &= 3;
        for (int i = 0; i < count; ++i) {
            int64_t tmp = s;
            s = t;
            t = -tmp;
        }
    }
    static inline int rotation_count(int64_t s, int64_t t) {
        if (s == 0) {
            if (t == 0) return 0;
            return t > 0 ? 3 : 1;
        }
        if (s > 0) return t >= 0 ? 2 : 1;
        return t > 0 ? 3 : 0;
    }
    static inline bool in_bottom_left(int64_t s, int64_t t) {
        if (s == 0 && t == 0) return true;
        return s < 0 && t <= 0;
    }
    inline bool in_diamond(int64_t s, int64_t t) const {
        return std::llabs(s) + std::llabs(t) <= center;
    }
    inline void invert_diamond(int64_t &s, int64_t &t) const {
        int64_t sign_s, sign_t;
        if (s >= 0 && t >= 0) { sign_s = 1; sign_t = 1; }
        else if (s <= 0 && t <= 0) { sign_s = -1; sign_t = -1; }
        else {
            sign_s = s > 0 ? 1 : -1;
            sign_t = t > 0 ? 1 : -1;
        }
        int64_t cs = sign_s * center, ct = sign_t * center;
        int64_t us = 2 * s - cs, ut = 2 * t - ct;
        if (sign_s * sign_t >= 0) {
            int64_t tmp = us;
            us = -ut;
            ut = -tmp;
        } else {
            std::swap(us, ut);
        }
        s = trunc_div2(us + cs);
        t = trunc_div2(ut + ct);
    }
    inline void original(int64_t pred_s, int64_t pred_t, int64_t corr_s,
                         int64_t corr_t, int64_t &out_s, int64_t &out_t) const {
        int64_t ps = pred_s - center, pt = pred_t - center;
        bool ind = in_diamond(ps, pt);
        if (!ind) invert_diamond(ps, pt);
        bool bl = in_bottom_left(ps, pt);
        int rot = rotation_count(ps, pt);
        if (!bl) rotate(ps, pt, rot);
        int64_t os = mod_max(ps + corr_s);
        int64_t ot = mod_max(pt + corr_t);
        if (!bl) rotate(os, ot, (4 - rot) & 3);
        if (!ind) invert_diamond(os, ot);
        out_s = os + center;
        out_t = ot + center;
    }
};

// ---------------------------------------------------------------------------
// Attribute decoding
// ---------------------------------------------------------------------------

enum { SEQ_GENERIC = 0, SEQ_INTEGER = 1, SEQ_QUANTIZATION = 2, SEQ_NORMALS = 3 };
enum { ATT_POSITION = 0, ATT_NORMAL = 1, ATT_COLOR = 2, ATT_TEX_COORD = 3, ATT_GENERIC = 4 };
enum { PRED_NONE = -2, PRED_DIFFERENCE = 0, PRED_PARALLELOGRAM = 1,
       PRED_CONSTRAINED_MULTI = 4, PRED_TEXCOORDS_PORTABLE = 5 };
enum { TR_DELTA = 0, TR_WRAP = 1, TR_OCT = 2, TR_OCT_CANON = 3 };

struct AttributeDesc {
    int att_type, data_type, nc, normalized, seq_type;
    int64_t unique_id;
};

struct AttributeResult {
    int64_t unique_id;
    int nc;
    bool is_float;
    std::vector<float> fvals;    // per point
    std::vector<int32_t> ivals;  // per point
};

struct MeshOut {
    int64_t num_points = 0;
    std::vector<int32_t> faces;
    std::vector<AttributeResult> attrs;
    std::string error;
};

static void decode_raw_integers(Buffer &b, int64_t num_values,
                                std::vector<uint32_t> &out) {
    int num_bytes = b.u8();
    if (num_bytes > 8) fail("raw integer width too large");
    out.assign(num_values, 0);
    for (int64_t i = 0; i < num_values; ++i) {
        uint64_t v = 0;
        for (int k = 0; k < num_bytes; ++k) v |= (uint64_t)b.u8() << (8 * k);
        out[i] = (uint32_t)v;
    }
}

static inline int64_t isqrt_u128(unsigned __int128 v) {
    // exact floor sqrt (mirrors Python math.isqrt over the product)
    if (v == 0) return 0;
    long double est = sqrtl((long double)(uint64_t)(v >> 64) *
                                18446744073709551616.0L +
                            (long double)(uint64_t)v);
    uint64_t r = (uint64_t)est;
    while (r > 0 && (unsigned __int128)r * r > v) --r;
    while ((unsigned __int128)(r + 1) * (r + 1) <= v) ++r;
    return (int64_t)r;
}

// Returns flattened int64 values (num_entries * nc_out)
static void decode_attribute_values(Buffer &b, const AttributeDesc &desc,
                                    const View &view,
                                    const std::vector<int64_t> &value_to_corner,
                                    const std::vector<int64_t> &vertex_to_value,
                                    const std::vector<int64_t> &corner_to_point,
                                    const std::vector<std::array<int64_t, 3>> *pos_for_point,
                                    std::vector<int64_t> &vals, int &nc_out) {
    int64_t num_entries = (int64_t)value_to_corner.size();
    int nc = desc.seq_type == SEQ_NORMALS ? 2 : desc.nc;
    nc_out = nc;
    int method = b.i8();
    int transform_type = -100;
    if (method != PRED_NONE) transform_type = b.i8();

    int compressed = b.u8();
    std::vector<uint32_t> symbols;
    if (compressed)
        decode_symbols(b, num_entries * nc, nc, symbols);
    else
        decode_raw_integers(b, num_entries * nc, symbols);

    // prediction-scheme data (read between symbols and transform data,
    // mirroring scene/draco.py::_decode_attribute_values)
    constexpr int MAX_PARALLELOGRAMS = 4;
    std::vector<std::vector<uint8_t>> crease_bits;
    std::vector<uint8_t> orientations;
    if (method == PRED_CONSTRAINED_MULTI) {
        crease_bits.resize(MAX_PARALLELOGRAMS);
        for (int i = 0; i < MAX_PARALLELOGRAMS; ++i) {
            int64_t num_flags = (int64_t)b.varint();
            if (num_flags < 0 || num_flags > 8 * b.size)
                fail("crease flag count exceeds stream capacity");
            crease_bits[i].assign(num_flags, 0);
            if (num_flags > 0) {
                RAnsBitDecoder dec;
                dec.init(b);
                for (int64_t f = 0; f < num_flags; ++f)
                    crease_bits[i][f] = (uint8_t)dec.bit();
            }
        }
    } else if (method == PRED_TEXCOORDS_PORTABLE) {
        if (nc != 2) fail("portable texcoords need 2 components");
        if (pos_for_point == nullptr)
            fail("portable texcoords need decoded positions");
        int64_t num_orient = (int64_t)(uint32_t)b.u32();
        if (num_orient > 8 * b.size)
            fail("orientation count exceeds stream capacity");
        orientations.assign(num_orient, 1);
        bool last = true;
        RAnsBitDecoder dec;
        dec.init(b);
        for (int64_t i = 0; i < num_orient; ++i) {
            if (!dec.bit()) last = !last;
            orientations[i] = (uint8_t)last;
        }
    }

    if (method == PRED_NONE) {
        vals.resize(symbols.size());
        for (size_t i = 0; i < symbols.size(); ++i) vals[i] = zigzag(symbols[i]);
        return;
    }
    if (method != PRED_DIFFERENCE && method != PRED_PARALLELOGRAM &&
        method != PRED_CONSTRAINED_MULTI && method != PRED_TEXCOORDS_PORTABLE)
        fail("unsupported prediction method " + std::to_string(method));

    WrapTransform wrap{};
    OctTransform oct{};
    bool corrections_positive;
    bool is_oct = false;
    if (transform_type == TR_WRAP) {
        wrap.init(b);
        corrections_positive = false;
    } else if (transform_type == TR_DELTA) {
        corrections_positive = false;
    } else if (transform_type == TR_OCT_CANON) {
        oct.init(b);
        corrections_positive = true;
        is_oct = true;
    } else {
        fail("unsupported prediction transform " + std::to_string(transform_type));
        return;
    }

    std::vector<int64_t> corr(symbols.size());
    for (size_t i = 0; i < symbols.size(); ++i)
        corr[i] = corrections_positive ? (int64_t)symbols[i] : zigzag(symbols[i]);

    vals.assign(symbols.size(), 0);
    auto apply = [&](const int64_t *pred, const int64_t *cr, int64_t *out) {
        if (is_oct) {
            oct.original(pred[0], pred[1], cr[0], cr[1], out[0], out[1]);
        } else if (transform_type == TR_WRAP) {
            for (int c = 0; c < nc; ++c) out[c] = wrap.original(pred[c], cr[c]);
        } else {
            for (int c = 0; c < nc; ++c) out[c] = pred[c] + cr[c];
        }
    };

    std::vector<int64_t> zero(nc, 0), pred(nc, 0);
    if (num_entries == 0) return;
    apply(zero.data(), corr.data(), vals.data());
    if (method == PRED_DIFFERENCE) {
        for (int64_t p = 1; p < num_entries; ++p)
            apply(&vals[(p - 1) * nc], &corr[p * nc], &vals[p * nc]);
    } else if (method == PRED_PARALLELOGRAM) {
        for (int64_t p = 1; p < num_entries; ++p) {
            int64_t corner = value_to_corner[p];
            int64_t opp = view.opposite[corner];
            bool have = false;
            if (opp >= 0) {
                int64_t vo = vertex_to_value[view.cv[opp]];
                int64_t vn = vertex_to_value[view.cv[next_c(opp)]];
                int64_t vp = vertex_to_value[view.cv[prev_c(opp)]];
                if (vo >= 0 && vo < p && vn >= 0 && vn < p && vp >= 0 && vp < p) {
                    for (int c = 0; c < nc; ++c)
                        pred[c] = vals[vn * nc + c] + vals[vp * nc + c] - vals[vo * nc + c];
                    have = true;
                }
            }
            if (!have)
                for (int c = 0; c < nc; ++c) pred[c] = vals[(p - 1) * nc + c];
            apply(pred.data(), &corr[p * nc], &vals[p * nc]);
        }
    } else if (method == PRED_CONSTRAINED_MULTI) {
        // MeshPredictionSchemeConstrainedMultiParallelogram (port of
        // scene/draco.py::_predict_constrained_multi): up to 4
        // parallelograms per entry, crease flags consumed per
        // parallelogram-count context
        std::vector<std::vector<int64_t>> preds(
            MAX_PARALLELOGRAMS, std::vector<int64_t>(nc, 0));
        std::array<int64_t, MAX_PARALLELOGRAMS> flag_pos{};
        std::vector<int64_t> total(nc, 0);
        for (int64_t p = 1; p < num_entries; ++p) {
            int64_t first_corner = value_to_corner[p];
            int64_t corner = first_corner;
            int num_par = 0;
            while (corner >= 0 && num_par < MAX_PARALLELOGRAMS) {
                int64_t opp = view.opposite[corner];
                if (opp >= 0) {
                    int64_t vo = vertex_to_value[view.cv[opp]];
                    int64_t vn = vertex_to_value[view.cv[next_c(opp)]];
                    int64_t vp = vertex_to_value[view.cv[prev_c(opp)]];
                    if (vo >= 0 && vo < p && vn >= 0 && vn < p &&
                        vp >= 0 && vp < p) {
                        for (int c = 0; c < nc; ++c)
                            preds[num_par][c] = vals[vn * nc + c] +
                                vals[vp * nc + c] - vals[vo * nc + c];
                        ++num_par;
                    }
                }
                int64_t o2 = view.opposite[prev_c(corner)];
                corner = o2 < 0 ? -1 : prev_c(o2);  // swing_right
                if (corner == first_corner) break;
            }
            std::fill(total.begin(), total.end(), 0);
            int num_used = 0;
            if (num_par > 0) {
                int ctx = num_par - 1;
                for (int i = 0; i < num_par; ++i) {
                    if (flag_pos[ctx] >= (int64_t)crease_bits[ctx].size())
                        fail("crease flags exhausted");
                    bool is_crease = crease_bits[ctx][flag_pos[ctx]++];
                    if (!is_crease) {
                        ++num_used;
                        for (int c = 0; c < nc; ++c) total[c] += preds[i][c];
                    }
                }
            }
            if (num_used)
                for (int c = 0; c < nc; ++c) pred[c] = total[c] / num_used;
            else
                for (int c = 0; c < nc; ++c) pred[c] = vals[(p - 1) * nc + c];
            apply(pred.data(), &corr[p * nc], &vals[p * nc]);
        }
    } else {  // PRED_TEXCOORDS_PORTABLE
        // MeshPredictionSchemeTexCoordsPortable (port of
        // scene/draco.py::_predict_tex_coords_portable): UV predicted
        // from the tip position projected onto the opposite edge in
        // integer arithmetic, one orientation bit per predictable
        // entry, consumed from the END of the orientation list.
        // int64 multiply-adds deliberately wrap (the Python reference
        // uses np.int64 arrays there); the projection quotient and the
        // isqrt product use exact 128-bit like Python's bigints.
        const auto &pp = *pos_for_point;
        int64_t ori_pos = (int64_t)orientations.size();
        auto point_of = [&](int64_t entry) {
            return corner_to_point[value_to_corner[entry]];
        };
        for (int64_t p = 1; p < num_entries; ++p) {
            int64_t corner = value_to_corner[p];
            int64_t ne = vertex_to_value[view.cv[next_c(corner)]];
            int64_t pe = vertex_to_value[view.cv[prev_c(corner)]];
            bool have = false;
            if (ne >= 0 && ne < p && pe >= 0 && pe < p) {
                int64_t n_uv[2] = {vals[ne * 2], vals[ne * 2 + 1]};
                int64_t p_uv[2] = {vals[pe * 2], vals[pe * 2 + 1]};
                if (p_uv[0] == n_uv[0] && p_uv[1] == n_uv[1]) {
                    pred[0] = p_uv[0];
                    pred[1] = p_uv[1];
                    have = true;
                } else {
                    const auto &tip = pp[point_of(p)];
                    const auto &npos = pp[point_of(ne)];
                    const auto &ppos = pp[point_of(pe)];
                    int64_t pn[3], cn[3];
                    uint64_t pn2 = 0, cdp = 0;
                    for (int i = 0; i < 3; ++i) {
                        pn[i] = ppos[i] - npos[i];
                        cn[i] = tip[i] - npos[i];
                        pn2 += (uint64_t)pn[i] * (uint64_t)pn[i];
                        cdp += (uint64_t)pn[i] * (uint64_t)cn[i];
                    }
                    int64_t pn_norm2 = (int64_t)pn2;
                    int64_t cn_dot_pn = (int64_t)cdp;
                    if (pn_norm2 != 0) {
                        if (pn_norm2 < 0) fail("texcoord overflow");
                        int64_t pn_uv[2] = {p_uv[0] - n_uv[0],
                                            p_uv[1] - n_uv[1]};
                        int64_t x_uv[2], x_pos[3];
                        for (int k = 0; k < 2; ++k)
                            x_uv[k] = (int64_t)(
                                (uint64_t)n_uv[k] * (uint64_t)pn_norm2 +
                                (uint64_t)cn_dot_pn * (uint64_t)pn_uv[k]);
                        uint64_t cx2 = 0;
                        for (int i = 0; i < 3; ++i) {
                            __int128 prod = (__int128)cn_dot_pn * pn[i];
                            x_pos[i] = npos[i] + (int64_t)(prod / pn_norm2);
                            int64_t d = tip[i] - x_pos[i];
                            cx2 += (uint64_t)d * (uint64_t)d;
                        }
                        int64_t cx_norm2 = (int64_t)cx2;
                        if (cx_norm2 < 0) fail("texcoord overflow");
                        int64_t s = isqrt_u128(
                            (unsigned __int128)(uint64_t)cx_norm2 *
                            (uint64_t)pn_norm2);
                        int64_t perp_uv[2] = {pn_uv[1], -pn_uv[0]};
                        bool ori = ori_pos > 0
                            ? (bool)orientations[ori_pos - 1] : true;
                        ori_pos -= 1;
                        for (int k = 0; k < 2; ++k) {
                            uint64_t step =
                                (uint64_t)perp_uv[k] * (uint64_t)s;
                            int64_t v = (int64_t)(
                                ori ? (uint64_t)x_uv[k] + step
                                    : (uint64_t)x_uv[k] - step);
                            pred[k] = v / pn_norm2;
                        }
                        have = true;
                    } else {
                        pred[0] = p_uv[0];
                        pred[1] = p_uv[1];
                        have = true;
                    }
                }
            }
            if (!have) {
                pred[0] = vals[(p - 1) * 2];
                pred[1] = vals[(p - 1) * 2 + 1];
            }
            apply(pred.data(), &corr[p * 2], &vals[p * 2]);
        }
    }
}

static void oct_to_unit(const int64_t *st, int bits, float *out3) {
    double max_value = (double)((1 << bits) - 1);
    double s = st[0] * (2.0 / max_value) - 1.0;
    double t = st[1] * (2.0 / max_value) - 1.0;
    double x = 1.0 - std::fabs(s) - std::fabs(t);
    double y = s, z = t;
    if (x < 0) {
        double sign_s = s >= 0 ? 1.0 : -1.0;
        double sign_t = t >= 0 ? 1.0 : -1.0;
        y = (1.0 - std::fabs(t)) * sign_s;
        z = (1.0 - std::fabs(s)) * sign_t;
    }
    double nrm = std::sqrt(x * x + y * y + z * z);
    if (nrm < 1e-30) nrm = 1e-30;
    out3[0] = (float)(x / nrm);
    out3[1] = (float)(y / nrm);
    out3[2] = (float)(z / nrm);
}

// ---------------------------------------------------------------------------
// Top-level decode
// ---------------------------------------------------------------------------

static MeshOut *decode_mesh(const uint8_t *data, int64_t size) {
    auto *out = new MeshOut();
    Buffer b{data, size};
    if (size < 11 || std::memcmp(b.raw(5), "DRACO", 5) != 0) fail("bad magic");
    int vmaj = b.u8(), vmin = b.u8();
    if (vmaj * 100 + vmin < 202) fail("unsupported bitstream version");
    int encoder_type = b.u8();
    int method = b.u8();
    int flags = b.u16();
    if (encoder_type != 1) fail("point clouds not supported");
    if (method != 1) fail("sequential mesh encoding not supported");
    if (flags & 0x8000) fail("metadata not supported");
    int traversal = b.u8();
    if (traversal != 0) fail("only standard EdgeBreaker traversal supported");

    int64_t num_encoded_vertices = (int64_t)b.varint();
    int64_t num_faces = (int64_t)b.varint();
    int num_attribute_data = b.u8();
    int64_t num_symbols = (int64_t)b.varint();
    int64_t num_split_symbols = (int64_t)b.varint();
    // sanity-cap stream-declared counts: every face/symbol/vertex
    // consumes at least one bit of payload, so anything beyond 8*size
    // is a lie (and unchecked would overflow 3*num_faces or trigger
    // multi-GB allocations from a few-byte stream)
    int64_t max_count = 8 * size;
    if (num_encoded_vertices > max_count || num_faces > max_count ||
        num_symbols > max_count || num_split_symbols > max_count)
        fail("declared counts exceed stream capacity");

    int64_t n_splits = (int64_t)b.varint();
    if (n_splits > max_count) fail("declared counts exceed stream capacity");
    std::vector<std::array<int64_t, 3>> events;
    int64_t last_src = 0;
    for (int64_t i = 0; i < n_splits; ++i) {
        int64_t src = last_src + (int64_t)b.varint();
        int64_t spl = src - (int64_t)b.varint();
        last_src = src;
        events.push_back({src, spl, 0});
    }
    if (n_splits) {
        b.start_bits(false);
        for (auto &e : events) e[2] = b.bits(1);
        b.end_bits();
    }

    uint64_t clers_size = b.start_bits(true);
    int64_t clers_start = b.pos;
    std::vector<int8_t> symbols(num_symbols);
    for (int64_t i = 0; i < num_symbols; ++i) {
        uint32_t s = b.bits(1);
        if (s) s |= b.bits(2) << 1;
        symbols[i] = (int8_t)s;
    }
    b.pos = clers_start + (int64_t)clers_size;
    b.bit_base = -1;

    RAnsBitDecoder start_faces;
    start_faces.init(b);
    std::vector<RAnsBitDecoder> seams(num_attribute_data);
    for (auto &s : seams) s.init(b);

    Connectivity conn;
    conn.num_faces = num_faces;
    conn.num_symbols = num_symbols;
    conn.num_attribute_data = num_attribute_data;
    conn.decode(symbols, events, start_faces, seams, num_encoded_vertices,
                num_split_symbols);

    // ---- attribute decoder configs
    int num_att_decoders = b.u8();
    std::vector<std::pair<int, int>> configs;  // (att_data_id, decoder_type)
    for (int d = 0; d < num_att_decoders; ++d) {
        int att_data_id = b.i8();
        int decoder_type = b.u8();
        int trav = b.u8();
        if (trav != 0) fail("only depth-first attribute traversal supported");
        configs.push_back({att_data_id, decoder_type});
    }
    std::vector<std::vector<AttributeDesc>> decoder_descs;
    for (auto &cfg : configs) {
        (void)cfg;
        int natt = (int)b.varint();
        std::vector<AttributeDesc> descs(natt);
        for (int a = 0; a < natt; ++a) {
            descs[a].att_type = b.u8();
            descs[a].data_type = b.i8();
            descs[a].nc = b.u8();
            descs[a].normalized = b.u8();
            descs[a].unique_id = (int64_t)b.varint();
        }
        for (int a = 0; a < natt; ++a) descs[a].seq_type = b.u8();
        decoder_descs.push_back(std::move(descs));
    }

    // ---- views
    View rview = real_view(conn);
    std::vector<View> att_views(num_attribute_data);
    std::vector<int> att_view_built(num_attribute_data, 0);
    for (size_t d = 0; d < configs.size(); ++d) {
        int aid = configs[d].first;
        if (aid >= 0 && !att_view_built[aid]) {
            att_views[aid] = attribute_view(conn, conn.seam_corners[aid]);
            att_view_built[aid] = 1;
        }
    }

    // ---- corner -> point (first-encounter order of unique wedge tuples,
    // refined by swing connectivity — mirror of decode_py; see its
    // comment on upstream's AssignPointsToCorners fan-walk semantics)
    int64_t n_corners = 3 * num_faces;
    std::vector<int64_t> corner_to_point(n_corners, -1);
    {
        // hash tuples (vertex, wedge ids of built views in att-data order)
        std::unordered_map<uint64_t, std::vector<int64_t>> buckets;
        std::vector<int64_t> key(1 + num_attribute_data);
        std::vector<std::vector<int64_t>> tuple_keys;
        std::vector<int64_t> corner_tuple(n_corners, -1);
        for (int64_t c = 0; c < n_corners; ++c) {
            key[0] = conn.cv[c];
            for (int a = 0; a < num_attribute_data; ++a)
                key[1 + a] = att_view_built[a] ? att_views[a].cv[c] : 0;
            uint64_t h = 1469598103934665603ull;
            for (int64_t k : key) {
                h ^= (uint64_t)k + 0x9e3779b97f4a7c15ull;
                h *= 1099511628211ull;
            }
            int64_t tid = -1;
            auto &bucket = buckets[h];
            for (int64_t cand : bucket) {
                if (tuple_keys[cand] == key) {
                    tid = cand;
                    break;
                }
            }
            if (tid < 0) {
                tid = (int64_t)tuple_keys.size();
                tuple_keys.push_back(key);
                bucket.push_back(tid);
            }
            corner_tuple[c] = tid;
        }
        // union-find: corners with equal tuples that are swing_right-
        // adjacent share a point; equal tuples in disconnected fan
        // sectors stay distinct (upstream's duplicate-point retention)
        std::vector<int64_t> parent(n_corners);
        for (int64_t c = 0; c < n_corners; ++c) parent[c] = c;
        auto find = [&](int64_t x) {
            int64_t root = x;
            while (parent[root] != root) root = parent[root];
            while (parent[x] != root) {
                int64_t nxt = parent[x];
                parent[x] = root;
                x = nxt;
            }
            return root;
        };
        for (int64_t c = 0; c < n_corners; ++c) {
            int64_t o = conn.opposite[prev_c(c)];
            if (o < 0) continue;
            int64_t r = prev_c(o);  // swing_right(c)
            if (corner_tuple[r] != corner_tuple[c]) continue;
            int64_t ra = find(c), rb = find(r);
            if (ra != rb) parent[rb] = ra;
        }
        std::vector<int64_t> point_of_root(n_corners, -1);
        int64_t num_points = 0;
        for (int64_t c = 0; c < n_corners; ++c) {
            int64_t root = find(c);
            if (point_of_root[root] < 0) point_of_root[root] = num_points++;
            corner_to_point[c] = point_of_root[root];
        }
        out->num_points = num_points;
    }
    out->faces.resize(n_corners);
    for (int64_t c = 0; c < n_corners; ++c) out->faces[c] = (int32_t)corner_to_point[c];
    // representative (smallest) corner per point
    std::vector<int64_t> point_corner(out->num_points, -1);
    for (int64_t c = n_corners - 1; c >= 0; --c) point_corner[corner_to_point[c]] = c;

    // ---- decode attribute blocks
    // portable (quantized-int) positions per point, for the
    // texcoords-portable predictor of a LATER decoder block (mirrors
    // decode_py's pos_portable_for_point)
    std::vector<std::array<int64_t, 3>> pos_portable;
    bool have_pos_portable = false;
    for (size_t d = 0; d < configs.size(); ++d) {
        int aid = configs[d].first;
        const View &view = aid < 0 ? rview : att_views[aid];
        std::vector<int64_t> value_to_corner, vertex_to_value;
        depth_first(view, value_to_corner, vertex_to_value);

        struct Pending {
            const AttributeDesc *desc;
            std::vector<int64_t> vals;
            int nc_out;
        };
        std::vector<Pending> pend;
        for (auto &desc : decoder_descs[d]) {
            Pending p;
            p.desc = &desc;
            decode_attribute_values(
                b, desc, view, value_to_corner, vertex_to_value,
                corner_to_point,
                have_pos_portable ? &pos_portable : nullptr,
                p.vals, p.nc_out);
            pend.push_back(std::move(p));
        }
        for (auto &p : pend) {
            const AttributeDesc &desc = *p.desc;
            int64_t num_entries = (int64_t)value_to_corner.size();
            AttributeResult res;
            res.unique_id = desc.unique_id;
            // entry per point
            std::vector<int64_t> entry_of_point(out->num_points);
            for (int64_t q = 0; q < out->num_points; ++q)
                entry_of_point[q] = vertex_to_value[view.cv[point_corner[q]]];
            if (desc.seq_type == SEQ_QUANTIZATION) {
                std::vector<double> mins(desc.nc);
                for (int c = 0; c < desc.nc; ++c) mins[c] = b.f32();
                double range = b.f32();
                int bits = b.u8();
                double delta = range / (double)((1ll << bits) - 1);
                res.nc = desc.nc;
                res.is_float = true;
                res.fvals.resize(out->num_points * desc.nc);
                for (int64_t q = 0; q < out->num_points; ++q) {
                    int64_t e = entry_of_point[q];
                    if (e < 0 || e >= num_entries) fail("point without value");
                    for (int c = 0; c < desc.nc; ++c)
                        res.fvals[q * desc.nc + c] =
                            (float)(mins[c] + (double)p.vals[e * desc.nc + c] * delta);
                }
                if (desc.att_type == ATT_POSITION && desc.nc == 3) {
                    pos_portable.resize(out->num_points);
                    for (int64_t q = 0; q < out->num_points; ++q) {
                        int64_t e = entry_of_point[q];
                        for (int c = 0; c < 3; ++c)
                            pos_portable[q][c] = p.vals[e * 3 + c];
                    }
                    have_pos_portable = true;
                }
            } else if (desc.seq_type == SEQ_NORMALS) {
                int bits = b.u8();
                res.nc = 3;
                res.is_float = true;
                res.fvals.resize(out->num_points * 3);
                for (int64_t q = 0; q < out->num_points; ++q) {
                    int64_t e = entry_of_point[q];
                    if (e < 0 || e >= num_entries) fail("point without value");
                    oct_to_unit(&p.vals[e * 2], bits, &res.fvals[q * 3]);
                }
            } else {
                res.nc = desc.nc;
                res.is_float = false;
                res.ivals.resize(out->num_points * desc.nc);
                for (int64_t q = 0; q < out->num_points; ++q) {
                    int64_t e = entry_of_point[q];
                    if (e < 0 || e >= num_entries) fail("point without value");
                    for (int c = 0; c < desc.nc; ++c)
                        res.ivals[q * desc.nc + c] = (int32_t)p.vals[e * desc.nc + c];
                }
            }
            out->attrs.push_back(std::move(res));
        }
    }
    return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI (ctypes)
// ---------------------------------------------------------------------------

extern "C" {

void *re_draco_decode(const uint8_t *data, long long size, char *err, int errlen) {
    MeshOut *out = nullptr;
    try {
        out = decode_mesh(data, size);
        if (err && errlen > 0) err[0] = 0;
        return out;
    } catch (const Error &e) {
        delete out;
        if (err && errlen > 0) {
            std::snprintf(err, errlen, "%s", e.msg.c_str());
        }
        return nullptr;
    } catch (const std::exception &e) {
        delete out;
        if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.what());
        return nullptr;
    }
}

long long re_draco_num_points(void *h) { return ((MeshOut *)h)->num_points; }
long long re_draco_num_faces(void *h) { return (long long)((MeshOut *)h)->faces.size() / 3; }
const int32_t *re_draco_faces(void *h) { return ((MeshOut *)h)->faces.data(); }
int re_draco_num_attributes(void *h) { return (int)((MeshOut *)h)->attrs.size(); }
void re_draco_attribute_info(void *h, int i, long long *unique_id, int *nc,
                             int *is_float) {
    auto &a = ((MeshOut *)h)->attrs[i];
    *unique_id = a.unique_id;
    *nc = a.nc;
    *is_float = a.is_float ? 1 : 0;
}
const float *re_draco_attribute_floats(void *h, int i) {
    return ((MeshOut *)h)->attrs[i].fvals.data();
}
const int32_t *re_draco_attribute_ints(void *h, int i) {
    return ((MeshOut *)h)->attrs[i].ivals.data();
}
void re_draco_release(void *h) { delete (MeshOut *)h; }

}  // extern "C"
