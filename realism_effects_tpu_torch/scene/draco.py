"""From-scratch decoder for Draco-compressed triangular meshes
(KHR_draco_mesh_compression), bitstream version 2.2.

The reference's demo scenes (`example/public/gltf/*.glb`,
loaded by `example/main.js:760-809`) are all Draco-compressed by
`gltf-transform draco` (see `example/public/gltf/optimize.js`), so a
decoder is required to render any of them. No Draco library is a
dependency; this module implements the decode path from the public
bitstream format:

- rANS entropy coding (binary + symbol alphabets)
- standard-traversal EdgeBreaker connectivity (CLERS replay, topology
  split events, hole/interior start-face configurations)
- per-attribute seam connectivity and point assignment
- sequential integer attribute decoding with difference /
  (constrained-multi-)parallelogram / portable-texcoord / geometric-
  normal prediction, wrap + octahedron transforms, dequantization

This is the pure-Python reference implementation; `native/draco.cpp`
is the production C++ port (ctypes), with this module as the fallback
and the cross-check in tests. Scope: triangular meshes, bitstream
>= 2.2, standard EdgeBreaker traversal (what `gltf-transform draco`
emits); valence traversal and point clouds raise ``DracoError``.
Numpy only: a copy of the JAX package's ``scene/draco.py``.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["DracoError", "decode", "DecodedMesh"]


class DracoError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Bitstream primitives
# ---------------------------------------------------------------------------

class Buffer:
    """Byte reader with Draco varints and LSB-first bit sections."""

    __slots__ = ("data", "pos", "_bit_base", "_bit_offset")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self._bit_base = -1
        self._bit_offset = 0

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def i8(self) -> int:
        v = self.u8()
        return v - 256 if v >= 128 else v

    def u16(self) -> int:
        v = struct.unpack_from("<H", self.data, self.pos)[0]
        self.pos += 2
        return v

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.pos)[0]
        self.pos += 4
        return v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.data, self.pos)[0]
        self.pos += 4
        return v

    def raw(self, n: int) -> bytes:
        v = self.data[self.pos:self.pos + n]
        if len(v) != n:
            raise DracoError("buffer underrun")
        self.pos += n
        return v

    def varint(self) -> int:
        v = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7
            if shift > 70:
                raise DracoError("varint overflow")

    # bit sections (DecoderBuffer::StartBitDecoding; bits LSB-first)
    def start_bits(self, decode_size: bool) -> int:
        size = self.varint() if decode_size else 0
        self._bit_base = self.pos
        self._bit_offset = 0
        return size

    def bits(self, n: int) -> int:
        v = 0
        base = self._bit_base
        off = self._bit_offset
        data = self.data
        for i in range(n):
            v |= ((data[base + (off >> 3)] >> (off & 7)) & 1) << i
            off += 1
        self._bit_offset = off
        return v

    def end_bits(self):
        self.pos = self._bit_base + ((self._bit_offset + 7) >> 3)
        self._bit_base = -1


# rANS constants (reference: Draco ans.h semantics)
_ANS_IO_BASE = 256
_ANS_P8_PRECISION = 256
_ANS_L_BASE = 4096  # binary (rabs) coder


class RAnsBitDecoder:
    """Binary rANS decoder (Draco RAnsBitDecoder: uint8 prob_zero +
    varint-sized byte blob; state bytes consumed from the end)."""

    def __init__(self, buf: Buffer):
        self.prob_zero = buf.u8()
        size = buf.varint()
        self.buf = buf.raw(size)
        offset = size
        if offset < 1:
            self.state = _ANS_L_BASE
            self.offset = 0
            return
        x = self.buf[offset - 1] >> 6
        if x == 0:
            self.state = self.buf[offset - 1] & 0x3F
            offset -= 1
        elif x == 1:
            if offset < 2:
                raise DracoError("rans init underrun")
            self.state = struct.unpack_from("<H", self.buf, offset - 2)[0] & 0x3FFF
            offset -= 2
        elif x == 2:
            if offset < 3:
                raise DracoError("rans init underrun")
            self.state = (self.buf[offset - 3]
                          | (self.buf[offset - 2] << 8)
                          | (self.buf[offset - 1] << 16)) & 0x3FFFFF
            offset -= 3
        else:
            raise DracoError("invalid rans bit-decoder init")
        self.state += _ANS_L_BASE
        self.offset = offset

    def bit(self) -> int:
        p0 = self.prob_zero
        p1 = _ANS_P8_PRECISION - p0
        state = self.state
        while state < _ANS_L_BASE and self.offset > 0:
            self.offset -= 1
            state = state * _ANS_IO_BASE + self.buf[self.offset]
        x = state % _ANS_P8_PRECISION
        quot = state // _ANS_P8_PRECISION
        if x < p1:
            self.state = quot * p1 + x
            return 1
        self.state = quot * p0 + (x - p1)
        return 0


class RAnsSymbolDecoder:
    """Multi-symbol rANS decoder (Draco RAnsSymbolDecoder): probability
    table with 2-bit token encoding, precision derived from the
    alphabet's bit length, state bytes consumed from the end."""

    def __init__(self, buf: Buffer, unique_symbols_bit_length: int):
        precision_bits = (3 * unique_symbols_bit_length) // 2
        precision_bits = max(12, min(20, precision_bits))
        self.precision = 1 << precision_bits
        self.l_base = self.precision * 4

        num_symbols = buf.varint()
        probs = np.zeros(num_symbols, np.uint32)
        i = 0
        while i < num_symbols:
            prob_data = buf.u8()
            token = prob_data & 3
            if token == 3:
                offset = prob_data >> 2
                if i + offset >= num_symbols:
                    raise DracoError("prob table overflow")
                # offset+1 symbols in a row have zero probability
                i += offset + 1
            else:
                prob = prob_data >> 2
                for b in range(token):
                    prob |= buf.u8() << (8 * (b + 1) - 2)
                probs[i] = prob
                i += 1
        total = int(probs.sum())
        if total != self.precision:
            raise DracoError(
                f"prob table sum {total} != precision {self.precision}")
        self.cum = np.zeros(num_symbols + 1, np.uint32)
        np.cumsum(probs, out=self.cum[1:])
        self.probs = probs
        # slot -> symbol lookup for O(1) decode
        self.lut = np.repeat(
            np.arange(num_symbols, dtype=np.uint32), probs)

        size = buf.varint()
        self.buf = buf.raw(size)
        offset = size
        if offset < 1:
            raise DracoError("empty rans stream")
        x = self.buf[offset - 1] >> 6
        if x == 0:
            self.state = self.buf[offset - 1] & 0x3F
            offset -= 1
        elif x == 1:
            self.state = struct.unpack_from("<H", self.buf, offset - 2)[0] & 0x3FFF
            offset -= 2
        elif x == 2:
            self.state = (self.buf[offset - 3]
                          | (self.buf[offset - 2] << 8)
                          | (self.buf[offset - 1] << 16)) & 0x3FFFFF
            offset -= 3
        else:
            self.state = struct.unpack_from("<I", self.buf, offset - 4)[0] & 0x3FFFFFFF
            offset -= 4
        self.state += self.l_base
        self.offset = offset

    def symbol(self) -> int:
        state = self.state
        while state < self.l_base and self.offset > 0:
            self.offset -= 1
            state = state * _ANS_IO_BASE + self.buf[self.offset]
        rem = state % self.precision
        quot = state // self.precision
        s = int(self.lut[rem])
        self.state = quot * int(self.probs[s]) + rem - int(self.cum[s])
        return s


def decode_symbols(buf: Buffer, num_values: int, num_components: int) -> np.ndarray:
    """Draco DecodeSymbols: tagged (bit-length tags) or raw rANS."""
    out = np.zeros(num_values, np.uint32)
    if num_values == 0:
        return out
    scheme = buf.u8()
    if scheme == 0:  # TAGGED
        tag_decoder = RAnsSymbolDecoder(buf, 5)
        buf.start_bits(False)
        i = 0
        while i < num_values:
            bit_length = tag_decoder.symbol()
            for _ in range(num_components):
                out[i] = buf.bits(bit_length)
                i += 1
        buf.end_bits()
    elif scheme == 1:  # RAW
        max_bit_length = buf.u8()
        dec = RAnsSymbolDecoder(buf, max_bit_length)
        for i in range(num_values):
            out[i] = dec.symbol()
    else:
        raise DracoError(f"unknown symbol coding scheme {scheme}")
    return out


def _symbols_to_signed(symbols: np.ndarray) -> np.ndarray:
    """Draco ConvertSymbolsToSignedInts (zigzag)."""
    vals = (symbols >> np.uint32(1)).astype(np.int64)
    return np.where(symbols & 1, -vals - 1, vals)


# ---------------------------------------------------------------------------
# Header / connectivity containers
# ---------------------------------------------------------------------------

class DecodedMesh:
    """Result: faces (F, 3) int32 point indices + per-attribute arrays
    (num_points, C) keyed by the draco unique attribute id."""

    def __init__(self, faces, attributes, num_points):
        self.faces = faces
        self.attributes = attributes
        self.num_points = num_points


# ---------------------------------------------------------------------------
# EdgeBreaker connectivity (standard traversal)
# ---------------------------------------------------------------------------

TOPOLOGY_C = 0
TOPOLOGY_S = 1
TOPOLOGY_L = 3
TOPOLOGY_R = 5
TOPOLOGY_E = 7


def _next(c):
    return c - (c % 3) + (c + 1) % 3


def _prev(c):
    return c - (c % 3) + (c + 2) % 3


class CornerTable:
    """Corner table built during EdgeBreaker replay.

    Face f owns corners 3f..3f+2; ``opposite`` links corners across
    shared edges; ``cv`` maps corner -> vertex id; ``leftmost[v]`` is
    the corner at v whose CCW-adjacent edge is on the active boundary
    (Draco's CornerTable::LeftMostCorner)."""

    def __init__(self, num_faces: int, num_vertex_slots: int):
        self.opposite = np.full(3 * num_faces, -1, np.int64)
        self.cv = np.full(3 * num_faces, -1, np.int64)
        self.leftmost = np.full(num_vertex_slots, -1, np.int64)

    def set_opposite(self, a, b):
        self.opposite[a] = b
        self.opposite[b] = a

    def swing_left(self, c):
        """CCW rotation around Vertex(c); -1 when crossing a boundary."""
        o = self.opposite[_next(c)]
        return -1 if o < 0 else _next(o)

    def swing_right(self, c):
        o = self.opposite[_prev(c)]
        return -1 if o < 0 else _prev(o)


class _Connectivity:
    """Replay of the CLERS symbol stream (reverse encoding order),
    mirroring Draco's MeshEdgebreakerDecoderImpl::DecodeConnectivity."""

    def __init__(self, num_faces, num_encoded_vertices, num_split_symbols,
                 num_symbols, num_attribute_data):
        self.num_symbols = num_symbols
        self.num_faces = num_faces
        self.num_attribute_data = num_attribute_data
        # vertex slots: encoded vertices + one temp per S merge
        self.table = CornerTable(
            num_faces, num_encoded_vertices + num_split_symbols + 3)
        self.is_vert_hole = np.ones(
            num_encoded_vertices + num_split_symbols + 3, bool)
        self.next_vert = 0
        self.active_stack: list[int] = []
        # decoder symbol id -> list of (corner registered for future S)
        self.split_corners: dict[int, int] = {}
        # seam corners per attribute-data index (corner c s.t. the edge
        # opposite c is an attribute seam)
        self.seam_corners = [[] for _ in range(num_attribute_data)]
        self.interior_start_faces: list[int] = []

    def new_vertex(self):
        v = self.next_vert
        if v >= len(self.is_vert_hole):
            raise DracoError("vertex allocation overflow")
        self.next_vert += 1
        return v

    def chk_vert(self, v):
        # vertex ids read back out of cv[] are untrusted: -1 (unset)
        # would silently wrap as a negative numpy index
        if v < 0 or v >= len(self.is_vert_hole):
            raise DracoError("vertex id out of range")
        return v

    def decode(self, symbols, split_events, start_face_bits: RAnsBitDecoder,
               seam_decoders: list[RAnsBitDecoder]):
        """symbols: list of CLERS ids in decode order. split_events:
        list of (source_symbol_id, split_symbol_id, source_edge) in
        ENCODER symbol ids; converted to decoder ids here."""
        t = self.table
        nsym = self.num_symbols
        # encoder ids count from the end of the decoder's symbol order
        by_source: dict[int, list] = {}
        for src, spl, edge in split_events:
            by_source.setdefault(nsym - src - 1, []).append(
                (nsym - spl - 1, edge))

        face = 0
        for i in range(nsym):
            sym = symbols[i]
            if face >= self.num_faces:
                # stream-declared counts are untrusted (crafted streams
                # can emit more symbols than declared faces)
                raise DracoError("more CLERS symbols than faces")
            corner = 3 * face
            face += 1
            if sym == TOPOLOGY_C:
                if not self.active_stack:
                    raise DracoError("C on empty stack")
                corner_a = self.active_stack[-1]
                vertex_x = self.chk_vert(t.cv[_next(corner_a)])
                lm = t.leftmost[vertex_x]
                if lm < 0:
                    raise DracoError("C without leftmost")
                corner_b = _next(lm)
                t.set_opposite(corner_a, corner + 1)
                t.set_opposite(corner_b, corner + 2)
                t.cv[corner] = vertex_x
                t.cv[corner + 1] = t.cv[_next(corner_b)]
                t.cv[corner + 2] = t.cv[_prev(corner_a)]
                t.leftmost[self.chk_vert(t.cv[corner + 2])] = corner + 2
                self.active_stack[-1] = corner
                self.is_vert_hole[vertex_x] = False
            elif sym == TOPOLOGY_R or sym == TOPOLOGY_L:
                if not self.active_stack:
                    raise DracoError("R/L on empty stack")
                corner_a = self.active_stack[-1]
                if sym == TOPOLOGY_R:
                    opp, corner_l, corner_r = corner + 2, corner + 1, corner
                else:
                    opp, corner_l, corner_r = corner + 1, corner, corner + 2
                t.set_opposite(opp, corner_a)
                v_new = self.new_vertex()
                t.cv[opp] = v_new
                t.leftmost[v_new] = opp
                vertex_r = self.chk_vert(t.cv[_prev(corner_a)])
                t.cv[corner_r] = vertex_r
                t.leftmost[vertex_r] = corner_r
                t.cv[corner_l] = t.cv[_next(corner_a)]
                self.active_stack[-1] = corner
            elif sym == TOPOLOGY_E:
                for k in range(3):
                    v = self.new_vertex()
                    t.cv[corner + k] = v
                    t.leftmost[v] = corner + k
                self.active_stack.append(corner)
            elif sym == TOPOLOGY_S:
                if not self.active_stack:
                    raise DracoError("S on empty stack")
                corner_b = self.active_stack.pop()
                reg = self.split_corners.pop(i, None)
                if reg is not None:
                    self.active_stack.append(reg)
                if not self.active_stack:
                    raise DracoError("S without second corner")
                corner_a = self.active_stack[-1]
                t.set_opposite(corner_a, corner + 2)
                t.set_opposite(corner_b, corner + 1)
                vertex_p = self.chk_vert(t.cv[_prev(corner_a)])
                t.cv[corner] = vertex_p
                t.cv[corner + 1] = t.cv[_next(corner_a)]
                t.cv[corner + 2] = t.cv[_prev(corner_b)]
                t.leftmost[self.chk_vert(t.cv[corner + 2])] = corner + 2
                # merge Vertex(Next(corner_b)) into vertex_p; walk its
                # whole fan (boundary fan: walk CW from its leftmost end)
                vertex_n = self.chk_vert(t.cv[_next(corner_b)])
                self.is_vert_hole[vertex_n] = False
                c = t.leftmost[vertex_n]
                start = c
                steps = 0
                max_steps = len(t.cv) + 1
                while c >= 0:
                    t.cv[c] = vertex_p
                    c = t.swing_right(c)
                    if c == start:
                        break
                    steps += 1
                    if steps > max_steps:
                        raise DracoError("vertex fan cycle")
                t.leftmost[vertex_p] = t.leftmost[vertex_n]
                self.active_stack[-1] = corner
            else:
                raise DracoError(f"bad CLERS symbol {sym}")
            # register topology-split corners sourced at this symbol
            for spl_id, edge in by_source.get(i, ()):  
                act = self.active_stack[-1]
                reg = _next(act) if edge == 1 else _prev(act)
                self.split_corners[spl_id] = reg
        # remaining active boundaries: interior start faces or holes
        while self.active_stack:
            corner_a = self.active_stack.pop()
            interior = start_face_bits.bit()
            if not interior:
                continue  # boundary hole: leave open
            if face >= self.num_faces:
                raise DracoError("too many interior faces")
            corner = 3 * face
            face += 1
            self.interior_start_faces.append(face - 1)
            steps = 0
            max_steps = len(t.cv) + 1
            corner_b = _prev(corner_a)
            while t.opposite[corner_b] >= 0:
                corner_b = _prev(t.opposite[corner_b])
                steps += 1
                if steps > max_steps:
                    raise DracoError("boundary walk cycle")
            corner_c = _next(corner_a)
            while t.opposite[corner_c] >= 0:
                corner_c = _next(t.opposite[corner_c])
                steps += 1
                if steps > max_steps:
                    raise DracoError("boundary walk cycle")
            t.set_opposite(corner, corner_a)
            t.set_opposite(corner + 1, corner_b)
            t.set_opposite(corner + 2, corner_c)
            vert_a = self.chk_vert(t.cv[_next(corner_a)])  # == cv[prev(corner_b)]
            vert_b = self.chk_vert(t.cv[_next(corner_b)])  # == cv[prev(corner_c)]
            vert_c = self.chk_vert(t.cv[_next(corner_c)])  # == cv[prev(corner_a)]
            t.cv[corner] = vert_b
            t.cv[corner + 1] = vert_c
            t.cv[corner + 2] = vert_a
            self.is_vert_hole[vert_a] = False
            self.is_vert_hole[vert_b] = False
            self.is_vert_hole[vert_c] = False
        if face != self.num_faces:
            raise DracoError(
                f"face count mismatch: replay {face} != {self.num_faces}")
        # attribute seams: one bit per attribute per interior edge, in
        # face order, each edge decoded at its lower-id face
        if self.num_attribute_data:
            for f in range(self.num_faces):
                for c in (3 * f, 3 * f + 1, 3 * f + 2):
                    o = t.opposite[c]
                    if o < 0 or o // 3 < f:
                        continue
                    for a, dec in enumerate(seam_decoders):
                        if dec.bit():
                            self.seam_corners[a].append(c)
        return t


# ---------------------------------------------------------------------------
# Attribute corner table (seams split vertices into wedge sectors)
# ---------------------------------------------------------------------------

class AttributeCornerTable:
    """Corner table view where seam edges act as boundaries
    (Draco MeshAttributeCornerTable): corners at a mesh vertex separated
    by seams map to distinct attribute vertices."""

    def __init__(self, table: CornerTable, seam_corners, num_real_vertices):
        n = len(table.cv)
        self.opposite = table.opposite.copy()
        # seam edge = edge opposite a seam corner; cut both directions
        for c in seam_corners:
            o = self.opposite[c]
            if o >= 0:
                self.opposite[o] = -1
            self.opposite[c] = -1
        # recompute per-corner attribute vertices: one id per contiguous
        # fan sector (walk each real vertex's corners, splitting at cuts)
        self.cv = np.full(n, -1, np.int64)
        visited = np.zeros(n, bool)
        next_id = 0
        for c0 in range(n):
            if visited[c0] or table.cv[c0] < 0:
                continue
            # rewind CCW (swing left) to the sector start (or full loop)
            c = c0
            while True:
                o = self.opposite[_next(c)]
                if o < 0:
                    break
                c = _next(o)
                if c == c0:
                    break
            # sweep CW (swing right) assigning this sector's id
            start = c
            vid = next_id
            next_id += 1
            while True:
                visited[c] = True
                self.cv[c] = vid
                o = self.opposite[_prev(c)]
                if o < 0:
                    break
                c = _prev(o)
                if c == start:
                    break
        self.num_vertices = next_id
        self._boundary = None

    def is_on_boundary(self, v_array):
        if self._boundary is None:
            b = np.zeros(self.num_vertices, bool)
            for c in range(len(self.cv)):
                if self.opposite[_next(c)] < 0 or self.opposite[_prev(c)] < 0:
                    b[self.cv[c]] = True
            self._boundary = b
        return self._boundary[v_array]


class RealTableView:
    """Adapter giving CornerTable the same duck-type as
    AttributeCornerTable for the traversers/predictors."""

    def __init__(self, table: CornerTable, num_vertices):
        self.opposite = table.opposite
        self.cv = table.cv
        self.num_vertices = num_vertices
        self._boundary = None

    def is_on_boundary(self, v_array):
        if self._boundary is None:
            b = np.zeros(self.num_vertices, bool)
            for c in range(len(self.cv)):
                if self.opposite[_next(c)] < 0:
                    b[self.cv[c]] = True
                if self.opposite[_prev(c)] < 0:
                    b[self.cv[c]] = True
            self._boundary = b
        return self._boundary[v_array]


def _swing_right(opposite, c):
    o = opposite[_prev(c)]
    return -1 if o < 0 else _prev(o)


def _swing_left(opposite, c):
    o = opposite[_next(c)]
    return -1 if o < 0 else _next(o)


# ---------------------------------------------------------------------------
# Depth-first traversal (Draco DepthFirstTraverser): produces the order
# in which attribute values were encoded
# ---------------------------------------------------------------------------

def depth_first_traverse(view, seed_corners):
    """Returns (value_to_corner, vertex_to_value): encoding order of
    attribute vertices. Mirrors Draco's DepthFirstTraverser seeded from
    the EdgeBreaker processing corners."""
    opposite = view.opposite
    cv = view.cv
    num_faces = len(cv) // 3
    face_visited = np.zeros(num_faces, bool)
    vert_visited = np.zeros(view.num_vertices, bool)
    value_to_corner = []
    vertex_to_value = np.full(view.num_vertices, -1, np.int64)

    def on_vertex(v, corner):
        vertex_to_value[v] = len(value_to_corner)
        value_to_corner.append(corner)

    boundary = view.is_on_boundary(np.arange(view.num_vertices))

    for seed in seed_corners:
        if face_visited[seed // 3]:
            continue
        stack = [seed]
        nv = cv[_next(seed)]
        pv = cv[_prev(seed)]
        if not vert_visited[nv]:
            vert_visited[nv] = True
            on_vertex(nv, _next(seed))
        if not vert_visited[pv]:
            vert_visited[pv] = True
            on_vertex(pv, _prev(seed))
        while stack:
            corner = stack[-1]
            if corner < 0 or face_visited[corner // 3]:
                stack.pop()
                continue
            while True:
                face_visited[corner // 3] = True
                vert = cv[corner]
                if not vert_visited[vert]:
                    vert_visited[vert] = True
                    on_vertex(vert, corner)
                    if not boundary[vert]:
                        # interior: keep walking right
                        # (GetRightCorner = Opposite(Next(corner)))
                        corner = opposite[_next(corner)]
                        continue
                right = opposite[_next(corner)]
                left = opposite[_prev(corner)]
                right_vis = right < 0 or face_visited[right // 3]
                left_vis = left < 0 or face_visited[left // 3]
                if right_vis and left_vis:
                    stack.pop()
                    break
                if right_vis:
                    corner = left
                elif left_vis:
                    corner = right
                else:
                    stack[-1] = left
                    stack.append(right)
                    break
    return value_to_corner, vertex_to_value


# ---------------------------------------------------------------------------
# Prediction transforms
# ---------------------------------------------------------------------------

class WrapTransform:
    """Draco PredictionSchemeWrapDecodingTransform: signed (zigzag)
    corrections added to the clamped prediction, single wrap into
    [min, max] (so a -1 step across the full range costs 1 bit)."""

    def __init__(self, buf: Buffer, num_components):
        self.min = np.int64(struct.unpack_from("<i", buf.data, buf.pos)[0])
        self.max = np.int64(struct.unpack_from("<i", buf.data, buf.pos + 4)[0])
        buf.pos += 8
        self.dif = self.max - self.min + 1

    corrections_positive = False

    def original(self, pred, corr):
        pred = np.clip(pred, self.min, self.max)
        v = pred + corr
        v = np.where(v > self.max, v - self.dif, v)
        v = np.where(v < self.min, v + self.dif, v)
        return v


class DeltaTransform:
    """PredictionSchemeTransform (DELTA): signed corrections, plain add."""

    def __init__(self, buf: Buffer, num_components):
        pass

    corrections_positive = False

    def original(self, pred, corr):
        return pred + corr


def _trunc_div2(x: int) -> int:
    """C++ integer division by 2 (truncates toward zero)."""
    return -((-x) // 2) if x < 0 else x // 2


class OctahedronCanonicalizedTransform:
    """PredictionSchemeNormalOctahedronCanonicalizedTransform:
    2-component octahedral coords; out-of-diamond predictions inverted,
    non-bottom-left predictions rotated into the canonical quadrant,
    positive corrections folded by ModMax."""

    corrections_positive = True

    def __init__(self, buf: Buffer, num_components):
        self.max_quantized = struct.unpack_from("<i", buf.data, buf.pos)[0]
        self.center = struct.unpack_from("<i", buf.data, buf.pos + 4)[0]
        buf.pos += 8
        # ModMax folds by max_quantized_value itself (odd alphabet
        # centered on center_value), not max+1
        self.n = self.max_quantized

    def _mod_max(self, x):
        if x > self.center:
            return x - self.n
        if x < -self.center:
            return x + self.n
        return x

    @staticmethod
    def _rotate(s, t, count):
        count %= 4
        if count == 1:
            return t, -s
        if count == 2:
            return -s, -t
        if count == 3:
            return -t, s
        return s, t

    @staticmethod
    def _rotation_count(s, t):
        if s == 0:
            if t == 0:
                return 0
            return 3 if t > 0 else 1
        if s > 0:
            return 2 if t >= 0 else 1
        return 3 if t > 0 else 0

    @staticmethod
    def _in_bottom_left(s, t):
        if s == 0 and t == 0:
            return True
        return s < 0 and t <= 0

    def _in_diamond(self, s, t):
        return abs(s) + abs(t) <= self.center

    def _invert_diamond(self, s, t):
        if s >= 0 and t >= 0:
            sign_s, sign_t = 1, 1
        elif s <= 0 and t <= 0:
            sign_s, sign_t = -1, -1
        else:
            sign_s = 1 if s > 0 else -1
            sign_t = 1 if t > 0 else -1
        corner_s = sign_s * self.center
        corner_t = sign_t * self.center
        us = 2 * s - corner_s
        ut = 2 * t - corner_t
        if sign_s * sign_t >= 0:
            us, ut = -ut, -us
        else:
            us, ut = ut, us
        return (_trunc_div2(us + corner_s), _trunc_div2(ut + corner_t))

    def original_value(self, pred_s, pred_t, corr_s, corr_t):
        c = self.center
        ps, pt = int(pred_s) - c, int(pred_t) - c
        in_diamond = self._in_diamond(ps, pt)
        if not in_diamond:
            ps, pt = self._invert_diamond(ps, pt)
        in_bottom_left = self._in_bottom_left(ps, pt)
        rot = self._rotation_count(ps, pt)
        if not in_bottom_left:
            ps, pt = self._rotate(ps, pt, rot)
        os_ = self._mod_max(ps + int(corr_s))
        ot = self._mod_max(pt + int(corr_t))
        if not in_bottom_left:
            os_, ot = self._rotate(os_, ot, (4 - rot) % 4)
        if not in_diamond:
            os_, ot = self._invert_diamond(os_, ot)
        return os_ + c, ot + c


# ---------------------------------------------------------------------------
# Prediction schemes (Draco PredictionSchemeMethod values)
# ---------------------------------------------------------------------------

PREDICTION_NONE = -2
PREDICTION_DIFFERENCE = 0
MESH_PREDICTION_PARALLELOGRAM = 1
MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM = 4
MESH_PREDICTION_TEX_COORDS_PORTABLE = 5
MESH_PREDICTION_GEOMETRIC_NORMAL = 6

TRANSFORM_DELTA = 0
TRANSFORM_WRAP = 1
TRANSFORM_NORMAL_OCTAHEDRON = 2
TRANSFORM_NORMAL_OCTAHEDRON_CANONICALIZED = 3


def _c_div(a: int, b: int) -> int:
    """C++ integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


class _SchemeState:
    """Per-attribute context handed to prediction schemes."""

    def __init__(self, view, value_to_corner, vertex_to_value, nc):
        self.view = view
        self.value_to_corner = value_to_corner
        self.vertex_to_value = vertex_to_value
        self.nc = nc


def _predict_difference(corr, transform, st):
    n = len(corr) // st.nc
    nc = st.nc
    out = np.zeros_like(corr)
    if transform.__class__ is OctahedronCanonicalizedTransform:
        zs, zt = transform.original_value(0, 0, corr[0], corr[1])
        out[0], out[1] = zs, zt
        for p in range(1, n):
            s, t = transform.original_value(
                out[(p - 1) * 2], out[(p - 1) * 2 + 1],
                corr[p * 2], corr[p * 2 + 1])
            out[p * 2], out[p * 2 + 1] = s, t
        return out
    out[:nc] = transform.original(np.zeros(nc, np.int64), corr[:nc])
    for p in range(1, n):
        out[p * nc:(p + 1) * nc] = transform.original(
            out[(p - 1) * nc: p * nc], corr[p * nc:(p + 1) * nc])
    return out


def _parallelogram_entries(opp_corner, cv, vertex_to_value):
    v_opp = vertex_to_value[cv[opp_corner]]
    v_next = vertex_to_value[cv[_next(opp_corner)]]
    v_prev = vertex_to_value[cv[_prev(opp_corner)]]
    return v_opp, v_next, v_prev


def _predict_parallelogram(corr, transform, st):
    nc = st.nc
    n = len(corr) // nc
    out = np.zeros_like(corr)
    cv = st.view.cv
    opposite = st.view.opposite
    v2v = st.vertex_to_value
    out[:nc] = transform.original(np.zeros(nc, np.int64), corr[:nc])
    for p in range(1, n):
        corner = st.value_to_corner[p]
        opp = opposite[corner]
        pred = None
        if opp >= 0:
            v_opp, v_next, v_prev = _parallelogram_entries(opp, cv, v2v)
            if 0 <= v_opp < p and 0 <= v_next < p and 0 <= v_prev < p:
                pred = (out[v_next * nc:(v_next + 1) * nc].astype(np.int64)
                        + out[v_prev * nc:(v_prev + 1) * nc]
                        - out[v_opp * nc:(v_opp + 1) * nc])
        if pred is None:
            pred = out[(p - 1) * nc: p * nc]
        out[p * nc:(p + 1) * nc] = transform.original(pred, corr[p * nc:(p + 1) * nc])
    return out


_MAX_PARALLELOGRAMS = 4


def _predict_constrained_multi(corr, transform, st, crease_bits):
    """MeshPredictionSchemeConstrainedMultiParallelogram: up to 4
    parallelograms per entry, selection flags per parallelogram-count
    context (bit true = crease = unused)."""
    nc = st.nc
    n = len(corr) // nc
    out = np.zeros_like(corr)
    cv = st.view.cv
    opposite = st.view.opposite
    v2v = st.vertex_to_value
    pos = [0] * _MAX_PARALLELOGRAMS
    out[:nc] = transform.original(np.zeros(nc, np.int64), corr[:nc])
    preds = np.zeros((_MAX_PARALLELOGRAMS, nc), np.int64)
    for p in range(1, n):
        first_corner = st.value_to_corner[p]
        corner = first_corner
        num_parallelograms = 0
        while corner >= 0 and num_parallelograms < _MAX_PARALLELOGRAMS:
            opp = opposite[corner]
            if opp >= 0:
                v_opp, v_next, v_prev = _parallelogram_entries(opp, cv, v2v)
                if 0 <= v_opp < p and 0 <= v_next < p and 0 <= v_prev < p:
                    preds[num_parallelograms] = (
                        out[v_next * nc:(v_next + 1) * nc].astype(np.int64)
                        + out[v_prev * nc:(v_prev + 1) * nc]
                        - out[v_opp * nc:(v_opp + 1) * nc])
                    num_parallelograms += 1
            corner = _swing_right(opposite, corner)
            if corner == first_corner:
                break
        total = np.zeros(nc, np.int64)
        num_used = 0
        if num_parallelograms > 0:
            ctx = num_parallelograms - 1
            bits = crease_bits[ctx]
            for i in range(num_parallelograms):
                is_crease = bits[pos[ctx]]
                pos[ctx] += 1
                if not is_crease:
                    num_used += 1
                    total += preds[i]
        if num_used:
            pred = np.array([_c_div(int(total[c]), num_used)
                             for c in range(nc)], np.int64)
        else:
            pred = out[(p - 1) * nc: p * nc]
        out[p * nc:(p + 1) * nc] = transform.original(pred, corr[p * nc:(p + 1) * nc])
    return out


def _predict_tex_coords_portable(corr, transform, st, orientations,
                                 entry_to_point, pos_for_point):
    """MeshPredictionSchemeTexCoordsPortable: UV from the projection of
    the tip position onto the opposite edge, integer arithmetic, one
    orientation bit per predictable entry."""
    import math
    nc = st.nc
    assert nc == 2
    n = len(corr) // nc
    out = np.zeros_like(corr)
    cv = st.view.cv
    v2v = st.vertex_to_value
    ori_pos = len(orientations)

    def pos_of_entry(e):
        return pos_for_point[entry_to_point[e]]

    for p in range(n):
        corner = st.value_to_corner[p]
        next_e = v2v[cv[_next(corner)]]
        prev_e = v2v[cv[_prev(corner)]]
        pred = None
        if 0 <= next_e < p and 0 <= prev_e < p:
            n_uv = out[next_e * 2: next_e * 2 + 2].astype(np.int64)
            p_uv = out[prev_e * 2: prev_e * 2 + 2].astype(np.int64)
            if p_uv[0] == n_uv[0] and p_uv[1] == n_uv[1]:
                pred = p_uv
            else:
                tip_pos = pos_of_entry(p)
                next_pos = pos_of_entry(next_e)
                prev_pos = pos_of_entry(prev_e)
                pn = prev_pos - next_pos
                pn_norm2 = int(pn @ pn)
                if pn_norm2 != 0:
                    cn = tip_pos - next_pos
                    cn_dot_pn = int(pn @ cn)
                    pn_uv = p_uv - n_uv
                    x_uv = n_uv * pn_norm2 + cn_dot_pn * pn_uv
                    x_pos = next_pos + np.array(
                        [_c_div(cn_dot_pn * int(pn[i]), pn_norm2)
                         for i in range(3)], np.int64)
                    d = tip_pos - x_pos
                    cx_norm2 = int(d @ d)
                    s = math.isqrt(cx_norm2 * pn_norm2)
                    perp_uv = np.array([pn_uv[1], -pn_uv[0]], np.int64)
                    nonlocal_ori = orientations[ori_pos - 1] if ori_pos > 0 else True
                    ori_pos -= 1
                    if nonlocal_ori:
                        v = x_uv + perp_uv * s
                    else:
                        v = x_uv - perp_uv * s
                    pred = np.array([_c_div(int(v[0]), pn_norm2),
                                     _c_div(int(v[1]), pn_norm2)], np.int64)
                else:
                    pred = p_uv
        if pred is None:
            if p == 0:
                pred = np.zeros(2, np.int64)
            else:
                pred = out[(p - 1) * 2: p * 2]
        out[p * 2:(p + 1) * 2] = transform.original(pred, corr[p * 2:(p + 1) * 2])
    return out


# ---------------------------------------------------------------------------
# Sequential attribute decoders + top-level decode
# ---------------------------------------------------------------------------

SEQ_GENERIC = 0
SEQ_INTEGER = 1
SEQ_QUANTIZATION = 2
SEQ_NORMALS = 3

ATT_POSITION = 0
ATT_NORMAL = 1
ATT_COLOR = 2
ATT_TEX_COORD = 3
ATT_GENERIC = 4


class _AttributeDesc:
    def __init__(self, att_type, data_type, nc, normalized, unique_id,
                 seq_type):
        self.att_type = att_type
        self.data_type = data_type
        self.nc = nc
        self.normalized = normalized
        self.unique_id = unique_id
        self.seq_type = seq_type


def _decode_raw_integers(buf: Buffer, num_values: int) -> np.ndarray:
    """Uncompressed path of SequentialIntegerAttributeDecoder."""
    num_bytes = buf.u8()
    if num_bytes > 8:
        raise DracoError("raw integer width too large")
    out = np.zeros(num_values, np.uint32)
    for i in range(num_values):
        v = 0
        for b in range(num_bytes):
            v |= buf.u8() << (8 * b)
        out[i] = v & 0xFFFFFFFF
    return out


def _decode_attribute_values(buf: Buffer, desc: _AttributeDesc, st,
                             entry_to_point, pos_for_point):
    """SequentialIntegerAttributeDecoder::DecodeValues: prediction
    method/transform bytes, symbols, prediction data, reconstruction.
    Returns int32 values flattened (num_entries * nc_out,)."""
    num_entries = len(st.value_to_corner)
    nc = 2 if desc.seq_type == SEQ_NORMALS else desc.nc
    st.nc = nc
    method = buf.i8()
    transform_type = buf.i8() if method != PREDICTION_NONE else None

    compressed = buf.u8()
    if compressed:
        symbols = decode_symbols(buf, num_entries * nc, nc)
    else:
        symbols = _decode_raw_integers(buf, num_entries * nc)

    # prediction data (scheme-specific first, then transform data)
    crease_bits = None
    orientations = None
    if method == MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM:
        crease_bits = []
        for i in range(_MAX_PARALLELOGRAMS):
            num_flags = buf.varint()
            bits = np.zeros(num_flags, bool)
            if num_flags > 0:
                dec = RAnsBitDecoder(buf)
                for f in range(num_flags):
                    bits[f] = dec.bit()
            crease_bits.append(bits)
    elif method == MESH_PREDICTION_TEX_COORDS_PORTABLE:
        num_orientations = buf.u32()
        orientations = np.zeros(num_orientations, bool)
        last = True
        dec = RAnsBitDecoder(buf)
        for i in range(num_orientations):
            if not dec.bit():
                last = not last
            orientations[i] = last
    elif method not in (PREDICTION_NONE, PREDICTION_DIFFERENCE,
                        MESH_PREDICTION_PARALLELOGRAM):
        raise DracoError(f"unsupported prediction method {method}")

    if method == PREDICTION_NONE:
        vals = _symbols_to_signed(symbols)
        return vals, None

    if transform_type == TRANSFORM_WRAP:
        transform = WrapTransform(buf, nc)
    elif transform_type == TRANSFORM_DELTA:
        transform = DeltaTransform(buf, nc)
    elif transform_type == TRANSFORM_NORMAL_OCTAHEDRON_CANONICALIZED:
        transform = OctahedronCanonicalizedTransform(buf, nc)
    else:
        raise DracoError(f"unsupported prediction transform {transform_type}")

    corr = (symbols.astype(np.int64) if transform.corrections_positive
            else _symbols_to_signed(symbols))

    if method == PREDICTION_DIFFERENCE:
        vals = _predict_difference(corr, transform, st)
    elif method == MESH_PREDICTION_PARALLELOGRAM:
        vals = _predict_parallelogram(corr, transform, st)
    elif method == MESH_PREDICTION_CONSTRAINED_MULTI_PARALLELOGRAM:
        vals = _predict_constrained_multi(corr, transform, st, crease_bits)
    elif method == MESH_PREDICTION_TEX_COORDS_PORTABLE:
        vals = _predict_tex_coords_portable(
            corr, transform, st, orientations, entry_to_point, pos_for_point)
    return vals, transform


def assemble_points(table, att_views: dict, num_faces: int):
    """Corner -> point assignment (upstream AssignPointsToCorners).

    Unique (vertex, per-attribute-data wedge) tuples, refined by
    swing_right connectivity: upstream assigns points by walking each
    vertex's corner fan, so corners with identical tuples that lie in
    swing-DISCONNECTED sectors of the fan stay distinct points
    (duplicate-point retention in the S-merge/hole bookkeeping case;
    2 points on 2 chevrolet primitives). Point ids are in
    first-encounter (corner) order so the native C++ decoder (same scan
    over corners) produces identical output. Returns
    (corner_to_point (3F,) int64, num_points)."""
    n_corners = 3 * num_faces
    keys = np.empty((n_corners, 1 + len(att_views)), np.int64)
    keys[:, 0] = table.cv
    for j, (aid, view) in enumerate(sorted(att_views.items())):
        keys[:, 1 + j] = view.cv
    _, corner_tuple = np.unique(keys, axis=0, return_inverse=True)
    parent = np.arange(n_corners, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    opp = table.opposite
    for c in range(n_corners):
        o = opp[_prev(c)]
        if o < 0:
            continue
        r = _prev(o)  # swing_right(c)
        if corner_tuple[r] == corner_tuple[c]:
            ra, rb = find(c), find(r)
            if ra != rb:
                parent[rb] = ra
    corner_to_point = np.empty(n_corners, np.int64)
    point_of_root: dict[int, int] = {}
    for c in range(n_corners):
        root = find(c)
        pid = point_of_root.get(root)
        if pid is None:
            pid = len(point_of_root)
            point_of_root[root] = pid
        corner_to_point[c] = pid
    return corner_to_point, len(point_of_root)


def _oct_to_unit(vals2: np.ndarray, bits: int) -> np.ndarray:
    """Octahedral ints (N, 2) in [0, 2^bits - 1] -> unit vectors (N, 3).
    Draco OctahedronToolBox::QuantizedOctahedralCoordsToUnitVector."""
    max_value = (1 << bits) - 1
    s = vals2[:, 0].astype(np.float64) * (2.0 / max_value) - 1.0
    t = vals2[:, 1].astype(np.float64) * (2.0 / max_value) - 1.0
    x = 1.0 - np.abs(s) - np.abs(t)
    neg = x < 0
    sign_s = np.where(s >= 0, 1.0, -1.0)
    sign_t = np.where(t >= 0, 1.0, -1.0)
    y = np.where(neg, (1.0 - np.abs(t)) * sign_s, s)
    z = np.where(neg, (1.0 - np.abs(s)) * sign_t, t)
    v = np.stack([x, y, z], -1)
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return (v / np.maximum(n, 1e-30)).astype(np.float32)


def decode(data: bytes, prefer_native: bool = True) -> DecodedMesh:
    """Decode a Draco triangular-mesh bitstream (KHR_draco_mesh_compression
    payload) into faces + per-unique-id attribute arrays.

    Uses the C++ decoder (``native/draco.cpp``, ctypes) when a toolchain
    is available; this module's pure-Python implementation is the
    fallback and the cross-check (the two are bit-identical,
    ``tests/test_draco.py``)."""
    if prefer_native:
        # Any native failure falls through to the Python decoder, so a
        # user asset never fails to load just because a toolchain is
        # present (both paths cover the same four prediction schemes;
        # the fallback guards future format corners).
        try:
            from .. import native
            result = native.draco_decode(data)
        except Exception:
            result = None
        if result is not None:
            faces, attrs, num_points = result
            return DecodedMesh(faces, attrs, num_points)
    return decode_py(data)


def decode_py(data: bytes) -> DecodedMesh:
    """Pure-Python reference decode path."""
    buf = Buffer(data)
    if buf.raw(5) != b"DRACO":
        raise DracoError("bad magic")
    vmaj, vmin = buf.u8(), buf.u8()
    if (vmaj, vmin) < (2, 2):
        raise DracoError(f"unsupported bitstream {vmaj}.{vmin}")
    encoder_type = buf.u8()
    method = buf.u8()
    flags = buf.u16()
    if encoder_type != 1:
        raise DracoError("point clouds not supported")
    if method != 1:
        raise DracoError("sequential mesh encoding not supported")
    if flags & 0x8000:
        raise DracoError("metadata not supported")
    traversal = buf.u8()
    if traversal != 0:
        raise DracoError(
            f"only standard EdgeBreaker traversal supported (got {traversal})")

    num_encoded_vertices = buf.varint()
    num_faces = buf.varint()
    num_attribute_data = buf.u8()
    num_symbols = buf.varint()
    num_split_symbols = buf.varint()
    # sanity-cap stream-declared counts: every face/symbol/vertex costs
    # at least one bit of payload, so anything beyond 8*len(data) is a
    # lie (unchecked, a few-byte stream could demand multi-GB arrays)
    max_count = 8 * len(data)
    if max(num_encoded_vertices, num_faces, num_symbols,
           num_split_symbols) > max_count:
        raise DracoError("declared counts exceed stream capacity")

    n_splits = buf.varint()
    if n_splits > max_count:
        raise DracoError("declared counts exceed stream capacity")
    events = []
    last_src = 0
    for _ in range(n_splits):
        src = last_src + buf.varint()
        spl = src - buf.varint()
        last_src = src
        events.append([src, spl, 0])
    if n_splits:
        buf.start_bits(False)
        for e in events:
            e[2] = buf.bits(1)
        buf.end_bits()

    clers_size = buf.start_bits(True)
    clers_start = buf.pos
    symbols = np.zeros(num_symbols, np.int8)
    for i in range(num_symbols):
        b = buf.bits(1)
        if b:
            b |= buf.bits(2) << 1
        symbols[i] = b
    buf.pos = clers_start + clers_size
    buf._bit_base = -1

    start_faces = RAnsBitDecoder(buf)
    seam_decoders = [RAnsBitDecoder(buf) for _ in range(num_attribute_data)]

    conn = _Connectivity(num_faces, num_encoded_vertices, num_split_symbols,
                         num_symbols, num_attribute_data)
    table = conn.decode(symbols, [tuple(e) for e in events],
                        start_faces, seam_decoders)

    # ---- attribute decoder configs
    num_att_decoders = buf.u8()
    configs = []
    for _ in range(num_att_decoders):
        att_data_id = buf.i8()
        decoder_type = buf.u8()
        trav_method = buf.u8()
        if trav_method != 0:
            raise DracoError(
                f"only depth-first attribute traversal supported "
                f"(got {trav_method})")
        configs.append((att_data_id, decoder_type))
    decoders = []
    for att_data_id, decoder_type in configs:
        natt = buf.varint()
        descs = []
        for _ in range(natt):
            att_type = buf.u8()
            data_type = buf.i8()
            nc = buf.u8()
            normalized = buf.u8()
            unique_id = buf.varint()
            descs.append([att_type, data_type, nc, normalized, unique_id])
        for d in descs:
            d.append(buf.u8())  # sequential decoder type
        decoders.append((att_data_id, decoder_type,
                         [_AttributeDesc(*d) for d in descs]))

    # ---- traversal views and corner -> point assembly
    num_vertex_slots = conn.next_vert
    real_view = RealTableView(table, num_vertex_slots)
    att_views = {}
    for att_data_id, decoder_type, descs in decoders:
        if att_data_id >= 0:
            att_views[att_data_id] = AttributeCornerTable(
                table, conn.seam_corners[att_data_id], num_vertex_slots)

    # seeds: face-creation (symbol) order, one corner per face
    seed_corners = [3 * f for f in range(num_faces)]

    n_corners = 3 * num_faces
    corner_to_point, num_points = assemble_points(
        table, att_views, num_faces)
    faces = corner_to_point.reshape(-1, 3).astype(np.int32)

    # representative corner per point (for value lookups)
    point_corner = np.zeros(num_points, np.int64)
    point_corner[corner_to_point[::-1]] = np.arange(n_corners - 1, -1, -1)

    # ---- decode each attributes-decoder block
    attributes = {}
    pos_portable_for_point = None   # portable (quantized) positions/point
    for att_data_id, decoder_type, descs in decoders:
        if att_data_id < 0:
            view = real_view
        else:
            view = att_views[att_data_id]
        value_to_corner, vertex_to_value = depth_first_traverse(
            view, seed_corners)
        st = _SchemeState(view, value_to_corner, vertex_to_value, 0)
        # entry -> point (for cross-attribute prediction)
        entry_to_point = corner_to_point[np.asarray(value_to_corner)]

        vals_per_desc = []
        for desc in descs:
            vals, transform = _decode_attribute_values(
                buf, desc, st, entry_to_point, pos_portable_for_point)
            vals_per_desc.append((desc, vals))

        # transform data needed by portable transforms (per controller,
        # after all its portable attributes)
        for desc, vals in vals_per_desc:
            num_entries = len(value_to_corner)
            # value per point
            entry_of_point = vertex_to_value[view.cv[point_corner]]
            if desc.seq_type == SEQ_QUANTIZATION:
                mins = np.array([buf.f32() for _ in range(desc.nc)],
                                np.float64)
                rng = buf.f32()
                bits = buf.u8()
                arr = vals.reshape(num_entries, desc.nc).astype(np.float64)
                delta = rng / ((1 << bits) - 1)
                out = (mins[None, :] + arr * delta).astype(np.float32)
                attributes[desc.unique_id] = out[entry_of_point]
                if desc.att_type == ATT_POSITION:
                    pos_portable_for_point = vals.reshape(
                        num_entries, desc.nc).astype(np.int64)[entry_of_point]
            elif desc.seq_type == SEQ_NORMALS:
                bits = buf.u8()
                arr = vals.reshape(num_entries, 2)
                attributes[desc.unique_id] = _oct_to_unit(arr, bits)[entry_of_point]
            else:  # INTEGER / GENERIC: raw ints
                arr = vals.reshape(num_entries, desc.nc).astype(np.int32)
                attributes[desc.unique_id] = arr[entry_of_point]

    return DecodedMesh(faces, attributes, num_points)
