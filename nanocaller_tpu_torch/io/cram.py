"""CRAM 3.0 reader/writer — closes the reference's CRAM capability.

A copy of nanocaller_tpu/io/cram.py on the port's own modules; its
native window decode (below) raises where the C++ decoder refuses a
container, where the JAX package falls back on the Python decoder.

The reference accepts BAM or CRAM input transparently through pysam/
htslib (`nanocaller_src/generate_SNP_pileups.py:134`,
`generate_indel_pileups.py:147`) and re-emits a haplotagged CRAM when
the input was CRAM (`nanocaller_src/indelCaller.py:248-251`). This
module implements the CRAM 3.0 container format from the public
hts-specs description (file definition, containers, compression-header
/slice/external blocks, ITF8/LTF8 varints, the codec set needed for
mapped reads, and the .crai index) as a from-scratch Python layer with
the same reader/writer interface as ``io/bam.py``.

Supported on read: block methods raw/gzip/bzip2/lzma/rANS4x8; encodings
EXTERNAL, HUFFMAN (canonical, incl. the 0-bit constant case),
BYTE_ARRAY_LEN, BYTE_ARRAY_STOP, BETA, GAMMA; reference-based and
embedded-reference sequence reconstruction; multi-ref slices; .crai
region queries. The writer emits single-slice containers with external
block encodings (gzip or rANS compressed), reference-based features
(X/I/i/D/S/N/H/P), BAM-format tag blobs, and a .crai index.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import zlib

import numpy as np

from . import rans
from .bam import AlignedRead, CIGAR_OPS, _OP_CONSUMES

CRAM_MAGIC = b"CRAM"

# block compression methods
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
# block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5
# encoding codec ids
E_NULL, E_EXTERNAL, E_GOLOMB, E_HUFFMAN = 0, 1, 2, 3
E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_BETA, E_SUBEXP = 4, 5, 6, 7
E_GOLOMB_RICE, E_GAMMA = 8, 9

# CRAM record flags (CF)
CF_QUAL_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8
# CRAM mate flags (MF)
MF_MATE_REVERSE = 0x1  # → BAM 0x20
MF_MATE_UNMAPPED = 0x2  # → BAM 0x8

BASES5 = "ACGTN"


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def itf8_put(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def itf8_get(data, pos):
    try:
        return _itf8_get(data, pos)
    except (IndexError, struct.error) as e:
        raise ValueError("truncated CRAM varint at offset %d" % pos) from e


def _itf8_get(data, pos):
    b0 = data[pos]
    if b0 < 0x80:
        v, n = b0, 1
    elif b0 < 0xC0:
        v = ((b0 & 0x3F) << 8) | data[pos + 1]
        n = 2
    elif b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (data[pos + 1] << 8) | data[pos + 2]
        n = 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (data[pos + 1] << 16) | \
            (data[pos + 2] << 8) | data[pos + 3]
        n = 4
    else:
        v = ((b0 & 0x0F) << 28) | (data[pos + 1] << 20) | \
            (data[pos + 2] << 12) | (data[pos + 3] << 4) | \
            (data[pos + 4] & 0x0F)
        n = 5
    if v >= 0x80000000:
        v -= 0x100000000
    return v, pos + n


def ltf8_put(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    # leading byte carries (7 - n_extra) data bits under n_extra leading 1s
    for n_extra in range(1, 8):
        bits = 7 - n_extra + 8 * n_extra  # data bits available
        if v < (1 << bits):
            lead = (0xFF << (8 - n_extra)) & 0xFF
            head = lead | (v >> (8 * n_extra))
            body = [(v >> (8 * (n_extra - 1 - k))) & 0xFF
                    for k in range(n_extra)]
            return bytes([head] + body)
    return bytes([0xFF]) + struct.pack(">Q", v)


def ltf8_get(data, pos):
    try:
        return _ltf8_get(data, pos)
    except (IndexError, struct.error) as e:
        raise ValueError("truncated CRAM varint at offset %d" % pos) from e


def _ltf8_get(data, pos):
    b0 = data[pos]
    n_extra = 0
    mask = 0x80
    while n_extra < 8 and (b0 & mask):
        n_extra += 1
        mask >>= 1
    if n_extra == 8:
        v = struct.unpack_from(">Q", data, pos + 1)[0]
        n = 9
    else:
        v = b0 & (0xFF >> n_extra)
        for k in range(n_extra):
            v = (v << 8) | data[pos + 1 + k]
        n = 1 + n_extra
    if v >= 0x8000000000000000:
        v -= 0x10000000000000000
    return v, pos + n


def _read_itf8_array(data, pos):
    n, pos = itf8_get(data, pos)
    vals = []
    for _ in range(n):
        v, pos = itf8_get(data, pos)
        vals.append(v)
    return vals, pos


def _write_itf8_array(vals) -> bytes:
    out = bytearray(itf8_put(len(vals)))
    for v in vals:
        out += itf8_put(v)
    return bytes(out)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _compress_block(raw: bytes, method: int) -> bytes:
    if method == M_RAW:
        return raw
    if method == M_GZIP:
        return gzip.compress(raw, compresslevel=6)
    if method == M_BZIP2:
        import bz2
        return bz2.compress(raw)
    if method == M_LZMA:
        import lzma
        return lzma.compress(raw)
    if method == M_RANS:
        order = 1 if len(raw) >= 4096 else 0
        return rans.compress(raw, order)
    raise ValueError("unsupported CRAM block method %d" % method)


def _uncompress_block(data: bytes, method: int, raw_size: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return gzip.decompress(data)
    if method == M_BZIP2:
        import bz2
        return bz2.decompress(data)
    if method == M_LZMA:
        import lzma
        return lzma.decompress(data)
    if method == M_RANS:
        return rans.uncompress(data, raw_size)
    raise ValueError("unsupported CRAM block method %d" % method)


class Block:
    __slots__ = ("method", "content_type", "content_id", "data")

    def __init__(self, content_type, content_id, data, method=M_RAW):
        self.method = method
        self.content_type = content_type
        self.content_id = content_id
        self.data = data  # raw (uncompressed) payload

    def serialize(self) -> bytes:
        comp = _compress_block(self.data, self.method)
        if self.method != M_RAW and len(comp) >= len(self.data):
            comp, method = self.data, M_RAW
        else:
            method = self.method
        out = bytearray()
        out.append(method)
        out.append(self.content_type)
        out += itf8_put(self.content_id)
        out += itf8_put(len(comp))
        out += itf8_put(len(self.data))
        out += comp
        out += struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF)
        return bytes(out)

    @classmethod
    def parse(cls, data, pos):
        start = pos
        method = data[pos]
        ctype = data[pos + 1]
        pos += 2
        cid, pos = itf8_get(data, pos)
        csize, pos = itf8_get(data, pos)
        rsize, pos = itf8_get(data, pos)
        payload = bytes(data[pos : pos + csize])
        pos += csize
        (crc,) = struct.unpack_from("<I", data, pos)
        if zlib.crc32(bytes(data[start:pos])) & 0xFFFFFFFF != crc:
            raise ValueError("CRAM block CRC mismatch")
        pos += 4
        raw = _uncompress_block(payload, method, rsize)
        if len(raw) != rsize:
            raise ValueError("CRAM block size mismatch (%d != %d)"
                             % (len(raw), rsize))
        blk = cls(ctype, cid, raw, method)
        return blk, pos


# ---------------------------------------------------------------------------
# container header
# ---------------------------------------------------------------------------

class ContainerHeader:
    __slots__ = ("length", "ref_id", "start", "span", "n_records",
                 "record_counter", "bases", "n_blocks", "landmarks")

    def __init__(self, length, ref_id, start, span, n_records,
                 record_counter, bases, n_blocks, landmarks):
        self.length = length
        self.ref_id = ref_id
        self.start = start
        self.span = span
        self.n_records = n_records
        self.record_counter = record_counter
        self.bases = bases
        self.n_blocks = n_blocks
        self.landmarks = landmarks

    def serialize(self) -> bytes:
        out = bytearray(struct.pack("<i", self.length))
        out += itf8_put(self.ref_id)
        out += itf8_put(self.start)
        out += itf8_put(self.span)
        out += itf8_put(self.n_records)
        out += ltf8_put(self.record_counter)
        out += ltf8_put(self.bases)
        out += itf8_put(self.n_blocks)
        out += _write_itf8_array(self.landmarks)
        out += struct.pack("<I", zlib.crc32(bytes(out)) & 0xFFFFFFFF)
        return bytes(out)

    @classmethod
    def parse(cls, fh):
        head = fh.read(4)
        if len(head) < 4:
            return None
        buf = bytearray(head)
        # varint fields: read generously, then rewind the file position
        more = fh.read(64)
        buf += more
        (length,) = struct.unpack_from("<i", buf, 0)
        pos = 4
        ref_id, pos = itf8_get(buf, pos)
        start, pos = itf8_get(buf, pos)
        span, pos = itf8_get(buf, pos)
        n_records, pos = itf8_get(buf, pos)
        record_counter, pos = ltf8_get(buf, pos)
        bases, pos = ltf8_get(buf, pos)
        n_blocks, pos = itf8_get(buf, pos)
        landmarks, pos = _read_itf8_array(buf, pos)
        crc_pos = pos
        if crc_pos + 4 > len(buf):
            buf += fh.read(crc_pos + 4 - len(buf))
        (crc,) = struct.unpack_from("<I", buf, crc_pos)
        if zlib.crc32(bytes(buf[:crc_pos])) & 0xFFFFFFFF != crc:
            raise ValueError("CRAM container header CRC mismatch")
        pos = crc_pos + 4
        # rewind extra bytes we over-read
        fh.seek(pos - len(buf), os.SEEK_CUR)
        return cls(length, ref_id, start, span, n_records, record_counter,
                   bases, n_blocks, landmarks)


# ---------------------------------------------------------------------------
# bit reader/writer for core-block codecs (MSB first)
# ---------------------------------------------------------------------------

class BitReader:
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read(self, nbits):
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return v

    def read_unary(self):
        n = 0
        while True:
            if self.read(1) == 0:
                return n
            n += 1


# ---------------------------------------------------------------------------
# encodings (decode side)
# ---------------------------------------------------------------------------

class _Streams:
    """External byte streams by content id + the core bit stream."""

    def __init__(self, external, core):
        self.ext = {cid: [data, 0] for cid, data in external.items()}
        self.core = BitReader(core) if core is not None else None

    def ext_byte(self, cid):
        st = self.ext[cid]
        b = st[0][st[1]]
        st[1] += 1
        return b

    def ext_itf8(self, cid):
        st = self.ext[cid]
        v, st[1] = itf8_get(st[0], st[1])
        return v

    def ext_take(self, cid, n):
        st = self.ext[cid]
        out = st[0][st[1] : st[1] + n]
        st[1] += n
        return bytes(out)

    def ext_until(self, cid, stop):
        st = self.ext[cid]
        data, p = st
        q = data.index(stop, p)
        st[1] = q + 1
        return bytes(data[p:q])


def parse_encoding(data, pos):
    """Parse one encoding definition → ((codec, params), pos)."""
    codec, pos = itf8_get(data, pos)
    nbytes, pos = itf8_get(data, pos)
    sub = data[pos : pos + nbytes]
    pos += nbytes
    if codec == E_NULL:
        params = None
    elif codec == E_EXTERNAL:
        cid, _ = itf8_get(sub, 0)
        params = cid
    elif codec == E_HUFFMAN:
        alphabet, p = _read_itf8_array(sub, 0)
        lengths, _ = _read_itf8_array(sub, p)
        params = _build_huffman(alphabet, lengths)
    elif codec == E_BYTE_ARRAY_LEN:
        len_enc, p = parse_encoding(sub, 0)
        val_enc, _ = parse_encoding(sub, p)
        params = (len_enc, val_enc)
    elif codec == E_BYTE_ARRAY_STOP:
        stop = sub[0]
        cid, _ = itf8_get(sub, 1)
        params = (stop, cid)
    elif codec == E_BETA:
        offset, p = itf8_get(sub, 0)
        nbits, _ = itf8_get(sub, p)
        params = (offset, nbits)
    elif codec == E_GAMMA:
        offset, _ = itf8_get(sub, 0)
        params = offset
    elif codec == E_SUBEXP:
        offset, p = itf8_get(sub, 0)
        k, _ = itf8_get(sub, p)
        params = (offset, k)
    else:
        raise ValueError("unsupported CRAM encoding codec %d" % codec)
    return (codec, params), pos


def _build_huffman(alphabet, lengths):
    """Canonical Huffman decode table: sorted (len, symbol-order) → codes."""
    if len(alphabet) == 1 and lengths[0] == 0:
        return ("const", alphabet[0])
    pairs = sorted(zip(lengths, range(len(alphabet))))
    codes = {}
    code = 0
    prev_len = pairs[0][0]
    for ln, idx in pairs:
        code <<= (ln - prev_len)
        prev_len = ln
        codes[(ln, code)] = alphabet[idx]
        code += 1
    return ("table", codes, max(lengths))


def decode_int(enc, streams: _Streams):
    codec, params = enc
    if codec == E_EXTERNAL:
        return streams.ext_itf8(params)
    if codec == E_HUFFMAN:
        if params[0] == "const":
            return params[1]
        _, codes, maxlen = params
        code = 0
        ln = 0
        while ln <= maxlen:
            code = (code << 1) | streams.core.read(1)
            ln += 1
            if (ln, code) in codes:
                return codes[(ln, code)]
        raise ValueError("bad huffman code")
    if codec == E_BETA:
        offset, nbits = params
        return streams.core.read(nbits) - offset
    if codec == E_GAMMA:
        offset = params
        n = 0
        while streams.core.read(1) == 0:
            n += 1
        v = 1
        for _ in range(n):
            v = (v << 1) | streams.core.read(1)
        return v - offset
    if codec == E_SUBEXP:
        offset, k = params
        n = streams.core.read_unary()
        if n == 0:
            b = k
            u = 0
        else:
            b = k + n - 1
            u = 1 << b  # implicit leading 1... per spec: val = (1<<b) + bits
        return (u | streams.core.read(b)) - offset
    raise ValueError("cannot decode int with codec %d" % codec)


def decode_byte(enc, streams: _Streams):
    codec, params = enc
    if codec == E_EXTERNAL:
        return streams.ext_byte(params)
    if codec == E_HUFFMAN:
        return decode_int(enc, streams)
    if codec == E_BETA:
        offset, nbits = params
        return streams.core.read(nbits) - offset
    raise ValueError("cannot decode byte with codec %d" % codec)


def decode_bytes(enc, streams: _Streams, n=None):
    codec, params = enc
    if codec == E_BYTE_ARRAY_STOP:
        stop, cid = params
        return streams.ext_until(cid, stop)
    if codec == E_BYTE_ARRAY_LEN:
        len_enc, val_enc = params
        ln = decode_int(len_enc, streams)
        vcodec, vparams = val_enc
        if vcodec == E_EXTERNAL:
            return streams.ext_take(vparams, ln)
        return bytes(decode_byte(val_enc, streams) for _ in range(ln))
    if codec == E_EXTERNAL:
        if n is None:
            raise ValueError("EXTERNAL byte array needs explicit length")
        return streams.ext_take(params, n)
    raise ValueError("cannot decode byte array with codec %d" % codec)


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

DATA_SERIES = [
    "BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
    "NF", "TL", "FN", "FC", "FP", "DL", "BB", "QQ", "BS", "IN", "SC",
    "HC", "PD", "RS", "BA", "QS", "MQ", "TC", "TN", "TM", "TV",
]


class CompressionHeader:
    def __init__(self):
        self.rn_preserved = True
        self.ap_delta = True
        self.rr = True
        self.sub_matrix = bytes([0x1B] * 5)
        self.td = []  # list of tag-line tuples: ((tag, type), ...)
        self.series = {}  # "BF" → encoding
        self.tags = {}  # (tag, type) → encoding

    # ---- decode -----------------------------------------------------------

    @classmethod
    def parse(cls, raw):
        self = cls()
        pos = 0
        # preservation map
        _size, pos = itf8_get(raw, pos)
        n, pos = itf8_get(raw, pos)
        for _ in range(n):
            key = raw[pos : pos + 2].decode()
            pos += 2
            if key == "RN":
                self.rn_preserved = bool(raw[pos]); pos += 1
            elif key == "AP":
                self.ap_delta = bool(raw[pos]); pos += 1
            elif key == "RR":
                self.rr = bool(raw[pos]); pos += 1
            elif key == "SM":
                self.sub_matrix = bytes(raw[pos : pos + 5]); pos += 5
            elif key == "TD":
                ln, pos = itf8_get(raw, pos)
                blob = bytes(raw[pos : pos + ln]); pos += ln
                self.td = _parse_td(blob)
            else:
                raise ValueError("unknown preservation key %s" % key)
        # data series encodings
        _size, pos = itf8_get(raw, pos)
        n, pos = itf8_get(raw, pos)
        for _ in range(n):
            key = raw[pos : pos + 2].decode()
            pos += 2
            enc, pos = parse_encoding(raw, pos)
            self.series[key] = enc
        # tag encodings
        _size, pos = itf8_get(raw, pos)
        n, pos = itf8_get(raw, pos)
        for _ in range(n):
            keyint, pos = itf8_get(raw, pos)
            tag = chr((keyint >> 16) & 0xFF) + chr((keyint >> 8) & 0xFF)
            typ = chr(keyint & 0xFF)
            enc, pos = parse_encoding(raw, pos)
            self.tags[(tag, typ)] = enc
        return self

    # ---- encode -----------------------------------------------------------

    def serialize(self) -> bytes:
        pres = bytearray()
        entries = 0
        for key, val in (("RN", self.rn_preserved), ("AP", self.ap_delta),
                         ("RR", self.rr)):
            pres += key.encode()
            pres.append(1 if val else 0)
            entries += 1
        pres += b"SM" + self.sub_matrix
        entries += 1
        td_blob = _serialize_td(self.td)
        pres += b"TD" + itf8_put(len(td_blob)) + td_blob
        entries += 1
        pres_map = itf8_put(entries) + bytes(pres)

        dse = bytearray()
        for key, enc in self.series.items():
            dse += key.encode()
            dse += _serialize_encoding(enc)
        dse_map = itf8_put(len(self.series)) + bytes(dse)

        tge = bytearray()
        for (tag, typ), enc in self.tags.items():
            keyint = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
            tge += itf8_put(keyint)
            tge += _serialize_encoding(enc)
        tge_map = itf8_put(len(self.tags)) + bytes(tge)

        out = bytearray()
        for m in (pres_map, dse_map, tge_map):
            out += itf8_put(len(m))
            out += m
        return bytes(out)


def _parse_td(blob):
    """TD dictionary: NUL-terminated lines of 3-byte (tag,tag,type)."""
    chunks = blob.split(b"\x00")
    if chunks and chunks[-1] == b"":
        chunks = chunks[:-1]
    lines = []
    for chunk in chunks:
        line = []
        for i in range(0, len(chunk), 3):
            t = chunk[i : i + 3]
            line.append((t[:2].decode(), chr(t[2])))
        lines.append(tuple(line))
    if not lines:
        lines = [()]
    return lines


def _serialize_td(td):
    out = bytearray()
    for line in td:
        for tag, typ in line:
            out += tag.encode() + typ.encode()
        out.append(0)
    return bytes(out)


def _serialize_encoding(enc) -> bytes:
    codec, params = enc
    if codec == E_NULL:
        sub = b""
    elif codec == E_EXTERNAL:
        sub = itf8_put(params)
    elif codec == E_HUFFMAN:
        kind = params[0]
        if kind == "const":
            sub = _write_itf8_array([params[1]]) + _write_itf8_array([0])
        else:
            raise NotImplementedError("only constant huffman on write")
    elif codec == E_BYTE_ARRAY_LEN:
        sub = _serialize_encoding(params[0]) + _serialize_encoding(params[1])
    elif codec == E_BYTE_ARRAY_STOP:
        stop, cid = params
        sub = bytes([stop]) + itf8_put(cid)
    elif codec == E_BETA:
        offset, nbits = params
        sub = itf8_put(offset) + itf8_put(nbits)
    elif codec == E_GAMMA:
        sub = itf8_put(params)
    else:
        raise NotImplementedError("serialize codec %d" % codec)
    return itf8_put(codec) + itf8_put(len(sub)) + sub


# ---------------------------------------------------------------------------
# slice header
# ---------------------------------------------------------------------------

class SliceHeader:
    __slots__ = ("ref_id", "start", "span", "n_records", "record_counter",
                 "n_blocks", "content_ids", "embedded_ref_id", "ref_md5")

    def __init__(self, ref_id, start, span, n_records, record_counter,
                 n_blocks, content_ids, embedded_ref_id=-1,
                 ref_md5=b"\x00" * 16):
        self.ref_id = ref_id
        self.start = start
        self.span = span
        self.n_records = n_records
        self.record_counter = record_counter
        self.n_blocks = n_blocks
        self.content_ids = content_ids
        self.embedded_ref_id = embedded_ref_id
        self.ref_md5 = ref_md5

    def serialize(self) -> bytes:
        out = bytearray()
        out += itf8_put(self.ref_id)
        out += itf8_put(self.start)
        out += itf8_put(self.span)
        out += itf8_put(self.n_records)
        out += ltf8_put(self.record_counter)
        out += itf8_put(self.n_blocks)
        out += _write_itf8_array(self.content_ids)
        out += itf8_put(self.embedded_ref_id)
        out += self.ref_md5
        return bytes(out)

    @classmethod
    def parse(cls, raw):
        pos = 0
        ref_id, pos = itf8_get(raw, pos)
        start, pos = itf8_get(raw, pos)
        span, pos = itf8_get(raw, pos)
        n_records, pos = itf8_get(raw, pos)
        record_counter, pos = ltf8_get(raw, pos)
        n_blocks, pos = itf8_get(raw, pos)
        content_ids, pos = _read_itf8_array(raw, pos)
        embedded_ref_id, pos = itf8_get(raw, pos)
        ref_md5 = bytes(raw[pos : pos + 16])
        return cls(ref_id, start, span, n_records, record_counter, n_blocks,
                   content_ids, embedded_ref_id, ref_md5)


# ---------------------------------------------------------------------------
# record decode
# ---------------------------------------------------------------------------

def _decode_tag_value(typ, blob):
    """BAM-format tag value blob (without tag/type prefix) → python value."""
    if typ == "A":
        return chr(blob[0])
    if typ == "c":
        return struct.unpack("<b", blob)[0]
    if typ == "C":
        return blob[0]
    if typ == "s":
        return struct.unpack("<h", blob)[0]
    if typ == "S":
        return struct.unpack("<H", blob)[0]
    if typ == "i":
        return struct.unpack("<i", blob)[0]
    if typ == "I":
        return struct.unpack("<I", blob)[0]
    if typ == "f":
        return struct.unpack("<f", blob)[0]
    if typ in "ZH":
        return blob.rstrip(b"\x00").decode()
    if typ == "B":
        sub = chr(blob[0])
        (cnt,) = struct.unpack_from("<I", blob, 1)
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H",
               "i": "i", "I": "I", "f": "f"}[sub]
        return list(struct.unpack_from("<%d%s" % (cnt, fmt), blob, 5))
    raise ValueError("unknown tag type %r" % typ)


def _encode_tag_value(val):
    """python value → (type char, BAM value blob). Type choices mirror
    io/bam._encode_tag so BAM and CRAM round-trips agree field-for-field."""
    if isinstance(val, bool):
        val = int(val)
    if isinstance(val, (int, np.integer)):
        v = int(val)
        if -128 <= v < 128:
            return "c", struct.pack("<b", v)
        if -32768 <= v < 32768:
            return "s", struct.pack("<h", v)
        return "i", struct.pack("<i", v)
    if isinstance(val, float):
        return "f", struct.pack("<f", val)
    if isinstance(val, str):
        return "Z", val.encode() + b"\x00"
    if isinstance(val, (list, tuple)):
        arr = np.asarray(val)
        if arr.dtype.kind == "f":
            sub, fmt = "f", "f"
            arr = arr.astype("<f4")
        else:
            sub, fmt = "i", "i"
            arr = arr.astype("<i4")
        return "B", sub.encode() + struct.pack("<I", len(val)) + arr.tobytes()
    raise TypeError("unsupported tag value %r" % (val,))


def _sub_base(sub_matrix, ref_base, code):
    """Substitution matrix lookup: (ref base, 2-bit code) → read base."""
    r = ref_base if ref_base in BASES5 else "N"
    row = sub_matrix["ACGTN".index(r)]
    for i, b in enumerate(a for a in BASES5 if a != r):
        if ((row >> (6 - 2 * i)) & 3) == code:
            return b
    return "N"


def _sub_code(sub_matrix, ref_base, read_base):
    """Inverse lookup; None when read_base can't be expressed (→ 'B')."""
    r = ref_base if ref_base in BASES5 else "N"
    row = sub_matrix["ACGTN".index(r)]
    for i, b in enumerate(a for a in BASES5 if a != r):
        if b == read_base:
            return (row >> (6 - 2 * i)) & 3
    return None


def _push_op(cigar, op, ln):
    if ln <= 0:
        return
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + ln)
    else:
        cigar.append((op, ln))


def _reconstruct_read(ap0, rl, features, refseg, ref_off0, sub_matrix,
                      quals):
    """Features + reference segment → (seq str, cigar list).

    ap0: 0-based alignment start; refseg covers reference positions
    [ref_off0, ref_off0+len) as an uppercase str. quals: bytearray(rl)
    mutated in place by Q/q features.
    """
    seq = bytearray(rl)
    cigar = []
    qpos = 0
    rpos = ap0

    def copy_ref(n):
        nonlocal qpos, rpos
        if n <= 0:
            return
        a = rpos - ref_off0
        seg = refseg[a : a + n]
        seq[qpos : qpos + n] = seg.encode()
        _push_op(cigar, 0, n)
        qpos += n
        rpos += n

    for code, fpos1, payload in features:
        copy_ref(fpos1 - 1 - qpos)
        if code == "X":
            rb = refseg[rpos - ref_off0]
            seq[qpos] = ord(_sub_base(sub_matrix, rb.upper(), payload))
            _push_op(cigar, 0, 1)
            qpos += 1
            rpos += 1
        elif code == "B":
            base, q = payload
            seq[qpos] = base
            quals[qpos] = q
            _push_op(cigar, 0, 1)
            qpos += 1
            rpos += 1
        elif code == "I":
            seq[qpos : qpos + len(payload)] = payload
            _push_op(cigar, 1, len(payload))
            qpos += len(payload)
        elif code == "i":
            seq[qpos] = payload
            _push_op(cigar, 1, 1)
            qpos += 1
        elif code == "S":
            seq[qpos : qpos + len(payload)] = payload
            _push_op(cigar, 4, len(payload))
            qpos += len(payload)
        elif code == "D":
            _push_op(cigar, 2, payload)
            rpos += payload
        elif code == "N":
            _push_op(cigar, 3, payload)
            rpos += payload
        elif code == "H":
            _push_op(cigar, 5, payload)
        elif code == "P":
            _push_op(cigar, 6, payload)
        elif code == "Q":
            quals[fpos1 - 1] = payload
        elif code == "b":
            seq[qpos : qpos + len(payload)] = payload
            _push_op(cigar, 0, len(payload))
            qpos += len(payload)
            rpos += len(payload)
        elif code == "q":
            quals[fpos1 - 1 : fpos1 - 1 + len(payload)] = payload
        else:
            raise ValueError("unknown CRAM feature code %r" % code)
    copy_ref(rl - qpos)
    return seq.decode(), cigar


def _ref_span_of_features(rl, features):
    """Reference bases consumed by a record, derived from its features."""
    span = rl
    for code, _fpos, payload in features:
        if code in ("I", "S", "b"):
            span -= len(payload)
        elif code == "i":
            span -= 1
        elif code in ("D", "N"):
            span += payload
    return span


def _decode_feature(comp, streams):
    fc = chr(decode_byte(comp.series["FC"], streams))
    fp = decode_int(comp.series["FP"], streams)
    if fc == "X":
        payload = decode_byte(comp.series["BS"], streams)
    elif fc == "B":
        payload = (decode_byte(comp.series["BA"], streams),
                   decode_byte(comp.series["QS"], streams))
    elif fc == "I":
        payload = decode_bytes(comp.series["IN"], streams)
    elif fc == "i":
        payload = decode_byte(comp.series["BA"], streams)
    elif fc == "S":
        payload = decode_bytes(comp.series["SC"], streams)
    elif fc == "D":
        payload = decode_int(comp.series["DL"], streams)
    elif fc == "N":
        payload = decode_int(comp.series["RS"], streams)
    elif fc == "H":
        payload = decode_int(comp.series["HC"], streams)
    elif fc == "P":
        payload = decode_int(comp.series["PD"], streams)
    elif fc == "Q":
        payload = decode_byte(comp.series["QS"], streams)
    elif fc == "b":
        payload = decode_bytes(comp.series["BB"], streams)
    elif fc == "q":
        payload = decode_bytes(comp.series["QQ"], streams)
    else:
        raise ValueError("unknown CRAM feature code %r" % fc)
    return fc, fp, payload


def decode_slice_records(comp: CompressionHeader, sh: SliceHeader,
                         streams: _Streams, ref_lookup, embedded_ref=None):
    """Decode all records of one slice → list of AlignedRead.

    ref_lookup(ref_id, start0, end0) → uppercase reference bases; may be
    None only when every record is unmapped or an embedded reference
    block is present.
    """
    reads = []
    last_ap = sh.start
    counter = sh.record_counter
    ref_cache = {}

    def get_ref(ref_id, start0, end0):
        if embedded_ref is not None and ref_id == sh.ref_id:
            off0 = sh.start - 1
            return embedded_ref[start0 - off0 : end0 - off0].upper(), start0
        cached = ref_cache.get(ref_id)
        if cached is None or cached[1] > start0 or cached[2] < end0:
            lo = min(start0, max(0, sh.start - 1))
            hi = max(end0, sh.start - 1 + max(sh.span, 0))
            ref_cache[ref_id] = (ref_lookup(ref_id, lo, hi).upper(), lo, hi)
            cached = ref_cache[ref_id]
        seg, lo, _hi = cached
        return seg, lo

    for _ in range(sh.n_records):
        bf = decode_int(comp.series["BF"], streams)
        cf = decode_int(comp.series["CF"], streams)
        if sh.ref_id == -2:
            ref_id = decode_int(comp.series["RI"], streams)
        else:
            ref_id = sh.ref_id
        rl = decode_int(comp.series["RL"], streams)
        if comp.ap_delta:
            last_ap += decode_int(comp.series["AP"], streams)
            ap = last_ap
        else:
            ap = decode_int(comp.series["AP"], streams)
        _rg = decode_int(comp.series["RG"], streams)
        rn = None
        if comp.rn_preserved:
            rn = decode_bytes(comp.series["RN"], streams).decode()
        mate_bits = 0
        if cf & CF_DETACHED:
            mf = decode_int(comp.series["MF"], streams)
            if not comp.rn_preserved:
                rn = decode_bytes(comp.series["RN"], streams).decode()
            _ns = decode_int(comp.series["NS"], streams)
            _np = decode_int(comp.series["NP"], streams)
            _ts = decode_int(comp.series["TS"], streams)
            if mf & MF_MATE_REVERSE:
                mate_bits |= 0x20
            if mf & MF_MATE_UNMAPPED:
                mate_bits |= 0x8
        elif cf & CF_MATE_DOWNSTREAM:
            decode_int(comp.series["NF"], streams)
        tl = decode_int(comp.series["TL"], streams)
        tags = {}
        for tag, typ in comp.td[tl]:
            blob = decode_bytes(comp.tags[(tag, typ)], streams)
            tags[tag] = _decode_tag_value(typ, blob)
        if rn is None:
            rn = "nc.%d" % counter
        counter += 1
        flags = bf | mate_bits

        if not (bf & 0x4):
            fn = decode_int(comp.series["FN"], streams)
            features = []
            fpos = 0
            for _f in range(fn):
                fc, fp, payload = _decode_feature(comp, streams)
                fpos += fp
                features.append((fc, fpos, payload))
            mq = decode_int(comp.series["MQ"], streams)
            quals = bytearray(rl)
            if cf & CF_QUAL_STORED:
                qenc = comp.series["QS"]
                if qenc[0] == E_EXTERNAL:
                    quals[:] = streams.ext_take(qenc[1], rl)
                else:
                    for qi in range(rl):
                        quals[qi] = decode_byte(qenc, streams)
            ap0 = ap - 1
            if cf & CF_NO_SEQ:
                seq = "N" * rl
                cigar = [(0, rl)]
            else:
                span = _ref_span_of_features(rl, features)
                refseg, off0 = get_ref(ref_id, ap0, ap0 + span)
                seq, cigar = _reconstruct_read(
                    ap0, rl, features, refseg, off0, comp.sub_matrix, quals)
            read = AlignedRead(rn, flags, ref_id, ap0, mq, cigar, seq,
                               np.frombuffer(bytes(quals), np.uint8).copy(),
                               tags)
        else:
            benc = comp.series["BA"]
            if benc[0] == E_EXTERNAL and rl and not (cf & CF_NO_SEQ):
                seq = streams.ext_take(benc[1], rl).decode()
            elif cf & CF_NO_SEQ:
                seq = "N" * rl
            else:
                seq = "".join(chr(decode_byte(benc, streams))
                              for _ in range(rl))
            quals = bytearray(rl)
            if cf & CF_QUAL_STORED:
                qenc = comp.series["QS"]
                if qenc[0] == E_EXTERNAL:
                    quals[:] = streams.ext_take(qenc[1], rl)
                else:
                    for qi in range(rl):
                        quals[qi] = decode_byte(qenc, streams)
            read = AlignedRead(rn, flags, ref_id, ap - 1, 0, [], seq,
                               np.frombuffer(bytes(quals), np.uint8).copy(),
                               tags)
        reads.append(read)
    return reads


# ---------------------------------------------------------------------------
# .crai index (gzipped text: ref, start, span, container off, slice off, len)
# ---------------------------------------------------------------------------

def read_crai(path):
    entries = []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            f = line.split("\t")
            entries.append((int(f[0]), int(f[1]), int(f[2]), int(f[3]),
                            int(f[4]), int(f[5])))
    return entries


def write_crai(path, entries):
    with gzip.open(path, "wt") as fh:
        for e in entries:
            fh.write("%d\t%d\t%d\t%d\t%d\t%d\n" % tuple(e))


_EOF_START = 4542278  # htslib's sentinel alignment start ("EOF")


def _eof_container() -> bytes:
    blk = Block(CT_COMPRESSION_HEADER, 0, bytes([1, 0, 1, 0, 1, 0]))
    payload = blk.serialize()
    hdr = ContainerHeader(len(payload), -1, _EOF_START, 0, 0, 0, 0, 1, [])
    return hdr.serialize() + payload


def _is_eof_container(ch: ContainerHeader) -> bool:
    return ch.ref_id == -1 and ch.n_records == 0 and ch.start == _EOF_START


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class CramReader:
    """Region-fetch reader over a CRAM 3.x file; BamReader-compatible.

    ``fasta`` (path or io.fasta.FastaFile) supplies the reference for
    sequence reconstruction; only slices with embedded reference blocks
    or unmapped records decode without it.
    """

    def __init__(self, path, fasta=None, index_path=None):
        self.path = path
        self._fh = open(path, "rb")
        magic = self._fh.read(4)
        if magic != CRAM_MAGIC:
            raise ValueError("not a CRAM file: %s" % path)
        self.version = (self._fh.read(1)[0], self._fh.read(1)[0])
        if self.version[0] not in (2, 3):
            raise ValueError("unsupported CRAM version %d.%d" % self.version)
        self.file_id = self._fh.read(20)
        try:
            ch = ContainerHeader.parse(self._fh)
            if ch is None:
                raise ValueError("missing header container")
            data = self._read_container_body(ch)
            blk, _ = Block.parse(data, 0)
            if blk.content_type != CT_FILE_HEADER:
                raise ValueError("first block is not a SAM-header block")
            (l_text,) = struct.unpack_from("<i", blk.data, 0)
        except (ValueError, IndexError, struct.error) as e:
            raise ValueError(
                "corrupt or truncated CRAM header in %s: %s" % (path, e))
        self.header_text = blk.data[4 : 4 + l_text].decode(errors="replace")
        self.references = []
        self.lengths = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                              if ":" in f)
                self.references.append(fields["SN"])
                self.lengths.append(int(fields.get("LN", 0)))
        self._ref_to_id = {n: i for i, n in enumerate(self.references)}
        self._data_start = self._fh.tell()
        if fasta is None:
            self._fasta = None
        elif isinstance(fasta, (str, os.PathLike)):
            from .fasta import FastaFile
            self._fasta = FastaFile(fasta)
        else:
            self._fasta = fasta
        self._index = None
        idx = index_path or path + ".crai"
        if os.path.exists(idx):
            self._index = read_crai(idx)

    # BamReader-compatible helpers
    def is_valid_reference_name(self, name):
        return name in self._ref_to_id

    def get_reference_length(self, name):
        return self.lengths[self._ref_to_id[name]]

    @property
    def format(self):
        return "CRAM"

    def _ref_lookup(self, ref_id, lo, hi):
        if self._fasta is None:
            raise ValueError(
                "CRAM decode requires the reference FASTA (pass fasta=...)")
        name = self.references[ref_id]
        lo = max(0, lo)
        return self._fasta.fetch(name, lo, hi)

    def _read_container_body(self, ch):
        data = self._fh.read(ch.length)
        if len(data) < ch.length:
            raise ValueError(
                "truncated CRAM container in %s (wanted %d bytes, got %d)"
                % (self.path, ch.length, len(data)))
        return data

    def _container_offsets_for(self, rid, start, end):
        """Byte offsets of containers that may hold overlapping reads."""
        offs = []
        seen = set()
        for e in self._index:
            e_rid, e_start, e_span, c_off = e[0], e[1], e[2], e[3]
            if e_rid == rid and e_start - 1 < end and \
                    e_start - 1 + e_span > start and c_off not in seen:
                seen.add(c_off)
                offs.append(c_off)
        offs.sort()
        return offs

    def _decode_container(self, ch, data):
        comp_blk, _ = Block.parse(data, 0)
        comp = CompressionHeader.parse(comp_blk.data)
        reads = []
        for lm in ch.landmarks:
            sh_blk, p = Block.parse(data, lm)
            sh = SliceHeader.parse(sh_blk.data)
            ext = {}
            core = None
            for _ in range(sh.n_blocks):
                blk, p = Block.parse(data, p)
                if blk.content_type == CT_CORE:
                    core = blk.data
                else:
                    ext[blk.content_id] = blk.data
            embedded = None
            if sh.embedded_ref_id >= 0:
                embedded = ext[sh.embedded_ref_id].decode()
            streams = _Streams(ext, core)
            reads.extend(decode_slice_records(
                comp, sh, streams, self._ref_lookup, embedded))
        return reads

    def _iter_containers(self, rid=None, start=None, end=None):
        """Yield (header, data) for containers overlapping the region
        (or all containers when rid is None). Non-overlapping containers
        are skipped without decompression."""
        if rid is not None and self._index is not None:
            for off in self._container_offsets_for(rid, start, end):
                self._fh.seek(off)
                ch = ContainerHeader.parse(self._fh)
                if ch is None or _is_eof_container(ch):
                    continue
                yield ch, self._read_container_body(ch)
            return
        self._fh.seek(self._data_start)
        while True:
            ch = ContainerHeader.parse(self._fh)
            if ch is None or _is_eof_container(ch):
                return
            overlaps = True
            if rid is not None and ch.ref_id != -2:
                overlaps = (ch.ref_id == rid and ch.start - 1 < end
                            and ch.start - 1 + ch.span > start)
            if overlaps:
                yield ch, self._read_container_body(ch)
            else:
                self._fh.seek(ch.length, os.SEEK_CUR)

    def __iter__(self):
        for ch, data in self._iter_containers():
            for read in self._decode_container(ch, data):
                yield read

    def fetch(self, contig, start=0, end=None, flag_exclude=0):
        """Yield mapped reads overlapping [start, end) (0-based half-open)."""
        if contig not in self._ref_to_id:
            return
        rid = self._ref_to_id[contig]
        if end is None:
            end = self.lengths[rid]
        start = max(0, start)
        from .bam import FUNMAP
        for ch, data in self._iter_containers(rid, start, end):
            for read in self._decode_container(ch, data):
                if read.ref_id != rid:
                    continue
                if read.flag & (FUNMAP | flag_exclude):
                    continue
                if read.pos >= end or read.reference_end <= start:
                    continue
                yield read

    def close(self):
        self._fh.close()
        if self._fasta is not None:
            self._fasta.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

# fixed external content-id assignment for the data series we emit
_CID = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "MF": 7,
    "NS": 8, "NP": 9, "TS": 10, "NF": 11, "TL": 12, "FN": 13, "FC": 14,
    "FP": 15, "DL": 16, "BA": 17, "QS": 18, "BS": 19, "IN": 20, "SC": 21,
    "HC": 22, "PD": 23, "RS": 24, "MQ": 25, "RN": 26,
}
_STOP_RN = 0x09  # '\t' cannot occur in read names
_STOP_SEQ = 0x00


def _writer_series_encodings():
    enc = {}
    for key, cid in _CID.items():
        if key == "RN":
            enc[key] = (E_BYTE_ARRAY_STOP, (_STOP_RN, cid))
        elif key in ("IN", "SC"):
            enc[key] = (E_BYTE_ARRAY_STOP, (_STOP_SEQ, cid))
        else:
            enc[key] = (E_EXTERNAL, cid)
    return enc


class _OutStreams:
    def __init__(self):
        self.ext = {}

    def buf(self, cid):
        b = self.ext.get(cid)
        if b is None:
            b = self.ext[cid] = bytearray()
        return b

    def put_itf8(self, cid, v):
        b = self.buf(cid)
        b += itf8_put(v)

    def put_byte(self, cid, v):
        self.buf(cid).append(v)

    def put_bytes(self, cid, blob):
        b = self.buf(cid)
        b += blob

    def put_stopped(self, cid, blob, stop):
        b = self.buf(cid)
        b += blob
        b.append(stop)


def _features_from_read(read: AlignedRead, refseg: str, ref_off0: int,
                        sub_matrix: bytes):
    """Express a mapped read as CRAM features vs. the reference segment.

    Returns (features, n_bases) where features are (code, fpos1, payload)
    with 1-based query positions, matching decode_slice_records.
    """
    feats = []
    qpos = 0
    rpos = read.pos
    seq = read.seq
    qual = read.qual
    for op, ln in read.cigar:
        if op in (0, 7, 8):  # M/=/X
            ref_chunk = refseg[rpos - ref_off0 : rpos - ref_off0 + ln].upper()
            if len(ref_chunk) < ln:
                ref_chunk = ref_chunk + "N" * (ln - len(ref_chunk))
            q_chunk = seq[qpos : qpos + ln].upper()
            # vectorized mismatch scan; only differing positions loop
            ra = np.frombuffer(ref_chunk.encode(), np.uint8)
            qa = np.frombuffer(q_chunk.encode(), np.uint8)
            for k in np.nonzero(ra != qa)[0]:
                k = int(k)
                rb = ref_chunk[k]
                qb = q_chunk[k]
                code = _sub_code(sub_matrix, rb, qb)
                if code is not None and rb in BASES5:
                    feats.append(("X", qpos + k + 1, code))
                else:
                    qv = int(qual[qpos + k]) if qual is not None else 0xFF
                    feats.append(("B", qpos + k + 1,
                                  (ord(seq[qpos + k]), qv)))
            qpos += ln
            rpos += ln
        elif op == 1:  # I
            if ln == 1:
                feats.append(("i", qpos + 1, ord(seq[qpos])))
            else:
                feats.append(("I", qpos + 1,
                              seq[qpos : qpos + ln].encode()))
            qpos += ln
        elif op == 2:  # D
            feats.append(("D", qpos + 1, ln))
            rpos += ln
        elif op == 3:  # N
            feats.append(("N", qpos + 1, ln))
            rpos += ln
        elif op == 4:  # S
            feats.append(("S", qpos + 1, seq[qpos : qpos + ln].encode()))
            qpos += ln
        elif op == 5:  # H
            feats.append(("H", qpos + 1, ln))
        elif op == 6:  # P
            feats.append(("P", qpos + 1, ln))
        else:
            raise ValueError("unsupported CIGAR op %d for CRAM write" % op)
    return feats


class CramWriter:
    """Write a coordinate-sorted CRAM 3.0 + .crai index.

    Same call surface as io.bam.BamWriter plus a required reference
    (``fasta``: path or FastaFile) for reference-based sequence coding —
    the haplotagged-CRAM output artifact of the reference pipeline
    (indelCaller.py:248-251) is produced through this class.
    """

    MAJOR, MINOR = 3, 0

    def __init__(self, path, references, lengths, fasta, header_text=None,
                 write_index=True, compression="gzip",
                 records_per_slice=10000):
        self.path = path
        self.references = list(references)
        self.lengths = list(lengths)
        self._ref_to_id = {n: i for i, n in enumerate(references)}
        if isinstance(fasta, (str, os.PathLike)):
            from .fasta import FastaFile
            self._fasta = FastaFile(fasta)
            self._owns_fasta = True
        else:
            self._fasta = fasta
            self._owns_fasta = False
        self._method = {"raw": M_RAW, "gzip": M_GZIP,
                        "rans": M_RANS}[compression]
        self._rps = records_per_slice
        self._write_index = write_index
        self._crai = []
        self._buf = []
        self._record_counter = 0
        self._fh = open(path, "wb")
        self._fh.write(CRAM_MAGIC)
        self._fh.write(bytes([self.MAJOR, self.MINOR]))
        file_id = os.path.basename(path).encode()[:20]
        self._fh.write(file_id.ljust(20, b"\x00"))
        if header_text is None:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                "@SQ\tSN:%s\tLN:%d\n" % (n, l)
                for n, l in zip(references, lengths))
        text = header_text.encode()
        blk = Block(CT_FILE_HEADER, 0,
                    struct.pack("<i", len(text)) + text, M_GZIP)
        payload = blk.serialize()
        hdr = ContainerHeader(len(payload), 0, 0, 0, 0, 0, 0, 1, [0])
        self._fh.write(hdr.serialize())
        self._fh.write(payload)

    def write(self, read: AlignedRead):
        rid = (read.ref_id if isinstance(read.ref_id, int)
               else self._ref_to_id[read.ref_id])
        if self._buf and (self._buf_rid != rid or len(self._buf) >= self._rps):
            self._flush_slice()
        if not self._buf:
            self._buf_rid = rid
        self._buf.append(read)

    # ---- slice/container assembly -----------------------------------------

    def _flush_slice(self):
        reads = self._buf
        self._buf = []
        rid = self._buf_rid
        if not reads:
            return
        ref_name = self.references[rid]
        slice_start0 = min(r.pos for r in reads)
        slice_end0 = max(max(r.reference_end, r.pos + 1) for r in reads)
        refseg = self._fasta.fetch(ref_name, slice_start0, slice_end0).upper()
        sub_matrix = bytes([0x1B] * 5)

        comp = CompressionHeader()
        comp.rn_preserved = True
        comp.ap_delta = True
        comp.rr = True
        comp.sub_matrix = sub_matrix
        comp.series = _writer_series_encodings()

        # pre-pass: tag lines + encodings
        td_index = {}
        td_lines = []
        read_tl = []
        read_tagblobs = []
        for r in reads:
            line = []
            blobs = []
            for tag, val in (r.tags or {}).items():
                typ, blob = _encode_tag_value(val)
                line.append((tag, typ))
                blobs.append(blob)
            key = tuple(line)
            if key not in td_index:
                td_index[key] = len(td_lines)
                td_lines.append(key)
            read_tl.append(td_index[key])
            read_tagblobs.append(blobs)
        comp.td = td_lines if td_lines else [()]
        for line in td_lines:
            for tag, typ in line:
                if (tag, typ) not in comp.tags:
                    cid = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                    comp.tags[(tag, typ)] = (
                        E_BYTE_ARRAY_LEN,
                        ((E_EXTERNAL, cid), (E_EXTERNAL, cid)))

        out = _OutStreams()
        last_ap = slice_start0 + 1
        n_bases = 0
        for i, r in enumerate(reads):
            n_bases += len(r.seq)
            mapped = not (r.flag & 0x4)
            bf = r.flag & ~0x28  # mate bits live in MF
            mf = ((1 if r.flag & 0x20 else 0)
                  | (2 if r.flag & 0x8 else 0))
            cf = CF_QUAL_STORED | CF_DETACHED
            out.put_itf8(_CID["BF"], bf)
            out.put_itf8(_CID["CF"], cf)
            rl = len(r.seq)
            out.put_itf8(_CID["RL"], rl)
            ap = r.pos + 1
            out.put_itf8(_CID["AP"], ap - last_ap)
            last_ap = ap
            out.put_itf8(_CID["RG"], -1)
            out.put_stopped(_CID["RN"], r.qname.encode(), _STOP_RN)
            # detached mate block (we do not thread mate records)
            out.put_itf8(_CID["MF"], mf)
            out.put_itf8(_CID["NS"], -1)
            out.put_itf8(_CID["NP"], 0)
            out.put_itf8(_CID["TS"], 0)
            out.put_itf8(_CID["TL"], read_tl[i])
            for (tag, typ), blob in zip(
                    (td_lines[read_tl[i]] if td_lines else ()),
                    read_tagblobs[i]):
                cid = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                out.put_itf8(cid, len(blob))
                out.put_bytes(cid, blob)
            if mapped:
                feats = _features_from_read(r, refseg, slice_start0,
                                            sub_matrix)
                out.put_itf8(_CID["FN"], len(feats))
                prev = 0
                for code, fpos1, payload in feats:
                    out.put_byte(_CID["FC"], ord(code))
                    out.put_itf8(_CID["FP"], fpos1 - prev)
                    prev = fpos1
                    if code == "X":
                        out.put_byte(_CID["BS"], payload)
                    elif code == "B":
                        out.put_byte(_CID["BA"], payload[0])
                        out.put_byte(_CID["QS"], payload[1])
                    elif code == "I":
                        out.put_stopped(_CID["IN"], payload, _STOP_SEQ)
                    elif code == "i":
                        out.put_byte(_CID["BA"], payload)
                    elif code == "S":
                        out.put_stopped(_CID["SC"], payload, _STOP_SEQ)
                    elif code == "D":
                        out.put_itf8(_CID["DL"], payload)
                    elif code == "N":
                        out.put_itf8(_CID["RS"], payload)
                    elif code == "H":
                        out.put_itf8(_CID["HC"], payload)
                    elif code == "P":
                        out.put_itf8(_CID["PD"], payload)
                out.put_itf8(_CID["MQ"], r.mapq)
            else:
                out.put_bytes(_CID["BA"], r.seq.encode())
            if r.qual is not None and len(r.qual) == rl:
                out.put_bytes(_CID["QS"],
                              np.asarray(r.qual, np.uint8).tobytes())
            else:
                out.put_bytes(_CID["QS"], b"\xff" * rl)

        # assemble blocks
        ext_blocks = [Block(CT_EXTERNAL, cid, bytes(data), self._method)
                      for cid, data in sorted(out.ext.items())]
        core_blk = Block(CT_CORE, 0, b"")
        span = slice_end0 - slice_start0
        md5 = hashlib.md5(refseg.encode()).digest()
        sh = SliceHeader(
            rid, slice_start0 + 1, span, len(reads), self._record_counter,
            1 + len(ext_blocks), [b.content_id for b in ext_blocks],
            -1, md5)
        self._record_counter += len(reads)

        comp_payload = Block(CT_COMPRESSION_HEADER, 0,
                             comp.serialize(), M_GZIP).serialize()
        slice_payload = Block(CT_SLICE_HEADER, 0, sh.serialize()).serialize()
        data_payload = core_blk.serialize() + b"".join(
            b.serialize() for b in ext_blocks)
        landmark = len(comp_payload)
        body = comp_payload + slice_payload + data_payload
        hdr = ContainerHeader(
            len(body), rid, slice_start0 + 1, span, len(reads),
            sh.record_counter, n_bases, 2 + len(ext_blocks), [landmark])
        container_off = self._fh.tell()
        self._fh.write(hdr.serialize())
        self._fh.write(body)
        self._crai.append((rid, slice_start0 + 1, span, container_off,
                           landmark, len(slice_payload) + len(data_payload)))

    def close(self):
        if self._buf:
            self._flush_slice()
        self._fh.write(_eof_container())
        self._fh.close()
        if self._write_index:
            write_crai(self.path + ".crai", self._crai)
        if self._owns_fasta and self._fasta is not None:
            self._fasta.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# native (C++) window decode: CRAM analog of io.native.decode_window_native
# ---------------------------------------------------------------------------

_SERIES_ENUM = {k: i for i, k in enumerate([
    "BF", "CF", "RI", "RL", "AP", "RG", "RN", "MF", "NS", "NP", "TS",
    "NF", "TL", "FN", "FC", "FP", "DL", "BB", "QQ", "BS", "IN", "SC",
    "HC", "PD", "RS", "BA", "QS", "MQ"])}


def _spec_encoding(enc) -> bytes:
    """Serialize an encoding for the C++ decoder (ncio_cram_feed spec
    grammar); raises ValueError on codecs it does not implement."""
    codec, params = enc
    out = bytearray([codec])
    if codec == E_NULL:
        pass
    elif codec == E_EXTERNAL:
        out += struct.pack("<i", params)
    elif codec == E_HUFFMAN:
        if params[0] == "const":
            out += struct.pack("<i", 1)
            out += struct.pack("<i", params[1])
            out += struct.pack("<i", 0)
        else:
            _, codes, _maxlen = params
            # codes: {(len, code): symbol}; rebuild alphabet/lens
            items = sorted(codes.items())
            out += struct.pack("<i", len(items))
            for (_ln, _code), sym in items:
                out += struct.pack("<i", sym)
            for (ln, _code), _sym in items:
                out += struct.pack("<i", ln)
    elif codec == E_BYTE_ARRAY_LEN:
        out += _spec_encoding(params[0])
        out += _spec_encoding(params[1])
    elif codec == E_BYTE_ARRAY_STOP:
        stop, cid = params
        out += bytes([stop]) + struct.pack("<i", cid)
    elif codec == E_BETA:
        out += struct.pack("<ii", params[0], params[1])
    elif codec == E_GAMMA:
        out += struct.pack("<i", params)
    else:
        raise ValueError("codec %d unsupported by native decoder" % codec)
    return bytes(out)


def _native_spec(comp: CompressionHeader):
    """CompressionHeader → native spec bytes, or None when it uses a
    layout the C++ decoder cannot handle (Python path takes over)."""
    try:
        out = bytearray()
        out.append(1 if comp.ap_delta else 0)
        out.append(1 if comp.rn_preserved else 0)
        out += comp.sub_matrix
        present = [(k, e) for k, e in comp.series.items()
                   if k in _SERIES_ENUM]
        out.append(len(present))
        for key, enc in present:
            out.append(_SERIES_ENUM[key])
            out += _spec_encoding(enc)
        out += struct.pack("<H", len(comp.td))
        for line in comp.td:
            out += struct.pack("<H", len(line))
            for tag, typ in line:
                out += tag.encode() + typ.encode()
                out += _spec_encoding(comp.tags[(tag, typ)])
        return bytes(out)
    except (ValueError, KeyError):
        return None


def _cram_decode_window(reader: "CramReader", contig, start, end,
                        flag_exclude, keep_seq=False, sites=None,
                        counts_only=False):
    """Native window decode over a CramReader → Window-dict (same layout
    as io.native.decode_window_native).

    counts_only: accumulate per-column counts + read metadata without
    materializing per-base event arrays (phase 1 of the two-phase SNP
    path; the caller re-decodes with `sites` once candidates are known).

    Raises ValueError where the C++ decoder refuses a container: a
    corrupt slice, or a layout it does not implement (a multi-reference
    slice, an encoding outside its set). The JAX package hands such a
    window to its Python decoder; the port runs that decoder only when
    asked (pileup.engine.decode_reads(use_native=False)).
    """
    from .native import (cram_window_begin, cram_window_feed,
                         cram_window_finish, cram_window_free)

    if reader._fasta is None:
        raise ValueError(
            "CRAM decode requires the reference FASTA (pass fasta=...)")
    rid = reader._ref_to_id.get(contig)
    n_sites = 0 if sites is None else len(sites)
    lib, handle = cram_window_begin(start, end, n_sites)
    if counts_only:
        lib.ncio_window_counts_only(handle)
    if rid is None:  # unknown contig: no reads, as fetch() gives
        return cram_window_finish(lib, handle, reader.path)
    try:
        for ch, data in reader._iter_containers(rid, start, end):
            comp_blk, _ = Block.parse(data, 0)
            comp = CompressionHeader.parse(comp_blk.data)
            spec = _native_spec(comp)
            if spec is None:
                raise ValueError(
                    "%s: a CRAM container uses an encoding the native "
                    "decoder does not implement" % reader.path)
            for lm in ch.landmarks:
                sh_blk, p = Block.parse(data, lm)
                sh = SliceHeader.parse(sh_blk.data)
                if sh.ref_id == -2:
                    raise ValueError(
                        "%s: multi-reference CRAM slices are not decoded "
                        "natively" % reader.path)
                ext = []
                core = b""
                for _ in range(sh.n_blocks):
                    blk, p = Block.parse(data, p)
                    if blk.content_type == CT_CORE:
                        core = blk.data
                    else:
                        ext.append((blk.content_id, blk.data))
                if sh.embedded_ref_id >= 0:
                    refseg = dict(ext)[sh.embedded_ref_id].decode().upper()
                    ref_off0 = sh.start - 1
                else:
                    ref_off0 = max(0, sh.start - 1)
                    refseg = reader._ref_lookup(
                        rid, ref_off0, sh.start - 1 + max(sh.span, 0)).upper()
                if not cram_window_feed(
                        lib, handle, spec, ext, core, refseg, ref_off0,
                        sh.ref_id, sh.start, sh.n_records,
                        sh.record_counter, rid, start, end, flag_exclude,
                        keep_seq, sites):
                    raise ValueError(
                        "%s: the native decoder refused a CRAM slice at "
                        "%s:%d (corrupt data or an unsupported layout)"
                        % (reader.path, contig, sh.start))
    except BaseException:
        cram_window_free(lib, handle)
        raise
    return cram_window_finish(lib, handle, reader.path)


# exposed on the reader so pileup/engine can dispatch uniformly
CramReader.decode_window = _cram_decode_window
