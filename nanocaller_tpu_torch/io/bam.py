"""BAM reader/writer with BAI indexing — in-repo htslib replacement.

Covers what the reference gets from pysam/samtools (SURVEY.md §2.3 N1/N4):
region fetch over indexed BAMs, full record decode (flags, CIGAR, SEQ,
tags incl. HP/PS), and BAM writing (for haplotagged output and test
fixtures). Binary layout per hts-specs SAMv1 §4; BAI per §5.2.

Pure-Python decode here is the correctness path; the batched hot-path
decode lives in ``nanocaller_tpu_torch/io/native`` (C++) with identical
semantics.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .bgzf import BGZF_EOF, BgzfReader, BgzfWriter

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
# char → 4-bit code for SEQ packing (unknown chars → N = 15)
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(SEQ_NT16):
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i
CIGAR_OPS = "MIDNSHP=X"
# op consumes (query, reference)
_OP_CONSUMES = {
    0: (1, 1),  # M
    1: (1, 0),  # I
    2: (0, 1),  # D
    3: (0, 1),  # N
    4: (1, 0),  # S
    5: (0, 0),  # H
    6: (0, 0),  # P
    7: (1, 1),  # =
    8: (1, 1),  # X
}

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# Default pileup exclusion mask (reference: generate_SNP_pileups.py:151-154)
DEFAULT_FLAG_FILTER = FUNMAP | FSECONDARY | FQCFAIL | FDUP | FSUPPLEMENTARY


class AlignedRead:
    """Decoded alignment record."""

    __slots__ = (
        "qname",
        "flag",
        "ref_id",
        "pos",
        "mapq",
        "cigar",
        "seq",
        "qual",
        "tags",
        "_ref_end",
    )

    def __init__(self, qname, flag, ref_id, pos, mapq, cigar, seq, qual, tags):
        self.qname = qname
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos  # 0-based leftmost
        self.mapq = mapq
        self.cigar = cigar  # list of (op, length)
        self.seq = seq
        self.qual = qual
        self.tags = tags
        self._ref_end = None

    @property
    def is_reverse(self):
        return bool(self.flag & FREVERSE)

    @property
    def is_unmapped(self):
        return bool(self.flag & FUNMAP)

    @property
    def reference_end(self):
        if self._ref_end is None:
            self._ref_end = self.pos + sum(
                l for op, l in self.cigar if _OP_CONSUMES[op][1]
            )
        return self._ref_end

    def has_tag(self, name):
        return name in self.tags

    def get_tag(self, name):
        return self.tags[name]


def _decode_record(data, refs):
    try:
        return _decode_record_inner(data, refs)
    except (struct.error, IndexError, KeyError, UnicodeDecodeError,
            ValueError) as e:
        raise ValueError("corrupt BAM record: %s" % e) from e


def _decode_record_inner(data, refs):
    (
        ref_id,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        _next_ref,
        _next_pos,
        _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    if l_seq < 0 or l_read_name == 0 or 32 + l_read_name + n_cigar * 4 \
            + (l_seq + 1) // 2 + l_seq > len(data):
        raise ValueError("field lengths exceed record size")
    off = 32
    qname = data[off : off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    q_len = 0
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, off)[0]
        if (v & 0xF) > 8:
            raise ValueError("invalid CIGAR op %d" % (v & 0xF))
        if (v & 0xF) in (0, 1, 4, 7, 8):
            q_len += v >> 4
        cigar.append((v & 0xF, v >> 4))
        off += 4
    # SEQ '*' (l_seq == 0) with a real CIGAR is spec-legal; a nonzero
    # l_seq shorter than the CIGAR's query consumption is corruption
    # (matches the C++ decoder's rule)
    if 0 < l_seq < q_len:
        raise ValueError("CIGAR exceeds sequence length")
    nbytes = (l_seq + 1) // 2
    packed = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=off)
    off += nbytes
    chars = np.empty(nbytes * 2, dtype=np.uint8)
    nt16 = np.frombuffer(SEQ_NT16.encode(), dtype=np.uint8)
    chars[0::2] = nt16[packed >> 4]
    chars[1::2] = nt16[packed & 0xF]
    seq = chars[:l_seq].tobytes().decode()
    qual = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=off).copy()
    off += l_seq
    tags = _decode_tags(data, off)
    return AlignedRead(qname, flag, ref_id, pos, mapq, cigar, seq, qual, tags)


def _decode_tags(data, off):
    tags = {}
    n = len(data)
    while off + 3 <= n:
        tag = data[off : off + 2].decode()
        typ = chr(data[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(data[off]); off += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", data, off)[0]; off += 1
        elif typ == "C":
            tags[tag] = data[off]; off += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", data, off)[0]; off += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", data, off)[0]; off += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", data, off)[0]; off += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", data, off)[0]; off += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", data, off)[0]; off += 4
        elif typ in "ZH":
            end = data.index(b"\x00", off)
            tags[tag] = data[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(data[off]); off += 1
            cnt = struct.unpack_from("<I", data, off)[0]; off += 4
            fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}[sub]
            vals = struct.unpack_from("<%d%s" % (cnt, fmt), data, off)
            off += cnt * struct.calcsize(fmt)
            tags[tag] = list(vals)
        else:
            break
    return tags


# ---------------------------------------------------------------------------
# BAI index (hts-specs SAMv1 §5.2): binning + 16kb linear index
# ---------------------------------------------------------------------------

def reg2bin(beg, end):
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg, end):
    """All bins overlapping [beg, end) for the 6-level BAI scheme."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("not a BAI index: %s" % path)
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioffsets = list(struct.unpack_from("<%dQ" % n_intv, data, off))
            off += 8 * n_intv
            self.refs.append((bins, ioffsets))

    def chunks_for_region(self, ref_idx, beg, end):
        if ref_idx >= len(self.refs):
            return []
        bins, ioffsets = self.refs[ref_idx]
        # pseudo-bin 37450 holds metadata, skip it
        min_off = 0
        lin_idx = beg >> 14
        if lin_idx < len(ioffsets):
            min_off = ioffsets[lin_idx]
        chunks = []
        for b in reg2bins(beg, end):
            if b == 37450:
                continue
            for cbeg, cend in bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        # merge adjacent/overlapping
        merged = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], c[1]))
            else:
                merged.append(c)
        return merged


def open_alignment(path, fasta=None, index_path=None):
    """Open a BAM or CRAM by magic bytes with one reader interface.

    Mirrors pysam.Samfile's transparent format dispatch (the reference
    opens either format through the same call,
    generate_SNP_pileups.py:134). CRAM decode needs the reference
    (``fasta``: path or io.fasta.FastaFile); it is ignored for BAM.
    """
    with open(path, "rb") as fh:
        head = fh.read(4)
    if head == b"CRAM":
        from .cram import CramReader

        return CramReader(path, fasta=fasta, index_path=index_path)
    return BamReader(path, index_path=index_path)


class BamReader:
    def __init__(self, path, index_path=None):
        self.path = path
        with open(path, "rb") as fh:
            head = fh.read(4)
        if head == b"CRAM":
            raise ValueError(
                "%s is a CRAM file — open it with io.bam.open_alignment() "
                "or io.cram.CramReader (needs the reference FASTA)" % path)
        # refuse truncated files up front: a BAM missing the BGZF EOF
        # marker would otherwise silently yield a partial pileup and
        # silently wrong calls (htslib warns here; we hard-fail)
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            tail = b""
            if size >= len(BGZF_EOF):
                fh.seek(size - len(BGZF_EOF))
                tail = fh.read(len(BGZF_EOF))
        if tail != BGZF_EOF:
            raise ValueError(
                "truncated or still-being-written BAM (missing BGZF EOF "
                "marker): %s" % path)
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file: %s" % path)
        (l_text,) = struct.unpack("<i", self._bgzf.read(4))
        self.header_text = self._bgzf.read(l_text).decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._bgzf.read(4))
        self.references = []
        self.lengths = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read(4))
            name = self._bgzf.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read(4))
            self.references.append(name)
            self.lengths.append(l_ref)
        self._ref_to_id = {n: i for i, n in enumerate(self.references)}
        self._data_start = self._bgzf.tell()
        self._index = None
        idx = index_path or path + ".bai"
        if os.path.exists(idx):
            self._index = BaiIndex(idx)

    # pysam-compatible helpers used by the region planner (utils.py:9-48)
    def is_valid_reference_name(self, name):
        return name in self._ref_to_id

    def get_reference_length(self, name):
        return self.lengths[self._ref_to_id[name]]

    @property
    def format(self):
        return "BAM"

    def _read_record(self):
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            return None
        (block_size,) = struct.unpack("<i", raw)
        if block_size <= 0 or block_size > (1 << 27):
            raise ValueError("corrupt BAM record size %d" % block_size)
        data = self._bgzf.read(block_size)
        if len(data) < block_size:
            return None
        return data

    def __iter__(self):
        self._bgzf.seek(self._data_start)
        while True:
            data = self._read_record()
            if data is None:
                return
            yield _decode_record(data, self.references)

    def fetch(self, contig, start=0, end=None, flag_exclude=0):
        """Yield mapped reads overlapping [start, end) (0-based half-open)."""
        if contig not in self._ref_to_id:
            return
        rid = self._ref_to_id[contig]
        if end is None:
            end = self.lengths[rid]
        start = max(0, start)
        if self._index is not None:
            chunk_list = self._index.chunks_for_region(rid, start, end)
        else:
            chunk_list = [(self._data_start, None)]
        for cbeg, cend in chunk_list:
            self._bgzf.seek(cbeg)
            while True:
                if cend is not None and self._bgzf.tell() >= cend:
                    break
                data = self._read_record()
                if data is None:
                    break
                r_ref, r_pos = struct.unpack_from("<ii", data, 0)
                if r_ref != rid:
                    if self._index is None and r_ref > rid:
                        return
                    if self._index is not None:
                        continue
                    continue
                if r_pos >= end:
                    if self._index is None or cend is None:
                        return
                    break
                rec = _decode_record(data, self.references)
                if rec.flag & (FUNMAP | flag_exclude):
                    continue
                if rec.reference_end <= start:
                    continue
                yield rec

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BamWriter:
    """Write a coordinate-sorted BAM + BAI index."""

    def __init__(self, path, references, lengths, header_text=None, write_index=True):
        self.path = path
        self.references = list(references)
        self.lengths = list(lengths)
        self._ref_to_id = {n: i for i, n in enumerate(references)}
        self._bgzf = BgzfWriter(path)
        self._write_index = write_index
        # per-ref: {bin: [(voff_beg, voff_end)]}, linear ioffsets
        self._bins = [dict() for _ in references]
        self._linear = [dict() for _ in references]
        if header_text is None:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                "@SQ\tSN:%s\tLN:%d\n" % (n, l) for n, l in zip(references, lengths)
            )
        text = header_text.encode()
        self._bgzf.write(b"BAM\x01")
        self._bgzf.write(struct.pack("<i", len(text)))
        self._bgzf.write(text)
        self._bgzf.write(struct.pack("<i", len(references)))
        for n, l in zip(references, lengths):
            nb = n.encode() + b"\x00"
            self._bgzf.write(struct.pack("<i", len(nb)))
            self._bgzf.write(nb)
            self._bgzf.write(struct.pack("<i", l))
        # Force a block boundary so record voffsets don't share the header
        # block (keeps index chunk arithmetic simple).
        self._bgzf.flush()

    def write(self, read: AlignedRead):
        rid = read.ref_id if isinstance(read.ref_id, int) else self._ref_to_id[read.ref_id]
        qname = read.qname.encode() + b"\x00"
        l_seq = len(read.seq)
        ref_end = read.pos + sum(l for op, l in read.cigar if _OP_CONSUMES[op][1])
        if ref_end == read.pos:
            ref_end = read.pos + 1
        bin_ = reg2bin(read.pos, ref_end)
        rec = bytearray()
        rec += struct.pack(
            "<iiBBHHHiiii",
            rid,
            read.pos,
            len(qname),
            read.mapq,
            bin_,
            len(read.cigar),
            read.flag,
            l_seq,
            -1,
            -1,
            0,
        )
        rec += qname
        rec += np.array([(l << 4) | op for op, l in read.cigar],
                        dtype="<u4").tobytes()
        codes = _NT16_LUT[np.frombuffer(read.seq.encode(), dtype=np.uint8)]
        if l_seq % 2:
            codes = np.append(codes, 0)
        rec += ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
        if read.qual is None:
            rec += b"\xff" * l_seq
        else:
            rec += np.asarray(read.qual, dtype=np.uint8).tobytes()
        for tag, val in (read.tags or {}).items():
            rec += _encode_tag(tag, val)
        voff_beg = self._bgzf.tell()
        self._bgzf.write(struct.pack("<i", len(rec)))
        self._bgzf.write(bytes(rec))
        voff_end = self._bgzf.tell()
        if self._write_index:
            self._bins[rid].setdefault(bin_, []).append((voff_beg, voff_end))
            for win in range(read.pos >> 14, ((ref_end - 1) >> 14) + 1):
                cur = self._linear[rid].get(win)
                if cur is None or voff_beg < cur:
                    self._linear[rid][win] = voff_beg
        return voff_beg

    def close(self):
        self._bgzf.close()
        if self._write_index:
            self._write_bai()

    def _write_bai(self):
        with open(self.path + ".bai", "wb") as fh:
            fh.write(b"BAI\x01")
            fh.write(struct.pack("<i", len(self.references)))
            for rid in range(len(self.references)):
                bins = self._bins[rid]
                # merge chunk lists per bin
                fh.write(struct.pack("<i", len(bins)))
                for bin_id in sorted(bins):
                    chunks = _merge_chunks(bins[bin_id])
                    fh.write(struct.pack("<Ii", bin_id, len(chunks)))
                    for beg, end in chunks:
                        fh.write(struct.pack("<QQ", beg, end))
                linear = self._linear[rid]
                n_intv = max(linear) + 1 if linear else 0
                fh.write(struct.pack("<i", n_intv))
                prev = 0
                for i in range(n_intv):
                    v = linear.get(i)
                    if v is None:
                        v = prev
                    prev = v
                    fh.write(struct.pack("<Q", v))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _merge_chunks(chunks):
    chunks = sorted(chunks)
    out = []
    for c in chunks:
        if out and c[0] <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], c[1]))
        else:
            out.append(list(c) if False else c)
    return out


def _encode_tag(tag, val):
    t = tag.encode()
    if isinstance(val, str) and len(val) == 1 and tag in ("HP",):
        val = int(val)
    if isinstance(val, bool):
        val = int(val)
    if isinstance(val, (int, np.integer)):
        if -128 <= val < 128:
            return t + b"c" + struct.pack("<b", int(val))
        if -32768 <= val < 32768:
            return t + b"s" + struct.pack("<h", int(val))
        return t + b"i" + struct.pack("<i", int(val))
    if isinstance(val, float):
        return t + b"f" + struct.pack("<f", val)
    if isinstance(val, str):
        return t + b"Z" + val.encode() + b"\x00"
    raise TypeError("unsupported tag type for %s: %r" % (tag, val))
