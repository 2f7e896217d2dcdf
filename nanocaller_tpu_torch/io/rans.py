"""rANS 4x8 entropy codec (CRAM 3.0 block compression method 4).

The reference reads CRAMs through htslib, whose rANS codec is specified
in the CRAM 3.0 format specification §13 ("rANS codec"): a static
range-coder with 12-bit normalized frequencies (total 4096), four
interleaved uint32 states renormalizing one byte at a time against a
lower bound of 2^23, in order-0 (context-free) and order-1 (previous
byte as context) variants.

This is a from-scratch implementation of that published format — the
correctness oracle for the C++ path in ``io/native`` that the CRAM reader
and writer run. A copy of nanocaller_tpu/io/rans.py.

Layout of a compressed stream:

    byte    order                (0 or 1)
    uint32  compressed size (LE) (frequency table + rANS bytes)
    uint32  raw size (LE)
    <frequency table>            (order-0: one table; order-1: table of
                                  tables keyed by context symbol)
    uint32  x4 initial states (LE)
    <renormalization bytes>

Frequency tables store (symbol, freq) pairs with symbols ascending;
freq is 1 byte when <128 else 2 bytes (0x80|hi, lo). A run of
consecutive symbols is collapsed: when a symbol s immediately follows
symbol s-1 in the table, s is followed by one byte giving how many
further consecutive symbols come after it (their symbol bytes omitted).
The table ends with a 0 symbol byte.
"""

from __future__ import annotations

import struct

RANS_BYTE_L = 1 << 23
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT  # 4096


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------

def _normalize_freqs(counts):
    """Scale a 256-entry count vector so nonzero entries sum to TOTFREQ."""
    total = sum(counts)
    if total == 0:
        return [0] * 256
    freqs = [0] * 256
    # floor-scale with at least 1 per present symbol
    assigned = 0
    max_sym = 0
    for s in range(256):
        if counts[s] == 0:
            continue
        f = counts[s] * TOTFREQ // total
        if f == 0:
            f = 1
        freqs[s] = f
        assigned += f
        if freqs[s] > freqs[max_sym] or freqs[max_sym] == 0:
            max_sym = s
    # push the remainder (either sign) onto the most frequent symbol
    freqs[max_sym] += TOTFREQ - assigned
    if freqs[max_sym] <= 0:
        raise ValueError("pathological frequency normalization")
    return freqs


def _write_keyed_table(out: bytearray, keys, emit_payload):
    """Serialize an ascending key list with the CRAM run-collapsing scheme.

    Stream grammar (mirrors ``_read_keyed_table``): first key byte, then
    repeatedly <payload for current key> followed by either nothing (when
    inside a collapsed run — the key increments implicitly), or the next
    key byte (plus a run-length byte when that key is previous+1), or the
    0 terminator.
    """
    i, n = 0, len(keys)
    out.append(keys[0])
    run_left = 0
    while True:
        emit_payload(keys[i])
        i += 1
        if run_left:
            run_left -= 1
            continue
        if i < n:
            out.append(keys[i])
            if keys[i] == keys[i - 1] + 1:
                j = i
                while j + 1 < n and keys[j + 1] == keys[j] + 1:
                    j += 1
                run_left = j - i
                out.append(run_left)
        else:
            out.append(0)
            return


def _read_keyed_table(data, pos, read_payload):
    """Inverse of ``_write_keyed_table``: calls read_payload(key, pos)→pos."""
    rle = 0
    key = data[pos]
    pos += 1
    while True:
        pos = read_payload(key, pos)
        if rle:
            rle -= 1
            key += 1
            continue
        nxt = data[pos]
        pos += 1
        if nxt == key + 1:
            rle = data[pos]
            pos += 1
        key = nxt
        if key == 0 and rle == 0:
            return pos


def _write_freq_table(out: bytearray, freqs):
    """Serialize one order-0 style table (symbols ascending, run-collapsed)."""
    syms = [s for s in range(256) if freqs[s] > 0]
    _write_keyed_table(out, syms, lambda s: _write_freq(out, freqs[s]))


def _write_freq(out: bytearray, f):
    if f < 128:
        out.append(f)
    else:
        out.append(0x80 | (f >> 8))
        out.append(f & 0xFF)


def _read_freq(data, pos):
    f = data[pos]
    pos += 1
    if f >= 128:
        f = ((f & 0x7F) << 8) | data[pos]
        pos += 1
    return f, pos


def _read_freq_table(data, pos):
    """Parse one table → (freqs[256], pos). Inverse of _write_freq_table."""
    freqs = [0] * 256

    def payload(sym, p):
        freqs[sym], p = _read_freq(data, p)
        return p

    pos = _read_keyed_table(data, pos, payload)
    return freqs, pos


def _cumulative(freqs):
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    return cum


def _sym_lookup(freqs):
    """f (0..4095) → symbol table."""
    table = bytearray(TOTFREQ)
    x = 0
    for s in range(256):
        if freqs[s]:
            table[x : x + freqs[s]] = bytes([s]) * freqs[s]
            x += freqs[s]
    return bytes(table)


# ---------------------------------------------------------------------------
# order-0
# ---------------------------------------------------------------------------

def _encode_stream(order_payload_iter, nstates=4):
    """Shared encoder core: iterate (state_idx, freq, cumfreq) in *decode*
    order reversed, emitting renorm bytes; returns the rANS byte stream."""
    states = [RANS_BYTE_L] * nstates
    out_rev = bytearray()
    for j, f, c in order_payload_iter:
        x = states[j]
        x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * f
        while x >= x_max:
            out_rev.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << TF_SHIFT) + c + (x % f)
    # flush states so the decoder can read them LE in index order first
    head = bytearray()
    for j in range(nstates):
        head += struct.pack("<I", states[j])
    return bytes(head) + bytes(reversed(out_rev))


def _compress_o0(data: bytes) -> bytes:
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freqs = _normalize_freqs(counts)
    cum = _cumulative(freqs)
    table = bytearray()
    _write_freq_table(table, freqs)

    n = len(data)

    def payload():
        for i in range(n - 1, -1, -1):
            s = data[i]
            yield i & 3, freqs[s], cum[s]

    body = _encode_stream(payload())
    return bytes(table) + body


def _uncompress_o0(data, pos, out_sz):
    freqs, pos = _read_freq_table(data, pos)
    cum = _cumulative(freqs)
    lut = _sym_lookup(freqs)
    states = list(struct.unpack_from("<4I", data, pos))
    pos += 16
    out = bytearray(out_sz)
    nd = len(data)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        f = x & (TOTFREQ - 1)
        s = lut[f]
        out[i] = s
        x = freqs[s] * (x >> TF_SHIFT) + f - cum[s]
        while x < RANS_BYTE_L and pos < nd:
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1
# ---------------------------------------------------------------------------

def _compress_o1(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    # per-context counts; context of each quarter-segment's first byte is 0
    counts = [None] * 256

    def bump(ctx, s):
        c = counts[ctx]
        if c is None:
            c = counts[ctx] = [0] * 256
        c[s] += 1

    for j in range(4):
        seg_start = j * isz4
        seg_end = (j + 1) * isz4 if j < 3 else n
        ctx = 0
        for p in range(seg_start, seg_end):
            bump(ctx, data[p])
            ctx = data[p]

    freqs = [None] * 256
    cums = [None] * 256
    for ctx in range(256):
        if counts[ctx] is not None:
            freqs[ctx] = _normalize_freqs(counts[ctx])
            cums[ctx] = _cumulative(freqs[ctx])

    # table of tables, outer keys run-collapsed the same way
    table = bytearray()
    ctxs = [c for c in range(256) if counts[c] is not None]
    _write_keyed_table(table, ctxs, lambda c: _write_freq_table(table, freqs[c]))

    def payload():
        # reverse of decode order: remainder (state 3) first, then
        # i = isz4-1 .. 0 each with states 3,2,1,0
        for p in range(n - 1, 4 * isz4 - 1, -1):
            ctx = data[p - 1] if p > 3 * isz4 else 0
            s = data[p]
            yield 3, freqs[ctx][s], cums[ctx][s]
        for i in range(isz4 - 1, -1, -1):
            for j in (3, 2, 1, 0):
                p = j * isz4 + i
                ctx = data[p - 1] if p > j * isz4 else 0
                s = data[p]
                yield j, freqs[ctx][s], cums[ctx][s]

    body = _encode_stream(payload())
    return bytes(table) + body


def _read_o1_tables(data, pos):
    freqs = [None] * 256

    def payload(ctx, p):
        freqs[ctx], p = _read_freq_table(data, p)
        return p

    pos = _read_keyed_table(data, pos, payload)
    return freqs, pos


def _uncompress_o1(data, pos, out_sz):
    freqs, pos = _read_o1_tables(data, pos)
    cums = [None] * 256
    luts = [None] * 256
    for c in range(256):
        if freqs[c] is not None:
            cums[c] = _cumulative(freqs[c])
            luts[c] = _sym_lookup(freqs[c])
    states = list(struct.unpack_from("<4I", data, pos))
    pos += 16
    nd = len(data)
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    last = [0, 0, 0, 0]
    for i in range(isz4):
        for j in range(4):
            x = states[j]
            ctx = last[j]
            f = x & (TOTFREQ - 1)
            s = luts[ctx][f]
            out[j * isz4 + i] = s
            x = freqs[ctx][s] * (x >> TF_SHIFT) + f - cums[ctx][s]
            while x < RANS_BYTE_L and pos < nd:
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
            last[j] = s
    # remainder decoded by state 3, continuing its context chain
    for p in range(4 * isz4, out_sz):
        x = states[3]
        ctx = last[3]
        f = x & (TOTFREQ - 1)
        s = luts[ctx][f]
        out[p] = s
        x = freqs[ctx][s] * (x >> TF_SHIFT) + f - cums[ctx][s]
        while x < RANS_BYTE_L and pos < nd:
            x = (x << 8) | data[pos]
            pos += 1
        states[3] = x
        last[3] = s
    return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def compress(data: bytes, order: int = 0, use_native=True) -> bytes:
    """Compress ``data`` into a CRAM rANS4x8 stream (header included).

    Runs the C++ encoder of io/native (byte-identical streams); the
    Python path below, taken with use_native=False, is its oracle."""
    data = bytes(data)
    if order == 1 and len(data) < 4:
        order = 0  # order-1 needs the 4-way split; tiny inputs go order-0
    if use_native:
        from .native import rans_compress_native

        return rans_compress_native(data, order)
    if len(data) == 0:
        body = b""
    elif order == 0:
        body = _compress_o0(data)
    else:
        body = _compress_o1(data)
    return struct.pack("<BII", order, len(body), len(data)) + body


def uncompress(stream: bytes, expected_size=None, use_native=True) -> bytes:
    """Decompress a CRAM rANS4x8 stream (with its 9-byte header).

    Runs the C++ decoder of io/native (ncio_rans_uncompress); the Python
    path below, taken with use_native=False, is its oracle. Both raise
    ValueError on a corrupt stream.
    """
    order, comp_sz, raw_sz = struct.unpack_from("<BII", stream, 0)
    if expected_size is not None and raw_sz != expected_size:
        raise ValueError(
            "rANS raw size %d != expected %d" % (raw_sz, expected_size))
    if raw_sz == 0:
        return b""
    if use_native and order in (0, 1):
        from .native import rans_uncompress_native

        return rans_uncompress_native(stream, raw_sz)
    pos = 9
    if order == 0:
        return _uncompress_o0(stream, pos, raw_sz)
    if order == 1:
        return _uncompress_o1(stream, pos, raw_sz)
    raise ValueError("unknown rANS order %d" % order)
