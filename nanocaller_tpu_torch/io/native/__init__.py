"""Build + ctypes binding of the port's native host library (libncio).

`ncio.cpp` beside this file is a verbatim copy of the JAX package's
nanocaller_tpu/io/native/ncio.cpp: the BAM window decode (one-shot,
site-filtered and the deferred two-phase forms), the CRAM slice decode,
rANS4x8, the star-MSA column projection, the phasing's greedy and
connectivity read selection and checkpointed wMEC trellis, and the
single-pass haplotag retagger. Its batch NW is not bound: every pair of
the port goes to the CUDA kernels K1/K2 (align/batch_nw.py).

The library is built with g++ at first use into nanocaller_tpu_torch/_build/
(a directory .gitignore lists), named by the hash of the source, the
build commands and the machine, under an exclusive file lock: one process
compiles to a temp name of its own and renames it into place, the others
wait and load the result. The commands are the JAX package's ladder:
-march=native with libdeflate, -march=native with zlib only, then the
same two portable; the first rung that compiles and loads is kept.

No silent fallback: a failed build raises RuntimeError with the
compiler's output, and a decode the library refuses (a corrupt or
truncated input) raises ValueError. The numpy/Python implementations
stay in the port as the oracles of these functions and are reached only
with an explicit `use_native=False` argument of their callers.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import time

import numpy as np

from ...runtime import watchdog

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ncio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")

_COMMON = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_NATIVE = ["-march=native", "-funroll-loops"]
_DEFLATE = ["-DNCIO_USE_LIBDEFLATE"]
# (compiler flags, libraries) of each rung; the libraries follow the
# source on the command line, or the linker drops them
_LADDER = ((_NATIVE + _DEFLATE, ["-lz", "-ldeflate"]), (_NATIVE, ["-lz"]),
           (_DEFLATE, ["-lz", "-ldeflate"]), ([], ["-lz"]))

_lib = None
_build_error = None


def _machine():
    """What a build is bound to besides its source: the host (a copied
    build directory may lack the libraries it linked) and its CPU's
    flags (-march=native)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((l for l in fh if l.startswith("flags")), "")
    except OSError:
        pass
    return repr((os.uname().nodename, os.uname().machine, flags))


def library_path():
    """Where the library for this source, ladder and machine is (or will
    be)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(repr((_COMMON, _LADDER)).encode())
    h.update(_machine().encode())
    return os.path.join(BUILD_DIR, "libncio_%s.so" % h.hexdigest()[:16])


def build():
    """Compile ncio.cpp unless the library for its hash exists; returns
    the library path. Concurrent callers (test workers) serialise on a
    lock file; each compiles to a temp name of its own and renames it
    into place, so no process ever loads a half-written library. It
    beats a supervising --watchdog while g++ runs and while it waits on
    another process's build (a cold build takes about 12 s)."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "libncio.lock"), "w") as lock:
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                watchdog.beat()
                time.sleep(0.2)
        try:
            if os.path.exists(so):  # built while this process waited
                return so
            tmp = "%s.%d.tmp" % (so, os.getpid())
            errors = []
            for flags, libs in _LADDER:
                cmd = ["g++", *_COMMON, *flags, _SRC, "-o", tmp, *libs]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                stderr = watchdog.communicate(proc)[1]
                if proc.returncode == 0:
                    # a rung may link a library the loader cannot find
                    # (a libdeflate outside its search path): take the
                    # first one that also loads
                    try:
                        ctypes.CDLL(tmp)
                    except OSError as e:
                        errors.append("$ %s\nbuilt, but does not load: %s"
                                      % (" ".join(cmd), e))
                        continue
                    os.replace(tmp, so)
                    return so
                errors.append("$ %s\n%s" % (" ".join(cmd), stderr))
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError("building the native library failed:\n"
                               + "\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _bind(lib):
    c = ctypes
    vp, i32, i64, dbl = c.c_void_p, c.c_int32, c.c_int64, c.c_double
    P = c.POINTER
    u8p, i8p, i32p, i64p, u64p = (P(c.c_uint8), P(c.c_int8), P(c.c_int32),
                                  P(c.c_int64), P(c.c_uint64))
    chp = P(c.c_char)
    sig = {
        "ncio_decode": (vp, [c.c_char_p, i32, i64, i64, u64p, i32, i32, i32,
                             i64p, i32]),
        "ncio_decode_defer": (vp, [c.c_char_p, i32, i64, i64, u64p, i32,
                                   i32, i32, i32]),
        "ncio_sizes": (None, [vp, i64p]),
        "ncio_fill": (None, [vp, i32p, i8p, i64p, i64p, i8p, i64p, chp, i64p,
                             chp, i64p, i32p, i32p, i8p, i32p, i32p, i32p,
                             i32p, i32p, i32p, i32p]),
        "ncio_emit_sites": (None, [vp, i64p, i32]),
        "ncio_emit_qpos": (None, [vp, i64p, i32, i32]),
        "ncio_emit_qwin": (None, [vp, i32p, i32p, i32, i32, chp, i32p]),
        "ncio_fill_events": (None, [vp, i32p, i32p, i8p, i32p]),
        "ncio_counts_width": (i64, [vp]),
        "ncio_counts_fill": (None, [vp, i32p]),
        "ncio_free": (None, [vp]),
        "ncio_haplotag": (i32, [c.c_char_p, c.c_char_p, i32, i64, i64, u64p,
                                i32, u8p, i64, i32, c.c_char_p, i64p, i8p,
                                i64p, i32, i32, i32]),
        "ncio_select_greedy": (None, [i64p, i64, i64p, i64p, i64, i32, u8p]),
        "ncio_select_connectivity": (None, [i64p, i64p, i64p, i64p, i64, i64,
                                            i32, u8p]),
        "ncio_wmec": (i32, [i32, i32, i32p, i32p, i64p, i32p, i8p, i8p, dbl,
                            i32, i64, i8p, i8p, i8p, P(dbl)]),
        "ncio_msa_project": (vp, [i8p, i64p, i32, P(c.c_uint32), i64p, i8p,
                                  i32, i32]),
        "ncio_msa_sizes": (None, [vp, i64p]),
        "ncio_msa_fill": (None, [vp, P(c.c_float), chp]),
        "ncio_msa_free": (None, [vp]),
        "ncio_rans_uncompress": (i32, [u8p, i64, u8p, i64, i64p]),
        "ncio_rans_compress": (i32, [u8p, i64, i32, u8p, i64, i64p]),
        "ncio_cram_begin": (vp, [i64, i64, i32]),
        "ncio_window_counts_only": (None, [vp]),
        "ncio_cram_feed": (i32, [vp, u8p, i64, u8p, i64p, i32p, i32, u8p, i64,
                                 chp, i64, i64, i64, i64, i64, i64,
                                 i32, i64, i64, i32, i32, i64p, i32]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib():
    """The loaded library, built at first use; raises RuntimeError when
    it cannot be built or loaded (again on every later call)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        _lib = _bind(ctypes.CDLL(build()))
    except (OSError, RuntimeError) as e:
        _build_error = str(e)
        raise RuntimeError(_build_error) from e
    return _lib


def _p(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _region_chunks(bam_reader, contig, start, end):
    """BAI virtual-offset chunk list for a region (flat uint64 pairs)."""
    if contig not in bam_reader._ref_to_id:
        return np.zeros(0, dtype=np.uint64)
    rid = bam_reader._ref_to_id[contig]
    if bam_reader._index is not None:
        chunk_list = bam_reader._index.chunks_for_region(rid, start, end)
        return np.array(chunk_list, dtype=np.uint64).reshape(-1)
    return np.array([bam_reader._data_start, 0], dtype=np.uint64)


def _sites_arg(sites):
    """(int64 array, count) for an optional site list; the array is never
    empty (ctypes needs a valid pointer)."""
    if sites is None:
        return np.zeros(1, np.int64), 0
    arr = np.ascontiguousarray(sites, dtype=np.int64)
    if len(arr) == 0:
        return np.zeros(1, np.int64), 0
    return arr, len(arr)


def decode_window_native(bam_reader, contig, start, end, flag_exclude,
                         keep_seq=False, sites=None):
    """Native decode → dict of arrays (same content as ReadWindow fields).

    bam_reader: an open io.bam.BamReader (provides the BAI chunk list and
    contig ids). Raises ValueError on a corrupt or truncated BAM.
    """
    lib = get_lib()
    chunks = _region_chunks(bam_reader, contig, start, end)
    rid = bam_reader._ref_to_id.get(contig, -1)
    sites_arr, n_sites = _sites_arg(sites)
    handle = lib.ncio_decode(
        bam_reader.path.encode(), rid, start, end,
        _p(chunks, ctypes.c_uint64), len(chunks) // 2, flag_exclude,
        1 if keep_seq else 0, _p(sites_arr, ctypes.c_int64), n_sites)
    try:
        return fill_window(lib, handle, bam_reader.path)
    finally:
        lib.ncio_free(handle)


def _sizes(lib, handle):
    sizes = np.zeros(7, dtype=np.int64)
    lib.ncio_sizes(handle, _p(sizes, ctypes.c_int64))
    return sizes


def fill_window(lib, handle, what="the input"):
    """Copy a native Window handle's arrays into a numpy dict (shared by
    the BAM and CRAM decode paths); ValueError when the decode failed."""
    n_reads, n_ev, n_del, n_ins, qn_bytes, seq_bytes, err = \
        _sizes(lib, handle)
    if err:
        raise ValueError("native decode of %s failed: corrupt or truncated "
                         "alignment records" % what)
    out = {
        "flags": np.zeros(n_reads, np.int32),
        "strand": np.zeros(n_reads, np.int8),
        "read_start": np.zeros(n_reads, np.int64),
        "read_end": np.zeros(n_reads, np.int64),
        "hp": np.zeros(n_reads, np.int8),
        "ps": np.zeros(n_reads, np.int64),
        "qnames_raw": np.zeros(max(1, qn_bytes), np.uint8),
        "qname_off": np.zeros(n_reads + 1, np.int64),
        "seqs_raw": np.zeros(max(1, seq_bytes), np.uint8),
        "seq_off": np.zeros(n_reads + 1, np.int64),
        "ev_rid": np.zeros(n_ev, np.int32),
        "ev_pos": np.zeros(n_ev, np.int32),
        "ev_code": np.zeros(n_ev, np.int8),
        "ev_qpos": np.zeros(n_ev, np.int32),
        "del_rid": np.zeros(n_del, np.int32),
        "del_start": np.zeros(n_del, np.int32),
        "del_len": np.zeros(n_del, np.int32),
        "ins_rid": np.zeros(n_ins, np.int32),
        "ins_pos": np.zeros(n_ins, np.int32),
        "ins_len": np.zeros(n_ins, np.int32),
    }
    c = ctypes
    lib.ncio_fill(
        handle,
        _p(out["flags"], c.c_int32), _p(out["strand"], c.c_int8),
        _p(out["read_start"], c.c_int64), _p(out["read_end"], c.c_int64),
        _p(out["hp"], c.c_int8), _p(out["ps"], c.c_int64),
        _p(out["qnames_raw"], c.c_char), _p(out["qname_off"], c.c_int64),
        _p(out["seqs_raw"], c.c_char), _p(out["seq_off"], c.c_int64),
        _p(out["ev_rid"], c.c_int32), _p(out["ev_pos"], c.c_int32),
        _p(out["ev_code"], c.c_int8), _p(out["ev_qpos"], c.c_int32),
        _p(out["del_rid"], c.c_int32), _p(out["del_start"], c.c_int32),
        _p(out["del_len"], c.c_int32), _p(out["ins_rid"], c.c_int32),
        _p(out["ins_pos"], c.c_int32), _p(out["ins_len"], c.c_int32))
    cw = lib.ncio_counts_width(handle)
    if cw > 0:
        counts = np.zeros((cw, 6), np.int32)
        lib.ncio_counts_fill(handle, _p(counts, c.c_int32))
        out["counts"] = counts
    return out


class DeferredDecode:
    """Two-phase native decode.

    Phase 1 (constructor, via decode_window_deferred): per-column counts +
    read metadata, record bytes stashed in the C++ handle — no per-base
    event arrays. Phase 2 (finish): emit events only at the
    candidate/neighbor site list and copy everything out.
    """

    def __init__(self, lib, handle, start, end, what):
        self._lib = lib
        self._handle = handle
        self._what = what
        self.start, self.end = start, end
        cw = lib.ncio_counts_width(handle)
        counts = np.zeros((max(0, cw), 6), np.int32)
        if cw > 0:
            lib.ncio_counts_fill(handle, _p(counts, ctypes.c_int32))
        self.counts = counts

    def finish(self, sites):
        """Emit site-filtered events and return the raw window dict."""
        sites_arr, n = _sites_arg(sites)
        self._lib.ncio_emit_sites(self._handle,
                                  _p(sites_arr, ctypes.c_int64), n)
        try:
            return fill_window(self._lib, self._handle, self._what)
        finally:
            self.close()

    def window_raw(self):
        """Phase-1 fill: read metadata/seqs/indel events, no M events
        (they're emitted later by finish/emit_qpos). The handle stays
        alive."""
        return fill_window(self._lib, self._handle, self._what)

    def emit_qpos(self, cols, keep=False):
        """Emit query-position-or-next pseudo-events at the sorted
        columns (indel path) and return (ev_rid, ev_pos, ev_code,
        ev_qpos). Frees the handle unless keep=True, which also retains
        the record store so emit_qwin can expand sequence windows later
        (caller must close())."""
        cols_arr, n = _sites_arg(cols)
        lib = self._lib
        lib.ncio_emit_qpos(self._handle, _p(cols_arr, ctypes.c_int64), n,
                           1 if keep else 0)
        try:
            n_ev = int(_sizes(lib, self._handle)[1])
            ev_rid = np.zeros(n_ev, np.int32)
            ev_pos = np.zeros(n_ev, np.int32)
            ev_code = np.zeros(n_ev, np.int8)
            ev_qpos = np.zeros(n_ev, np.int32)
            lib.ncio_fill_events(
                self._handle, _p(ev_rid, ctypes.c_int32),
                _p(ev_pos, ctypes.c_int32), _p(ev_code, ctypes.c_int8),
                _p(ev_qpos, ctypes.c_int32))
            return ev_rid, ev_pos, ev_code, ev_qpos
        finally:
            if not keep:
                self.close()

    def emit_qwin(self, rids, qstarts, win):
        """Expand query windows seq[max(0,q):q+win] from the stashed
        packed records (python-slice clamping); returns list[str].
        Valid only after emit_qpos(keep=True)."""
        rids = np.ascontiguousarray(rids, dtype=np.int32)
        qstarts = np.ascontiguousarray(qstarts, dtype=np.int32)
        n = len(rids)
        if n == 0:
            return []
        out = ctypes.create_string_buffer(n * win)
        out_len = np.zeros(n, np.int32)
        self._lib.ncio_emit_qwin(
            self._handle, _p(rids, ctypes.c_int32),
            _p(qstarts, ctypes.c_int32), n, win, out,
            _p(out_len, ctypes.c_int32))
        buf = out.raw
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(out_len, out=offs[1:])
        return [buf[offs[i]:offs[i + 1]].decode() for i in range(n)]

    def close(self):
        if self._handle is not None:
            self._lib.ncio_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def decode_window_deferred(bam_reader, contig, start, end, flag_exclude,
                           keep_seq=False, want_counts=True):
    """Start a two-phase deferred decode; ValueError on a corrupt BAM.

    want_counts=False (indel path) skips the per-base count accumulation
    entirely — phase 1 then costs only the record parse + indel events."""
    lib = get_lib()
    chunks = _region_chunks(bam_reader, contig, start, end)
    rid = bam_reader._ref_to_id.get(contig, -1)
    handle = lib.ncio_decode_defer(
        bam_reader.path.encode(), rid, start, end,
        _p(chunks, ctypes.c_uint64), len(chunks) // 2, flag_exclude,
        1 if keep_seq else 0, 1 if want_counts else 0)
    if _sizes(lib, handle)[6]:
        lib.ncio_free(handle)
        raise ValueError("native decode of %s failed: corrupt or truncated "
                         "alignment records" % bam_reader.path)
    return DeferredDecode(lib, handle, start, end, bam_reader.path)


def haplotag_native(bam_reader, out_path, contig, start, end, tags, level=6,
                    threads=0):
    """Write the haplotagged-BAM artifact in one C++ pass (stream region
    records, splice HP/PS tags, BGZF-write at deflate `level` + BAI).
    tags: {qname: (hp, ps)}. threads: deflate pool size (0 = auto).
    The C++ pass releases the GIL. Raises ValueError for a non-BAM input,
    an unknown contig or a corrupt input (a BGZF block that fails to
    load, a bad record size) and RuntimeError when the write fails."""
    lib = get_lib()
    if getattr(bam_reader, "format", None) != "BAM":
        raise ValueError("haplotag_native reads a BAM, not %s"
                         % getattr(bam_reader, "format", None))
    if contig not in bam_reader._ref_to_id:
        raise ValueError("contig %r is not in %s" % (contig, bam_reader.path))
    rid = bam_reader._ref_to_id[contig]
    chunks = _region_chunks(bam_reader, contig, start, end)

    # raw uncompressed BAM header, same default text as io/bam.BamWriter
    header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        "@SQ\tSN:%s\tLN:%d\n" % (n, l)
        for n, l in zip(bam_reader.references, bam_reader.lengths))
    text = header_text.encode()
    hdr = bytearray(b"BAM\x01")
    hdr += struct.pack("<i", len(text)) + text
    hdr += struct.pack("<i", len(bam_reader.references))
    for n, l in zip(bam_reader.references, bam_reader.lengths):
        nb = n.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    hdr_arr = np.frombuffer(bytes(hdr), np.uint8)

    names = [qn.encode() for qn in tags]
    n_tags = len(names)
    off = np.zeros(n_tags + 1, np.int64)
    hp = np.zeros(max(1, n_tags), np.int8)
    ps = np.zeros(max(1, n_tags), np.int64)
    for i, (qn, t) in enumerate(tags.items()):
        off[i + 1] = off[i] + len(names[i])
        hp[i], ps[i] = int(t[0]), int(t[1])
    qcat = b"".join(names) or b"\x00"

    rc = lib.ncio_haplotag(
        bam_reader.path.encode(), out_path.encode(), rid, start, end,
        _p(chunks, ctypes.c_uint64), len(chunks) // 2,
        _p(hdr_arr, ctypes.c_uint8), len(hdr_arr),
        len(bam_reader.references), qcat, _p(off, ctypes.c_int64),
        _p(hp, ctypes.c_int8), _p(ps, ctypes.c_int64), n_tags, level,
        threads)
    if rc == 2:
        raise ValueError("native haplotag of %s failed: corrupt BGZF block "
                         "or alignment record" % bam_reader.path)
    if rc != 0:
        raise RuntimeError("native haplotag of %s into %s failed (rc=%d)"
                           % (bam_reader.path, out_path, rc))
    return out_path


def cram_window_begin(start, end, n_sites):
    """(lib, handle) of a native Window for CRAM slice feeding."""
    lib = get_lib()
    return lib, lib.ncio_cram_begin(start, end, n_sites)


def cram_window_feed(lib, handle, spec, ext_blocks, core, refseg, ref_off0,
                     slice_ref_id, slice_start, n_records, record_counter,
                     want_rid, start, end, flag_exclude, keep_seq, sites):
    """Feed one slice into a CRAM window handle. ext_blocks: list of
    (content_id, bytes). Returns True on success; False when the C++
    decoder refuses the slice (the caller raises)."""
    n_ext = len(ext_blocks)
    off = np.zeros(n_ext + 1, np.int64)
    cids = np.zeros(max(1, n_ext), np.int32)
    for i, (cid, data) in enumerate(ext_blocks):
        off[i + 1] = off[i] + len(data)
        cids[i] = cid
    cat = (b"".join(d for _, d in ext_blocks) or b"\x00")
    cat_arr = np.frombuffer(cat, np.uint8)
    core_arr = np.frombuffer(core or b"\x00", np.uint8)
    ref_arr = np.frombuffer(refseg.encode() if refseg else b"\x00", np.uint8)
    spec_arr = np.frombuffer(spec, np.uint8)
    sites_arr, n_sites = _sites_arg(sites)
    rc = lib.ncio_cram_feed(
        handle, _p(spec_arr, ctypes.c_uint8), len(spec_arr),
        _p(cat_arr, ctypes.c_uint8), _p(off, ctypes.c_int64),
        _p(cids, ctypes.c_int32), n_ext, _p(core_arr, ctypes.c_uint8),
        len(core or b""), _p(ref_arr, ctypes.c_char), ref_off0,
        len(refseg or ""), slice_ref_id, slice_start, n_records,
        record_counter, want_rid, start, end, flag_exclude,
        1 if keep_seq else 0, _p(sites_arr, ctypes.c_int64), n_sites)
    return rc == 0


def cram_window_finish(lib, handle, what="the CRAM input"):
    try:
        return fill_window(lib, handle, what)
    finally:
        lib.ncio_free(handle)


def cram_window_free(lib, handle):
    lib.ncio_free(handle)


def msa_project_native(read_codes_list, cigars, ref_codes, width=128):
    """Star-MSA column projection + indel tensor via the C++ kernel.

    read_codes_list: list of int8 arrays in the MSA alphabet (A0 G1 T2
    C3 other/gap 4); cigars: list of [(op, len)] global-alignment runs
    vs ref (or packed uint32 (len<<4|op) run arrays); ref_codes: int8
    array. Returns (tensor (5,width,2) float32, consensus str) —
    bit-identical to align/msa.project_alignments + msa_tensor.
    """
    lib = get_lib()
    n = len(read_codes_list)
    read_off = np.zeros(n + 1, np.int64)
    cig_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in read_codes_list], out=read_off[1:])
    np.cumsum([len(c) for c in cigars], out=cig_off[1:])
    codes_cat = (np.concatenate(read_codes_list).astype(np.int8)
                 if n and read_off[-1] else np.zeros(1, np.int8))
    if n and cigars and isinstance(cigars[0], np.ndarray):
        # the packed wire (BatchAligner.align_many(packed=True)): one
        # concatenation, no per-run Python
        runs = (np.concatenate(cigars).astype(np.uint32, copy=False)
                if cig_off[-1] else np.zeros(1, np.uint32))
    else:
        runs = np.zeros(max(1, int(cig_off[-1])), np.uint32)
        k = 0
        for cg in cigars:
            for op, ln in cg:
                runs[k] = (ln << 4) | op
                k += 1
    ref_arr = np.ascontiguousarray(ref_codes, dtype=np.int8)
    if len(ref_arr) == 0:
        ref_arr = np.zeros(1, np.int8)
    c = ctypes
    handle = lib.ncio_msa_project(
        _p(codes_cat, c.c_int8), _p(read_off, c.c_int64), n,
        _p(runs, c.c_uint32), _p(cig_off, c.c_int64),
        _p(ref_arr, c.c_int8), len(ref_codes), width)
    try:
        sizes = np.zeros(1, np.int64)
        lib.ncio_msa_sizes(handle, _p(sizes, c.c_int64))
        tensor = np.zeros((5, width, 2), np.float32)
        cns_buf = c.create_string_buffer(max(1, int(sizes[0])))
        lib.ncio_msa_fill(handle, _p(tensor.reshape(-1), c.c_float),
                          cns_buf)
        return tensor, cns_buf.raw[: int(sizes[0])].decode()
    finally:
        lib.ncio_msa_free(handle)


def rans_uncompress_native(stream, raw_size):
    """C++ rANS4x8 decode; raises ValueError on a corrupt stream."""
    lib = get_lib()
    buf = np.frombuffer(bytes(stream), dtype=np.uint8)
    out = np.zeros(max(1, raw_size), dtype=np.uint8)
    out_len = np.zeros(1, np.int64)
    rc = lib.ncio_rans_uncompress(
        _p(buf, ctypes.c_uint8), len(buf), _p(out, ctypes.c_uint8), len(out),
        _p(out_len, ctypes.c_int64))
    if rc != 0:
        raise ValueError("malformed rANS stream (native rc=%d)" % rc)
    return out[: int(out_len[0])].tobytes()


def rans_compress_native(data, order):
    """C++ rANS4x8 encode (byte-identical to io/rans.compress's Python
    path); raises RuntimeError when the encoder fails."""
    lib = get_lib()
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if len(buf) == 0:
        buf = np.zeros(1, np.uint8)
    cap = len(data) + 300_000
    out = np.zeros(cap, dtype=np.uint8)
    out_len = np.zeros(1, np.int64)
    rc = lib.ncio_rans_compress(
        _p(buf, ctypes.c_uint8), len(data), order, _p(out, ctypes.c_uint8),
        cap, _p(out_len, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError("native rANS encode failed (rc=%d)" % rc)
    return out[: int(out_len[0])].tobytes()


def select_connectivity_native(first, last, cnt, multi, S, max_cov,
                               n_reads):
    """C++ connectivity-first selection loop
    (phase/wmec.select_reads_connectivity); returns taken bool[n_reads],
    bit-identical to the Python lazy-rescoring heap."""
    lib = get_lib()
    first = np.ascontiguousarray(first, np.int64)
    last = np.ascontiguousarray(last, np.int64)
    cnt = np.ascontiguousarray(cnt, np.int64)
    multi = np.ascontiguousarray(multi, np.int64)
    taken = np.zeros(n_reads, np.uint8)
    i64 = ctypes.c_int64
    lib.ncio_select_connectivity(
        _p(first, i64), _p(last, i64), _p(cnt, i64), _p(multi, i64),
        len(multi), int(S), int(max_cov), _p(taken, ctypes.c_uint8))
    return taken.astype(bool)


def select_greedy_native(order, first, last, S, max_cov, n_reads):
    """C++ greedy coverage-selection loop (phase/wmec.select_reads);
    returns taken bool[n_reads], bit-identical to the Python loop."""
    lib = get_lib()
    order = np.ascontiguousarray(order, np.int64)
    first = np.ascontiguousarray(first, np.int64)
    last = np.ascontiguousarray(last, np.int64)
    taken = np.zeros(n_reads, np.uint8)
    i64 = ctypes.c_int64
    lib.ncio_select_greedy(
        _p(order, i64), len(order), _p(first, i64), _p(last, i64), int(S),
        int(max_cov), _p(taken, ctypes.c_uint8))
    return taken.astype(bool)


def wmec_native(first, last, col_start, obs_read, obs_allele, g_in, gq,
                max_active, cell_budget):
    """Exact wMEC + joint genotype DP (phase/wmec.py core) in C++.

    Inputs are the renumbered multi-read form (see wmec.wmec_exact_gt):
    first/last int32[R] site spans, col_start int64[S+1] CSR of
    observations sorted by site, obs_read int32[K], obs_allele int8[K],
    g_in int8[S]. Blocks past cell_budget cells (up to 16x) run in
    checkpoint mode. Returns (cost, a1, a2, part), or None when the
    instance is infeasible: an active width over max_active, or more than
    16 x cell_budget cells."""
    lib = get_lib()
    S = len(g_in)
    R = len(first)
    first = np.ascontiguousarray(first, np.int32)
    last = np.ascontiguousarray(last, np.int32)
    col_start = np.ascontiguousarray(col_start, np.int64)
    obs_read = np.ascontiguousarray(obs_read, np.int32)
    obs_allele = np.ascontiguousarray(obs_allele, np.int8)
    g_in = np.ascontiguousarray(g_in, np.int8)
    a1 = np.zeros(S, np.int8)
    a2 = np.zeros(S, np.int8)
    part = np.zeros(max(R, 1), np.int8)
    cost = ctypes.c_double(0.0)
    i8, i32 = ctypes.c_int8, ctypes.c_int32
    rc = lib.ncio_wmec(
        S, R, _p(first, i32), _p(last, i32), _p(col_start, ctypes.c_int64),
        _p(obs_read, i32), _p(obs_allele, i8), _p(g_in, i8), float(gq),
        int(max_active), int(cell_budget), _p(a1, i8), _p(a2, i8),
        _p(part, i8), ctypes.byref(cost))
    if rc != 0:
        return None
    return float(cost.value), a1, a2, part[:R]
