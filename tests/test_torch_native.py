"""The port's native host library (nanocaller_tpu_torch/io/native, a copy
of the JAX package's libncio) against the port's own numpy/Python oracles,
as tests/test_native.py holds the JAX package's: the BAM window decode
(whole, site-filtered, deferred, split across threads), the haplotag
retagger, the MSA projection, the phasing's read selection and trellis;
and the library's build (one library under concurrent builders, a failed
build raising with the compiler's output)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nanocaller_tpu_torch.align.msa import (MSA_GAP_EXTEND, MSA_GAP_OPEN,
                                            MSA_MATCH, MSA_MISMATCH,
                                            star_msa_from_cigars)
from nanocaller_tpu_torch.align.nw import nw_align, pack_cigar
from nanocaller_tpu_torch.caller import write_haplotagged_bam
from nanocaller_tpu_torch.io import native as N
from nanocaller_tpu_torch.io.bam import AlignedRead, BamReader, BamWriter
from nanocaller_tpu_torch.phase import wmec as PW
from nanocaller_tpu_torch.pileup.engine import (column_counts, decode_reads,
                                                decode_reads_parallel,
                                                deferred_decode)

from fixtures import make_fixture
from test_wmec_prod import gen_block
from torch_jax_native import jax_native_lib
from torch_threads import _torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RW_FIELDS = ("flags", "strand", "read_start", "read_end", "hp", "ps",
             "ev_rid", "ev_pos", "ev_code", "ev_qpos", "del_rid",
             "del_start", "del_len", "ins_rid", "ins_pos", "ins_len")


@pytest.fixture(scope="module")
def bam_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_native")
    indels = [(1000, "del", 5, "het1"), (2000, "ins", "TTT", "hom"),
              (3000, "ins", "GGGGGGGGG", "het2")]
    return make_fixture(tmp, depth=25, L=5000, read_len=700, seed=77,
                        indels=indels, tag_haplotypes=True, error_rate=0.02)


def assert_windows_equal(a, b):
    assert a.qnames == b.qnames
    for f in RW_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.seqs == b.seqs


@pytest.mark.parametrize("window", [(0, 5000), (1200, 1300), (2950, 3050),
                                    (4400, 5000)])
def test_decode_matches_numpy(bam_fixture, window):
    bam = BamReader(bam_fixture[1])
    nat = decode_reads(bam, "chr_t", *window, keep_seq=True)
    py = decode_reads(bam, "chr_t", *window, keep_seq=True, use_native=False)
    assert nat.n_reads == py.n_reads > 0
    assert_windows_equal(nat, py)


def test_decode_without_index_and_without_seqs(bam_fixture):
    bam = BamReader(bam_fixture[1], index_path="/nonexistent")
    assert_windows_equal(decode_reads(bam, "chr_t", 500, 1500),
                         decode_reads(bam, "chr_t", 500, 1500,
                                      use_native=False))
    nat = decode_reads(BamReader(bam_fixture[1]), "chr_t", 0, 5000)
    assert nat.seqs == [] and nat.n_reads > 0


def test_counts_cache_matches_numpy(bam_fixture):
    bam = BamReader(bam_fixture[1])
    nat = decode_reads(bam, "chr_t", 100, 4900)
    py = decode_reads(bam, "chr_t", 100, 4900, use_native=False)
    assert nat.counts_cache is not None and py.counts_cache is None
    for s, e in ((100, 4900), (1000, 2000)):
        np.testing.assert_array_equal(column_counts(nat, s, e),
                                      column_counts(py, s, e))


SITES = np.array([500, 1000, 1500, 2999, 3001, 4800], np.int64)


def test_site_filtered_decode(bam_fixture):
    bam = BamReader(bam_fixture[1])
    full = decode_reads(bam, "chr_t", 0, 5000, use_native=False)
    nat = decode_reads(bam, "chr_t", 0, 5000, sites=SITES)
    assert_windows_equal(nat, decode_reads(bam, "chr_t", 0, 5000,
                                           sites=SITES, use_native=False))
    keep = np.isin(full.ev_pos, SITES)
    for f in ("ev_pos", "ev_rid", "ev_code", "ev_qpos"):
        np.testing.assert_array_equal(getattr(nat, f),
                                      getattr(full, f)[keep])
    assert 0 < len(nat.ev_pos) < len(full.ev_pos) / 10


def test_deferred_decode(bam_fixture):
    bam = BamReader(bam_fixture[1])
    dd = deferred_decode(bam, "chr_t", 0, 5000)
    py = decode_reads(bam, "chr_t", 0, 5000, use_native=False)
    np.testing.assert_array_equal(dd.counts(0, 5000),
                                  column_counts(py, 0, 5000))
    assert_windows_equal(dd.finish(SITES),
                         decode_reads(bam, "chr_t", 0, 5000, sites=SITES,
                                      use_native=False))
    empty = deferred_decode(bam, "chr_t", 0, 5000).finish(
        np.zeros(0, np.int64))
    assert len(empty.ev_pos) == 0 and empty.n_reads > 0
    dd2 = deferred_decode(bam, "chr_t", 0, 5000)
    dd2.close()  # abandoned without candidates: no leak, no crash
    dd2.close()


@pytest.mark.parametrize("n_parts", [2, 3, 4])
def test_parallel_split_identical(bam_fixture, n_parts):
    bam = BamReader(bam_fixture[1])
    sites = np.arange(40, 5000, 37, dtype=np.int64)
    assert_windows_equal(
        decode_reads_parallel(bam, "chr_t", 0, 5000, sites=sites,
                              min_span=1, n_parts=n_parts),
        decode_reads(bam, "chr_t", 0, 5000, sites=sites))
    assert_windows_equal(
        decode_reads_parallel(bam, "chr_t", 100, 4700, keep_seq=True,
                              min_span=1, n_parts=n_parts),
        decode_reads(bam, "chr_t", 100, 4700, keep_seq=True))


def test_corrupt_bam_raises_cleanly(bam_fixture, tmp_path):
    data = open(bam_fixture[1], "rb").read()
    trunc = str(tmp_path / "trunc.bam")
    with open(trunc, "wb") as fh:
        fh.write(data[: int(len(data) * 0.6)])
    with pytest.raises(ValueError, match="truncated"):
        BamReader(trunc)
    # garbage inside a BGZF block within the index chunk (header, index
    # and EOF marker intact): both decoders raise ValueError
    offs = [0]
    while offs[-1] < len(data):  # block starts: BSIZE + 1 bytes each
        offs.append(offs[-1] + int.from_bytes(
            data[offs[-1] + 16:offs[-1] + 18], "little") + 1)
    assert len(offs) > 4
    lo, hi = offs[2] + 40, offs[3] - 40
    bad = data[:lo] + bytes(x ^ 0x5A for x in data[lo:hi]) + data[hi:]
    path = str(tmp_path / "bad.bam")
    with open(path, "wb") as fh:
        fh.write(bad)
    shutil.copy(bam_fixture[1] + ".bai", path + ".bai")
    for use_native in (True, False):
        with pytest.raises(ValueError, match="corrupt"):
            decode_reads(BamReader(path), "chr_t", 0, 5000,
                         use_native=use_native)


def _block_starts(data):
    """The file offsets of a BGZF file's blocks (BSIZE + 1 bytes each)."""
    offs = [0]
    while offs[-1] < len(data):
        offs.append(offs[-1] + int.from_bytes(
            data[offs[-1] + 16:offs[-1] + 18], "little") + 1)
    return offs


@pytest.fixture
def corrupt_first_block(bam_fixture, tmp_path):
    """The fixture with the deflate bytes of its first record block (block
    1; block 0 holds the header) flipped, its header and EOF marker
    intact; (indexed path, unindexed path)."""
    data = open(bam_fixture[1], "rb").read()
    offs = _block_starts(data)
    lo, hi = offs[1] + 18, offs[2] - 8  # BGZF header, CRC32 + ISIZE
    bad = data[:lo] + bytes(x ^ 0x5A for x in data[lo:hi]) + data[hi:]
    paths = []
    for name in ("indexed", "unindexed"):
        path = str(tmp_path / ("%s.bam" % name))
        with open(path, "wb") as fh:
            fh.write(bad)
        paths.append(path)
    shutil.copy(bam_fixture[1] + ".bai", paths[0] + ".bai")
    return paths


@pytest.mark.parametrize("indexed", [True, False])
@pytest.mark.parametrize("decode", ["whole", "deferred", "oracle"])
def test_corrupt_first_block_raises(corrupt_first_block, indexed, decode):
    """A first record block that fails to inflate raises on an indexed and
    on an unindexed scan: the native decoder no longer skips the index
    chunk (indexed) or ends the scan as if at EOF (unindexed)."""
    bam = BamReader(corrupt_first_block[0 if indexed else 1])
    assert (bam._index is not None) == indexed
    with pytest.raises(ValueError, match="corrupt"):
        if decode == "deferred":
            deferred_decode(bam, "chr_t", 0, 5000).finish(
                np.arange(40, 5000, 37, dtype=np.int64))
        else:
            decode_reads(bam, "chr_t", 0, 5000, keep_seq=True,
                         use_native=decode == "whole")


@pytest.mark.parametrize("indexed", [True, False])
def test_corrupt_first_block_retagger_raises(corrupt_first_block, tmp_path,
                                             indexed):
    bam = BamReader(corrupt_first_block[0 if indexed else 1])
    with pytest.raises(ValueError, match="corrupt"):
        N.haplotag_native(bam, str(tmp_path / "out.phased.bam"), "chr_t", 0,
                          5000, {})


@pytest.mark.parametrize("indexed", [True, False])
def test_jax_native_decode_drops_a_corrupt_first_block(
        corrupt_first_block, bam_fixture, monkeypatch, indexed):
    """The fault the port's repair removes: the JAX package's copy of the
    decoder returns no read and no error on the same file, where the
    intact file has reads."""
    from nanocaller_tpu.io.bam import DEFAULT_FLAG_FILTER
    from nanocaller_tpu.io.bam import BamReader as JBamReader
    from nanocaller_tpu.io.native import decode_window_native as j_decode

    jax_native_lib(monkeypatch)
    path = corrupt_first_block[0 if indexed else 1]
    got = j_decode(JBamReader(path), "chr_t", 0, 5000, DEFAULT_FLAG_FILTER)
    want = j_decode(JBamReader(bam_fixture[1]), "chr_t", 0, 5000,
                    DEFAULT_FLAG_FILTER)
    assert len(got["read_start"]) == 0 < len(want["read_start"])


def test_seqless_reads_skipped_by_both_decoders(tmp_path):
    path = str(tmp_path / "s.bam")
    with BamWriter(path, ["chr_t"], [5000]) as w:
        w.write(AlignedRead("withseq", 0, 0, 100, 60, [(0, 50)],
                            "A" * 50, np.full(50, 30, np.uint8), {}))
        w.write(AlignedRead("noseq", 0, 0, 120, 60, [(0, 50)],
                            "", np.zeros(0, np.uint8), {}))
    bam = BamReader(path)
    nat = decode_reads(bam, "chr_t", 0, 5000, keep_seq=True)
    py = decode_reads(bam, "chr_t", 0, 5000, keep_seq=True, use_native=False)
    assert nat.qnames == py.qnames == ["withseq"]
    assert_windows_equal(nat, py)


@pytest.mark.parametrize("level", [1, 6])
def test_haplotag_native_matches_python_writer(bam_fixture, tmp_path, level):
    bam_p = bam_fixture[1]
    reads = list(BamReader(bam_p).fetch("chr_t", 0, 5000))
    tags = {r.qname: (1 + (i % 2), 100 + 70000 * (i % 3))
            for i, r in enumerate(reads[::2])}
    nat_p = str(tmp_path / "nat.phased.bam")
    py_p = str(tmp_path / "py.phased.bam")
    write_haplotagged_bam(BamReader(bam_p), nat_p, "chr_t", 0, 5000, tags,
                          level=level, threads=2)
    write_haplotagged_bam(BamReader(bam_p), py_p, "chr_t", 0, 5000, tags,
                          use_native=False)
    nat = list(BamReader(nat_p).fetch("chr_t", 0, 5000))
    py = list(BamReader(py_p).fetch("chr_t", 0, 5000))
    assert len(nat) == len(py) == len(reads)
    for a, b in zip(nat, py):
        assert (a.qname, a.pos, a.flag, a.cigar, a.seq, list(a.qual),
                a.tags) == (b.qname, b.pos, b.flag, b.cigar, b.seq,
                            list(b.qual), b.tags)
        if a.qname in tags:
            assert (a.tags["HP"], a.tags["PS"]) == tags[a.qname]
    sub = [[r.qname for r in BamReader(p).fetch("chr_t", 2000, 2500)]
           for p in (nat_p, py_p)]
    assert sub[0] == sub[1] and sub[0]
    np.testing.assert_array_equal(
        decode_reads(BamReader(nat_p), "chr_t", 0, 5000).hp,
        decode_reads(BamReader(py_p), "chr_t", 0, 5000, use_native=False).hp)


def test_haplotag_native_refuses_cram_and_unknown_contig(bam_fixture,
                                                        tmp_path):
    bam = BamReader(bam_fixture[1])
    with pytest.raises(ValueError, match="contig"):
        N.haplotag_native(bam, str(tmp_path / "x.bam"), "nope", 0, 10, {})

    class Cram:
        format = "CRAM"

    with pytest.raises(ValueError, match="BAM"):
        N.haplotag_native(Cram(), str(tmp_path / "x.bam"), "chr_t", 0, 10,
                          {})


def test_msa_projection_native_matches_numpy():
    rng = np.random.default_rng(7)

    def mutate(ref, sub=0.06, ind=0.05):
        out = []
        for ch in ref:
            r = rng.random()
            if r < sub:
                out.append("ACGT"[rng.integers(4)])
            elif r < sub + ind / 2:
                pass
            elif r < sub + ind:
                out += [ch, "ACGT"[rng.integers(4)]]
            else:
                out.append(ch)
        return "".join(out)

    for trial in range(25):
        ref = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 200))))
        seqs = [mutate(ref) for _ in range(int(rng.integers(2, 30)))]
        if trial % 5 == 0:
            seqs[0] = seqs[0][:8] + "N" * 3 + seqs[0][11:]
        cigars = [nw_align(s, ref, match=MSA_MATCH, mismatch=MSA_MISMATCH,
                           gap_open=MSA_GAP_OPEN,
                           gap_extend=MSA_GAP_EXTEND)[1] for s in seqs]
        a = star_msa_from_cigars(seqs, cigars, ref, 2)
        b = star_msa_from_cigars(seqs, cigars, ref, 2, use_native=False)
        assert np.array_equal(a[2], b[2]), trial
        assert (a[3], a[4]) == (b[3], b[4]), trial


def test_msa_projection_takes_packed_runs():
    """The packed wire of BatchAligner.align_many(packed=True) gives the
    tuple lists' tensor and consensus, on the native route and the numpy
    oracle alike."""
    rng = np.random.default_rng(8)
    for trial in range(10):
        ref = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 200))))
        seqs = [ref[: int(rng.integers(5, len(ref)))] + "ACG"
                for _ in range(int(rng.integers(2, 12)))]
        cigars = [nw_align(s, ref, match=MSA_MATCH, mismatch=MSA_MISMATCH,
                           gap_open=MSA_GAP_OPEN,
                           gap_extend=MSA_GAP_EXTEND)[1] for s in seqs]
        packed = [pack_cigar(c) for c in cigars]
        want = star_msa_from_cigars(seqs, cigars, ref, 2)
        for got in (star_msa_from_cigars(seqs, packed, ref, 2),
                    star_msa_from_cigars(seqs, packed, ref, 2,
                                         use_native=False)):
            assert np.array_equal(got[2], want[2]), trial
            assert (got[3], got[4]) == (want[3], want[4]), trial


def _block(seed, depth, n_sites):
    rng = np.random.default_rng(seed)
    rids, sidx, al, n_reads, _ = gen_block(rng, n_sites, depth, 0.1, 3, 9)
    return rng, rids, sidx, al, n_reads


@pytest.mark.parametrize("seed", range(3))
def test_selection_native_matches_python(seed):
    _, rids, sidx, _, n_reads = _block(seed, 24, 40)
    for cap in (4, 10, 15):
        for fn in (PW.select_reads, PW.select_reads_connectivity):
            got = fn(rids, sidx, n_reads, max_cov=cap)
            assert got.any()
            np.testing.assert_array_equal(
                got, fn(rids, sidx, n_reads, max_cov=cap, use_native=False))


@pytest.mark.parametrize("seed", range(4))
def test_wmec_native_matches_python_trellis(seed):
    rng, rids, sidx, al, _ = _block(seed, 8, int(10 + 8 * seed))
    n = int(sidx.max()) + 1
    g_in = rng.choice([1, 1, 2], n).astype(np.int8)
    for gq in (0.5, 3.0, 1e30):
        got = PW.wmec_exact_gt(rids, sidx, al, n, g_in, gq)
        want = PW.wmec_exact_gt(rids, sidx, al, n, g_in, gq, native=False)
        assert got[0] == want[0] and got[3] == want[3]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


def test_wmec_native_infeasible_raises():
    _, rids, sidx, al, _ = _block(0, 24, 30)
    n = int(sidx.max()) + 1
    with pytest.raises(ValueError, match="infeasible"):
        PW.wmec_exact_gt(rids, sidx, al, n, np.ones(n, np.int8), 1e30,
                         max_active=4)


_BUILD = r"""
import ctypes, sys
sys.path.insert(0, %r)
from nanocaller_tpu_torch.io import native as N
N.BUILD_DIR = sys.argv[1]
so = N.build()
ctypes.CDLL(so).ncio_free
print(so)
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Builders started together (as test workers are) wait on the lock:
    each loads the one library, and no temp file is left behind."""
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD % REPO,
                               build_dir], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(build_dir)) == sorted(
        [os.path.basename(paths.pop()), "libncio.lock"])


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "ncio.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(N, "_SRC", str(src))
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="building the native library "
                                           "failed(.|\n)*error"):
        N.build()
    assert os.listdir(tmp_path / "build") == ["libncio.lock"]
