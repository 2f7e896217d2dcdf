"""CRAM input of the port (nanocaller_tpu_torch/io/{cram,rans}.py and the
native CRAM decode of io/native), as tests/test_cram.py holds the JAX
package's: rANS native against the Python codec, CRAM round trips and
region fetch against the BAM, CRAM files crossing between the two
packages' writers and readers, the native window decode against the
Python decoder and the BAM decode, corrupt and truncated input, and
`--mode all` on a CRAM: byte-identical VCFs to the port's BAM run and to
the JAX CLI's CRAM run, and a phased CRAM artifact whose records are the
phased BAM's."""

import gzip
import os
import random

import numpy as np
import pytest

from nanocaller_tpu.caller import run as j_run
from nanocaller_tpu.config import Config as JConfig
from nanocaller_tpu.io.cram import CramReader as JCramReader
from nanocaller_tpu.io.cram import CramWriter as JCramWriter
from nanocaller_tpu_torch.caller import run
from nanocaller_tpu_torch.config import Config
from nanocaller_tpu_torch.io import rans
from nanocaller_tpu_torch.io.bam import AlignedRead, BamReader, open_alignment
from nanocaller_tpu_torch.io.cram import CramReader, CramWriter
from nanocaller_tpu_torch.io.fasta import write_fasta
from nanocaller_tpu_torch.pileup.engine import (column_counts, decode_reads,
                                                deferred_decode)

from fixtures import make_diploid_readset, make_fixture, random_seq, write_bam
from torch_threads import _torch_threads  # noqa: F401 (autouse)

RW_FIELDS = ("flags", "strand", "read_start", "read_end", "hp", "ps",
             "ev_rid", "ev_pos", "ev_code", "ev_qpos", "del_rid",
             "del_start", "del_len", "ins_rid", "ins_pos", "ins_len")


def _windows_equal(a, b, label):
    assert a.qnames == b.qnames, label
    for f in RW_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg="%s %s" % (label, f))
    assert a.seqs == b.seqs, label


def _record(r):
    """A read's fields as a CRAM round trip keeps them (=/X become M)."""
    cigar = []
    for op, ln in r.cigar:
        op = 0 if op in (7, 8) else op
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + ln)
        else:
            cigar.append((op, ln))
    return (r.qname, r.flag, r.ref_id, r.pos, r.mapq, cigar, r.seq,
            bytes(np.asarray(r.qual, np.uint8)), dict(r.tags))


RANS_CASES = [b"", b"A", bytes(range(256)) * 3,
              bytes(random.Random(17).getrandbits(8) for _ in range(30011)),
              bytes(random.Random(18).choice(b"ACGT") for _ in range(70003)),
              b"\x07" * 9999]


@pytest.mark.parametrize("order", [0, 1])
def test_rans_native_round_trip_matches_python(order):
    for data in RANS_CASES:
        stream = rans.compress(data, order)
        assert stream == rans.compress(data, order, use_native=False)
        assert rans.uncompress(stream) == data
        assert rans.uncompress(stream, use_native=False) == data


def test_rans_native_rejects_corrupt():
    stream = rans.compress(b"ACGTACGTAA" * 50, 0)[:14]
    with pytest.raises(ValueError):
        rans.uncompress(stream)


@pytest.fixture(scope="module")
def cram_fixture(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cram")
    fa, bam_p, _, _ = make_fixture(tmp, seed=6, L=30000, depth=30,
                                   read_len=2500)
    br = BamReader(bam_p)
    cram_p = str(tmp / "r.cram")
    with CramWriter(cram_p, br.references, br.lengths, fa,
                    compression="rans", records_per_slice=100) as w:
        for r in br.fetch("chr_t"):
            w.write(r)
    return str(tmp), fa, bam_p, cram_p


@pytest.mark.parametrize("compression", ["gzip", "rans", "raw"])
def test_round_trip_and_fetch_match_bam(cram_fixture, compression):
    tmp, fa, bam_p, _ = cram_fixture
    br = BamReader(bam_p)
    reads = list(br.fetch("chr_t"))
    path = os.path.join(tmp, "rt_%s.cram" % compression)
    with CramWriter(path, br.references, br.lengths, fa,
                    compression=compression, records_per_slice=64) as w:
        for r in reads:
            w.write(r)
    assert os.path.exists(path + ".crai")
    cr = CramReader(path, fasta=fa)
    assert (cr.references, cr.lengths) == (br.references, br.lengths)
    assert [_record(r) for r in cr.fetch("chr_t")] == \
        [_record(r) for r in reads]
    for s, e in [(3000, 3500), (29900, 30000), (0, 1)]:
        assert sorted(r.qname for r in cr.fetch("chr_t", s, e)) == \
            sorted(r.qname for r in br.fetch("chr_t", s, e))


def test_open_alignment_dispatch_and_missing_fasta(cram_fixture):
    _tmp, fa, _bam_p, cram_p = cram_fixture
    obj = open_alignment(cram_p, fasta=fa)
    assert isinstance(obj, CramReader) and obj.format == "CRAM"
    with pytest.raises(ValueError, match="CRAM"):
        BamReader(cram_p)
    no_fasta = CramReader(cram_p)
    with pytest.raises(ValueError, match="FASTA"):
        list(no_fasta.fetch("chr_t"))
    with pytest.raises(ValueError, match="FASTA"):
        decode_reads(no_fasta, "chr_t", 0, 1000)


def test_crams_cross_between_packages(cram_fixture):
    """A CRAM the JAX package writes reads the same in the port, natively
    and through its Python decoder, and the reverse."""
    tmp, fa, bam_p, cram_p = cram_fixture
    reads = [_record(r) for r in BamReader(bam_p).fetch("chr_t")]
    j_path = os.path.join(tmp, "jax.cram")
    br = BamReader(bam_p)
    with JCramWriter(j_path, br.references, br.lengths, fa,
                     records_per_slice=100) as w:
        for r in br.fetch("chr_t"):
            w.write(r)
    assert [_record(r) for r in CramReader(j_path, fasta=fa).fetch(
        "chr_t")] == reads
    assert [_record(r) for r in JCramReader(cram_p, fasta=fa).fetch(
        "chr_t")] == reads
    _windows_equal(decode_reads(CramReader(j_path, fasta=fa), "chr_t", 0,
                                30000, keep_seq=True),
                   decode_reads(BamReader(bam_p), "chr_t", 0, 30000,
                                keep_seq=True), "jax cram")


@pytest.mark.parametrize("window", [(0, 30000), (12_000, 13_000),
                                    (29_000, 30_000)])
def test_native_decode_matches_python_and_bam(cram_fixture, window):
    _tmp, fa, bam_p, cram_p = cram_fixture
    cr = CramReader(cram_p, fasta=fa)
    nat = decode_reads(cr, "chr_t", *window, keep_seq=True)
    _windows_equal(nat, decode_reads(cr, "chr_t", *window, keep_seq=True,
                                     use_native=False), "oracle")
    _windows_equal(nat, decode_reads(BamReader(bam_p), "chr_t", *window,
                                     keep_seq=True), "bam")
    assert nat.n_reads > 0


def test_deferred_and_site_filtered_decode(cram_fixture):
    _tmp, fa, _bam_p, cram_p = cram_fixture
    cr = CramReader(cram_p, fasta=fa)
    dd = deferred_decode(cr, "chr_t", 0, 30000)
    full = decode_reads(cr, "chr_t", 0, 30000, use_native=False)
    np.testing.assert_array_equal(dd.counts(0, 30000),
                                  column_counts(full, 0, 30000))
    sites = np.arange(5000, 25000, 997)
    want = decode_reads(cr, "chr_t", 0, 30000, sites=sites,
                        use_native=False)
    _windows_equal(dd.finish(sites), want, "deferred")
    nat = decode_reads(cr, "chr_t", 0, 30000, sites=sites)
    _windows_equal(nat, want, "sites")
    assert len(nat.ev_pos) and set(nat.ev_pos.tolist()) <= set(sites)


def test_corrupt_and_truncated_cram_raise(cram_fixture):
    tmp, fa, _bam_p, cram_p = cram_fixture
    data = open(cram_p, "rb").read()
    trunc = os.path.join(tmp, "trunc.cram")
    with open(trunc, "wb") as fh:
        fh.write(data[: len(data) // 2])
    with pytest.raises(ValueError):
        decode_reads(open_alignment(trunc, fasta=fa), "chr_t", 0, 30000)
    # flipped bytes in the middle of the data containers
    lo, hi = len(data) // 3, len(data) // 3 + 4000
    bad = os.path.join(tmp, "bad.cram")
    with open(bad, "wb") as fh:
        fh.write(data[:lo] + bytes(x ^ 0x5A for x in data[lo:hi])
                 + data[hi:])
    with pytest.raises(ValueError):
        decode_reads(open_alignment(bad, fasta=fa), "chr_t", 0, 30000)


def test_layout_outside_the_native_set_goes_to_the_python_decoder(
        cram_fixture, monkeypatch):
    """A container whose encoding _native_spec reports as outside the
    native set (patched here for one container): its window is decoded
    by the Python decoder, equal field for field to the all-native window
    and to the JAX package's, and counted once a decode, with and without
    a site filter; the counts-first decode refuses the window without
    counting it (its caller decodes it with decode_reads); a flipped byte
    inside a slice still raises, with nothing counted."""
    from nanocaller_tpu.pileup.engine import decode_reads as j_decode_reads
    from nanocaller_tpu_torch.io import cram as C

    _tmp, fa, _bam_p, cram_p = cram_fixture
    window = (12_000, 13_000)
    native = decode_reads(CramReader(cram_p, fasta=fa), "chr_t", *window,
                          keep_seq=True)
    cr = CramReader(cram_p, fasta=fa)
    target = next(ch.start for ch, _ in cr._iter_containers(0, *window))
    seen, flip = {}, {}
    orig_iter, orig_spec = CramReader._iter_containers, C._native_spec

    def iter_containers(self, *a, **k):
        for ch, data in orig_iter(self, *a, **k):
            seen["start"] = ch.start
            if flip and ch.start == target:
                data = bytearray(data)
                data[len(data) - 10] ^= 0x5A  # in the container's last slice
            yield ch, bytes(data)

    monkeypatch.setattr(CramReader, "_iter_containers", iter_containers)
    monkeypatch.setattr(C, "_native_spec", lambda comp: (
        None if seen.get("start") == target else orig_spec(comp)))
    got = decode_reads(cr, "chr_t", *window, keep_seq=True)
    assert cr.python_windows == 1
    _windows_equal(got, native, "python vs native")
    _windows_equal(got, j_decode_reads(JCramReader(cram_p, fasta=fa),
                                       "chr_t", *window, keep_seq=True),
                   "python vs jax")
    np.testing.assert_array_equal(column_counts(got, *window),
                                  column_counts(native, *window))
    assert got.n_reads > 0

    sites = np.arange(window[0] + 7, window[1], 61)
    got = decode_reads(cr, "chr_t", *window, sites=sites)
    assert cr.python_windows == 2
    _windows_equal(got, decode_reads(CramReader(cram_p, fasta=fa), "chr_t",
                                     *window, sites=sites), "sites native")
    _windows_equal(got, j_decode_reads(JCramReader(cram_p, fasta=fa),
                                       "chr_t", *window, sites=sites),
                   "sites jax")
    assert len(got.ev_pos) and set(got.ev_pos.tolist()) <= set(sites)
    assert deferred_decode(cr, "chr_t", *window) is None
    assert cr.python_windows == 2

    monkeypatch.setattr(C, "_native_spec", orig_spec)
    flip["on"] = True
    with pytest.raises(ValueError):
        decode_reads(cr, "chr_t", *window, keep_seq=True)
    assert cr.python_windows == 2


def _vcf_bytes(path):
    with gzip.open(path) as fh:
        return fh.read()


def test_all_mode_cram_equals_bam_and_jax_cli(tmp_path, monkeypatch):
    """`--mode all` on a CRAM: the five VCFs byte-identical to the port's
    BAM run and to the JAX CLI's CRAM run; the phased CRAM artifact holds
    the phased BAM artifact's records. The same again with every
    container's layout refused by the native decoder (_native_spec
    patched): the SNP scan, the phasing and the indel decodes all go to
    the Python decoder, each window counted in cram.python_windows."""
    import json

    from nanocaller_tpu_torch.io import cram as C

    rng = np.random.default_rng(12)
    L = 6000
    ref = random_seq(rng, L)
    snps = [(p, "ACGT"[("ACGT".index(ref[p]) + 1) % 4],
             "het1" if i % 2 == 0 else "het2")
            for i, p in enumerate(range(400, L - 400, 330))]
    reads = make_diploid_readset(rng, ref, snps=snps,
                                 indels=[(2210, "del", 6, "het1")], depth=35,
                                 read_len=1200, error_rate=0.02)
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, {"chr_t": ref})
    bam_p = str(tmp_path / "reads.bam")
    write_bam(bam_p, "chr_t", L, reads)
    br = BamReader(bam_p)
    cram_p = str(tmp_path / "reads.cram")
    with CramWriter(cram_p, br.references, br.lengths, fa) as w:
        for r in br.fetch("chr_t"):
            w.write(r)

    def kw(inp, out):
        return dict(bam=inp, ref=fa, mode="all", cpu=1,
                    output=str(tmp_path / out), prefix="p", sample="S",
                    phase_qual_score=4, batch_size=128,
                    suppress_progress=True)

    outs = {"bam": run(Config(device="cpu", **kw(bam_p, "bam"))),
            "cram": run(Config(device="cpu", **kw(cram_p, "cram")))}
    j_run(JConfig(**kw(cram_p, "jax")))
    monkeypatch.setattr(C, "_native_spec", lambda comp: None)
    run(Config(device="cpu", **kw(cram_p, "cram_python")))
    monkeypatch.undo()
    names = ("p.unfiltered.snps.vcf.gz", "p.snps.vcf.gz",
             "p.snps.phased.vcf.gz", "p.indels.vcf.gz", "p.vcf.gz")
    data = {side: [_vcf_bytes(str(tmp_path / side / n)) for n in names]
            for side in ("bam", "cram", "jax", "cram_python")}
    assert data["cram"] == data["bam"] == data["jax"] == data["cram_python"]
    counts = {side: json.load(open(str(tmp_path / side / "metrics.json")))[
        "counts"].get("cram.python_windows") for side in
        ("cram", "cram_python")}
    # one SNP decode group, the phasing decode, the indel chunks' decodes
    assert counts["cram"] == 0 and counts["cram_python"] >= 3, counts
    assert data["cram"][1].count(b"\tPASS\t") > 5
    assert outs["cram"]["final"] == str(tmp_path / "cram" / "p.vcf.gz")
    phase_dir = lambda side: str(tmp_path / side / "intermediate_phase_files")
    art = os.path.join(phase_dir("cram"), "chr_t.phased.cram")
    assert not os.path.exists(os.path.join(phase_dir("cram"),
                                           "chr_t.phased.bam"))
    got = [_record(r) for r in CramReader(art, fasta=fa).fetch("chr_t")]
    want = [_record(r) for r in BamReader(os.path.join(
        phase_dir("bam"), "chr_t.phased.bam")).fetch("chr_t")]
    assert got == want
    assert sum(1 for r in got if "HP" in r[-1] and "PS" in r[-1]) > 10
