"""Alignment / reference / interval / variant file I/O (BAM, CRAM, FASTA,
BED, VCF), copied from nanocaller_tpu/io, with the C++ library of
``nanocaller_tpu_torch/io/native`` for the hot decode loops."""

from .bam import AlignedRead, BamReader, BamWriter, open_alignment
from .bed import BedIntervals
from .bgzf import BgzfReader, BgzfWriter
from .cram import CramReader, CramWriter
from .fasta import FastaFile
