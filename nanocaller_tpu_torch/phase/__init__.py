"""Read-based phasing: the in-repo WhatsHap replacement, on the host."""

from .mec import PhaseResult, phase_contig, haplotag_reads
