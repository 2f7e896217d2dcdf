"""snp.wire_ms_per_group: milliseconds of the port's span snp.wire a group
in the traced window of the snp_stream cells: the host layout of a SNP
group's wire (read windows, CSR row pointers, span offsets, site
arrays), pileup/snp_pileup._wire before its copies."""

from nbench.program import span_ms_per_input


def read(ctx):
    return span_ms_per_input(ctx, "snp_stream", "snp.wire")
