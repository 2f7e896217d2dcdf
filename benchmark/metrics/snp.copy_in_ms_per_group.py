"""snp.copy_in_ms_per_group: milliseconds of the port's span snp.copy_in a
group in the traced window of the snp_stream cells: a SNP group's host-
to-device copies (the wire's 18 fields, each cohort's rows), each a
blocking copy from pageable memory."""

from nbench.program import span_ms_per_input


def read(ctx):
    return span_ms_per_input(ctx, "snp_stream", "snp.copy_in")
