"""snp.cohorts_ms_per_group: milliseconds of the port's span snp.cohorts a
group in the traced window of the snp_stream cells: the host's packing
of a SNP group's members into K3 cohorts (site depth, the depth check,
the coverage scale, the concatenation), snp_caller.pileup_cohorts up to
its first copy."""

from nbench.program import span_ms_per_input


def read(ctx):
    return span_ms_per_input(ctx, "snp_stream", "snp.cohorts")
