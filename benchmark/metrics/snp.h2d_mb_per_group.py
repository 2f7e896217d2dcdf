"""snp.h2d_mb_per_group: megabytes (1e6 bytes) a SNP group sends from the
host to the device in the snp_stream cells: the port's counter
snp.h2d_bytes over snp.groups."""

from nbench.program import counter_ratio


def read(ctx):
    r = counter_ratio(ctx, "snp_stream", "snp.h2d_bytes", "snp.groups")
    return None if r is None else r / 1e6
