"""snp.blocking_copies_per_group: copies between host and device a SNP
group makes after which PyTorch makes the host wait for the device's
stream (made without non_blocking, from or to pageable memory), in the
snp_stream cells: the port's counter snp.blocking_copies over
snp.groups."""

from nbench.program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "snp_stream", "snp.blocking_copies",
                         "snp.groups")
