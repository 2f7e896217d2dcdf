"""snp.async_copy_backs_per_group: copies of probabilities back to the
host a SNP group queues on the device's stream, behind its CNN and with
an event of their own that the finisher waits on (one a part), in the
snp_stream cells: the port's counter snp.async_copy_backs over
snp.groups. None on a port that counts no such copies."""

from nbench.program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "snp_stream", "snp.async_copy_backs",
                         "snp.groups")
