"""snp.trunk_launches_per_group: launches of kernel K6, the SNP CNN's
convolutional trunk in one kernel, a group in the snp_stream cells (each
graph replay counts the launches its capture recorded; 8.0 for a group of
7 full 4,096-row slices and a tail): the port's counter k6.launches over
snp.groups. None on a port that counts no K6 launch."""

from nbench.program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "snp_stream", "k6.launches", "snp.groups")
