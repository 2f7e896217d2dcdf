"""snp.cnn_graph_replays_per_group: full slices of the SNP CNN a group
runs as a replay of a captured CUDA graph (one runtime call in place of
the eager forward's ~73), in the snp_stream cells: the port's counter
snp.cnn_graph_replays over snp.groups. None on a port that counts no
such replays."""

from nbench.program import counter_ratio


def read(ctx):
    return counter_ratio(ctx, "snp_stream", "snp.cnn_graph_replays",
                         "snp.groups")
