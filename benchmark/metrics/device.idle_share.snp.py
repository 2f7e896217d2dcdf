"""device.idle_share.snp: % of the traced window of the snp_stream cells in
which no kernel, copy or memset ran on the device."""

from nbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "snp_stream")
