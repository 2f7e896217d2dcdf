"""copies.share.snp: % of the device's busy time in the traced window
of the snp_stream cells that host-to-device and device-to-host copies
took."""

from nbench.readers import copies_share


def read(ctx):
    return copies_share(ctx, "snp_stream")
