"""snp.device_ms_per_group: milliseconds the device is busy (kernels,
copies, memsets) a SNP decode group in the traced window. The cell's
rate is paced by the host (the device idles about half the window), so
this device-side number stands beside it as the steadier reading of
what a change to K3, the CNN or the copies saves."""


def read(ctx):
    if ctx["traffic"]["kind"] != "snp_stream" or ctx["trace"] is None \
            or not ctx["traced"]["sent"]:
        return None
    return 1e3 * ctx["trace"]["busy_s"] / len(ctx["traced"]["sent"])
