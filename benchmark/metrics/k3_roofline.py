"""k3_roofline: % of its roofline that kernel K3 (csrc/snp_pileup.cu)
reaches in the traced window: the least time its launches need (the
larger of their bytes over the HBM rate and their int32 operations over
the int32 rate, work.k3_bytes / work.k3_ops from the reference's counts)
over the time its launches took on the device. Which of the two bounds
it goes to standard error."""


def read(ctx):
    if ctx["traffic"]["kind"] != "snp_stream" or ctx["trace"] is None \
            or ctx["peaks"] is None:
        return None
    from nbench.trace import kernel_seconds

    work, kind = ctx["work"], ctx["kind"]
    least, by_bytes, launches = 0.0, 0.0, 0
    for k in ctx["traced"]["sent"]:
        if k not in ctx["need"]:
            return None
        for nbytes, ops in kind.k3_launches(k, ctx["need"][k]):
            t, by = work.bound_s(ctx["peaks"], nbytes=nbytes, ops=ops)
            least += t
            by_bytes += t if by == "bytes" else 0.0
            launches += 1
    n, seconds = kernel_seconds(ctx["trace"], "snp_pileup_kernel")
    if n != launches or seconds <= 0:
        return None
    ctx["notes"].append("k3_roofline: %d launches, %.6f s on the device, "
                        "least %.6f s, %.0f%% of it bound by bytes"
                        % (n, seconds, least, 100 * by_bytes / least))
    return 100.0 * least / seconds
