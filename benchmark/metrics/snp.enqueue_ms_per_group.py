"""snp.enqueue_ms_per_group: host milliseconds of one SNP group's
infer_snp_group(..., async_mode=True) call (pileup_cohorts, the payload's
copies, K3's launch and the CNN's launches), the mean over the measured
window (not the traced one, so the profiler adds nothing)."""


def read(ctx):
    if ctx["traffic"]["kind"] != "snp_stream" or not ctx["main"]["host_s"]:
        return None
    h = ctx["main"]["host_s"]
    return 1e3 * sum(h) / len(h)
