"""snp.launch_ms_per_group: milliseconds of the port's span snp.launch a
group in the traced window of the snp_stream cells: queueing a SNP
group's K3 launch and the SNP CNN's forwards (the host's time to launch
them, not the device's).

A traced reading, not the untraced one: the profiler slows each of the
group's ~105 runtime calls, so this reads above the host-clock time of
an untraced run, and snp.copy_out_ms_per_group reads low by about as
much (the host reaches the copy-back later, with less of the device's
work left). Read the two as a sum, which the profiler moves far less,
and a change to either against the untraced times in PERF.md."""

from nbench.program import span_ms_per_input


def read(ctx):
    return span_ms_per_input(ctx, "snp_stream", "snp.launch")
