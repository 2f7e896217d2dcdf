"""snp.copy_out_ms_per_group: milliseconds of the port's span snp.copy_out
a group in the traced window of the snp_stream cells: the copies of a
SNP group's probabilities back to the host in its finisher, where the
host waits for the device.

A traced reading, not the untraced wait: the profiler slows the
launches before it (snp.launch_ms_per_group reads high), so the host
reaches the copy-back with less of the device's work left, and this
reads a fraction of the untraced wait, by how much varies from run to
run. Read the two as a sum, which the profiler moves far less, and a
change to either against the untraced times in PERF.md."""

from nbench.program import span_ms_per_input


def read(ctx):
    return span_ms_per_input(ctx, "snp_stream", "snp.copy_out")
