"""What the per-layer readers (benchmark/metrics/<name>.py) share: each
reads one number from a run's context, or None where the run has
nothing to read (another kind of work, no trace, a device without a
table of peaks, or a trace that does not hold what the count expects).

The context (harness.run): cfg and traffic (the cell's files), kind (the
kind of work, benchmark/kinds/<kind>.py), main (the measured window: units,
window_s, sent, host_s), traced and trace (the traced window and its
reduction, trace.py), peaks (work.PEAKS of the device), need (the
reference's counts of each checked input), work (work.py), notes (lines
for standard error).
"""

from __future__ import annotations


def _traced(ctx, kind):
    return ctx["traffic"]["kind"] == kind and ctx["trace"] is not None


def idle_share(ctx, kind):
    """% of the traced window in which nothing ran on the device."""
    if not _traced(ctx, kind):
        return None
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def copies_share(ctx, kind):
    """% of the device's busy time spent in host-to-device and
    device-to-host copies."""
    if not _traced(ctx, kind) or ctx["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * ctx["trace"]["copies_s"] / ctx["trace"]["busy_s"]


def mfu(ctx, kind, cnn):
    """% of the device's float32 peak that the CNN's FLOPs of every unit
    finished in the traced window make over that window."""
    if not _traced(ctx, kind) or ctx["peaks"] is None:
        return None
    flops = ctx["work"].cnn_flops(ctx["cfg"][cnn]) * ctx["traced"]["units"]
    return 100.0 * flops / (ctx["trace"]["window_s"]
                            * ctx["peaks"]["fp32_flops_per_s"])
