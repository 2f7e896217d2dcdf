"""What the per-layer readers read of the program's own records: the
port's spans in the traced window (nanocaller_tpu_torch.runtime.metrics
`span`, which trace.reduce_events sums by name) and its counters
(`counters`, kept by the process over the whole run). Each gives None
where the run has nothing to read: another kind of work, no trace, or a
program that records no such span or counter (an older port)."""

from __future__ import annotations


def span_ms_per_input(ctx, kind, name):
    """Milliseconds of the program's span `name` in the traced window,
    over the inputs that window sent."""
    if ctx["traffic"]["kind"] != kind or ctx["trace"] is None \
            or not ctx["traced"]["sent"]:
        return None
    s = ctx["trace"]["spans"].get(name)
    if s is None:
        return None
    return 1e3 * s[1] / len(ctx["traced"]["sent"])


def counter_ratio(ctx, kind, num, den):
    """The program's counter `num` over its counter `den`, both counted
    by this process through warm-up and both windows (the ratio of a
    per-input count is the same in each), read in a traced run."""
    if ctx["traffic"]["kind"] != kind or ctx["trace"] is None:
        return None
    try:
        from nanocaller_tpu_torch.runtime.metrics import counters
    except ImportError:
        return None
    c = counters()
    if num not in c or not c.get(den):
        return None
    return c[num] / c[den]
