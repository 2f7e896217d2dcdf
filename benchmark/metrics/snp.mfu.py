"""snp.mfu: % of the device's float32 peak (TF32 is off) that the
snp CNN's FLOPs (work.cnn_flops of the configuration's snp_cnn, for
every unit finished) make over the traced window: the whole step's share,
which bounds what any one kernel on the path can claim."""

from nbench.readers import mfu


def read(ctx):
    return mfu(ctx, "snp_stream", "snp_cnn")
