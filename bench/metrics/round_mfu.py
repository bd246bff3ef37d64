"""The round's model operations (``bench.counts.cnn_flops``) over the
untraced round time, as a share of the card's fp32 peak, in % (the fleet
runs in full fp32: TF32 off)."""
from bench.counts import peaks
from bench.counts.cnn_flops import round_flops


def read(ctx):
    peak = peaks.of(ctx["device_kind"])
    if peak is None:
        return None
    flops = round_flops(ctx["config"], ctx["traffic"])
    return 100.0 * flops / ctx["untraced_round_s"] / peak["fp32_flop_per_s"]
