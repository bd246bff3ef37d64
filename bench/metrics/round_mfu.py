"""The round's model operations (the cell's driver's ``round_flops``) over
the untraced round time, as a share of the card's peak at the precision
the configuration states (the driver's ``FLOP_PEAK``), in %. None where
the driver counts no operations or the card is not in ``peaks.json``."""
from bench.counts import peaks


def read(ctx):
    driver, peak = ctx["driver"], peaks.of(ctx["device_kind"])
    round_flops = getattr(driver, "round_flops", None)
    if round_flops is None or peak is None:
        return None
    flops = round_flops(ctx["config"], ctx["traffic"])
    return 100.0 * flops / ctx["untraced_round_s"] / peak[driver.FLOP_PEAK]
