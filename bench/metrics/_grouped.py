"""What the two grouped-product roofline readers share."""
from bench.counts import model_flops, peaks


def routed(view, driver):
    """(slots routed to the held experts, client layers) of the traced
    call, from the range the driver's call names after them; None where
    the trace holds no such range."""
    tag = getattr(driver, "ROUTED", None)
    for name, _a, _b in view.host:
        words = name.split(" ")
        if tag and len(words) == 3 and words[0] == tag:
            return float(words[1]), int(words[2])
    return None


def roofline(ctx, kernel: str, products: str):
    """The launches of ``kernel`` in the traced call against the least time
    of ``model_flops.<products>`` grouped products over the call's routed
    slots; None without the kernel, the counters or the card's peaks."""
    view, driver = ctx["view"], ctx["driver"]
    times = view.kernels(kernel)
    counts = routed(view, driver)
    peak = peaks.of(ctx["device_kind"])
    if not times or counts is None or peak is None:
        return None
    slots, client_layers = counts
    n = getattr(model_flops, products)
    flops = model_flops.grouped_flops(ctx["config"], slots, n)
    nbytes = model_flops.grouped_bytes(ctx["config"], slots, n, client_layers)
    least_s = max(flops / peak[driver.FLOP_PEAK], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * least_s / (sum(times) / 1e6)
