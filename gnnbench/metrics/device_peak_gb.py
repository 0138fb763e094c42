"""``torch.cuda.max_memory_allocated`` over the driver's set-up and the
window, in GB (1e9 bytes); the inputs' generation before set-up is not
counted (the peak is reset after it)."""

UNIT, LAYER, MOVES = "GB", "end to end", "device_peak_gb"


def read(ctx):
    w = ctx["window"]
    return None if not w else w["peak_bytes"] / 1e9
