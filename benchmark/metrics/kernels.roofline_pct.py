"""The least time the card could take for the profiled calls' work, over
the device's busy time, in %.  The least time is the least bytes that the
work must move (the call module's `work_bytes`, counted from the images and
the `.nice` bytes, never from the program's tensors) over the card's
published memory bandwidth (`peaks.json`).  Whatever kernels do the work,
the bytes stay the same, so this cannot pass 100 %."""


def read(ctx):
    t = ctx.trace
    card = ctx.peaks.get("cards", {}).get(ctx.card)
    if t is None or not t.device_ops or t.busy_s <= 0 or card is None:
        return None
    return 100.0 * t.work_bytes / card["hbm_bytes_per_s"] / t.busy_s
