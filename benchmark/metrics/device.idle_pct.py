"""100 x (1 - busy / window) over the profiled calls: busy is the union of
the device operations' intervals (`torch.profiler`, CUDA activity) inside
the traced window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
