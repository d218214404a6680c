"""Device operations (kernels, copies, sets) in the traced window over the
calls in it."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops or not t.calls:
        return None
    return len(t.device_ops) / t.calls
