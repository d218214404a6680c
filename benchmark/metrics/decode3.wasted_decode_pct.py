"""Images that the fused round trip decoded on the device although their
encode had overflowed, over the images of the window's calls, in %: the
program's `stats["overflow_decoded"]`.  Such a decode proves nothing; the
host codec encodes and proves the image."""


def read(ctx):
    if "overflow_decoded" not in ctx.stats or not ctx.images:
        return None
    return 100.0 * ctx.stats["overflow_decoded"] / ctx.images
