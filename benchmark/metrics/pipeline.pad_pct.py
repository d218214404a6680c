"""The pixels the round trip's device batches held past their images, over
the images' pixels, in %: the program's `stats`, 100 x ("batch_pixels" -
"image_pixels") / "image_pixels", which `api.roundtrip_batch` counts (a
batch holds B times its largest image's pixels).  None where the program
counts neither."""


def read(ctx):
    held, pixels = ctx.stats.get("batch_pixels"), ctx.stats.get("image_pixels")
    if held is None or not pixels:
        return None
    return 100.0 * (held - pixels) / pixels
