"""Content generators, one module a kind, found by the `content.kind` of a
configuration file.  Each has `corpus_names(content) -> names` and
`make(config, seed, corpus) -> list of (H, W, C) uint8 images` (the pool).
"""
