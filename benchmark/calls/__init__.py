"""The calls a traffic mix drives, one module a call, found by the traffic
file's "call".  Each module has:

    prepare(pool, root) -> inputs          one input a pool image, made
                                           before the window (set-up)
    Program(device, pool)                  the system under test:
        .call(inputs, stats) -> answers    the untraced window's call, one
                                           answer an image
        .traced(inputs, stats, marks)      the traced run's call, one level
                                           down where only that level
                                           takes `marks`
        .watch(items)                      optional: the pool items of the
                                           next call where the harness keeps
                                           its answers for the check, else
                                           None
        .resident_bytes                    optional: device bytes that the
                                           benchmark's own check holds
                                           through the window
    SPANS                                  (module, attribute) pairs that a
                                           traced run wraps in spans
    raw_bytes(image) -> int                raw RGB8 bytes of one image
    work_bytes(image, input, answer) -> int   the least bytes the work of
                                           one image must move
    digest(answer)                         what the harness keeps of a
                                           sampled answer, in the window
    expected(pool, inputs, items, root) -> {item: ...}   what a right
                                           answer's digest holds, from the
                                           reference, after the window
    control(pool, inputs, items, root) -> {item: answer}   the control's
                                           answers: the reference with the
                                           lossless guarantee broken
    wrong(digest, expected) -> bool
"""
