"""The benchmark's plain reference codec: frozen numpy copies of the
program's spec codec and the format modules it needs.

It imports numpy and its own modules only, never the program, and makes
the reference `.nice` bytes and pixels from the same inputs that the
program is given.  `worker` runs it in plain subprocesses, one job each,
so that its slow Python loops spread over the host's cores.
"""
