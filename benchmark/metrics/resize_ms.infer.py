"""Stream ms a frame of the align-corners resizes: the program's
``resize`` spans (the matrices built on the host, copied, and the two
products) over the traced frames."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["resize"])
