"""Stream ms a step of the augmentation: the program's ``aug`` spans (the
batch's copy to the device and the step's augmentation) over the traced
steps."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["aug"])
