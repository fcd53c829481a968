"""Host ms a frame to enqueue the inference call: the host time of the
program's ``infer`` spans over the traced frames."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["infer"], "host_ms")
