"""Host ms a step to enqueue it: the host time of the program's
``step.sac`` or ``step.abn`` spans over the traced steps."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["step.sac", "step.abn"], "host_ms")
