"""MB a step of interpolation matrices built on the host and copied to
the device by the resize (``nn.functional.HOST_MATRICES``)."""

from benchmark.program_spans import host_matrix_mb_per_unit


def read(r):
    return host_matrix_mb_per_unit(r)
