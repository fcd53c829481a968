"""Stream ms a step of SegFormer's Mix-FFN: the program's ``mix_ffn``
spans, each a block's FFN branch (LN2, fc1, the 3x3 depthwise conv, GELU,
fc2, the drop path and the residual add, eager or replayed from its CUDA
graph), over the traced steps."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["mix_ffn"])
