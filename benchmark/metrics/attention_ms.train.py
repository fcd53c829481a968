"""Stream ms a step of SegFormer's efficient self-attention: the program's
``attention`` spans, each a block's attention branch (LN1, q, the
spatial-reduction conv and its LayerNorm, kv, the fused attention, proj,
the drop path and the residual add, eager or replayed from its CUDA
graph), over the traced steps."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["attention"])
