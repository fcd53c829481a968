"""Stream ms a step of SegFormer's All-MLP decode head: the program's
``decode_head`` spans (the four Linear embeddings, their half-pixel
upsamples, the concat, linear_fuse, the channel dropout and linear_pred,
in each forward) over the traced steps."""

from benchmark.program_spans import ms_per_unit


def read(r):
    return ms_per_unit(r, ["decode_head"])
