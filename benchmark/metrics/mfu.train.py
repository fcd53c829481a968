"""The whole train step's share of the card's dense bf16 peak: the plain
count's FLOPs a step (forwards and backwards as the algorithm needs
them, no replay) times the window's steps a second."""


def read(r):
    return 100.0 * r.flops_per_unit * r.units_per_s / r.peak_flops
