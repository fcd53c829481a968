"""The whole inference call's share of the card's dense bf16 peak: the
plain count's FLOPs a frame (every scale and its mirror) times the
window's frames a second."""


def read(r):
    return 100.0 * r.flops_per_unit * r.units_per_s / r.peak_flops
