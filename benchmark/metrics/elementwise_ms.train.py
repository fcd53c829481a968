"""Device ms a step in the elementwise kernel-name group (BN's
multiply-add, ReLU and their backward, the augmentation, SGD), from the
trace."""


def read(r):
    s = r.trace.by_group.get("elementwise")
    return None if s is None else 1e3 * s / r.trace.units
