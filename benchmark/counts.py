"""The algorithm's operations and bytes, counted once per cell on the
plain reference model over the meta device: no data, no kernel of the
port, no remat replay.  So the count is the same whatever implements it.

``Count`` is a dispatch mode that sees every ``aten`` call of a forward
or backward: for each convolution (and each of its backward's two
products) the FLOPs, ``2 * N * Cout * Ho * Wo * Cin/groups * kh * kw``,
and the bytes it must move at the least, each input read once and each
output written once in the tensors' own dtypes.  The convolutions are
the algorithm's FLOPs.  The reference's align-corners resizes are dense
products with interpolation matrices, an implementation's choice: the
resize itself needs two taps an output along each axis (under 0.01% of
the convolutions' FLOPs here), so no matrix product is counted; nor are
the elementwise passes (BN, ReLU, softmax, refine)."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def conv_flops(x_shape, w_shape, out_shape):
    """FLOPs of one convolution: a multiply and an add per tap of every
    output element."""
    n, _, *spatial = out_shape
    taps = 1
    for s in w_shape[1:]:
        taps *= s
    out = n * w_shape[0]
    for s in spatial:
        out *= s
    return 2 * out * taps


def _bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


class Count(TorchDispatchMode):
    """``convs``: (flops, bytes) of each convolution product."""

    def __init__(self):
        super().__init__()
        self.convs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        pkt = func.overloadpacket
        if pkt is aten.convolution:
            x, w, b = args[0], args[1], args[2]
            self.convs.append((conv_flops(x.shape, w.shape, out.shape),
                               _bytes(x, w, b, out)))
        elif pkt is aten.convolution_backward:
            gy, x, w = args[0], args[1], args[2]
            mask = args[-1]
            f = conv_flops(x.shape, w.shape, gy.shape)
            gx, gw, gb = out
            if mask[0]:     # grad_input: gy with w
                self.convs.append((f, _bytes(gy, w, gx)))
            if mask[1]:     # grad_weight: gy with x
                self.convs.append((f, _bytes(gy, x, gw, gb)))
        return out

    @property
    def flops(self):
        return sum(f for f, _ in self.convs)

    def conv_min_s(self, peak_flops, peak_bytes):
        """The least time of the convolutions on a card of these peaks:
        each product bound by its FLOPs or its bytes, whichever takes
        longer."""
        return sum(max(f / peak_flops, b / peak_bytes) for f, b in self.convs)
