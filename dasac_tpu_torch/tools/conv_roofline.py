"""Conv roofline for the flagship step (counterpart of
``dasac_tpu/tools/conv_roofline.py``): cuDNN's achieved TF/s on each
dominant conv shape of DeepLabv2/ResNet-101 at 512x1024 (forward +
both backward convs, bf16, NHWC: ``channels_last``), and the conv-bound
step-time floor those speeds give.

Each row: one conv shape (``flagship_convs``, ``dasac_tpu``'s table and
per-step multiplicities), its forward GFLOP an image, the measured TF/s of
forward + data grad + weight grad (median of ``--iters`` runs between CUDA
events, after a warm-up), its share of the card's dense bf16 tensor-core
peak, and the implied ms a step.  The last line: the sum of those ms, the
step's conv TFLOP and the img/s it would allow if everything else were
free.  Every line is a JSON object with the card's name and power limit.

The peak comes from the card's name (``tools/bench.py``'s table: NVIDIA's
data sheets, dense, without sparsity): H100 SXM 989.4 TF/s, H100 NVL
835.5, H100 PCIe 756.5; ``--peak-tf`` overrides it (and gives one to a
card or CPU not in the table, which otherwise gets no share).

    python -m dasac_tpu_torch.tools.conv_roofline [--batch 16] [--iters 10]
"""

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.tools import bench, flagship


# (name, spatial_hw, cin, cout, ksize, dilation, per_step_multiplicity)
# multiplicity: how many times this conv shape runs per SAC step counting
# student fwd+bwd (3x flops) over 16 images and teacher fwd (1x) over 8
# views — expressed as "equivalent forward passes at batch B".
def flagship_convs():
    hw4 = (128, 256)   # /4
    hw8 = (64, 128)    # /8
    convs = []
    # stem (B,512,1024,3)->(B,256,512,64): 7x7/2
    convs.append(("stem7x7s2", (256, 512), 3, 64, 7, 1, 1))
    # layer1 @ /4: 3 blocks (64,64,256), in 64/256
    convs.append(("l1_1x1a", hw4, 256, 64, 1, 1, 3))
    convs.append(("l1_3x3", hw4, 64, 64, 3, 1, 3))
    convs.append(("l1_1x1b", hw4, 64, 256, 1, 1, 3))
    # layer2 @ /8 (stride-2 edge shapes folded in): 4 blocks (128,128,512)
    convs.append(("l2_1x1a", hw8, 512, 128, 1, 1, 4))
    convs.append(("l2_3x3", hw8, 128, 128, 3, 1, 4))
    convs.append(("l2_1x1b", hw8, 128, 512, 1, 1, 4))
    # layer3 @ /8 d=2: 23 blocks (256,256,1024)
    convs.append(("l3_1x1a", hw8, 1024, 256, 1, 1, 23))
    convs.append(("l3_3x3d2", hw8, 256, 256, 3, 2, 23))
    convs.append(("l3_1x1b", hw8, 256, 1024, 1, 1, 23))
    # layer4 @ /8 d=4: 3 blocks (512,512,2048)
    convs.append(("l4_1x1a", hw8, 2048, 512, 1, 1, 3))
    convs.append(("l4_3x3d4", hw8, 512, 512, 3, 4, 3))
    convs.append(("l4_1x1b", hw8, 512, 2048, 1, 1, 3))
    # ASPP: 4x 3x3 dilated 2048 -> 19
    convs.append(("aspp3x3", hw8, 2048, 19, 3, 6, 4))
    return convs


def peak_tf(card, override=None):
    """The dense bf16 peak (TF/s) of ``card`` (its ``nvidia-smi`` name),
    ``override`` when given, else None for a card not in the table."""
    if override is not None:
        return override
    return next((tf for key, tf in bench.BF16_PEAK_TF if key in card), None)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16,
                    help="images per step (8 source + 8 target views)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--peak-tf", type=float, default=None,
                    help="dense bf16 peak, TF/s (default: from the card's "
                         "name)")
    return ap.parse_args(argv)


def conv_case(batch, hw, cin, cout, ks, d, device, gen):
    """``run()``: forward + data grad + weight grad of one bf16 conv on
    NHWC (``channels_last``) tensors, SAME padding, stride 1, drawn on
    ``device`` from ``gen`` (drawn on the host, the table's 2.2e9 values
    took most of the tool's run)."""
    cl = torch.channels_last

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                ).to(torch.bfloat16).contiguous(memory_format=cl)

    x = rand(batch, cin, *hw, scale=0.1).requires_grad_()
    w = rand(cout, cin, ks, ks, scale=1 / np.sqrt(ks * ks * cin))
    w.requires_grad_()
    gy = rand(batch, cout, *hw)
    pad = (ks // 2) * d

    def run():
        y = F.conv2d(x, w, padding=pad, dilation=d)
        return torch.autograd.grad(y, (x, w), gy)

    return run


def main(argv=None, device=None):
    """Print one JSON line a shape and the floor; returns ``{"rows",
    "floor"}``.  ``device`` defaults to CUDA (raises when there is
    none)."""
    args = parse_args(argv)
    device = resolve_device(device)
    autotune_convolutions(device)
    card = flagship.device_label(device)
    peak = peak_tf(card, args.peak_tf)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, total_flops, total_ms = [], 0.0, 0.0
    for name, hw, cin, cout, ks, d, mult in flagship_convs():
        run = conv_case(args.batch, hw, cin, cout, ks, d, device, gen)
        ms = flagship.median_ms(run, device, args.iters)
        # fwd + both grads = 3 conv applications
        fl = 3 * 2 * args.batch * hw[0] * hw[1] * ks * ks * cin * cout
        tf = fl / (ms * 1e-3) / 1e12
        # per step: student fwd+bwd (the measured 3x) * mult, plus teacher
        # fwd (1x of 8 views = 1/6 of the 3x16) folded in as a 9/8 scale
        step_fl = fl * mult * 9.0 / 8.0
        step_ms = step_fl / (tf * 1e12) * 1e3
        total_flops += step_fl
        total_ms += step_ms
        rows.append(dict(conv=name, gf_per_img=fl / 3 / args.batch / 1e9,
                         ms=ms, tf_s=tf,
                         share_of_peak=tf / peak if peak else None,
                         mult=mult, ms_per_step=step_ms, card=card))
        print(json.dumps(rows[-1]), flush=True)
    floor = dict(conv_bound_floor_ms=total_ms, tf_per_step=total_flops / 1e12,
                 max_img_s=args.batch / 2 / (total_ms / 1e3),
                 peak_tf=peak, batch=args.batch, card=card)
    print(json.dumps(floor), flush=True)
    return {"rows": rows, "floor": floor}


if __name__ == "__main__":
    main()
