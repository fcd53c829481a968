"""The benchmark's inputs, all made on the device from the run's seed: the
model's starting weights, and pools of uint8 frames and label maps at the
loader's sizes.  Both sides of the correctness check are handed the same
tensors: the reference asks for them again from the same seed.

A seed is any whole number; each use takes its own 63-bit stream of it,
so the weights, the pools and the step's generator do not overlap."""

import hashlib

import torch

IGNORE = 255


def stream(seed, name):
    """A 63-bit seed for the use ``name`` of the run's ``seed``."""
    digest = hashlib.sha256(("%d:%s" % (seed, name)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed, name, device):
    """A ``torch.Generator`` on ``device`` seeded for ``name``."""
    return torch.Generator(device=device).manual_seed(stream(seed, name))


def make_weights(spec, shapes, seed, device):
    """A state dict from ``spec`` (``reference.layers.init_spec``) and
    ``shapes`` (name -> (shape, dtype)): every ``("normal", std)`` entry
    cut from one standard-normal draw on ``device`` and scaled, the rest
    constants; float32 except the integer counters."""
    g = generator(seed, "weights", device)
    normal = [k for k in shapes if spec[k][0] == "normal"]
    flat = torch.randn(sum(_numel(shapes[k][0]) for k in normal),
                       generator=g, device=device)
    out, at = {}, 0
    for k, (shape, dtype) in shapes.items():
        kind = spec[k]
        if kind[0] == "normal":
            n = _numel(shape)
            out[k] = flat[at:at + n].view(shape).mul_(kind[1])
            at += n
        elif kind[0] == "ones":
            out[k] = torch.ones(shape, dtype=dtype, device=device)
        elif kind[0] == "const":
            out[k] = torch.full(shape, kind[1], dtype=dtype, device=device)
        else:
            out[k] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def frames(g, n, hw, device):
    """``n`` uint8 RGB frames [n, H, W, 3] of uniform noise."""
    return torch.randint(0, 256, (n, *hw, 3), generator=g, device=device,
                         dtype=torch.uint8)


def label_maps(g, n, hw, num_classes, device, block=16, ignore=0.05,
               classes_per_frame=None):
    """``n`` uint8 label maps [n, H, W]: a class a ``block`` x ``block``
    tile, a share ``ignore`` of the tiles set to 255.  With
    ``classes_per_frame`` each frame's tiles take only that many classes,
    drawn for the frame, so frames differ in their mix as scenes do."""
    bh, bw = -(-hw[0] // block), -(-hw[1] // block)
    if classes_per_frame is None:
        tiles = torch.randint(0, num_classes, (n, bh, bw), generator=g,
                              device=device, dtype=torch.uint8)
    else:
        mix = torch.stack([torch.randperm(num_classes, generator=g,
                                          device=device)[:classes_per_frame]
                           for _ in range(n)])
        pick = torch.randint(0, classes_per_frame, (n, bh * bw),
                             generator=g, device=device)
        tiles = mix.gather(1, pick).view(n, bh, bw).to(torch.uint8)
    drop = torch.rand((n, bh, bw), generator=g, device=device) < ignore
    tiles = torch.where(drop, IGNORE, tiles).to(torch.uint8)
    full = tiles.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return full[:, :hw[0], :hw[1]].contiguous()


def train_pool(seed, traffic, num_classes, device):
    """``traffic["pool"]`` batches ``(src_images, src_labels, tgt_images,
    tgt_labels)`` at the loader's sizes; every frame differs.  The
    traffic's ``classes_per_frame`` (if any) sets each label map's mix."""
    g = generator(seed, "pool", device)
    src, tgt = traffic["source"], traffic["target"]
    k = traffic.get("classes_per_frame")
    out = []
    for _ in range(traffic["pool"]):
        out.append((frames(g, src["frames"], src["hw"], device),
                    label_maps(g, src["frames"], src["hw"], num_classes,
                               device, classes_per_frame=k),
                    frames(g, tgt["frames"], tgt["hw"], device),
                    label_maps(g, tgt["frames"], tgt["hw"], num_classes,
                               device, classes_per_frame=k)))
    return out


def infer_pool(seed, traffic, device):
    """``traffic["pool"]`` frames [1, H, W, 3], each a request's input."""
    g = generator(seed, "pool", device)
    return [frames(g, 1, traffic["hw"], device)
            for _ in range(traffic["pool"])]
