"""Benchmark: SAC adaptation-training throughput on one GPU (counterpart of
the root ``bench.py``).

Measures the flagship configuration (``deeplabv2_resnet101_train.yaml``
semantics, ``tools/flagship.py``): DeepLabv2/ResNet-101 in bf16 with
random weights from seed 0, 512x1024 crops, 8 source images + 2 groups x 4
target views a step, device-side augmentation: the whole step with the
teacher forward, the refinement, the pseudo-labels, both backwards and the
optimizer.  The defaults are ``bench.py``'s: no remat, the refine chain in
bf16 at stride 8, the plain log-softmax CE (``--ce-impl xla``; ``pallas``
runs the CUDA CE kernels, the port's ``ce_impl="kernel"``).

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline", ...}``
with ``bench.py``'s keys for each ``--mode``, the card's name and power
limit (``card``) and the CE kernels' launches by path over the timed steps
(``ce_launches``; 0 on the CPU, where the plain version runs).

``value`` follows the reference's own counter (train.py:314: images/sec =
iterations * TRAIN.BATCH_SIZE / elapsed, source images only).

The other keys:
  * ``step_flops_tf``, ``mfu``: the FLOPs of one step over its time and the
    card's dense bf16 peak; ``step_hbm_gb``, ``hbm_util``: its bytes over
    its time and the card's memory rate (:func:`count_cost`; the peaks by
    card name, NVIDIA's data sheets; ``mfu`` and ``hbm_util`` are left out
    for a card or CPU not in the table);
  * ``end_to_end_images_per_sec``: the same step fed by the host input
    pipeline (PNG decode of GTA- and Cityscapes-sized frames through the
    C++ decoder, prefetch overlap, the copy to the card);
  * ``h2d_mb_s``: host-to-device rate of a pageable 64 MB copy;
  * ``input_images_per_sec_{decode,packed}``: the source loader alone, PNG
    decode against reads from a pack (``tools/pack_dataset.py``).

``vs_baseline``: the reference publishes no throughput (BASELINE.md).  Its
4x Titan-X (Pascal, ~11 fp32 TFLOP/s each) adaptation run is estimated at
~1.5 img/s per GPU; ``vs_baseline`` = ours / 1.5.

``main(argv, device="cpu")`` runs it on the CPU (tests, with ``--arch
tiny --hw 32 64`` or a shallow model); without a device it needs a card.

    python -m dasac_tpu_torch.tools.bench [--mode step] [--ce-impl pallas]
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from dasac_tpu_torch.core.device import autotune_convolutions, resolve_device
from dasac_tpu_torch.ops import ce
from dasac_tpu_torch.tools import flagship, op_traffic
from dasac_tpu_torch.train import steps

REF_IMAGES_PER_SEC_PER_GPU = 1.5  # documented estimate, see module docstring

INFER_HW = (1024, 2048)   # one Cityscapes-native frame
SRC_SPLIT, TGT_SPLIT = "train_game_9K", "train_cityscapes"
# the synthetic corpus of ``corpus``: GTA- and Cityscapes-native sizes
CORPUS = dict(n_train_src=12, n_train_tgt=6, n_val=1, src_hw=(1052, 1914),
              tgt_hw=(1024, 2048), val_hw=(64, 64))

# dense (no sparsity) bf16 tensor-core peak, TF/s, and memory rate, TB/s,
# by product (NVIDIA data sheets); the first key the card's name contains
# wins
BF16_PEAK_TF = (("H100 PCIe", 756.5), ("H100 NVL", 835.5), ("H100", 989.4))
HBM_PEAK_TB_S = (("H100 PCIe", 2.0), ("H100 NVL", 3.9), ("H100", 3.35))


def _by_name(table, card):
    return next((v for key, v in table if key in card), None)


def bf16_peak_flops(card):
    """Dense bf16 FLOP/s of ``card`` (its ``nvidia-smi`` name), None for a
    card or CPU not in the table."""
    tf = _by_name(BF16_PEAK_TF, card)
    return None if tf is None else tf * 1e12


def hbm_peak_bw(card):
    """Memory bytes/s of ``card``, None for a card or CPU not in the
    table."""
    tb = _by_name(HBM_PEAK_TB_S, card)
    return None if tb is None else tb * 1e12


def count_cost(fn):
    """Run ``fn()`` once and count its cost: ``(flops, bytes, flops_by_op)``.

    FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the call as it
    runs, remat replays included (XLA's ``flops`` costs the compiled
    program, rematerialized ops included).  It counts convolutions and
    matrix products, forward and backward; unlike XLA's count it leaves out
    elementwise ops and reductions, and the CUDA CE kernels (launched
    through ``ctypes``, out of the dispatcher's sight: ~1e9 FLOP a
    flagship step against ~4e13).  ``flops_by_op``: ``conv`` and
    ``matmul`` (the resize matrices, ``nn/functional.py``).

    Bytes: ``tools/op_traffic.py``'s ``Traffic``, each op's tensor inputs
    read and its outputs written, the CE kernels' own rows added; XLA's
    ``bytes accessed`` means the same (operands plus outputs, no cache
    credit), over an eager program that fuses nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        traffic = op_traffic.record(fn)
    by_op = {}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        key = "conv" if "convolution" in str(op) else "matmul"
        by_op[key] = by_op.get(key, 0) + n
    return counter.get_total_flops(), sum(traffic.totals()), by_op


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _paths():
    return {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}


def _paths_since(paths0):
    """The CE launches by kernel and path since ``paths0``."""
    return {k: {p: n - paths0[k][p] for p, n in v.items()}
            for k, v in ce.PATH_LAUNCHES.items()}


def step_config(args):
    """The step config of ``args`` (``bench.py``'s ``_build``): the CE
    route through ``train/steps.py``'s ``TPU.CE_IMPL`` map."""
    if args.resize_method != "matmul":
        raise ValueError(
            "--resize-method %s: the port has one bilinear resize, the "
            "interpolation-matrix products (nn/functional.py), which is "
            "bench.py's matmul; it has no gather formulation"
            % args.resize_method)
    if args.ckpt_loss:
        raise ValueError(
            "--ckpt-loss: the port does not rematerialize the CE maps "
            "(train/steps.py does not read TPU.CKPT_LOSS; the kernel CE "
            "keeps no log-softmax residual)")
    return flagship.step_config(
        args, args.refine_dtype, args.refine_res,
        ce_impl=steps._CE_IMPLS[args.ce_impl], loss_dtype=args.loss_dtype)


def build(args, device):
    """``(state, scfg, step)``: ``args.arch`` in bf16 under ``--remat``,
    random weights from seed 0, SGD with ``bench.py``'s MODEL section, and
    the SAC step of :func:`step_config`."""
    scfg = step_config(args)
    state = flagship.build_state(args, device, remat=args.remat)
    return state, scfg, steps.make_sac_step(scfg, device=device)


def device_batch(args, device):
    """uint8 noise frames and labels from ``RandomState(0)``, on
    ``device``."""
    return flagship.random_batch(args, device, np.random.RandomState(0))


def bench_step(args, state, step, device):
    """Device-resident batch: 3 warm-up steps, then ``args.iters`` steps on
    the host clock up to a synchronize; then one more step, untimed, whose
    cost :func:`count_cost` counts.  Returns ``(seconds a step, flops,
    bytes, flops_by_op, CE launches of the timed steps)``."""
    gen = torch.Generator(device=device).manual_seed(0)
    batch = device_batch(args, device)
    for _ in range(3):
        step(state, batch, gen)
    _sync(device)
    paths0 = _paths()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step(state, batch, gen)
    _sync(device)
    dt = (time.perf_counter() - t0) / args.iters
    launches = _paths_since(paths0)
    flops, nbytes, by_op = count_cost(lambda: step(state, batch, gen))
    _sync(device)
    return dt, flops, nbytes, by_op, launches


def bench_h2d(device, n_mb=64):
    """MB/s of one pageable ``n_mb`` MB copy from a numpy array to
    ``device``, synchronized (what ``jnp.asarray`` measures)."""
    x = np.random.randint(0, 255, (n_mb, 1 << 20), np.uint8)
    torch.from_numpy(x[:1]).to(device, copy=True)   # warm the path
    _sync(device)
    t0 = time.perf_counter()
    torch.from_numpy(x).to(device, copy=True)
    _sync(device)
    return n_mb / (time.perf_counter() - t0)


def corpus(root=None):
    """The synthetic GTA- and Cityscapes-native-size PNG corpus of
    ``CORPUS`` at ``root`` (default: under the temporary directory),
    written by the port's encoder unless a complete one with the same
    parameters is there; returns ``root``."""
    from dasac_tpu_torch.data.synth import make_synthetic_root

    root = root or os.path.join(tempfile.gettempdir(),
                                "dasac_tpu_torch_bench_corpus")
    # the marker records the generation parameters: a corpus written with
    # other sizes or counts is written anew, not reused
    stamp = json.dumps(CORPUS, sort_keys=True)
    marker = os.path.join(root, ".complete")
    done = False
    if os.path.isfile(marker):
        with open(marker) as f:
            done = f.read() == stamp
    if not done:
        shutil.rmtree(root, ignore_errors=True)
        make_synthetic_root(root, **CORPUS)
        with open(marker, "w") as f:
            f.write(stamp)
    return root


def _index_fn(batch, n):
    return lambda bi: [(bi * batch + k) % n for k in range(batch)]


def _packed_source(root, split, hw):
    """The pack of ``split`` at ``hw`` under ``root``, written if absent."""
    from dasac_tpu_torch.data import packed as packed_mod
    from dasac_tpu_torch.tools.pack_dataset import pack_split

    pdir = packed_mod.default_dir(root)
    if packed_mod.find_pack(pdir, split, hw, "resize") is None:
        pack_split(root, split, size=hw, verbose=False)
    return packed_mod.PackedDataset(
        packed_mod.find_pack(pdir, split, hw, "resize"))


def bench_end_to_end(args, state, step, device, root, packed=False):
    """The same step driven by the host pipeline: PNG decode at the
    datasets' native sizes (or reads from an offline pack when
    ``packed``), prefetch overlap, the copy to the card, the step; 2
    warm-up steps, then ``args.iters``.  Returns ``(seconds a step, CE
    launches of the timed steps)``."""
    from dasac_tpu_torch.data import host_loader, lists

    src_imgs, src_msks = lists.read_split(root, SRC_SPLIT)
    tgt_imgs, tgt_msks = lists.read_split(root, TGT_SPLIT)
    hw = tuple(args.hw)
    if packed:
        source = _packed_source(root, SRC_SPLIT, lists.canonical_size(
            SRC_SPLIT))
        target = _packed_source(root, TGT_SPLIT, hw)
    else:
        source = host_loader.SegDataset(
            src_imgs, src_msks, lists.canonical_size(SRC_SPLIT),
            mode="resize")
        # SAC target groups decode straight at CROP_SIZE (factory.py)
        target = host_loader.SegDataset(tgt_imgs, tgt_msks, hw, mode="resize")

    warm, total = 2, 2 + args.iters
    src_loader = host_loader.PrefetchLoader(
        source, args.batch, total, _index_fn(args.batch, len(src_imgs)),
        threads=1, prefetch=2)
    tgt_loader = host_loader.PrefetchLoader(
        target, args.groups, total, _index_fn(args.groups, len(tgt_imgs)),
        threads=1, prefetch=2)

    gen = torch.Generator(device=device).manual_seed(0)
    t0, paths0 = None, None
    for bi, ((si, sl), (ti, tl)) in enumerate(zip(src_loader, tgt_loader)):
        step(state, (si, sl, ti, tl), gen)
        if bi + 1 == warm:
            _sync(device)
            t0, paths0 = time.perf_counter(), _paths()
    _sync(device)
    return (time.perf_counter() - t0) / args.iters, _paths_since(paths0)


def bench_inference(args, device, iters=10):
    """Full-resolution inference on one GPU: ``args.arch`` in bf16, one
    ``INFER_HW`` frame, single scale, the probability volume
    (``infer/engine.make_infer_fn``: the reference's ``infer_val.py``
    workload, which it never measured).  Returns img/s."""
    from dasac_tpu_torch.infer.engine import make_infer_fn
    from dasac_tpu_torch.nn.factory import build_model

    model = build_model(args.arch, flagship.C, dtype=torch.bfloat16,
                        device=device,
                        generator=torch.Generator().manual_seed(0))
    fn = make_infer_fn(model, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                       device=device)
    x = torch.from_numpy((np.random.RandomState(0).rand(
        1, *INFER_HW, 3) * 255).astype(np.uint8)).to(device)
    fn(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    _sync(device)
    return iters / (time.perf_counter() - t0)


def bench_input_pipeline(args, root, iters=8):
    """Host-only source-loader img/s at the GTA-native decode shape: PNG
    decode through the C++ decoder against reads from a pack; prefetch 1,
    so the rate is the loader's production rate."""
    from dasac_tpu_torch.data import host_loader, lists

    src_hw = lists.canonical_size(SRC_SPLIT)
    imgs, msks = lists.read_split(root, SRC_SPLIT)
    decode_ds = host_loader.SegDataset(imgs, msks, src_hw, mode="resize")
    packed_ds = _packed_source(root, SRC_SPLIT, src_hw)
    rates = []
    for ds in (decode_ds, packed_ds):
        loader = host_loader.PrefetchLoader(
            ds, args.batch, 1 + iters, _index_fn(args.batch, len(imgs)),
            threads=1, prefetch=1)
        it = iter(loader)
        next(it)   # warm: thread start, page cache
        t0 = time.perf_counter()
        n = sum(1 for _ in it)
        rates.append(n * args.batch / (time.perf_counter() - t0))
    return rates[0], rates[1]


def parser():
    """``bench.py``'s flags, choices and defaults, and
    ``tools/flagship.py``'s ``--arch``, ``--hw`` and ``--group-size``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    flagship.add_step_args(ap)   # --arch, --hw, --batch, --groups, ...
    ap.add_argument("--remat", choices=["block", "none", "convs"],
                    default="none",
                    help="activation checkpointing of the trunk (none: "
                         "keep every activation; block: replay each "
                         "bottleneck; convs: keep conv outputs, replay "
                         "the BN/ReLU chain)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--refine-dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="precision of the no-grad teacher refine/"
                         "pseudo-label chain (TPU.REFINE_DTYPE)")
    ap.add_argument("--ckpt-loss", action="store_true",
                    help="bench.py's CE-map rematerialization; refused "
                         "here (the port has none)")
    ap.add_argument("--loss-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="CE log-softmax precision (TPU.LOSS_DTYPE; the "
                         "plain route only)")
    ap.add_argument("--ce-impl", choices=["xla", "pallas"], default="xla",
                    help="per-pixel CE (xla: the plain log-softmax; "
                         "pallas: the CUDA CE kernels, softmax recomputed "
                         "in backward)")
    ap.add_argument("--refine-res", choices=["full", "stride8"],
                    default="stride8",
                    help="teacher refine-chain resolution (stride8: at the "
                         "logits' grid, one upsample at the end; full: "
                         "reference-exact op order)")
    ap.add_argument("--resize-method", choices=["matmul", "gather"],
                    default="matmul",
                    help="bilinear-upsample formulation; the port has "
                         "matmul only (gather is refused)")
    ap.add_argument("--mode", choices=["full", "step", "e2e", "infer"],
                    default="full")
    return ap


def parse_args(argv):
    args = parser().parse_args(argv)
    step_config(args)   # refuse what the port does not have, up front
    return args


def main(argv=None, device=None, root=None):
    """Run the benchmark; print and return its JSON record.  ``device``
    defaults to CUDA (raises when there is none).  ``root``: a data root
    that already holds the two training splits (``SRC_SPLIT``,
    ``TGT_SPLIT``), for the e2e mode's loaders; default: :func:`corpus`."""
    args = parse_args(argv)
    device = resolve_device(device)
    autotune_convolutions(device)
    card = flagship.device_label(device)

    if args.mode == "infer":
        rate = bench_inference(args, device, iters=args.iters)
        out = {
            "metric": "inference_images_per_sec_per_chip",
            "value": rate,
            "unit": "img/s/GPU (%dx%d Cityscapes-native, %s, bf16, "
                    "single-scale)" % (*INFER_HW, args.arch),
            "ms_per_frame": 1e3 / rate,
            "vs_baseline": None,  # the reference publishes no inference rate
            "card": card,
        }
        print(json.dumps(out), flush=True)
        return out

    state, _, step = build(args, device)
    out = {
        "metric": "sac_adapt_train_images_per_sec_per_chip",
        "unit": "img/s/GPU (TRAIN.BATCH_SIZE=%d @%dx%d, %s, bf16)"
                % (args.batch, *args.hw, args.arch),
        "remat": args.remat,
        # the reference publishes no throughput: vs_baseline divides by the
        # documented ~1.5 img/s/GPU estimate (module docstring); mfu and
        # hbm_util are the measured, estimate-free numbers
        "vs_baseline_note": "estimate-derived (ref publishes no throughput)",
        "ce_impl": args.ce_impl,
        "card": card,
    }

    if args.mode in ("full", "step"):
        dt, flops, nbytes, by_op, launches = bench_step(args, state, step,
                                                        device)
        img_s = args.batch / dt
        out.update(value=img_s,
                   vs_baseline=img_s / REF_IMAGES_PER_SEC_PER_GPU,
                   step_ms=dt * 1e3, step_flops_tf=flops / 1e12,
                   step_flops_tf_by_op={k: v / 1e12
                                        for k, v in by_op.items()},
                   step_hbm_gb=nbytes / 1e9, ce_launches=launches)
        peak, bw = bf16_peak_flops(card), hbm_peak_bw(card)
        if peak:
            out["mfu"] = flops / dt / peak
        if bw:
            # ~1.0: the step moves bytes at the card's memory rate
            out["hbm_util"] = nbytes / dt / bw

    if args.mode in ("full", "e2e"):
        out["h2d_mb_s"] = bench_h2d(device)
        root = root or corpus()
        dt_e2e, launches = bench_end_to_end(args, state, step, device, root)
        out["end_to_end_images_per_sec"] = args.batch / dt_e2e
        out["end_to_end_step_ms"] = dt_e2e * 1e3
        out["end_to_end_ce_launches"] = launches
        # the host input pipeline alone (no device): PNG decode against a
        # pack, with the host's load around it (a concurrent build or test
        # run on the host slows the decode, and the load says so)
        load_pre = os.getloadavg()[0]
        dec, pk = bench_input_pipeline(args, root, iters=max(4, args.iters))
        out["input_images_per_sec_decode"] = dec
        out["input_images_per_sec_packed"] = pk
        out["host_cpus"] = os.cpu_count()
        out["host_load1_pre_input"] = load_pre
        out["host_load1_post_input"] = os.getloadavg()[0]
        if args.mode == "e2e":
            out["value"] = out["end_to_end_images_per_sec"]
            out["vs_baseline"] = out["value"] / REF_IMAGES_PER_SEC_PER_GPU

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
