"""The rank side of ``tests/test_torch_infer_mesh.py``: what each process
of its 4-rank gloo world runs.  It imports torch and the port only, so a
spawned rank starts without loading JAX; the inputs arrive as numpy arrays
and the results leave as a ``torch.save`` file per rank.
"""

import os

import numpy as np
import torch

from dasac_tpu_torch.core import dist, mesh
from dasac_tpu_torch.infer import cli, engine
from dasac_tpu_torch.nn import functional as tF
from dasac_tpu_torch.nn import spatial
from dasac_tpu_torch.nn.convert import from_jax_variables
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.nn.layers import Conv2d

WORLD = 4
C = 19
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# frame heights of the op checks: divisible, 42 (the 42-row padded frame
# of dasac_tpu's test), and an odd 1052/8-like height
OP_HEIGHTS = (40, 42, 131)
# (kernel, stride, dilation, padding): the r101 trunk's and ASPP's 3x3
# dilations, its 7x7/2 stem, the 1x1/2 projection, tiny's 3x3/2 "same"
CONVS = ((3, 1, 1, 1), (3, 1, 2, 2), (3, 1, 4, 4), (3, 1, 24, 24),
         (7, 2, 1, 3), (1, 2, 1, 0), (3, 2, 1, "same"))
# the run_inference layouts of the 4-rank world: (spatial, batch_size)
LAYOUTS = {"batch": (0, 4), "spatial": (-1, None), "combined": (2, None)}
SETTINGS = {"single": dict(scales=(1.0,)),
            "multi": dict(scales=(0.75, 1.0), flip=True, fuse="stride8")}
FCN_HW = (96, 128)


def port_model(arch, variables, **kw):
    model = build_model(arch, C, device="cpu", **kw)
    model.load_state_dict(from_jax_variables(variables, arch), strict=True)
    return model.eval()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _sharded_vs_plain(sh, x, dim, fn, rows_out):
    """``fn`` on this rank's strip of ``x`` and on ``x`` whole: the
    relative error of this rank's rows."""
    ref = fn(x)
    with sh.frame():
        got = fn(sh.shard(x, dim))
    lo, hi = sh.own(rows_out(ref))
    return _rel(got, ref.narrow(dim, lo, hi - lo))


@torch.no_grad()
def op_checks(group):
    """Every sharded op against its unsharded self over ``group``."""
    sh = spatial.Sharded(group)
    gen = torch.Generator().manual_seed(0)
    out = {}
    calls0 = dict(dist.CALLS)
    for h in OP_HEIGHTS:
        x = torch.randn(2, 6, h, 13, generator=gen).contiguous(
            memory_format=torch.channels_last)
        for k, st, d, pad in CONVS:
            conv = Conv2d(6, 5, k, stride=st, padding=pad, dilation=d,
                          bias=True)
            conv.reset_parameters(generator=gen)
            conv.bias.normal_(generator=gen)
            out[("conv", h, k, st, d, pad)] = _sharded_vs_plain(
                sh, x, 2, conv, lambda r: r.shape[2])
        out[("max_pool_ceil", h)] = _sharded_vs_plain(
            sh, x, 2, tF.max_pool_ceil, lambda r: r.shape[2])
        out[("max_pool", h)] = _sharded_vs_plain(
            sh, x, 2, tF.max_pool, lambda r: r.shape[2])
        xn = torch.randn(2, h, 13, C, generator=gen)
        for oh in (8 * h, h // 3):
            out[("resize", h, oh)] = _sharded_vs_plain(
                sh, xn, 1,
                lambda t, oh=oh: tF.resize_bilinear_align_corners(t, (oh, 9)),
                lambda r: r.shape[1])
    calls = {k: dist.CALLS[k] - v for k, v in calls0.items()}
    return out, calls


def fcn_check(group):
    """FCN8s at full width (its fusion resizes to the skip grids) on a
    frame split over ``group``, against its unsharded forward (which
    ``tests/test_torch_vgg.py`` holds against JAX): the probabilities'
    relative error of this rank's rows and the exchanges."""
    model = build_model("fcn_vgg16_bn", C, device="cpu",
                        generator=torch.Generator().manual_seed(4)).eval()
    frame = np.random.RandomState(5).randint(0, 256, (1, *FCN_HW, 3),
                                             dtype=np.uint8)
    sh = spatial.Sharded(group)
    calls0 = dict(dist.CALLS)
    got = engine.make_infer_fn(model, MEAN, STD, device="cpu",
                               sharded=sh)(frame)
    calls = {k: dist.CALLS[k] - v for k, v in calls0.items()}
    ref = engine.make_infer_fn(model, MEAN, STD, device="cpu")(frame)
    lo, hi = sh.own(FCN_HW[0])
    return _rel(got, ref[:, lo:hi]), calls


def inference_runs(cases, models, roots, out_dir, group):
    """``run_inference`` of each case ``(model, root, setting, layout)`` in
    the world; rank 0 keeps the confusions and the exchanges of each."""
    built = {name: port_model(*spec[:2], **spec[2]) for name, spec
             in models.items()}
    out = {}
    for case in cases:
        model, root, setting, layout = case
        spatial_, batch = LAYOUTS[layout]
        ds = engine.InferDataset(roots[root], "val_cityscapes")
        calls0 = dict(dist.CALLS)
        conf = engine.run_inference(
            built[model], ds, os.path.join(out_dir, "_".join(case)),
            mean=MEAN, std=STD, batch_size=batch, spatial=spatial_,
            verbose=False, device="cpu", group=group, **SETTINGS[setting])
        out[case] = dict(conf=conf, exchanges={
            k: dist.CALLS[k] - v for k, v in calls0.items()})
    return out


def world_main(rank, addr, out_dir, inp, cli_argv, cli_port):
    """One rank: the op checks over its pair ([0, 1] or [2, 3]) and over
    the world, FCN8s over the pair [0, 1], the ``run_inference`` cases;
    then the infer CLI as rank ``rank`` of a new world of 4 given by
    flags."""
    torch.set_num_threads(1)
    dist.init(dist.Launch(addr, WORLD, rank, rank), torch.device("cpu"))
    world = dist.group()
    try:
        pair = mesh.sp_group(mesh.infer_mesh(WORLD, None, 2), rank)
        res = {"ops_pair": op_checks(pair), "ops_world": op_checks(world)}
        if rank < 2:
            res["fcn"] = fcn_check(pair)
        res["runs"] = inference_runs(inp["cases"], inp["models"],
                                     inp["roots"], out_dir, world)
        try:   # a layout the world cannot make
            engine.run_inference(None, None, out_dir, mean=MEAN, std=STD,
                                 spatial=3, device="cpu", group=world)
            res["refusal"] = None
        except ValueError as e:
            res["refusal"] = str(e)
    finally:
        dist.destroy()
    torch.save(res, os.path.join(out_dir, "rank%d.pt" % rank))
    cli.main(cli_argv + ["--world-size", str(WORLD), "--rank", str(rank),
                         "--dist-url", "tcp://127.0.0.1:%d" % cli_port],
             device="cpu")
