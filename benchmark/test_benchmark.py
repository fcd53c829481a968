"""The benchmark's own tests, on the CPU at tiny sizes (``tiny.py``):
every cell resolves to its files by name, the manifest keeps to its
format, the plain count equals a hand formula, the result line has its
keys, nothing the benchmark loads is JAX or ``dasac_tpu``, the reference
loads nothing of the port, the frozen reference equals the port where
both compute in float32, and the control and each planted fault make
``correct`` false under the cell's limits."""

import ast
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import counts, harness, inputs, trace
from benchmark.loops import common, infer, train
from benchmark.reference.layers import CONTROL, Precision
from benchmark.tiny import tiny

ROOT = harness.ROOT
BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CPU = torch.device("cpu")


def _ctx(name, seed=20251018, **over):
    cell, kw = tiny(harness.cell(name))
    kw.update(over)
    return common.Ctx(cell=cell, seed=seed, seconds=0.5, trace=False,
                      device=CPU, t0=time.perf_counter(),
                      keys=harness.cfg_keys(cell), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.cell(name)
    assert harness.loop(cell).run
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    keys = harness.cfg_keys(cell)
    assert keys["MODEL.ARCH"] == cell.config["cfg"]["MODEL.ARCH"]


def test_manifest_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_plain_count_equals_the_hand_formula():
    from torch.utils.flop_counter import FlopCounterMode

    w1 = torch.empty(8, 3, 3, 3, device="meta", requires_grad=True)
    w2 = torch.empty(5, 8, 1, 1, device="meta", requires_grad=True)
    m = torch.empty(24, 12, device="meta")

    def net():
        x = torch.empty(2, 3, 12, 16, device="meta")
        y = F.conv2d(F.conv2d(x, w1, padding=1, stride=2), w2)  # 6x8
        z = torch.matmul(m, y.reshape(2, 5 * 6, 8).transpose(1, 2)
                         .reshape(2, 8, 30)[:, :, :12].transpose(1, 2))
        z.sum().backward()

    c = counts.Count()
    with c:
        net()
    conv1 = 2 * 2 * 8 * 6 * 8 * 3 * 3 * 3
    conv2 = 2 * 2 * 5 * 6 * 8 * 8
    # forward; conv2 backward to its input and weight; conv1's input
    # needs no gradient: its weight only
    assert c.flops == conv1 + 2 * conv2 + conv1 + conv2
    # the dense product (a resize's interpolation matrix) is not counted
    matmul = 2 * (2 * 24 * 12 * 8) + 2 * (2 * 12 * 24 * 8)
    with FlopCounterMode(display=False) as fc:
        net()
    assert fc.get_total_flops() == c.flops + matmul
    # bf16 tensors: each input read and each output written once
    x = torch.empty(1, 4, 6, 6, device="meta", dtype=torch.bfloat16)
    w = torch.empty(3, 4, 3, 3, device="meta", dtype=torch.bfloat16)
    c = counts.Count()
    with c:
        F.conv2d(x, w)
    assert c.convs == [(2 * 3 * 4 * 4 * 36, 2 * (144 + 108 + 48))]
    assert c.conv_min_s(1e12, 1e9) == pytest.approx(600 / 1e9)


def test_trace_reduction():
    dev = [("volta_elementwise_kernel", 0.0, 10.0),
           ("sm90_xmma_fprop", 5.0, 20.0), ("reduce_kernel", 40.0, 50.0)]
    host = [("aten::item", 18.0, 45.0), ("cudaStreamSynchronize", 25.0, 35.0)]
    t = trace.Trace(60e-6, 2, dev, host)
    assert t.busy_s == pytest.approx(30e-6)
    assert t.by_group == pytest.approx({"elementwise": 10e-6,
                                        "convolution": 15e-6,
                                        "reduction": 10e-6})
    # a convolution operator's kernels, whatever cuDNN names them; a
    # cuBLAS product outside one is a matrix product
    gemm = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8"
    ops = [(gemm, 0.0, 8.0, "aten::mm"), (gemm, 8.0, 9.0, None),
           ("nvjet_tst_256x144", 9.0, 11.0, "aten::cudnn_convolution"),
           ("sm90_xmma_wgrad", 11.0, 14.0, "aten::convolution_backward")]
    assert trace.Trace(20e-6, 1, ops, []).by_group == pytest.approx(
        {"matmul": 9e-6, "convolution": 5e-6})
    assert t.gaps == [("host: cudaStreamSynchronize", pytest.approx(20e-6))]
    b = t.breakdown()
    assert b["device_ops"][0][0] == "sm90_xmma_fprop"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    # the launching operator comes from the profiler's kernels of each
    # host operator, matched by name and duration
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def ev(name, s, e, dev=DeviceType.CUDA, kernels=()):
        return NS(name=name, device_type=dev, kernels=list(kernels),
                  time_range=NS(start=s, end=e))

    host_op = ev("aten::cudnn_convolution", 0.0, 1.0, DeviceType.CPU,
                 [NS(name="nvjet_tst", device=0, duration=2.0)])
    device, host = trace.split_events(
        [host_op, ev("nvjet_tst", 5.0, 7.0), ev("nvjet_tst", 7.0, 10.0)])
    assert device == [("nvjet_tst", 5.0, 7.0, "aten::cudnn_convolution"),
                      ("nvjet_tst", 7.0, 10.0, None)]
    assert host == [("aten::cudnn_convolution", 0.0, 1.0)]


def test_seeded_inputs():
    big = 2 ** 31 + 12345
    assert inputs.stream(big, "pool") != inputs.stream(big + 1, "pool")
    assert inputs.stream(big, "pool") < 2 ** 63
    t = {"pool": 2, "source": {"frames": 2, "hw": [20, 30]},
         "target": {"frames": 1, "hw": [16, 24]}}
    a, b = (inputs.train_pool(big, t, 19, CPU) for _ in range(2))
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], a[1][0])
    lab = a[0][1]
    assert lab.dtype == torch.uint8 and ((lab < 19) | (lab == 255)).all()


@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(name):
    ctx = _ctx(name)
    rec = harness.loop(ctx.cell).run(ctx)
    line = harness.result_line(ctx.cell, rec, False, {
        "platform": "gpu", "kind": "test", "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and rec.attempted >= 1
    assert set(line["metrics"]) == {m["name"] for m in ctx.cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    # the traced line: per-layer metrics, busy and window, the breakdown
    dev = [("elementwise_kernel", 0.0, 4.0), ("cudnn_conv_fprop", 4.0, 9.0)]
    rec.readings = harness.Readings(
        trace=trace.Trace(20e-6, 1, dev, []), units_per_s=2.0,
        flops_per_unit=1e12, conv_min_s_per_unit=2e-6, peak_flops=989.4e12)
    line = harness.result_line(ctx.cell, rec, True, {
        "platform": "gpu", "kind": "test", "count": 1})
    assert set(line["metrics"]) == {m["name"] for m in ctx.cell.per_layer}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"
    assert all(0 <= line["metrics"][k]["value"] <= 100
               for k in line["metrics"] if "roofline" in k or "mfu" in k)


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(harness.HERE, "reference")
    files = [os.path.join(d, f) for d, _, fs in os.walk(ref) for f in fs
             if f.endswith(".py")]
    assert len(files) >= 6
    for f in files:
        assert not set(_imports(f)) & {"dasac_tpu_torch", "dasac_tpu",
                                       "jax", "jaxlib", "flax"}, f
    code = ("import json, sys; import benchmark.reference.steps, "
            "benchmark.reference.archs.deeplabv2_resnet101, "
            "benchmark.reference.archs.fcn_vgg16_bn; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    tops = json.loads(subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, check=True).stdout)
    assert "benchmark" in tops and "dasac_tpu_torch" not in tops


def test_a_run_loads_no_jax_and_nothing_of_dasac_tpu():
    code = """
import json, sys, time, torch
from benchmark import harness
from benchmark.loops import common
from benchmark.tiny import tiny
cell, kw = tiny(harness.cell("r101.sac"))
ctx = common.Ctx(cell=cell, seed=7, seconds=0.2, trace=False,
                 device=torch.device("cpu"), t0=time.perf_counter(),
                 keys=harness.cfg_keys(cell), **kw)
harness.loop(cell).run(ctx)
print(json.dumps([harness.banned_modules(),
                  sorted({m.split('.')[0] for m in sys.modules})]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    banned, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert banned == []
    # the port's name begins with the JAX package's: whole names compared
    assert "dasac_tpu_torch" in tops and "dasac_tpu" not in tops
    assert not {"jax", "jaxlib", "flax"} & set(tops)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "r101.sac",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("name", CELLS)
def test_the_frozen_reference_equals_the_port_in_float32(name):
    """At the tests' size, the program's convolutions in float32 and the
    reference's refine in bf16 as the program's, every number the
    harness can compare reads 0: the copy follows the port's draws and
    arithmetic."""
    ctx = _ctx(name, seed=3)
    if ctx.cell.traffic["loop"] == "infer":
        fn, pool = infer.program_setup(ctx)
        labels = [infer.serve(fn, f)[0] for f in pool]
        got = infer.gaps(infer.reference_probs(ctx, pool), labels)
    else:
        prog = train.program_setup(ctx)[-1]
        got = train.compare(prog, train.reference_readings(
            ctx, Precision(torch.float32, False, torch.bfloat16)))
    assert all(v <= 1e-6 for v in got.values()), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_limit(card, name):
    """At the cell's own size on the card: the reference in bf16 with
    fp8-rounded convolution operands (the precision below the
    configuration's), read as the program is, fails one of the cell's
    numbers.  On the chip: ``python -m pytest benchmark -m gpu``."""
    cell = harness.cell(name)
    ctx = common.Ctx(cell=cell, seed=20251018, seconds=0.0, trace=False,
                     device=card, t0=time.perf_counter(),
                     keys=harness.cfg_keys(cell))
    if cell.traffic["loop"] == "infer":
        frames = inputs.infer_pool(ctx.seed, cell.traffic, card)[:2]
        ref = infer.reference_probs(ctx, frames)
        ctrl = infer.reference_probs(ctx, frames, CONTROL)
        got = infer.gaps(ref, [p[0].argmax(-1) for p in ctrl])
    else:
        ref = train.reference_readings(ctx)
        got = train.compare(train.reference_readings(ctx, CONTROL), ref)
    assert any(got[k] > v for k, v in cell.limits.items()), got


def _unchanged(step):
    def wrapped(state, batch, gen):
        keep = {k: v.clone() for k, v in state.model.state_dict().items()}
        m = step(state, batch, gen)
        state.model.load_state_dict(keep)
        return m
    return wrapped


def _half_batch(step):
    def wrapped(state, batch, gen):
        return step(state, tuple(t[:max(1, t.shape[0] // 2)] for t in batch),
                    gen)
    return wrapped


def _altered(step):
    def wrapped(state, batch, gen):
        m = step(state, batch, gen)
        with torch.no_grad():
            p = next(iter(state.model.parameters()))
            p.add_(p.detach().abs().mean())
        return m
    return wrapped


TRAIN_CELLS = [n for n in CELLS if harness.cell(n).traffic["loop"]
               == "train"]
FAULTS = [(n, f) for n in TRAIN_CELLS
          for f in (_unchanged, _half_batch, _altered)]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_train_step_is_not_correct(monkeypatch, name, fault):
    from dasac_tpu_torch.train import steps

    for make in ("make_sac_step", "make_abn_step"):
        real = getattr(steps, make)
        monkeypatch.setattr(steps, make,
                            lambda *a, _r=real, **k: fault(_r(*a, **k)))
    ctx = _ctx(name, seed=5)
    rec = harness.loop(ctx.cell).run(ctx)
    assert harness.correct(rec) is False, rec.checks


def test_an_altered_label_map_is_not_correct(monkeypatch):
    from dasac_tpu_torch.infer import engine

    real = engine.make_infer_fn

    def make(*a, **k):
        fn = real(*a, **k)

        def altered(x):
            y = fn(x).clone()
            y[:, : y.shape[1] // 4] = (y[:, : y.shape[1] // 4] + 1) % 19
            return y
        return altered

    monkeypatch.setattr(engine, "make_infer_fn", make)
    ctx = _ctx("r101.infer_ms_flip", seed=5)
    rec = harness.loop(ctx.cell).run(ctx)
    assert harness.correct(rec) is False, rec.checks


def test_calibrate_reads_program_control_and_fault():
    rows = __import__("benchmark.calibrate", fromlist=["main"]).main(
        ["--workload", "r101.sac", "--seeds", "8", "--control-seeds", "8",
         "--witness-seeds", "8"], device="cpu", adjust=tiny)
    assert set(rows[0]) >= {"program", "control", "half_batch",
                            "altered_leaf", "reference_bf16"}
    assert all(v <= 1e-5 for v in rows[0]["program"].values())
    assert rows[0]["altered_leaf"]["change"] > 1.0
