"""The port's spans (``dasac_tpu_torch/utils/spans.py``), the resize's
host-matrix counter (``nn/functional.HOST_MATRICES``) and the benchmark's
readers of them, on the CPU at the tiny size:

  * without a profiler or ``spans.recording()`` a SAC step records
    nothing (the counter still counts);
  * under ``torch.profiler`` (CPU), a SAC step, an ABN step, their gspmd
    counterparts and an inference call record their spans with the
    parents ``train/steps.py`` and ``infer/engine.py`` name, each a host
    event that is no user annotation, inside its parent on the trace's
    clock;
  * a SAC or ABN step's metrics and parameters are bitwise equal with
    recording on and off;
  * the counter grows by ``4 (out_h in_h + out_w in_w)`` bytes for a
    resize and not at all when the size is unchanged;
  * a span times its stream with CUDA events only when its work runs on a
    CUDA device (its own or its enclosing span's), so a CPU step times
    with the host clock also once CUDA is set up (on a card: for real);
  * each new ``benchmark/metrics`` reader, through ``harness.reader``,
    reads the totals a traced unit, and ``None`` when its span is absent
    or the program has no spans; a cell's loop run under
    ``spans.recording()`` gives a traced result line with every per-layer
    metric of the cell;
  * the train CLI's ``--profile`` writes a line a span beside its trace.
"""

import contextlib
import sys
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, trace
from benchmark.loops import common
from benchmark.tiny import tiny
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.core.mesh import TrainGroups
from dasac_tpu_torch.data.synth import make_synthetic_root
from dasac_tpu_torch.infer import engine
from dasac_tpu_torch.nn import functional
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.tools import flagship, profile_step
from dasac_tpu_torch.train import cli, steps
from dasac_tpu_torch.utils import spans

CPU = torch.device("cpu")
TINY = ["--arch", "tiny", "--hw", "32", "64", "--batch", "2", "--groups",
        "1", "--group-size", "2"]
CELLS = [w["name"] for w in harness.manifest()["workloads"]]

SAC = {"step.sac": {None}, "aug": {"step.sac"}, "ema": {"step.sac"},
       "teacher": {"step.sac"}, "refine": {"step.sac"},
       "src_grad": {"step.sac"}, "tgt_grad": {"step.sac"},
       "optim": {"step.sac"},
       "resize": {"teacher", "refine", "src_grad", "tgt_grad"}}
# the gspmd teacher keeps its stride-8 logits: no resize under it
GSPMD_SAC = dict(SAC, resize={"refine", "src_grad", "tgt_grad"})
ABN = {"step.abn": {None}, "aug": {"step.abn"}, "src_grad": {"step.abn"},
       "optim": {"step.abn"}, "tgt_stats": {"step.abn"},
       "resize": {"src_grad", "tgt_stats"}}
INFER = {"infer": {None}, "resize": {"infer"}}


@pytest.fixture(autouse=True)
def _fresh_spans():
    spans.reset()
    yield
    spans.reset()


def _gen():
    return torch.Generator().manual_seed(0)


def _train(kind):
    """``(run, state)``: one tiny step of ``kind`` on a fresh state."""
    args = profile_step.parse_args(TINY)
    scfg = flagship.step_config(args, ce_impl="logsoftmax")
    state = flagship.build_state(args, CPU)
    batch = flagship.random_batch(args, CPU, np.random.RandomState(0))
    groups = TrainGroups(None, None, None, 0, 0, 1, 1)
    make = {"sac": lambda: steps.make_sac_step(scfg, CPU),
            "abn": lambda: steps.make_abn_step(scfg, CPU),
            "gspmd_sac": lambda: steps.make_gspmd_sac_step(scfg, groups, CPU),
            "gspmd_abn": lambda: steps.make_gspmd_abn_step(scfg, groups,
                                                           CPU)}[kind]()
    return (lambda: make(state, batch, _gen())), state


def _infer():
    model = build_model("tiny", 19, device=CPU,
                        generator=torch.Generator().manual_seed(0))
    fn = engine.make_infer_fn(model, (0.5,) * 3, (0.2,) * 3,
                              scales=(1.0, 1.5), flip=True, output="argmax",
                              device=CPU)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1, 32, 48, 3)).astype(np.uint8))
    return lambda: fn(x)


def test_spans_record_nothing_without_a_profiler():
    run, _ = _train("sac")
    assert spans.span("aug") is spans.span("refine")   # one null context
    before = functional.HOST_MATRICES["count"]
    run()
    assert spans.totals() == {} and spans.growth("host_matrices") is None
    assert functional.HOST_MATRICES["count"] > before   # always counted


@pytest.mark.parametrize("kind,want", [
    ("sac", SAC), ("abn", ABN), ("gspmd_sac", GSPMD_SAC), ("gspmd_abn", ABN),
    ("infer", INFER)])
def test_paths_record_their_spans_as_host_events(kind, want):
    run = _infer() if kind == "infer" else _train(kind)[0]
    run()                                    # warm-up, off
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    got = spans.totals()
    assert {k: set(t.parents) for k, t in got.items()} == want
    outer = next(k for k, p in want.items() if p == {None})
    assert got[outer].count == 1
    assert got["resize" if kind == "infer" else "src_grad"].count >= 1
    for t in got.values():                   # the host clock on the CPU
        assert t.host_ms > 0 and t.stream_ms == pytest.approx(t.host_ms)
    events = [e for e in prof.events() if e.name in want]
    assert {e.name for e in events} == set(want)
    assert all(e.is_user_annotation is False
               and e.device_type == DeviceType.CPU for e in events)
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range)
    for e in events:                         # inside a parent's interval
        parents = want[e.name] - {None}
        assert not parents or any(
            p.start <= e.time_range.start and e.time_range.end <= p.end
            for name in parents for p in by_name[name]), e.name


@pytest.mark.parametrize("kind", ["sac", "abn"])
@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_recording_leaves_the_step_bitwise_equal(kind, how):
    on = {"recording": spans.recording,
          "profiler": lambda: profile(activities=[ProfilerActivity.CPU])}
    outs = []
    for ctx in (contextlib.nullcontext, on[how]):
        run, state = _train(kind)
        with ctx():
            metrics = run()
        outs.append((metrics, state.model.state_dict()))
    assert spans.totals()["step." + kind].count == 1
    (m_off, sd_off), (m_on, sd_on) = outs
    assert set(m_off) == set(m_on) and set(sd_off) == set(sd_on)
    for k in m_off:
        assert torch.equal(m_off[k], m_on[k]), k
    for k in sd_off:
        assert torch.equal(sd_off[k], sd_on[k]), k


@pytest.mark.parametrize("in_hw,out_hw,dtype", [
    ((5, 7), (9, 13), torch.float32), ((9, 13), (5, 7), torch.float32),
    ((16, 16), (16, 33), torch.float32), ((1, 8), (4, 3), torch.float32),
    ((12, 20), (25, 41), torch.bfloat16)])
def test_host_matrices_grow_by_the_matrices_bytes(in_hw, out_hw, dtype):
    x = torch.randn(2, *in_hw, 3)
    before = dict(functional.HOST_MATRICES)
    with spans.recording():
        y = functional.resize_bilinear_align_corners(x, out_hw, dtype)
    (ih, iw), (oh, ow) = in_hw, out_hw
    grown = {k: functional.HOST_MATRICES[k] - before[k] for k in before}
    assert grown == {"count": 2, "bytes": 4 * (oh * ih + ow * iw)}
    assert spans.growth("host_matrices") == grown
    assert y.shape == (2, oh, ow, 3)
    assert spans.totals()["resize"].count == 1


def test_an_unchanged_size_builds_no_matrix_and_no_span():
    x = torch.randn(1, 6, 10, 4)
    before = dict(functional.HOST_MATRICES)
    with spans.recording():
        y = functional.resize_bilinear_align_corners(x, (6, 10))
    assert y is x and functional.HOST_MATRICES == before
    assert spans.totals() == {} and spans.growth("host_matrices") is None


class _FakeEvent:
    """A timing event that reads 5 ms between any two records."""

    def record(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end):
        return 5.0


@pytest.mark.parametrize("outer,inner,timed", [
    ("cpu", None, {}), (None, None, {}), ("cuda", None, {"o", "i"}),
    ("cuda", "cpu", {"o"}), ("cpu", "cuda", {"i"})])
def test_the_stream_clock_follows_the_spans_device(outer, inner, timed,
                                                    monkeypatch):
    made = []
    monkeypatch.setattr(spans, "_event", lambda: made.append(1) or
                        _FakeEvent())
    monkeypatch.setattr(spans, "_resolve", lambda agg, wait: [
        setattr(agg, "stream_ms", agg.stream_ms + 5.0 * len(agg.pending)),
        agg.pending.clear()])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with spans.recording():
        with spans.span("o", outer), spans.span("i", inner):
            time.sleep(0.002)
    got = spans.totals()
    assert len(made) == 2 * len(timed)
    for name, t in got.items():
        want = 5.0 if name in timed else pytest.approx(t.host_ms)
        assert t.count == 1 and t.stream_ms == want, name


@pytest.mark.gpu
def test_a_cpu_step_after_cuda_is_set_up_times_with_the_host_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.ones(1, device="cuda").sum().item()      # CUDA is set up
    run, _ = _train("sac")
    with spans.recording():
        run()
        with spans.span("gpu", torch.device("cuda")):
            torch.randn(256, 256, device="cuda").matmul(
                torch.randn(256, 256, device="cuda"))
    got = spans.totals()
    for name in SAC:
        assert got[name].stream_ms == pytest.approx(got[name].host_ms), name
    assert got["gpu"].stream_ms > 0 and got["gpu"].parents == {None}


# metric -> (spans read, field); None: the counter
READERS = {"aug_ms.train": (["aug"], "stream_ms"),
           "teacher_ms.train": (["ema", "teacher", "refine"], "stream_ms"),
           "host_ms.train": (["step.sac", "step.abn"], "host_ms"),
           "host_ms.infer": (["infer"], "host_ms"),
           "resize_ms.infer": (["resize"], "stream_ms"),
           "resize_h2d_mb.train": None,
           "resize_h2d_mb.infer": None,
           "attention_ms.train": (["attention"], "stream_ms"),
           "mix_ffn_ms.train": (["mix_ffn"], "stream_ms"),
           "decode_head_ms.train": (["decode_head"], "stream_ms")}


def _readings(units):
    return harness.Readings(trace=trace.Trace(1.0, units, [], []),
                            units_per_s=1.0, flops_per_unit=1.0,
                            conv_min_s_per_unit=1.0, peak_flops=1.0)


def test_every_span_metric_has_a_reader_here():
    new = {m["name"] for m in harness.manifest()["per_layer"]
           if m["name"] in READERS}
    assert new == set(READERS)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_the_totals_a_unit(metric):
    x = torch.randn(1, 5, 7, 2)
    with spans.recording():
        for _ in range(2):
            with spans.span("step.sac"):
                for name in ("aug", "ema", "teacher", "refine",
                             "attention", "mix_ffn", "decode_head"):
                    with spans.span(name):
                        functional.resize_bilinear_align_corners(x, (9, 4))
            with spans.span("infer"):
                functional.resize_bilinear_align_corners(x, (3, 8))
    totals = spans.totals()
    if READERS[metric] is None:
        grown = spans.growth("host_matrices")
        want = grown["bytes"] / 1e6 / 4
        assert grown["count"] == 32
    else:
        names, field = READERS[metric]
        want = sum(getattr(totals[n], field) for n in names
                   if n in totals) / 4
    got = harness.reader(metric)(_readings(4))
    assert got == pytest.approx(want, rel=1e-12) and got > 0


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_none_without_their_spans(metric):
    with spans.recording(), spans.span("unrelated"):
        pass
    got = harness.reader(metric)(_readings(3))
    if READERS[metric] is None:
        assert got == 0.0          # spans ran, no matrix was built
        spans.reset()
        assert harness.reader(metric)(_readings(3)) is None
    else:
        assert got is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_readers_read_none_from_a_program_without_spans(metric,
                                                         monkeypatch):
    with spans.recording(), spans.span("infer"):
        functional.resize_bilinear_align_corners(torch.ones(1, 2, 2, 1),
                                                 (3, 3))
    monkeypatch.setitem(sys.modules, "dasac_tpu_torch.utils.spans", None)
    assert harness.reader(metric)(_readings(1)) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_recorded_cell_reports_every_per_layer_metric(name):
    cell, kw = tiny(harness.cell(name))
    ctx = common.Ctx(cell=cell, seed=2 ** 31 + 77, seconds=0.2, trace=False,
                     device=CPU, t0=time.perf_counter(),
                     keys=harness.cfg_keys(cell), **kw)
    with spans.recording():
        rec = harness.loop(cell).run(ctx)
    totals = spans.totals()
    outer = "infer" if cell.traffic["loop"] == "infer" else (
        "step." + cell.traffic["stage"])
    units = totals[outer].count
    assert units >= rec.attempted >= 1
    rec.readings = harness.Readings(
        trace=trace.Trace(20e-6, units, [("elementwise_kernel", 0.0, 4.0),
                                         ("cudnn_conv_fprop", 4.0, 9.0)],
                          []),
        units_per_s=1.0, flops_per_unit=1.0, conv_min_s_per_unit=1e-9,
        peak_flops=1e15)
    line = harness.result_line(cell, rec, True, {
        "platform": "cpu", "kind": "test", "count": 1})
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    for m in cell.per_layer:
        if m["name"] in READERS and READERS[m["name"]] is not None:
            names, field = READERS[m["name"]]
            want = sum(getattr(totals[n], field) for n in names
                       if n in totals) / units
            assert line["metrics"][m["name"]]["value"] == pytest.approx(
                want, rel=1e-12)


def test_span_lines_give_each_span_a_step():
    totals = {"step.sac": spans.Total(4, 8.0, 40.0, frozenset({None})),
              "load": spans.Total(5, 2.0, 1.0, frozenset({None})),
              "resize": spans.Total(16, 4.0, 12.0,
                                    frozenset({"teacher", "refine"}))}
    lines = cli.span_lines(totals)
    assert [ln.split()[1] for ln in lines] == ["step.sac", "resize", "load"]
    assert lines[1].split()[3] == "refine,teacher"
    assert "host      1.000 ms" in lines[1] and "stream      3.000" in lines[1]
    assert lines[2].split()[3] == "-" and " 5 " in lines[2]


def test_train_cli_profile_writes_the_spans(tmp_path):
    root = make_synthetic_root(str(tmp_path / "root"), hw=(48, 64),
                               n_train_src=4, n_train_tgt=4, n_val=2,
                               val_hw=(32, 48))
    try:
        cli.main(["--cfg", "configs/tiny_cpu.yaml", "--snapshot-dir",
                  str(tmp_path / "snap"), "--logdir", str(tmp_path / "logs"),
                  "--exp", "e", "--run", "p", "--workers", "2", "--profile",
                  "--set", "DATASET.ROOT", root, "TRAIN.NUM_EPOCHS", "0",
                  "TPU.NATIVE_LOADER", "False", "TPU.COMPILE_CACHE", ""],
                 device="cpu")
    finally:
        tconfig.reset_cfg()
    logs = tmp_path / "logs" / "default" / "e" / "p"
    assert (logs / "trace.json").exists()
    lines = (logs / "spans.txt").read_text().splitlines()
    names = {ln.split()[1] for ln in lines}
    assert {"load", "step.sac", "aug", "ema", "optim", "resize"} <= names
    steps_run = spans.totals()["step.sac"].count
    load = next(ln for ln in lines if ln.split()[1] == "load")
    assert int(load.split()[5]) == steps_run + 1   # the last finds none
