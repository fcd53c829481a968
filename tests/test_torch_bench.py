"""The port's bench (``dasac_tpu_torch/tools/bench.py``) against the root
``bench.py``, on the CPU at the tiny size (``--hw 32 64``, 2 source
frames, one group of 2 views, ``--iters 1``):

  (a) its flags, choices and defaults are ``bench.py``'s ``main``'s (read
      with ``ast``: calling it would run the bench), plus
      ``tools/flagship.py``'s ``--arch``, ``--hw`` and ``--group-size``;
      ``--resize-method gather`` and ``--ckpt-loss`` are refused;
  (b) for each ``--ce-impl``, ``--refine-dtype``, ``--refine-res`` and
      ``--loss-dtype``, its step config equals, field by field, the
      ``StepConfig`` that ``bench._build`` makes (captured by
      monkeypatching ``dasac_tpu.train.steps.make_sac_step`` and
      ``build_model``), ``ce_impl`` through ``train/steps.py``'s map and
      ``ckpt_loss`` aside;
  (c) one bench step from ``bench._build``'s own state (a full-width r101
      cut to one block a stage, its classifier scaled so that the teacher
      is confident; f32 compute on both sides), carried across by
      ``nn/convert``, on the views ``dasac_tpu``'s augmentation draws, gives
      ``dasac_tpu``'s ``src_loss_ce`` within rtol 2e-4 and ``self_ce``
      within rtol 5e-3 (``tests/test_torch_step.py``'s bounds): the plain
      CE with the refine chain in f32 at full resolution, the kernel CE (on
      the CPU, its plain row-wise version) with it at stride 8, and the
      source CE with it in bf16 at stride 8.  ``dasac_tpu``'s step runs op
      by op: jitted, XLA's stride-8 refine on this 5x9 grid moves
      probabilities by up to 0.83 from its own un-jitted result;
  (d) each mode prints one JSON line with ``bench.py``'s keys, without
      ``mfu`` / ``hbm_util`` on the CPU; the e2e step also runs from packs;
      the corpus is rewritten only when its parameters change; without a
      device the bench raises;
  (e) the FLOPs of a step equal a count by forward hooks on every conv
      (2 N Ho Wo Cin Cout kh kw; a student conv 3x, 2x where its input
      needs no gradient, a teacher conv 1x) and on the resize (its two
      matrix products, 2x with a gradient) within 1%; its bytes are
      ``op_traffic``'s for a step;
  (f) the peaks come by card name (SXM, NVL, PCIe), None otherwise;
  (g) ``bench_infer`` reports ``step_flops_tf`` and ``hbm_gb_per_step``;
  (h) ``frontier_scan.sh`` runs ``tools/frontier_scan.sh``'s five points
      through the port's module (a stub ``python`` on ``PATH``).

Wall time of this file on the CPU host the tier-1 tests run on: ~46 s
run alone, most of it (c)'s op-by-op JAX steps.
"""

import ast
import json
import os
import re
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from dasac_tpu.aug import pipelines as jpipe
from dasac_tpu.nn import factory as jfactory
from dasac_tpu.nn import functional as jF
from dasac_tpu.train import steps as jsteps
from dasac_tpu_torch.nn import functional as tF
from dasac_tpu_torch.nn import layers
from dasac_tpu_torch.nn.convert import train_state_from_jax
from dasac_tpu_torch.sac import refine as trefine
from dasac_tpu_torch.tools import bench, bench_infer, conv_roofline, flagship
from dasac_tpu_torch.tools import op_traffic
from dasac_tpu_torch.train import steps as tsteps
from tests.test_torch_nn import ShallowDeepLab

REPO = Path(__file__).resolve().parents[1]
TINY = ["--arch", "tiny", "--hw", "32", "64", "--batch", "2", "--groups",
        "1", "--group-size", "2", "--iters", "1"]
SMALL_CORPUS = dict(n_train_src=2, n_train_tgt=2, n_val=1, src_hw=(40, 60),
                    tgt_hw=(32, 64), val_hw=(16, 16))
# bench.py's JSON keys by mode (its main: the dict literals and the keys it
# sets for "step" and "e2e"; "infer" prints its own record)
COMMON = {"metric", "unit", "remat", "vs_baseline_note", "value",
          "vs_baseline"}
STEP = {"step_ms", "step_flops_tf", "step_hbm_gb"}
E2E = {"h2d_mb_s", "end_to_end_images_per_sec", "end_to_end_step_ms",
       "input_images_per_sec_decode", "input_images_per_sec_packed",
       "host_cpus", "host_load1_pre_input", "host_load1_post_input"}
JAX_KEYS = {"step": COMMON | STEP, "e2e": COMMON | E2E,
            "full": COMMON | STEP | E2E,
            "infer": {"metric", "value", "unit", "ms_per_frame",
                      "vs_baseline"}}
# what the port adds: the card, the CE route and launches, FLOPs by op
PORT_KEYS = {"step": {"card", "ce_impl", "ce_launches",
                      "step_flops_tf_by_op"},
             "e2e": {"card", "ce_impl", "end_to_end_ce_launches"},
             "infer": {"card"}}
PORT_KEYS["full"] = PORT_KEYS["step"] | PORT_KEYS["e2e"]


@pytest.fixture
def one_thread():
    """One intra-op thread: the steps are small, and several test workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) flags
# ---------------------------------------------------------------------------

def _jax_flags():
    """``{flag: (type, action, choices, default)}`` of ``bench.py``'s
    ``main``, from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for node in ast.walk(main):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = (
                getattr(kw.get("type"), "id", None),
                ast.literal_eval(kw["action"]) if "action" in kw else None,
                ast.literal_eval(kw["choices"]) if "choices" in kw else None,
                ast.literal_eval(kw["default"]) if "default" in kw else None)
    return flags


def _port_flags():
    out = {}
    for a in bench.parser()._actions:
        if not a.option_strings or a.dest == "help":
            continue
        action = "store_true" if a.const is True and a.nargs == 0 else None
        out[a.option_strings[0]] = (
            getattr(a.type, "__name__", None), action,
            list(a.choices) if a.choices else None,
            None if action else a.default)
    return out


def test_flags_choices_and_defaults_are_bench_pys():
    jax_flags, port = _jax_flags(), _port_flags()
    assert len(jax_flags) == 11
    assert set(port) - set(jax_flags) == {"--arch", "--hw", "--group-size"}
    for flag, want in jax_flags.items():
        assert port[flag] == want, flag


@pytest.mark.parametrize("flags,match", [
    (["--resize-method", "gather"], "no gather formulation"),
    (["--ckpt-loss"], "does not rematerialize")])
def test_refused_flags_raise(flags, match):
    with pytest.raises(ValueError, match=match):
        bench.parse_args(flags)
    with pytest.raises(ValueError, match=match):
        bench.main(TINY + flags, device="cpu")


# ---------------------------------------------------------------------------
# (b) the step config, field by field
# ---------------------------------------------------------------------------

def _capture_jax_build(monkeypatch, model):
    """Make ``bench._build`` record the model, optimizer and ``StepConfig``
    it hands to ``make_sac_step`` (into the returned dict) and build
    ``model`` (a callable of ``dtype``) for its ``build_model``."""
    seen = {}

    def make_sac_step(m, tx, scfg):
        seen.update(model=m, tx=tx, scfg=scfg)
        return lambda state, batch, rng: (state, {})

    monkeypatch.setattr(jsteps, "make_sac_step", make_sac_step)
    monkeypatch.setattr(jfactory, "build_model",
                        lambda arch, c, dtype, remat: model(dtype))
    # _build sets this module global; put it back after the test
    monkeypatch.setattr(jF, "RESIZE_METHOD", jF.RESIZE_METHOD)
    return seen


class _NoModel:
    """A flax-free stand-in: ``bench._build`` only inits it."""

    def init(self, *a, **kw):
        return {"params": {}}


CONFIG_CASES = [(ce_, rd, rr, ld) for ce_ in ("xla", "pallas")
                for rd in ("float32", "bfloat16")
                for rr in ("full", "stride8")
                for ld in ("float32", "bfloat16")]


@pytest.mark.parametrize("ce_impl,refine_dtype,refine_res,loss_dtype",
                         CONFIG_CASES)
def test_step_config_equals_bench_py_field_by_field(
        monkeypatch, ce_impl, refine_dtype, refine_res, loss_dtype):
    seen = _capture_jax_build(monkeypatch, lambda dtype: _NoModel())
    monkeypatch.setattr("dasac_tpu.train.optim.build_optimizer",
                        lambda *a: (None, None))
    monkeypatch.setattr("dasac_tpu.core.state.create_train_state",
                        lambda *a: None)
    jbench._build("none", refine_dtype=refine_dtype, loss_dtype=loss_dtype,
                  ce_impl=ce_impl, refine_res=refine_res)
    ref = seen["scfg"]
    ours = bench.step_config(bench.parse_args([
        "--ce-impl", ce_impl, "--refine-dtype", refine_dtype,
        "--refine-res", refine_res, "--loss-dtype", loss_dtype]))
    assert set(ours._fields) == set(ref._fields) - {"ckpt_loss"}
    for field in ours._fields:
        want = getattr(ref, field)
        if field == "ce_impl":
            want = tsteps._CE_IMPLS[want]
        assert getattr(ours, field) == want, field


# ---------------------------------------------------------------------------
# (c) one bench step against dasac_tpu's
# ---------------------------------------------------------------------------

# (ce_impl, refine dtype, refine res, self_ce held): the bf16 chain rounds
# the refined probabilities otherwise than XLA's near ties (tests/
# test_torch_sac.py bounds its labels by share), which moves self_ce here by
# 4%: its case holds the source CE alone
STEP_CASES = [("xla", "float32", "full", True),
              ("pallas", "float32", "stride8", True),
              ("pallas", "bfloat16", "stride8", False)]


@pytest.mark.parametrize("ce_impl,refine_dtype,refine_res,self_ce",
                         STEP_CASES)
def test_bench_step_matches_dasac_tpu(monkeypatch, one_thread, ce_impl,
                                      refine_dtype, refine_res, self_ce):
    h, w, b, g, t = 32, 64, 2, 1, 2
    for name, v in (("HW", (h, w)), ("BATCH_SIZE", b), ("NUM_GROUPS", g),
                    ("GROUP_SIZE", t)):
        monkeypatch.setattr(jbench, name, v)
    # f32 compute on both sides (bench.py's and the bench's bf16 differ by
    # up to 5e-2 a logit, tests/test_torch_nn.py, which moves pseudo-labels)
    seen = _capture_jax_build(monkeypatch, lambda dtype: ShallowDeepLab())
    jstate, _ = jbench._build("none", refine_dtype=refine_dtype,
                              ce_impl=ce_impl, refine_res=refine_res)
    scfg = seen["scfg"]
    # a classifier 1e5x the init's (logits ~4e-5 otherwise): a confident
    # teacher, whose pseudo-labels pass bench.py's run_conf_lower of 0.2
    aspp = jax.tree.map(lambda a: a * 1e5, jstate.params["aspp"])
    jstate = jstate.replace(
        params={**jstate.params, "aspp": aspp},
        teacher_params={**jstate.teacher_params, "aspp": aspp})

    # the batch bench.py's step takes, and dasac_tpu's augmentation of it
    rng = np.random.RandomState(0)
    src_u8 = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    src_lbl = rng.randint(0, 19, (b, h, w)).astype(np.uint8)
    tgt_u8 = (rng.rand(g, h, w, 3) * 255).astype(np.uint8)
    tgt_lbl = rng.randint(0, 19, (g, h, w)).astype(np.uint8)
    k_src, k_tgt = jax.random.split(jax.random.PRNGKey(3))
    src = jpipe.augment_source_batch(
        k_src, src_u8, src_lbl, crop_hw=scfg.crop_hw,
        scale_range=scfg.src_scale, hflip=scfg.src_hflip,
        jitter=scfg.src_jitter, blur=scfg.src_blur, mean=scfg.src_mean,
        std=scfg.src_std)
    views = jpipe.augment_target_groups(
        k_tgt, tgt_u8, tgt_lbl, group_size=scfg.group_size,
        target_scale=scfg.target_scale, zoom=scfg.zoom,
        group_hflip=scfg.group_hflip, guided_hflip=scfg.guided_hflip,
        blur=scfg.tgt_blur, jitter=scfg.tgt_jitter,
        greyscale=scfg.tgt_greyscale, mean=scfg.mean, std=scfg.std)
    src, views = jax.tree.map(np.asarray, (src, views))
    # op by op: under jit, XLA's fused stride-8 refine on this 5x9 grid moves
    # probabilities by up to 0.83 from dasac_tpu's own un-jitted refine
    # (which the port equals within 2e-6)
    with jax.disable_jit():
        _, jm = jsteps.make_sac_views_step(seen["model"], seen["tx"], scfg)(
            jstate, *src, views, jax.random.PRNGKey(7))

    # the port's bench, the same weights, the same augmented inputs
    build_model = flagship.build_model
    monkeypatch.setattr(flagship, "build_model", lambda *a, **kw: build_model(
        *a, **dict(kw, dtype=torch.float32, layers=(1, 1, 1, 1))))
    args = bench.parse_args(TINY[2:] + [
        "--arch", "deeplabv2_resnet101", "--ce-impl", ce_impl,
        "--refine-dtype", refine_dtype, "--refine-res", refine_res])
    state, _, step = bench.build(args, "cpu")
    j = jax.tree.map(np.asarray, jstate)
    train_state_from_jax(dict(
        params=j.params, batch_stats=j.batch_stats,
        teacher_params=j.teacher_params, teacher_stats=j.teacher_stats,
        running_conf=j.running_conf, slow_init=float(j.slow_init),
        step=int(j.step)), "deeplabv2_resnet101", state)
    tviews = tsteps.pipelines.TargetViews(*(torch.from_numpy(np.array(a))
                                            for a in views))
    monkeypatch.setattr(tsteps, "augment_sac", lambda scfg_, gen, batch: (
        torch.from_numpy(src[0]), torch.from_numpy(src[1]), tviews))
    tm = step(state, (src_u8, src_lbl, tgt_u8, tgt_lbl),
              torch.Generator().manual_seed(0))

    np.testing.assert_allclose(float(tm["src_loss_ce"]),
                               float(jm["src_loss_ce"]), rtol=2e-4,
                               atol=1e-6)
    assert float(tm["pseudo_cover"]) > 0.05, "no pseudo-labels to compare"
    if self_ce:
        np.testing.assert_allclose(float(tm["self_ce"]),
                                   float(jm["self_ce"]), rtol=5e-3,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (d) the modes' JSON lines
# ---------------------------------------------------------------------------

def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("mode", ["step", "e2e", "infer", "full"])
def test_each_mode_prints_one_line_with_bench_pys_keys(
        monkeypatch, tmp_path, capsys, one_thread, mode):
    monkeypatch.setattr(bench, "CORPUS", SMALL_CORPUS)
    monkeypatch.setattr(bench, "INFER_HW", (64, 128))
    out = bench.main(TINY + ["--mode", mode], device="cpu",
                     root=bench.corpus(str(tmp_path / "corpus")))
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [json.loads(json.dumps(out))]
    assert set(out) == JAX_KEYS[mode] | PORT_KEYS[mode]   # no mfu on the CPU
    assert out["value"] > 0 and out["card"] == "cpu"
    if mode != "infer":
        assert out["ce_impl"] == "xla" and out["remat"] == "none"
    if mode in ("step", "full"):
        assert out["step_flops_tf"] > 0 and out["step_hbm_gb"] > 0
        assert out["ce_launches"] == {k: {"bulk": 0, "strided": 0}
                                      for k in ("nll_fwd", "nll_bwd")}
    if mode in ("e2e", "full"):
        assert out["input_images_per_sec_decode"] > 0
        assert out["input_images_per_sec_packed"] > 0


def test_end_to_end_from_packs(monkeypatch, tmp_path, one_thread):
    """``bench_end_to_end(packed=True)`` (``bench.py``'s, which its main
    does not call either) writes the packs of both training splits under
    the root and steps from them."""
    monkeypatch.setattr(bench, "CORPUS", SMALL_CORPUS)
    root = bench.corpus(str(tmp_path / "corpus"))
    args = bench.parse_args(TINY + ["--mode", "e2e"])
    state, _, step = bench.build(args, "cpu")
    dt, launches = bench.bench_end_to_end(args, state, step,
                                          torch.device("cpu"), root,
                                          packed=True)
    assert dt > 0 and state.step == 2 + args.iters
    assert sorted(os.listdir(os.path.join(root, "packed"))) and all(
        any(f.startswith(split) for f in os.listdir(os.path.join(
            root, "packed"))) for split in (bench.SRC_SPLIT,
                                            bench.TGT_SPLIT))


def test_corpus_is_reused_and_rewritten_when_its_parameters_change(
        monkeypatch, tmp_path):
    root = str(tmp_path / "corpus")
    monkeypatch.setattr(bench, "CORPUS", SMALL_CORPUS)
    bench.corpus(root)
    marker = os.path.join(root, ".complete")
    mtime = os.path.getmtime(marker)
    assert bench.corpus(root) == root and os.path.getmtime(marker) == mtime
    monkeypatch.setattr(bench, "CORPUS", dict(SMALL_CORPUS, n_train_src=3))
    bench.corpus(root)
    with open(os.path.join(root, "train_game_9K.txt")) as f:
        assert len(f.read().split("\n")) >= 3
    with open(marker) as f:
        assert json.loads(f.read())["n_train_src"] == 3


def test_bench_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "step"])


# ---------------------------------------------------------------------------
# (e) the FLOP and byte counts
# ---------------------------------------------------------------------------

def _hook_count(model):
    """A FLOP count of what runs while it is active, by forward hooks on
    every conv of ``model`` and a wrapper of the resize: a conv's
    2 N Ho Wo Cin Cout kh kw once, plus once for each of its input and
    weight that needs a gradient; the resize's two products likewise."""
    total = [0]

    def grads(*ts):
        return 1 + (sum(t.requires_grad for t in ts)
                    if torch.is_grad_enabled() else 0)

    def conv_hook(mod, inputs, out):
        n, cout, ho, wo = out.shape
        cin = mod.weight.shape[1]
        total[0] += (2 * n * ho * wo * cin * cout * mod.kernel ** 2
                     * grads(inputs[0], mod.weight))

    def resize(x, size, *a, **kw):
        b, ih, iw, c = x.shape
        oh, ow = size
        if (ih, iw) != (oh, ow):
            total[0] += 2 * b * oh * c * iw * (ih + ow) * grads(x)
        return tF.resize_bilinear_align_corners(x, size, *a, **kw)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, layers.Conv2d)]
    return total, hooks, resize


def test_step_flops_equal_a_count_by_hooks_and_bytes_op_traffics(
        monkeypatch, one_thread):
    from dasac_tpu_torch.nn import tiny

    args = bench.parse_args(TINY + ["--mode", "step"])
    state, _, step = bench.build(args, "cpu")
    batch = bench.device_batch(args, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, batch, gen)
    total, hooks, resize = _hook_count(state.model)
    monkeypatch.setattr(tiny, "resize_bilinear_align_corners", resize)
    monkeypatch.setattr(trefine, "resize_bilinear_align_corners", resize)
    flops, nbytes, by_op = bench.count_cost(lambda: step(state, batch, gen))
    for h in hooks:
        h.remove()
    assert flops == sum(by_op.values()) and by_op["matmul"] > 0
    assert abs(flops - total[0]) <= 0.01 * total[0], (flops, total[0])
    traffic = op_traffic.record(lambda: step(state, batch, gen))
    assert nbytes == sum(traffic.totals())


def test_count_cost_of_a_conv_and_a_matmul_by_hand():
    x = torch.ones(2, 3, 8, 8, requires_grad=True)
    w = torch.ones(4, 3, 3, 3, requires_grad=True)
    m = torch.ones(5, 6)

    def fn():
        torch.nn.functional.conv2d(x, w, padding=1).sum().backward()
        return m @ torch.ones(6, 7)

    flops, nbytes, by_op = bench.count_cost(fn)
    conv = 2 * 2 * 8 * 8 * 3 * 4 * 9
    assert by_op == {"conv": 3 * conv, "matmul": 2 * 5 * 6 * 7}
    assert flops == 3 * conv + 2 * 5 * 6 * 7 and nbytes > 0


# ---------------------------------------------------------------------------
# (f) peaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("card,tf,tb", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 989.4, 3.35),
    ("NVIDIA H100 NVL, 400.00 W", 835.5, 3.9),
    ("NVIDIA H100 PCIe, 350.00 W", 756.5, 2.0),
    ("NVIDIA A100-SXM4-80GB, 400.00 W", None, None), ("cpu", None, None)])
def test_peaks_by_card_name(card, tf, tb):
    assert bench.bf16_peak_flops(card) == (tf and tf * 1e12)
    assert bench.hbm_peak_bw(card) == (tb and tb * 1e12)
    assert conv_roofline.peak_tf(card) == tf   # one table


# ---------------------------------------------------------------------------
# (g) bench_infer's cost
# ---------------------------------------------------------------------------

def test_bench_infer_reports_flops_and_bytes_on_the_cpu(monkeypatch,
                                                        one_thread):
    for name, fn in (("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("get_device_name", lambda *a: "cpu")):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(bench_infer, "card_name", lambda: "cpu")
    args = bench_infer.parse_args(["--arch", "tiny", "--hw", "32", "64",
                                   "--batch", "1", "--iters", "1"])
    rec = bench_infer.bench(args, torch.device("cpu"), None)
    assert rec["step_flops_tf"] > 0 and rec["hbm_gb_per_step"] > 0
    assert "mfu" not in rec and "hbm_util" not in rec
    model = bench_infer.build_model("tiny", 19, device="cpu")
    total, hooks, resize = _hook_count(model)
    monkeypatch.setattr("dasac_tpu_torch.nn.tiny."
                        "resize_bilinear_align_corners", resize)
    bench_infer.make_infer_fn(model, bench_infer.MEAN, bench_infer.STD,
                              device="cpu")(torch.zeros(1, 32, 64, 3,
                                                        dtype=torch.uint8))
    for h in hooks:
        h.remove()
    assert abs(rec["step_flops_tf"] * 1e12 - total[0]) <= 0.01 * total[0]


# ---------------------------------------------------------------------------
# (h) the frontier scan
# ---------------------------------------------------------------------------

def _jax_scan():
    """``tools/frontier_scan.sh``'s points and its bench command with the
    point's ``$1 $2 $3`` put in, one per point (read, not run: it writes
    under /tmp)."""
    text = (REPO / "tools" / "frontier_scan.sh").read_text().replace(
        "\\\n", " ")
    points = re.findall(r'"([^"]+)"', re.search(r"for cfg in (.*); do",
                                                text).group(1))
    cmd = " ".join(re.search(r"python (bench\.py .*?)>>", text).group(
        1).split())
    out = []
    for p in points:
        c = cmd
        for k, v in enumerate(p.split(), 1):
            c = c.replace('"$%d"' % k, v)
        out.append(c)
    return points, out


def test_frontier_scan_runs_bench_pys_points_through_the_port(tmp_path):
    points, jax_calls = _jax_scan()
    assert len(points) == 5
    stub = tmp_path / "bin" / "python"
    stub.parent.mkdir()
    log = tmp_path / "calls"
    # the stub records its argv; the first point fails, as a run can
    stub.write_text('#!/bin/sh\necho "$*" >> %s\ncase "$*" in '
                    '*"--remat none --batch 12"*) echo "boom \\"x\\"" >&2;'
                    ' exit 1;; esac\necho \'{"value": 1}\'\n' % log)
    stub.chmod(0o755)
    out = tmp_path / "scan.jsonl"
    env = {**os.environ, "PATH": "%s:%s" % (stub.parent, os.environ["PATH"]),
           "OUT": str(out), "ERR": str(tmp_path / "err.log")}
    p = subprocess.run(["sh", "dasac_tpu_torch/tools/frontier_scan.sh"],
                       env=env, cwd=REPO, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr
    calls = log.read_text().splitlines()
    assert [c.replace("-m dasac_tpu_torch.tools.bench", "bench.py", 1)
            for c in calls] == jax_calls
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    remat, batch, groups = points[0].split()
    assert rows == [{"remat": remat, "batch": int(batch),
                     "groups": int(groups), "error": "boom 'x'"}] + [
        {"value": 1}] * 4
    # each point parses in the port's bench
    for c in calls:
        args = bench.parse_args(c.split()[2:])
        assert args.mode == "step" and args.iters == 10
