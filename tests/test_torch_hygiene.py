"""Rules of the port that no parity test sees.

  * ``dasac_tpu_torch`` and ``chip_smoke.py`` import nothing of JAX, nothing
    of ``dasac_tpu``, and no PIL, torchvision or PyYAML (the card's machine
    has none of them);
  * the entry points default to CUDA and raise, rather than run on the CPU,
    when no device is given and there is no card; the trainer CLI does so
    before it reads a config or touches data; on the card they turn cuDNN
    autotuning on, and nowhere else;
  * the CE wrapper runs its plain version only for a CPU tensor;
  * ``chip_smoke.py`` fails, and prints no result, without a card or
    without the rest of the repo.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dasac_tpu_torch.core.device import autotune_convolutions
from dasac_tpu_torch.core.state import create_train_state
from dasac_tpu_torch.infer import engine
from dasac_tpu_torch.nn.factory import build_model
from dasac_tpu_torch.ops import ce
from dasac_tpu_torch.infer import cli as infer_cli
from dasac_tpu_torch.tools import bench_infer
from dasac_tpu_torch.train import cli, optim, steps

REPO = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "dasac_tpu", "PIL",
          "torchvision", "yaml"}


def _port_files():
    return sorted((REPO / "dasac_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_dasac_tpu():
    files = _port_files()
    assert len(files) > 30
    # the Triton yardstick, the nvcc build module, the eval, checkpoint and
    # inference modules and the training program's are scanned like the
    # rest
    for name in ("ops/ce_triton.py", "ops/cuda_build.py", "train/metrics.py",
                 "train/checkpoints.py", "infer/engine.py",
                 "core/config.py", "core/yaml_subset.py", "core/opts.py",
                 "data/category.py", "data/lists.py", "data/sampler.py",
                 "data/png.py", "data/packed.py", "data/host_loader.py",
                 "data/synth.py", "data/factory.py", "train/loop.py",
                 "train/cli.py", "utils/logging.py", "utils/visualise.py",
                 "nn/vgg.py", "infer/cli.py", "tools/evaluate_miou.py",
                 "tools/compute_is_weights.py", "tools/bench_infer.py",
                 "data/native.py", "data/native_build.py",
                 "data/id_mappers.py", "data/png16.py",
                 "tools/convert_train_ids.py", "tools/make_split_lists.py",
                 "tools/check_dataset.py", "tools/pack_dataset.py",
                 "tools/recipe.py", "core/mesh.py", "nn/spatial.py",
                 "tools/flagship.py", "tools/profile_step.py",
                 "tools/compare_refine_res.py", "tools/conv_roofline.py",
                 "tools/op_traffic.py", "train/optax_rules.py",
                 "tools/bench.py"):
        assert REPO / "dasac_tpu_torch" / name in files
    bad = {str(p.relative_to(REPO)): sorted(set(_imported_roots(p)) & BANNED)
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


class _MC:
    LR = 0.01
    WEIGHT_DECAY = 5e-4
    OPT = "SGD"
    OPT_NESTEROV = False
    MOMENTUM = 0.9


def test_entry_points_raise_without_a_device(monkeypatch):
    model = build_model("tiny", 5, device="cpu")
    opt = optim.build_optimizer(_MC, "tiny", model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("tiny", 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(model, opt, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.make_sac_step(steps.StepConfig())
    for make in (steps.make_abn_step, steps.make_eval_step,
                 steps.make_target_eval_step, steps.make_visual_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(steps.StepConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.make_infer_fn(model, (0.5,) * 3, (0.2,) * 3)
    # naming the CPU is the caller's explicit choice
    assert create_train_state(model, opt, 5, device="cpu").step == 0


def test_trainer_cli_raises_without_a_device_before_touching_data(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--cfg", str(tmp_path / "missing.yaml"), "--logdir",
            str(tmp_path / "logs"), "--snapshot-dir", str(tmp_path / "snap"),
            "--set", "DATASET.ROOT", str(tmp_path / "no_data")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    # no config read (the file does not exist), no directory made
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("main", [infer_cli.main, bench_infer.main],
                         ids=["infer_cli", "bench_infer"])
def test_inference_entry_points_raise_without_a_device(monkeypatch, tmp_path,
                                                       main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--cfg", str(tmp_path / "missing.yaml"), "--resume",
            str(tmp_path / "missing.pth"), "--mask-output-dir",
            str(tmp_path / "out")] if main is infer_cli.main else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.run_inference(build_model("tiny", 5, device="cpu"), None,
                             str(tmp_path / "out"), mean=(0.5,) * 3,
                             std=(0.2,) * 3)
    assert not any(tmp_path.iterdir())


def test_recipe_raises_without_a_device_before_touching_data(monkeypatch,
                                                            tmp_path):
    from dasac_tpu_torch.tools import recipe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe.main(["--work", str(tmp_path / "work"), "--out",
                     str(tmp_path / "records.jsonl")])
    # no corpus, no record, no directory
    assert not any(tmp_path.iterdir())


def test_cudnn_autotuning_is_set_for_the_card_only(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    autotune_convolutions(torch.device("cpu"))
    assert torch.backends.cudnn.benchmark is False
    autotune_convolutions(torch.device("cuda"))
    assert torch.backends.cudnn.benchmark is True


def test_bench_infer_spatial_raises_naming_item_10():
    """Spatial mode (ROADMAP item 10) is ported: a layout the world cannot
    make raises ``ValueError`` naming the world and N, a height that does
    not tile the ranks of a frame likewise, and the CPU is refused as
    before."""
    args = bench_infer.parse_args(["--mode", "spatial", "--sp", "3"])
    with pytest.raises(ValueError,
                       match="spatial=3 must divide the 4-rank world"):
        bench_infer.layout(args, 4)
    args = bench_infer.parse_args(["--mode", "spatial", "--hw", "42", "64"])
    with pytest.raises(ValueError, match="height 42 must tile the 4 ranks"):
        bench_infer.layout(args, 4)
    assert bench_infer.layout(bench_infer.parse_args(
        ["--mode", "spatial", "--sp", "2"]), 8) == (4, 2, 4)
    with pytest.raises(ValueError, match="times the card"):
        bench_infer.main(["--mode", "spatial"], device="cpu")


def test_ce_wrapper_has_no_fallback_off_the_cpu():
    x = torch.empty(4, 19, device="meta")
    lbl = torch.empty(4, dtype=torch.int32, device="meta")
    before = dict(ce.LAUNCHES)
    with pytest.raises(ValueError, match="no CE kernel"):
        ce.nll_fwd(x, lbl)
    with pytest.raises(ValueError, match="no CE kernel"):
        ce.nll_bwd(x, lbl, torch.empty(4, device="meta"))
    assert ce.LAUNCHES == before
    # the plain version on the CPU is no launch
    ce.nll_fwd(torch.zeros(4, 19), torch.zeros(4, dtype=torch.int32))
    assert ce.LAUNCHES == before


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_a_result(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_smoke(REPO)
    assert r.returncode != 0 and not _printed_a_result(r.stdout)
    # alone in a directory, without the port
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and not _printed_a_result(r.stdout)
