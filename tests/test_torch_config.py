"""The port's config layer against dasac_tpu and PyYAML on the CPU.

  * the YAML-subset reader (dasac_tpu_torch/core/yaml_subset.py) gives what
    ``yaml.safe_load`` gives, value for value and type for type, on every
    file in ``configs/`` and on edge cases of the subset; what it does not
    support raises with the file name and line;
  * ``cfg_from_file`` / ``cfg_from_list`` give configs equal to
    dasac_tpu's (``cfg_snapshot()``), including the ``launch/train.sh``
    overrides, and raise the same exception types;
  * ``get_arguments`` gives the same namespace; more than one process
    raises.
"""

import glob
import os

import pytest
import yaml

from dasac_tpu.core import config as jconfig
from dasac_tpu.core import opts as jopts
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.core import dist
from dasac_tpu_torch.core import opts as topts
from dasac_tpu_torch.core import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


def _typed(obj):
    """Values with their types, recursively (True == 1 == 1.0 in Python)."""
    if isinstance(obj, dict):
        return {k: _typed(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [_typed(v) for v in obj])
    return (type(obj).__name__, obj)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_pyyaml_on_configs(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert _typed(yaml_subset.load(path)) == _typed(ref)


@pytest.mark.parametrize("text", [
    "A: 1e-3", "A: .5", "A: 1.", "A: -2.5e+3", "A: +3", "A: 0", "A: -7",
    "A: True\nB: False", "A: [.7, 1.]", "A: [512, 1024]", "A: []",
    "A: [1, 'a,b', \"c\", d]", "A: 'it''s'", "A: \"x\"  # comment",
    "A: models/pretrained/resnet101-5d3b4d8f.pth", "A: a#b", "A: x # y",
    "# head\nA:\n  B: 1\n  C:\n    D: avg_pool\n\n  E: [9,14,16]\nF: 2",
    "  A: 1\n  B:\n      C: 2", ""])
def test_yaml_reader_types_like_pyyaml(text):
    assert _typed(yaml_subset.loads(text)) == _typed(yaml.safe_load(text))


@pytest.mark.parametrize("text,line", [
    ("A: 1\nB: yes", 2), ("A: null", 1), ("A: ~", 1), ("A: 0x1f", 1),
    ("A: 1_000", 1), ("A: 07", 1), ("A: .inf", 1), ("A: 2020-01-01", 1),
    ("A: true", 1), ("A: {b: 1}", 1), ("A: |", 1), ("A: &x 1", 1),
    ("A: [1, [2]]", 1), ("A: [1,\n  2]", 1), ("A: 'x", 1),
    ("A: \"a\\nb\"", 1), ("A: x: y", 1), ("- a", 1), ("ON: 1", 1),
    ("A: 1\n\tB: 2", 2), ("A:\n  B: 1\n C: 2", 3), ("A: 1\n  B: 2", 2),
    ("---\nA: 1", 1), ("A: [1,, 2]", 1)])
def test_yaml_reader_rejects_the_rest(text, line):
    with pytest.raises(yaml_subset.YamlSubsetError,
                       match=r"^cfg\.yaml:%d: " % line):
        yaml_subset.loads(text, "cfg.yaml")


def test_yaml_reader_rejects_a_key_without_value(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("TRAIN:\nMODEL:\n  LR: 1.\n")
    with pytest.raises(yaml_subset.YamlSubsetError, match="bad.yaml:2"):
        yaml_subset.load(str(p))
    p.write_text("TRAIN:\n")
    with pytest.raises(yaml_subset.YamlSubsetError, match="bad.yaml"):
        yaml_subset.load(str(p))


def _both(fn_name, *args):
    for mod in (jconfig, tconfig):
        getattr(mod, fn_name)(*args)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_cfg_from_file_equals_jax(path):
    _both("cfg_from_file", path)
    assert _typed(tconfig.cfg_snapshot()) == _typed(jconfig.cfg_snapshot())
    # the defaults were replaced, not merged into a new object
    assert tconfig.cfg.MODEL.ARCH == jconfig.cfg.MODEL.ARCH


def test_defaults_equal_jax():
    assert _typed(tconfig.cfg_snapshot()) == _typed(jconfig.cfg_snapshot())


def test_cfg_from_list_train_sh_overrides(tmp_path):
    """launch/train.sh's --set lists: ABN, and SYNTHIA SAC with IS
    weights."""
    weights = str(tmp_path / "cs_weights_resnet101_synthia.data")
    for cfg_file, sets in (
            ("deeplabv2_resnet101.yaml",
             ["MODEL.BASELINE", "True", "TRAIN.TASK", "train_game_9K"]),
            ("deeplabv2_resnet101_train.yaml",
             ["DATASET.SAMPLE_WEIGHTS", weights, "TRAIN.TASK",
              "train_synthia_9K", "VAL.IGNORE_CLASS", "[9,14,16]"])):
        for mod in (jconfig, tconfig):
            mod.reset_cfg()
            mod.cfg_from_file(os.path.join(REPO, "configs", cfg_file))
            mod.cfg_from_list(sets)
        assert _typed(tconfig.cfg_snapshot()) == \
            _typed(jconfig.cfg_snapshot())
    assert tconfig.cfg.VAL.IGNORE_CLASS == [9, 14, 16]
    assert tconfig.cfg.DATASET.SAMPLE_WEIGHTS == weights
    # a float default takes an int, a string default any literal
    _both("cfg_from_list", ["MODEL.LR", "1", "DATASET.ROOT", "123",
                            "TB.IM_SIZE", "[1, 2]"])
    assert _typed(tconfig.cfg_snapshot()) == _typed(jconfig.cfg_snapshot())
    assert tconfig.cfg.TB.IM_SIZE == (1, 2)


@pytest.mark.parametrize("case", ["unknown_file_key", "unknown_list_key",
                                  "type_mismatch", "odd_list",
                                  "immutable"])
def test_config_errors_match_jax(tmp_path, case):
    bad = tmp_path / "bad.yaml"
    bad.write_text("MODEL:\n  NO_SUCH_KEY: 1\n")
    calls = {
        "unknown_file_key": lambda m: m.cfg_from_file(str(bad)),
        "unknown_list_key": lambda m: m.cfg_from_list(["MODEL.NOPE", "1"]),
        "type_mismatch": lambda m: m.cfg_from_list(["TRAIN.BATCH_SIZE",
                                                    "[1]"]),
        "odd_list": lambda m: m.cfg_from_list(["MODEL.LR"]),
        "immutable": lambda m: (m.assert_and_infer_cfg(),
                                m.cfg_from_list(["MODEL.LR", "0.1"])),
    }
    errors = []
    for mod in (jconfig, tconfig):
        with pytest.raises(Exception) as e:
            calls[case](mod)
        errors.append(e.type)
        mod.reset_cfg()
    assert errors[0] is errors[1], errors


def test_get_arguments_equal_namespaces(tmp_path):
    argv = ["--cfg", "configs/tiny_cpu.yaml", "--snapshot-dir",
            str(tmp_path / "snap"), "--logdir", str(tmp_path / "logs"),
            "--exp", "e", "--run", "r", "--workers", "3", "--seed", "7",
            "--resume", "auto", "--profile", "--dataloader", "cityscapes",
            "--set", "MODEL.BASELINE", "True"]
    ours, ref = topts.get_arguments(argv), jopts.get_arguments(argv)
    assert vars(ours) == vars(ref)
    assert os.path.isdir(ours.logdir) and os.path.isdir(ours.snapshot_dir)
    assert ours.logdir == str(tmp_path / "logs" / "cityscapes" / "e" / "r")
    # the defaults too
    base = ["--cfg", "x.yaml", "--logdir", str(tmp_path / "l2"),
            "--snapshot-dir", str(tmp_path / "s2")]
    assert vars(topts.get_arguments(base)) == vars(jopts.get_arguments(base))


@pytest.mark.parametrize("flags", [["--multiprocessing-distributed"],
                                   ["--world-size", "2"]])
def test_opts_refuse_more_than_one_process(tmp_path, flags):
    """Both flags once raised; now each parses, as dasac_tpu's opts do,
    into the launch plan of the world the process joins: the environment's
    (torchrun's) with ``--multiprocessing-distributed``, ``--world-size``
    processes at ``--dist-url`` (or MASTER_ADDR/MASTER_PORT) otherwise."""
    base = ["--cfg", "x.yaml", "--logdir", str(tmp_path / "l"),
            "--snapshot-dir", str(tmp_path / "s")]
    args = topts.get_arguments(base + flags)
    assert vars(args) == vars(jopts.get_arguments(base + flags))
    env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500",
           "WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"}
    plan = topts.launch_plan(args, env)
    if "--multiprocessing-distributed" in flags:
        assert plan == dist.Launch("10.0.0.1:29500", 4, 3, 1)
        with pytest.raises(ValueError, match="MASTER_ADDR, WORLD_SIZE"):
            topts.launch_plan(args, {"MASTER_ADDR": "10.0.0.1"})
    else:
        assert plan == dist.Launch("10.0.0.1:29500", 2, 0, 1)
        args = topts.get_arguments(base + flags + [
            "--rank", "1", "--dist-url", "tcp://host0:23456"])
        assert topts.launch_plan(args, {}) == dist.Launch("host0:23456", 2,
                                                          1, 0)
        args.dist_url = "file:///shared/init"
        with pytest.raises(ValueError, match="--dist-url"):
            topts.launch_plan(args, {})
    # neither flag: no world to join (the trainer CLI may still spawn one)
    assert topts.launch_plan(topts.get_arguments(base), env) is None
