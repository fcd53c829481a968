"""The port's launchers (``dasac_tpu_torch/launch/{train,infer_val}.sh``)
against ``launch/{train,infer_val}.sh`` under ``DASAC_DRYRUN`` (which prints
the dispatched command and stops).

  * for each source, net, ``base`` and the environment (``RESUME``,
    ``IS_WEIGHTS``, ``EXP``, ``EXP_ID``; ``SCALES``, ``FLIP``, ``BATCH``,
    ``SPATIAL``, ``OUTPUT_DIR``, ``DATALOADER``), the port's launcher prints
    the command that ``launch/`` prints, with ``python train.py`` /
    ``python infer_val.py`` replaced by ``python -m
    dasac_tpu_torch.train.cli`` / ``...infer.cli``, and its flags parse in
    the port's CLI;
  * the guards refuse as ``launch/``'s do (unknown source or net, SAC
    without ``RESUME``, no ``SNAPSHOT_PATH``) and also refuse a flax
    ``.ckpt``, naming ``dasac_tpu.tools.export_torch``.
"""

import os
import shlex
import subprocess
from pathlib import Path

import pytest

from dasac_tpu_torch.core.opts import get_arguments
from dasac_tpu_torch.infer import cli as infer_cli

REPO = Path(__file__).resolve().parents[1]
PROGRAMS = {"train.sh": ("python train.py",
                         "python -m dasac_tpu_torch.train.cli"),
            "infer_val.sh": ("python infer_val.py",
                             "python -m dasac_tpu_torch.infer.cli")}


def _run(launcher, args, env):
    p = subprocess.run(["bash", launcher, *args],
                       env={**os.environ, "DASAC_DRYRUN": "1", **env},
                       cwd=REPO, capture_output=True, text=True)
    return p.returncode, p.stdout + p.stderr


def _command(out, program):
    lines = [line for line in out.splitlines() if line.startswith(program)]
    assert len(lines) == 1, out
    return " ".join(lines[0].split())


def _both(script, args, env):
    """(rc, out) of launch/<script> and of the port's, with the port's
    dispatched command mapped back to launch/'s program."""
    jax_prog, port_prog = PROGRAMS[script]
    rc_j, out_j = _run("launch/" + script, args, env)
    rc_t, out_t = _run("dasac_tpu_torch/launch/" + script, args, env)
    assert rc_j == rc_t == 0, (out_j, out_t)
    cmd_j, cmd_t = _command(out_j, jax_prog), _command(out_t, port_prog)
    assert cmd_t == cmd_j.replace(jax_prog, port_prog, 1)
    return shlex.split(cmd_t)[len(shlex.split(port_prog)):], out_t


@pytest.fixture
def files(tmp_path):
    out = {}
    for name in ("abn.pth", "abn.ckpt", "w.data"):
        out[name] = tmp_path / name
        out[name].write_bytes(b"x")
    return out


@pytest.mark.parametrize("src,net,base", [
    ("gta", "resnet101", "base"), ("synthia", "vgg16", "base"),
    ("gta", "vgg16fcn", "base"), ("gta", "resnet101", ""),
    ("synthia", "resnet101", ""), ("gta", "vgg16", ""),
    ("synthia", "vgg16fcn", "")])
def test_train_dispatch_equals_launchs(src, net, base, files, tmp_path):
    env = {"RESUME": str(files["abn.pth"]), "EXP": "x", "EXP_ID": "r7"}
    if src == "synthia" and not base:
        env["IS_WEIGHTS"] = str(files["w.data"])
    flags, out = _both("train.sh", [src, net, base], env)
    args = get_arguments(flags)
    assert os.path.isfile(REPO / args.cfg_file)
    assert args.exp == "x" and args.run.startswith("r7")
    if base:
        assert "MODEL.BASELINE" in args.set_cfgs and args.resume is None
    else:
        assert args.resume == str(files["abn.pth"])
        assert ("DATASET.SAMPLE_WEIGHTS" in args.set_cfgs) == (
            "IS_WEIGHTS" in env), out
        assert ("uniform sampling" in out) == ("IS_WEIGHTS" not in env)
    assert ("VAL.IGNORE_CLASS" in args.set_cfgs) == (src == "synthia")


@pytest.mark.parametrize("env", [
    {}, {"FLIP": "1", "SPATIAL": "1", "BATCH": "16"}, {"SPATIAL": "4"},
    {"SCALES": "0.75 1.0 1.25", "OUTPUT_DIR": "OUT", "DATALOADER": "city"}])
def test_infer_dispatch_equals_launchs(env, files, tmp_path):
    env = dict(env, SNAPSHOT_PATH=str(files["abn.pth"]),
               OUTPUT_DIR=str(tmp_path / env.get("OUTPUT_DIR", "results")))
    flags, _ = _both("infer_val.sh", ["deeplabv2_vgg16_train",
                                      "train_cityscapes"], env)
    args = infer_cli.parse_args(flags)
    assert os.path.isfile(REPO / args.cfg_file)
    assert args.infer_list == "data/train_cityscapes.txt"
    assert args.flip == ("FLIP" in env)
    assert args.batch == int(env.get("BATCH", 0))
    assert args.spatial == {"1": -1, "4": 4}.get(env.get("SPATIAL"), 0)


@pytest.mark.parametrize("script,args,env,says", [
    ("train.sh", ["kitti", "resnet101"], {}, "not supported"),
    ("train.sh", ["gta", "resnet50"], {}, "not supported"),
    ("train.sh", ["gta", "resnet101"], {"RESUME": ""}, "RESUME"),
    ("infer_val.sh", [], {"SNAPSHOT_PATH": ""}, "SNAPSHOT_PATH")])
def test_guards_refuse_as_launchs(script, args, env, says, tmp_path):
    env = dict(env, OUTPUT_DIR=str(tmp_path))
    for path in ("launch/", "dasac_tpu_torch/launch/"):
        rc, out = _run(path + script, args, env)
        assert rc != 0 and says in out, (path, out)


@pytest.mark.parametrize("script,args,var", [
    ("train.sh", ["gta", "resnet101"], "RESUME"),
    ("infer_val.sh", [], "SNAPSHOT_PATH")])
def test_a_flax_ckpt_is_refused_naming_the_converter(script, args, var,
                                                     files):
    env = {var: str(files["abn.ckpt"]), "OUTPUT_DIR": str(files["abn.ckpt"]
                                                        .parent / "out")}
    rc, out = _run("launch/" + script, args, env)
    assert rc == 0, out  # dasac_tpu reads it
    rc, out = _run("dasac_tpu_torch/launch/" + script, args, env)
    assert rc != 0 and "dasac_tpu.tools.export_torch" in out, out
    assert "python -m dasac_tpu_torch" not in out
