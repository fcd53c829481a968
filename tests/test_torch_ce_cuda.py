"""What the CPU can check of the CUDA CE kernels (dasac_tpu_torch/csrc/ce.cu
and its binding in dasac_tpu_torch/ops/ce.py): the ctypes signatures
against the C declarations, the choice between the bulk and strided paths,
the build command, and that nothing gives way when the build cannot run.
No JAX is needed; tests/test_torch_gpu.py runs the kernels on the card.
"""

import ctypes
import re

import pytest
import torch

from dasac_tpu_torch.ops import ce, cuda_build

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int64_t": ctypes.c_int64, "int": ctypes.c_int,
            "const char*": ctypes.c_char_p}


def _declarations():
    """``extern "C"`` functions of ce.cu: name -> (restype, argtypes)."""
    src = ce.SOURCE.read_text()
    out = {}
    for ret, name, params in re.findall(
            r'extern "C" ([\w ]+?\*?) (\w+)\(([^)]*)\)', src):
        kinds = [re.sub(r"\s+\w+$", "", p.strip()).replace(" *", "*")
                 for p in params.split(",")]
        out[name] = (_C_TYPES[ret.strip()], [_C_TYPES[k] for k in kinds])
    return out


def test_bound_signatures_match_the_c_declarations():
    decls = _declarations()
    assert set(decls) == set(ce.SIGNATURES)
    for name, (restype, argtypes) in ce.SIGNATURES.items():
        assert decls[name] == (restype, list(argtypes)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_aligned_rows_take_the_bulk_path(dtype):
    x = torch.randn(1000, 19).to(dtype)
    lbl = torch.randint(0, 19, (1000,), dtype=torch.int32)
    g = torch.rand(1000)
    assert x.data_ptr() % 16 == 0
    assert ce.kernel_path("nll_fwd", x, lbl) == "bulk"
    assert ce.kernel_path("nll_bwd", x, lbl, g) == "bulk"
    assert ce.kernel_path("nll_fwd", x, lbl.long()) == "bulk"


@pytest.mark.parametrize("view", ["offset", "class_slice", "transposed",
                                  "label_offset", "grad_stride"])
def test_strided_or_unaligned_inputs_take_the_strided_path(view):
    x = torch.randn(1001, 19)
    lbl = torch.randint(0, 19, (1001,), dtype=torch.int32)
    g = torch.rand(1001)
    if view == "offset":                 # 76 bytes off a 16-byte boundary
        x, lbl, g = x[1:], lbl[1:], g[1:]
    elif view == "class_slice":          # rows 40 apart
        x = torch.randn(1001, 40)[:, :19]
    elif view == "transposed":           # strides (1, N)
        x = x.t().contiguous().t()
    elif view == "label_offset":
        lbl = torch.randint(0, 19, (1002,), dtype=torch.int32)[1:]
    else:
        g = torch.rand(2002)[::2]
    assert ce.kernel_path("nll_bwd", x, lbl, g) == "strided"
    if view != "grad_stride":
        assert ce.kernel_path("nll_fwd", x, lbl) == "strided"


def test_rows_too_wide_for_shared_memory_take_the_strided_path():
    x = torch.randn(300, 48)
    lbl = torch.zeros(300, dtype=torch.int32)
    assert ce.kernel_path("nll_fwd", x, lbl) == "bulk"
    assert ce.kernel_path("nll_bwd", x, lbl, torch.rand(300)) == "strided"
    assert ce.kernel_path("nll_fwd", torch.randn(300, 256), lbl) == "strided"


def test_missing_nvcc_raises_and_launches_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(ce, "_LIB", None)
    before = dict(ce.LAUNCHES)
    paths = {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()}
    with pytest.raises(RuntimeError, match="no nvcc"):
        cuda_build.build(ce.SOURCE)
    # the launch path itself: the build fails before anything is counted
    x = torch.randn(300, 19)
    lbl = torch.zeros(300, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no nvcc"):
        ce._launch_fwd(x, lbl)
    with pytest.raises(RuntimeError, match="no nvcc"):
        ce._launch_bwd(x, lbl, torch.rand(300))
    assert ce.LAUNCHES == before
    assert {k: dict(v) for k, v in ce.PATH_LAUNCHES.items()} == paths
    assert not list(tmp_path.iterdir())


def test_failed_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ce.cu(1): error: no such thing' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="no such thing"):
        cuda_build.build(ce.SOURCE)


def test_build_command_targets_sm90a_under_build():
    out = cuda_build.library_path(ce.SOURCE)
    cmd = cuda_build.build_command("nvcc", ce.SOURCE, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-use_fast_math" not in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    assert out.parent == cuda_build.REPO / "build" / "kernels"
    assert out.name.startswith("ce_") and out.suffix == ".so"


def test_library_name_follows_the_source(tmp_path):
    a, b = tmp_path / "k.cu", tmp_path / "k2.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    assert (cuda_build.library_path(a).name.split("_")[1]
            != cuda_build.library_path(b).name.split("_")[1])


def test_nvcc_lookup_order(monkeypatch, tmp_path):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    (home / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert cuda_build.find_nvcc() == str(home / "bin" / "nvcc")


def test_non_hopper_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    with pytest.raises(RuntimeError, match="sm_90a"):
        cuda_build.require_hopper(torch.device("cuda", 0))


def test_label_and_gradient_types_the_kernels_do_not_take_raise():
    x = torch.randn(8, 19)
    with pytest.raises(TypeError, match="int32 or int64"):
        ce.check_inputs(x, torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(TypeError, match="integer labels"):
        ce.check_inputs(x, torch.zeros(8))
    with pytest.raises(TypeError, match="f32 upstream gradient"):
        ce.check_inputs(x, torch.zeros(8, dtype=torch.int64),
                        torch.zeros(8, dtype=torch.bfloat16))
    ce.check_inputs(x.half(), torch.zeros(8, dtype=torch.int64),
                    torch.zeros(8))
