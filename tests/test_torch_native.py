"""The port's binding of the C++ PNG decoder (``data/native_build.py``,
``data/native.py``) and the loader's routes through it, on the CPU.

  * the build: ``native/Makefile``'s flags, compiled by path into
    ``build/native/``, nothing written under ``native/``, no ``make``; a
    missing ``g++`` or a failed build raises naming the command and
    ``TPU.NATIVE_LOADER False``, and the loader does not decode in Python
    instead;
  * the ctypes signatures against the ``extern "C"`` declarations;
  * ``decode_pair``, ``decode_batch`` and ``png_info`` byte-equal to
    ``dasac_tpu.data.native``'s on PIL-written files (RGB, gray, palette,
    RGBA, gray + alpha) and on port-written files of all five row filters,
    with palette masks, a missing file (status ``[0, -1]``) and a missing
    mask (filled with 255);
  * the loader's routes, counted in ``native.PATH_DECODES``: resize-mode
    batches in one library call, exact center-crop and native-mode decodes,
    refusals and non-PNG samples in Python, and the infer CLI's
    ``InferDataset`` (a ``SegDataset``) byte-equal to ``dasac_tpu``'s.
"""

import re
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dasac_tpu.data import host_loader as jhost
from dasac_tpu.data import native as jnative
from dasac_tpu.infer import engine as jengine
from dasac_tpu_torch.data import host_loader as thost
from dasac_tpu_torch.data import native, native_build, png
from dasac_tpu_torch.infer import engine as tengine

REPO = Path(__file__).resolve().parents[1]
HW = (24, 37)


@pytest.fixture(autouse=True)
def _native_on():
    """The flag is process-global: on for each test, restored after."""
    flag = native.enabled()
    native.set_enabled(True)
    yield
    native.set_enabled(flag)


def _frames(seed=0, hw=HW):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    img[hw[0] // 2:] = np.clip(np.cumsum(rng.randint(-3, 4, (hw[0] - hw[0]
                                                           // 2, hw[1], 3)),
                                         1) + 128, 0, 255)
    return img, rng.randint(0, 19, hw).astype(np.uint8)


def _pil_files(d):
    """PIL-written image files of every 8-bit colour type, and masks."""
    img, mask = _frames()
    pal = np.zeros(768, np.uint8)
    pal[:57] = np.random.RandomState(1).randint(0, 255, 57)
    p = Image.fromarray(mask, "P")
    p.putpalette(pal)
    ims = {"rgb": Image.fromarray(img), "gray": Image.fromarray(img[..., 0]),
           "palette": p, "la": Image.fromarray(img[..., 0]).convert("LA"),
           "rgba": Image.fromarray(np.concatenate([img, mask[..., None]],
                                                  -1), "RGBA")}
    out = {}
    for k, im in ims.items():
        out[k] = str(d / ("%s.png" % k))
        im.save(out[k])
    return out


def _port_files(d, filter_type):
    img, mask = _frames(filter_type)
    files = {"img": str(d / ("i%d.png" % filter_type)),
             "gray": str(d / ("g%d.png" % filter_type)),
             "palette": str(d / ("p%d.png" % filter_type))}
    png.write(files["img"], img, filter_type)
    png.write(files["gray"], mask, filter_type)
    png.write(files["palette"], mask, filter_type,
              palette=np.random.RandomState(2).randint(0, 255, (19, 3))
              .astype(np.uint8))
    return files


def _equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def _makefile_flags():
    text = (REPO / "native" / "Makefile").read_text()
    get = lambda pat: re.search(pat, text, re.M).group(1).split()  # noqa
    return ((get(r"^CXXFLAGS \?= (.*)$"), get(r"^LDFLAGS \?= (.*)$")),
            (get(r"^CXXFLAGS \+= (.*)$"), get(r"^LDFLAGS \+= (.*)$")))


def test_build_command_is_the_makefiles_into_build_native(tmp_path,
                                                           monkeypatch):
    (cflags, ldflags), (dflags, dldflags) = _makefile_flags()
    assert native_build.flags(False) == (tuple(cflags), tuple(ldflags))
    assert native_build.flags(True) == (tuple(cflags + dflags),
                                        tuple(ldflags + dldflags))
    for deflate in (False, True):
        out = native_build.library_path(deflate)
        assert out.parent == REPO / "build" / "native"
        cmd = native_build.build_command("g++", deflate, out)
        assert cmd[0] == "g++" and "make" not in " ".join(cmd)
        assert str(REPO / "native" / "dasac_io.cpp") in cmd
        assert all(not a.startswith(str(REPO / "native" / "lib"))
                   for a in cmd)
    assert native_build.library_path(True) != native_build.library_path(
        False)
    # a build from scratch writes its library and log there, nothing under
    # native/
    before = sorted(p.name for p in (REPO / "native").iterdir())
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
    lib = native_build.build()
    assert lib.parent == tmp_path / "b" and lib.is_file()
    assert "-O3" in lib.with_suffix(".log").read_text()
    assert sorted(p.name for p in (REPO / "native").iterdir()) == before
    assert sorted(p.suffix for p in (tmp_path / "b").iterdir()) == [".log",
                                                                   ".so"]


def test_ctypes_signatures_match_the_source():
    import ctypes

    src = (REPO / "native" / "dasac_io.cpp").read_text()
    ctype = {"const char*": ctypes.c_char_p, "int": ctypes.c_int,
             "uint8_t*": ctypes.POINTER(ctypes.c_uint8),
             "int*": ctypes.POINTER(ctypes.c_int),
             "const char**": ctypes.POINTER(ctypes.c_char_p)}
    for name, (restype, argtypes) in native_build.SIGNATURES.items():
        m = re.search(r"^int %s\(([^)]*)\)" % name, src, re.M)
        assert m and restype is ctypes.c_int, name
        params = [" ".join(p.split()[:-1]).replace(" *", "*").replace(
            "* ", "*") for p in m.group(1).replace("\n", " ").split(",")]
        assert [ctype[p] for p in params] == list(argtypes), (name, params)


@pytest.mark.parametrize("fault", ["no_compiler", "build_fails"])
def test_no_working_compiler_raises_under_native_loader(tmp_path,
                                                         monkeypatch, fault):
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", None)
    if fault == "no_compiler":
        monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
        match = "no g\\+\\+ on PATH"
    else:   # as on a host without zlib.h
        bad = tmp_path / "dasac_io.cpp"
        bad.write_text("#include <no_such_zlib.h>\n")
        monkeypatch.setattr(native_build, "SOURCE", bad)
        match = "no_such_zlib.h"
    img, mask = _frames()
    ip, mp = str(tmp_path / "i.png"), str(tmp_path / "m.png")
    png.write(ip, img)
    png.write(mp, mask)
    before = dict(native.PATH_DECODES)
    for mode, call in (("resize", lambda ds: ds.load_batch([0])),
                       ("center_crop", lambda ds: ds.load(0))):
        ds = thost.SegDataset([ip], [mp], (16, 16), mode)
        with pytest.raises(RuntimeError, match=match) as e:
            call(ds)
        assert "TPU.NATIVE_LOADER False" in str(e.value)
    assert native.PATH_DECODES == before   # nothing decoded in Python
    # the flag off decodes in Python without building anything
    native.set_enabled(False)
    assert thost.SegDataset([ip], [mp], None, "native").load(0)[1].shape \
        == HW
    assert native.PATH_DECODES["python"] == before["python"] + 1
    assert native._lib is None


# ---------------------------------------------------------------------------
# byte-equal to dasac_tpu's binding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_hw", [HW, (11, 16), (40, 61)])
def test_decodes_equal_jax_on_pil_files(tmp_path, out_hw):
    assert jnative.available()
    f = _pil_files(tmp_path)
    for kind, path in f.items():
        for mask in (None, f["palette"], f["gray"], f["rgb"]):
            _equal(native.decode_pair(path, mask, out_hw),
                   jnative.decode_pair(path, mask, out_hw))
        assert native.png_info(path) == jnative.png_info(path) == HW
    paths = list(f.values())
    ours = native.decode_batch(paths, [f["palette"]] * len(paths), out_hw,
                               threads=3)
    ref = jnative.decode_batch(paths, [f["palette"]] * len(paths), out_hw,
                               threads=3)
    _equal(ours, ref)
    assert not ours[2].any()


@pytest.mark.parametrize("filter_type", range(5))
def test_decodes_equal_jax_on_port_files(tmp_path, filter_type):
    f = _port_files(tmp_path, filter_type)
    img, mask = _frames(filter_type)
    for out_hw in (HW, (13, 20)):
        for m in (f["gray"], f["palette"], None):
            ours = native.decode_pair(f["img"], m, out_hw, mask_fill=255)
            _equal(ours, jnative.decode_pair(f["img"], m, out_hw,
                                             mask_fill=255))
        if out_hw == HW:   # exact at the frame's own size
            np.testing.assert_array_equal(ours[0], img)
            assert (ours[1] == 255).all()
            np.testing.assert_array_equal(native.decode_pair(
                f["img"], f["palette"], HW)[1], mask)
    missing = str(tmp_path / "missing.png")
    ours = native.decode_batch([f["img"], missing], [f["palette"], None],
                               (13, 20), threads=2)
    ref = jnative.decode_batch([f["img"], missing], [f["palette"], None],
                               (13, 20), threads=2)
    assert ours[2].tolist() == ref[2].tolist() == [0, -1]
    _equal(tuple(a[:1] for a in ours), tuple(a[:1] for a in ref))
    assert native.decode_pair(missing, None, HW) is None
    assert native.png_info(missing) is None


# ---------------------------------------------------------------------------
# the loader's routes
# ---------------------------------------------------------------------------

def _routes(fn):
    before = dict(native.PATH_DECODES)
    out = fn()
    return out, {k: native.PATH_DECODES[k] - before[k] for k in before}


def test_resize_batches_are_one_library_call_with_refusals_in_python(
        tmp_path, monkeypatch):
    f = _port_files(tmp_path, 4)
    upper = str(tmp_path / "x.PNG")   # a PNG the loader does not offer it
    Path(upper).write_bytes(Path(f["img"]).read_bytes())
    i16 = str(tmp_path / "m16.png")   # a 16-bit mask, which it refuses
    Image.fromarray(np.full(HW, 7, np.uint16)).save(i16)
    images = [f["img"], f["img"], upper, f["img"]]
    masks = [f["palette"], None, None, i16]
    idxs = [0, 1, -1, 2, 3]
    calls = []
    real = native.decode_batch
    monkeypatch.setattr(native, "decode_batch",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    for out_hw in ((13, 20), HW):
        ours = thost.SegDataset(images, masks, out_hw, "resize")
        ref = jhost.SegDataset(images, masks, out_hw, "resize")
        calls.clear()
        got, routes = _routes(lambda: ours.load_batch(idxs, threads=2))
        assert len(calls) == 1 and len(calls[0][0]) == 3
        assert routes == {"native": 2, "python": 2}
        want = ref.load_batch(idxs, threads=2)
        for (a, b), (c, d), i in zip(got, want, idxs):
            np.testing.assert_array_equal(b, d)
            if out_hw == HW or i in (0, 1, -1):
                np.testing.assert_array_equal(a, c)
            else:   # torch's bilinear against PIL's, as without the flag
                assert np.abs(a.astype(int) - c).max() <= 1


@pytest.mark.parametrize("mode", ["center_crop", "native"])
def test_crop_and_native_modes_decode_exactly_in_the_library(tmp_path,
                                                             mode):
    f = _pil_files(tmp_path)
    out_hw = (16, 50) if mode == "center_crop" else None
    cases = {"gray mask": ("rgb", "gray", "native"),
             "palette mask": ("palette", "palette", "native"),
             "no mask": ("la", None, "native"),
             "rgba image": ("rgba", "palette", "native"),
             # the library's luma is not PIL's convert("L")
             "rgb mask": ("rgb", "rgb", "python")}
    for what, (im, m, route) in cases.items():
        args = [f[im]], [m and f[m]], out_hw, mode
        got, routes = _routes(lambda: thost.SegDataset(*args).load(0))
        assert routes[route] == 1 and sum(routes.values()) == 1, what
        want = jhost.SegDataset(*args).load(0)
        for a, b in zip(got, want):
            assert a.flags.c_contiguous, what
            np.testing.assert_array_equal(a, b, err_msg=what)


def test_infer_dataset_inherits_the_native_path(tmp_path):
    from dasac_tpu.data import synth as jsynth

    root = jsynth.make_synthetic_root(str(tmp_path / "r"), n_train_src=1,
                                      n_train_tgt=1, n_val=3, hw=(20, 30))
    ours = tengine.InferDataset(root, "val_cityscapes")
    ref = jengine.InferDataset(root, "val_cityscapes")
    got, routes = _routes(lambda: ours.load_batch([0, 1, 2, -1], threads=2))
    assert routes == {"native": 3, "python": 0}
    for (a, b), (c, d) in zip(got, ref.load_batch([0, 1, 2, -1], threads=2)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
