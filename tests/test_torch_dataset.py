"""The port's dataset program against dasac_tpu's on the CPU: the id
mappers, 16-bit reads, ``convert_train_ids``, ``make_split_lists``,
``check_dataset``, ``pack_dataset`` and ``make_domain_gap_root``.

  * the LUTs of every mapper are equal, and so is what ``read`` gives for
    8-bit and 16-bit label files; ``SynthiaMapper.read`` and
    ``read_png16`` equal dasac_tpu's on ``tests/test_png16.py``'s cases
    (every row filter, the Paeth wrap-around, IDAT before IHDR a
    ``ValueError``);
  * the converted labels (decoded) and the returned counts are equal;
  * the split lists are byte-equal for the same root, limit and seed;
  * ``check_dataset``'s report and exit code are equal, and its failures
    too but for the module they name, on ``tests/test_check_dataset.py``'s
    cases;
  * the packs are byte-equal with ``TPU.NATIVE_LOADER`` on in both;
  * ``make_domain_gap_root`` writes the same pixels and split files.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from dasac_tpu.data import id_mappers as jmap
from dasac_tpu.data import native as jnative
from dasac_tpu.data import packed as jpacked
from dasac_tpu.data import synth as jsynth
from dasac_tpu.data.png16 import read_png16 as jread_png16
from dasac_tpu.tools import check_dataset as jcheck
from dasac_tpu.tools import convert_train_ids as jconvert
from dasac_tpu.tools import make_split_lists as jsplits
from dasac_tpu.tools import pack_dataset as jpack
from dasac_tpu_torch.data import id_mappers as tmap
from dasac_tpu_torch.data import native as tnative
from dasac_tpu_torch.data import packed as tpacked
from dasac_tpu_torch.data import synth as tsynth
from dasac_tpu_torch.data.png16 import read_png16 as tread_png16
from dasac_tpu_torch.tools import check_dataset as tcheck
from dasac_tpu_torch.tools import convert_train_ids as tconvert
from dasac_tpu_torch.tools import make_split_lists as tsplits
from dasac_tpu_torch.tools import pack_dataset as tpack
from tests.test_png16 import _write_png16


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im)


# ---------------------------------------------------------------------------
# id mappers and 16-bit reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cs", "gta", "synthia", "SYNTHIA"])
def test_mapper_luts_equal_jax(name):
    ours, ref = tmap.get_mapper(name), jmap.get_mapper(name)
    np.testing.assert_array_equal(ours.LUT, ref.LUT)
    assert ours.LUT.dtype == np.uint8 and ours.ext() == ref.ext()
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(ours.remap(raw), ref.remap(raw))
    assert [ours()[k] for k in range(256)] == [ref()[k] for k in range(256)]


def _label_files(d):
    """8-bit label files PIL writes, and 16-bit ones of every colour type."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 34, (6, 7)).astype(np.uint8)
    p = Image.fromarray(ids, "P")
    p.putpalette(rng.randint(0, 255, 768).astype(np.uint8))
    files = {"L": Image.fromarray(ids), "P": p,
             "RGB": Image.fromarray(np.stack([ids, ids // 2, ids * 3], -1)),
             "RGBA": Image.fromarray(np.stack([ids, ids, ids // 3, ids],
                                              -1), "RGBA")}
    out = {}
    for k, im in files.items():
        out[k] = str(d / ("%s.png" % k))
        im.save(out[k])
    v16 = rng.randint(0, 2 ** 16, (6, 7, 4)).astype(np.uint16)
    v16[..., 0] = rng.randint(0, 300, (6, 7))
    for ct, c in ((0, 1), (2, 3), (4, 2), (6, 4)):
        out["16bit_%d" % ct] = str(d / ("s%d.png" % ct))
        _write_png16(out["16bit_%d" % ct], v16[..., :c], color_type=ct,
                     filters=[0, 1, 2, 3, 4, 4])
    return out


def test_mapper_reads_equal_jax(tmp_path):
    for kind, path in _label_files(tmp_path).items():
        for cls in ("CityscapesMapper", "GameMapper", "SynthiaMapper"):
            ours = getattr(tmap, cls).read(path)
            ref = getattr(jmap, cls).read(path)
            assert ours.dtype == ref.dtype == np.uint8, (kind, cls)
            np.testing.assert_array_equal(ours, ref, err_msg="%s %s"
                                          % (kind, cls))


@pytest.mark.parametrize("case", ["filters_0_2", "sub", "average", "paeth",
                                  "paeth_wraparound", "synthia_ids"])
def test_read_png16_and_synthia_read_equal_jax(tmp_path, case):
    rng = np.random.RandomState(len(case))
    p = str(tmp_path / "m.png")
    if case == "filters_0_2":
        _write_png16(p, rng.randint(0, 2 ** 16, (6, 5, 3)).astype(np.uint16),
                     filters=[0, 2, 0, 2, 2, 0])
    elif case == "paeth_wraparound":
        vals = np.array([[[0x0001], [0xFF00]], [[0x2233], [0x0102]]],
                        np.uint16)
        _write_png16(p, vals, color_type=0, filters=[0, 4])
    elif case == "synthia_ids":
        ids = np.arange(1, 21).reshape(4, 5).astype(np.uint16)
        _write_png16(p, np.stack([ids, ids * 0, ids * 0], -1))
    else:
        f = {"sub": 1, "average": 3, "paeth": 4}[case]
        _write_png16(p, rng.randint(0, 2 ** 16, (7, 6, 3)).astype(np.uint16),
                     filters=[0, f, f, 2, f, 1, f])
    ours, ref = tread_png16(p), jread_png16(p)
    assert ours.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tmap.SynthiaMapper.read(p),
                                  jmap.SynthiaMapper.read(p))


def test_read_png16_refuses_what_jax_refuses(tmp_path):
    import struct
    import zlib

    from tests.test_png16 import _chunk

    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IDAT", zlib.compress(b"\0"))
                 + _chunk(b"IEND", b""))
    eight = str(tmp_path / "m8.png")
    Image.fromarray(np.array([[3, 1], [16, 2]], np.uint8)).save(eight)
    for path in (bad, eight):
        for read in (tread_png16, jread_png16):
            with pytest.raises(ValueError):
                read(path)
    # an 8-bit mask reads as itself through the SYNTHIA mapper
    np.testing.assert_array_equal(tmap.SynthiaMapper.read(eight),
                                  jmap.SynthiaMapper.read(eight))
    assert struct.unpack(">I", open(eight, "rb").read()[16:20])[0] == 2


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def _raw_labels(d):
    """Label trees of each dataset: GTA palette and gray ids (one with
    nothing mapped), Cityscapes labelIds in city folders, SYNTHIA 16-bit."""
    rng = np.random.RandomState(5)
    (d / "gta" / "sub").mkdir(parents=True)
    ids = rng.randint(0, 34, (9, 11)).astype(np.uint8)
    p = Image.fromarray(ids, "P")
    p.putpalette(rng.randint(0, 255, 768).astype(np.uint8))
    p.save(d / "gta" / "a.png")
    Image.fromarray(ids[::-1].copy()).save(d / "gta" / "sub" / "b.png")
    Image.fromarray(np.full((9, 11), 3, np.uint8)).save(d / "gta" / "c.png")
    Image.fromarray(np.stack([ids] * 3, -1)).save(d / "gta" / "rgb.png")
    for city in ("aachen", "bremen"):
        (d / "cs" / city).mkdir(parents=True)
        Image.fromarray(ids + 1).save(
            d / "cs" / city / ("%s_0_gtFine_labelIds.png" % city))
        Image.fromarray(ids).save(d / "cs" / city / ("%s_0_color.png"
                                                     % city))
    (d / "synthia").mkdir()
    _write_png16(str(d / "synthia" / "0001.png"),
                 np.stack([rng.randint(0, 23, (9, 11)), rng.randint(
                     0, 9, (9, 11)), np.zeros((9, 11), int)], -1)
                 .astype(np.uint16), filters=[4] * 9)


@pytest.mark.parametrize("dataset", ["gta", "cs", "synthia"])
def test_convert_train_ids_equals_jax(tmp_path, dataset):
    _raw_labels(tmp_path)
    src = str(tmp_path / dataset)
    n_ours = tconvert.preprocess(dataset, src, str(tmp_path / "t"),
                                 verbose=False)
    n_ref = jconvert.preprocess(dataset, src, str(tmp_path / "j"),
                                verbose=False)
    assert n_ours == n_ref == {"gta": 3, "cs": 2, "synthia": 1}[dataset]
    written = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "j")
                     for r, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert written == sorted(
        os.path.relpath(os.path.join(r, f), tmp_path / "t")
        for r, _, fs in os.walk(tmp_path / "t") for f in fs)
    for rel in written:
        with Image.open(tmp_path / "t" / rel) as im:
            assert im.mode == "L"
        np.testing.assert_array_equal(_pil(tmp_path / "t" / rel),
                                      _pil(tmp_path / "j" / rel))
    tconvert.main(["--dataset", dataset, "--ann-data", src, "--ann-out",
                   str(tmp_path / "m")])


@pytest.mark.parametrize("argv", [
    ["--dataset", "cityscapes", "--image-dir", "leftImg8bit/train",
     "--label-dir", "labels_cs/train"],
    ["--dataset", "cityscapes", "--image-dir", "leftImg8bit/train",
     "--label-dir", "labels_cs/train", "--limit", "4", "--seed", "3"],
    ["--dataset", "gta", "--image-dir", "images"],
    ["--dataset", "gta", "--image-dir", "images", "--label-dir", "labels",
     "--limit", "2"]])
def test_split_lists_equal_jax(tmp_path, argv):
    root = tmp_path / "root"
    for city in ("zurich", "aachen"):
        (root / "leftImg8bit" / "train" / city).mkdir(parents=True)
        (root / "labels_cs" / "train" / city).mkdir(parents=True)
        for i in range(4):
            stem = "%s_%02d" % (city, i)
            (root / "leftImg8bit" / "train" / city
             / (stem + "_leftImg8bit.png")).write_bytes(b"")
            if i != 2:   # an image without its label is left out
                (root / "labels_cs" / "train" / city
                 / (stem + "_gtFine_labelIds.png")).write_bytes(b"")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    for i in (3, 1, 2, 10):
        (root / "images" / ("%05d.png" % i)).write_bytes(b"")
        (root / "labels" / ("%05d.png" % i)).write_bytes(b"")
    outs = []
    for mod, name in ((tsplits, "t.txt"), (jsplits, "j.txt")):
        mod.main(argv + ["--root", str(root), "--out", str(tmp_path / name)])
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1] and outs[0]


def _root(tmp_path, **kw):
    return jsynth.make_synthetic_root(str(tmp_path / "data"), hw=(32, 48),
                                      n_train_src=4, n_train_tgt=4, n_val=2,
                                      **kw)


def _synthia_root(tmp_path):
    root = _root(tmp_path, source_split="train_synthia_9K",
                 val_splits=("val_cityscapes", "val2_cityscapes",
                             "val_synthia"))
    ids = np.arange(1, 13).repeat(128).reshape(32, 48).astype(np.uint16)
    _write_png16(os.path.join(root, "labels", "src_000.png"),
                 np.stack([ids, ids * 0, ids * 0], -1))
    return root, "synthia", 1


def _gray16_root(tmp_path):
    root = _root(tmp_path)
    ids = np.where(np.arange(32 * 48).reshape(32, 48) % 7 == 0,
                   255, 11).astype(np.uint16)
    _write_png16(os.path.join(root, "labels", "src_000.png"), ids[..., None],
                 color_type=0)
    return root, "gta", 0


def _labels_root(tmp_path, mask):
    root = _root(tmp_path)
    Image.fromarray(np.full((32, 48), 26, np.uint8)).save(
        os.path.join(root, "labels", mask))
    return root, "gta", 0


def _missing_root(tmp_path):
    root = _root(tmp_path)
    os.remove(os.path.join(root, "images", "src_001.png"))
    return root, "gta", 0


def _stale_root(tmp_path):
    root = _root(tmp_path)
    os.makedirs(os.path.join(root, "packed"))
    with open(os.path.join(root, "packed", "train_cityscapes_32x48.json"),
              "w") as f:
        json.dump({"version": 2, "n": 99, "hw": [32, 48], "mode": "resize",
                   "mask_basenames": ["stale.png"]}, f)
    return root, "gta", 0


CHECK_CASES = {
    "ready": lambda t: (_root(t), "gta", 0),
    "missing": _missing_root,
    "unconverted_labelids": lambda t: _labels_root(t, "tgt_000.png"),
    "source_id_hint": lambda t: _labels_root(t, "src_000.png"),
    "synthia_16bit": _synthia_root,
    "gray16_trainids": _gray16_root,
    "stale_pack": _stale_root,
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_dataset_equals_jax(tmp_path, case, capsys):
    root, task, seed = CHECK_CASES[case](tmp_path)
    for spot in (2, 4):
        ours = tcheck.check_root(root, task, spot=spot, seed=seed,
                                 verbose=False)
        ref = jcheck.check_root(root, task, spot=spot, seed=seed,
                                verbose=False)
        assert ours[0] == ref[0]
        assert [f.replace("dasac_tpu_torch.", "dasac_tpu.")
                for f in ours[1]] == ref[1]
    argv = ["--root", root, "--task", task, "--seed", str(seed)]
    rc_ours = tcheck.main(argv + ["--json", str(tmp_path / "t.json")])
    rc_ref = jcheck.main(argv + ["--json", str(tmp_path / "j.json")])
    assert rc_ours == rc_ref == (0 if case in ("ready", "gray16_trainids")
                                 else 1)
    reports = [json.loads((tmp_path / n).read_text().replace(
        "dasac_tpu_torch.", "dasac_tpu.")) for n in ("t.json", "j.json")]
    assert reports[0] == reports[1]
    out = capsys.readouterr().out
    assert out.count("\nREADY: ") == 2 * (rc_ours == 0)
    assert out.count("NOT READY") == 2 * rc_ours


def test_packs_equal_jax_with_the_native_loader(tmp_path):
    assert jnative.available()
    jnative.set_enabled(True)
    tnative.set_enabled(True)
    root = jsynth.make_synthetic_root(str(tmp_path / "r"), hw=(30, 44),
                                      src_hw=(26, 40), n_train_src=3,
                                      n_train_tgt=2, n_val=2)
    before = dict(tnative.PATH_DECODES)
    for split, size in (("train_game_9K", None), ("train_cityscapes",
                                                  (20, 24))):
        jhdr = jpack.pack_split(root, split, size=size, out_dir=str(
            tmp_path / "j"), verbose=False)
        thdr = tpack.pack_split(root, split, size=size, out_dir=str(
            tmp_path / "t"), verbose=False)
        hw = tpacked.PackedDataset(thdr).out_hw
        assert jhdr == jpacked.pack_paths(str(tmp_path / "j"), split, hw)[0]
        for a, b in zip(jpacked.pack_paths(str(tmp_path / "j"), split, hw),
                        tpacked.pack_paths(str(tmp_path / "t"), split, hw)):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if a.endswith(".json"):
                    assert json.load(fa) == json.load(fb)
                else:
                    assert fa.read() == fb.read(), b
    assert tnative.PATH_DECODES["native"] - before["native"] == 5
    assert tnative.PATH_DECODES["python"] == before["python"]
    assert tpack.main(["--root", root, "--split", "val_cityscapes",
                       "--out", str(tmp_path / "m")]) == 0


def test_domain_gap_root_equals_jax(tmp_path):
    kw = dict(n_train_src=2, n_train_tgt=2, n_val=1, src_hw=(26, 35),
              tgt_hw=(20, 40), seed=4)
    jroot = jsynth.make_domain_gap_root(str(tmp_path / "j"), **kw)
    troot = tsynth.make_domain_gap_root(str(tmp_path / "t"), **kw)
    names = sorted(os.path.relpath(os.path.join(r, f), jroot)
                   for r, _, fs in os.walk(jroot) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), troot)
                           for r, _, fs in os.walk(troot) for f in fs)
    assert len(names) == 5 + 2 * 7
    for rel in names:
        a, b = os.path.join(jroot, rel), os.path.join(troot, rel)
        if rel.endswith(".txt"):
            assert open(a).read() == open(b).read()
        else:
            np.testing.assert_array_equal(_pil(b), _pil(a))
