"""The port's data layer against dasac_tpu (and PIL) on the CPU.

PNG codec (dasac_tpu_torch/data/png.py), exactly equal to PIL both ways:
PIL-written RGB, L, P and RGBA files (PIL picks a filter per row) decode to
what ``convert("RGB")`` and the loader's mask rule give; every one of the
five filter types written by the port's encoder reads back equal through
PIL and through the port.

Loaders: on a root written by dasac_tpu's ``make_synthetic_root``, with
``TPU.PACKED_DIR ""`` on both sides, for the same seed:
``steps_per_epoch``, every source and target batch of epochs 0 and 1 (SAC
with importance sampling and IS weights, and ABN), and the val splits in
``resize`` and ``center_crop`` modes.  With ``TPU.NATIVE_LOADER False`` on
both sides (JAX decodes through PIL) masks are exactly equal, and images
are exactly equal where no resize happens and within 1 uint8 level where
one does (torch's uint8 antialiased bilinear against PIL's; the share of
pixels that differ is printed and bounded by 5%).  With ``TPU.NATIVE_LOADER
True`` (the default) on both sides every batch is byte-equal: both decode
and resize through the same C++ library.

Packs: a pack written by dasac_tpu's ``write_pack`` reads equal through
the port (and the port's factory picks it up); the port's ``write_pack``
writes the same bytes.  Samplers and the synthetic root: the same index
streams and the same pixels.
"""

import json
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from dasac_tpu.core import config as jconfig
from dasac_tpu.data import factory as jfactory
from dasac_tpu.data import host_loader as jhost
from dasac_tpu.data import packed as jpacked
from dasac_tpu.data import sampler as jsampler
from dasac_tpu.data import synth as jsynth
from dasac_tpu_torch.core import config as tconfig
from dasac_tpu_torch.data import factory as tfactory
from dasac_tpu_torch.data import host_loader as thost
from dasac_tpu_torch.data import packed as tpacked
from dasac_tpu_torch.data import png
from dasac_tpu_torch.data import sampler as tsampler
from dasac_tpu_torch.data import synth as tsynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_RESIZE_SHARE = 0.05


@pytest.fixture(autouse=True)
def _keep_native_loader_flags():
    """Both packages' Loaders set their process-global native-decoder flag
    from TPU.NATIVE_LOADER: put them back for the tests that follow in
    this process."""
    from dasac_tpu.data import native as jnative
    from dasac_tpu_torch.data import native as tnative

    flags = jnative._enabled, tnative.enabled()
    yield
    jnative.set_enabled(flags[0])
    tnative.set_enabled(flags[1])


@pytest.fixture(autouse=True)
def _reset_port_cfg():
    """The loaders read the process-global config while they run."""
    tconfig.reset_cfg()
    yield
    tconfig.reset_cfg()


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

def _images(seed=0, h=40, w=53):
    """Noise, and a frame of noise, repeated rows, ramps and random walks
    along the rows, for which PIL's adaptive filtering picks several row
    filters (None, Sub, Up and Paeth with Pillow 12)."""
    rng = np.random.RandomState(seed)
    noise = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    mixed = noise.copy()
    mixed[8:16] = mixed[7]
    yy, xx = np.mgrid[0:h, 0:w]
    mixed[16:24] = ((yy * 3 + xx * 2) % 256)[16:24, :, None]
    mixed[24:32] = ((yy * xx) % 256)[24:32, :, None]
    mixed[32:] = np.clip(np.cumsum(rng.randint(-3, 4, (h - 32, w, 3)), 1)
                         + 128, 0, 255)
    return noise, mixed


def _filters_used(path):
    """The set of row-filter bytes in a non-interlaced 8-bit PNG."""
    import zlib

    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            w, h = (int.from_bytes(data[pos + 8 + o:pos + 12 + o], "big")
                    for o in (0, 4))
            bpp = {0: 1, 2: 3, 3: 1, 6: 4}[data[pos + 17]]
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, w * bpp + 1)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["RGB", "RGB_mixed", "L", "P", "RGBA"])
def test_png_decodes_pil_files_exactly(tmp_path, mode):
    noise, smooth = _images()
    im = {"RGB": Image.fromarray(noise),
          "RGB_mixed": Image.fromarray(smooth),
          "L": Image.fromarray(smooth[..., 0]),
          "P": Image.fromarray(smooth).convert("P", palette=Image.ADAPTIVE,
                                               colors=19),
          "RGBA": Image.fromarray(np.concatenate([smooth, noise[..., :1]],
                                                 -1))}[mode]
    path = str(tmp_path / "x.png")
    im.save(path)
    img = png.read(path)
    with Image.open(path) as ref:
        np.testing.assert_array_equal(png.to_rgb(img),
                                      np.asarray(ref.convert("RGB")))
        ref_mask = ref if ref.mode == "P" else ref.convert("L")
        np.testing.assert_array_equal(png.to_mask(img), np.asarray(ref_mask))
        assert png.png_size(path) == (ref.size[1], ref.size[0])
    if mode == "RGB_mixed":
        assert len(_filters_used(path)) >= 3, _filters_used(path)


@pytest.mark.parametrize("filter_type", range(5))
def test_png_encoder_filters_read_by_pil(tmp_path, filter_type):
    noise, smooth = _images(1)
    for arr in (noise, smooth, smooth[..., 1], noise[:1, :1]):
        path = str(tmp_path / "w.png")
        png.write(path, arr, filter_type)
        assert _filters_used(path) == {filter_type}
        with Image.open(path) as ref:
            assert ref.mode == ("L" if arr.ndim == 2 else "RGB")
            np.testing.assert_array_equal(np.asarray(ref), arr)
        np.testing.assert_array_equal(png.read(path).pixels, arr)


def _unfilter_bytewise(data, kinds, bpp):
    """The PNG specification's unfilter, one byte at a time."""
    out = np.zeros(data.shape, np.int64)
    for y, x in np.ndindex(*data.shape):
        a = out[y, x - bpp] if x >= bpp else 0
        b = out[y - 1, x] if y else 0
        c = out[y - 1, x - bpp] if y and x >= bpp else 0
        p = a + b - c
        pred = (0, a, b, (a + b) // 2,
                a if abs(p - a) <= min(abs(p - b), abs(p - c))
                else (b if abs(p - b) <= abs(p - c) else c))[kinds[y]]
        out[y, x] = (data[y, x] + pred) & 0xFF
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_of_mixed_rows_equals_bytewise(bpp):
    """Images with Average or Paeth rows among the others are unfiltered
    along anti-diagonals; every byte is the specification's."""
    rng = np.random.RandomState(bpp)
    for h, w in ((1, 1), (1, 9), (7, 1), (6, 11), (13, 5)):
        data = rng.randint(0, 256, (h, w * bpp)).astype(np.uint8)
        kinds = rng.randint(0, 5, h).astype(np.uint8)
        kinds[rng.randint(h)] = 3 + rng.randint(2)
        raw = np.concatenate([kinds[:, None], data], 1).tobytes()
        np.testing.assert_array_equal(
            png._unfilter(raw, h, w, bpp, "x.png"),
            _unfilter_bytewise(data, kinds, bpp))


def test_png_rejects_what_it_does_not_read(tmp_path):
    # 16-bit gray is read (as uint16, for the offline scorer); it is no
    # image for the loaders, and a mask as PIL's convert("L") reads it
    # (clipped at 255)
    i16 = str(tmp_path / "i16.png")
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 40
                    ).save(i16)
    img = png.read(i16)
    with Image.open(i16) as ref:
        np.testing.assert_array_equal(img.pixels, np.asarray(ref))
        np.testing.assert_array_equal(png.to_mask(img),
                                      np.asarray(ref.convert("L")))
    assert img.pixels.dtype == np.uint16 and img.bit_depth == 16
    assert png.to_mask(img).max() == 255
    with pytest.raises(png.PngError, match="16-bit"):
        png.to_rgb(img)
    cases = {
        "la.png": lambda p: Image.new("LA", (4, 3)).save(p),
        "bits1.png": lambda p: Image.new("1", (4, 3)).save(p),
        "x.jpg": lambda p: Image.new("RGB", (4, 3)).save(p, "JPEG"),
    }
    for name, make in cases.items():
        path = str(tmp_path / name)
        make(path)
        with pytest.raises(png.PngError, match=name):
            png.read(path)
    with pytest.raises(png.PngError, match="x.jpg"):
        png.png_size(str(tmp_path / "x.jpg"))
    good = str(tmp_path / "g.png")
    png.write(good, np.zeros((3, 4), np.uint8))
    data = bytearray(open(good, "rb").read())
    data[-20] ^= 1  # inside the IDAT chunk
    open(good, "wb").write(bytes(data))
    with pytest.raises(png.PngError, match="CRC"):
        png.read(good)
    with pytest.raises(png.PngError):
        png.encode(np.zeros((3, 4), np.float32))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

CROP = (32, 48)


@pytest.fixture(scope="module")
def jax_root(tmp_path_factory):
    """Written by dasac_tpu (PIL).  Source frames at 52x70 (no resize: far
    below the GTA canonical size), target at 48x64 (SAC decodes it resized
    to the crop), val at 28x60 (padded and cropped, or resized)."""
    root = str(tmp_path_factory.mktemp("jroot"))
    jsynth.make_synthetic_root(root, n_train_src=6, n_train_tgt=5, n_val=3,
                               hw=(48, 64), src_hw=(52, 70), val_hw=(28, 60))
    return root


def _is_weights(root, path):
    """Each image's share of a class's target pixels (the
    compute_is_weights format), pickled."""
    counts = {}
    with open(os.path.join(root, "train_cityscapes.txt")) as f:
        for line in f:
            mask = np.asarray(Image.open(os.path.join(root, line.split()[1])))
            counts[os.path.basename(line.split()[1])] = np.bincount(
                mask.ravel(), minlength=256)[:19]
    total = np.maximum(sum(counts.values()), 1)
    weights = {name: {c: float(n[c] / total[c]) for c in np.nonzero(n)[0]}
               for name, n in counts.items()}
    with open(path, "wb") as f:
        pickle.dump(weights, f)
    return path


def _loaders(root, sets, seed=3, native=False):
    out = []
    for mod, fac in ((jconfig, jfactory), (tconfig, tfactory)):
        mod.reset_cfg()
        mod.cfg_from_file(os.path.join(REPO, "configs", "tiny_cpu.yaml"))
        mod.cfg_from_list(["DATASET.ROOT", root, "TPU.NATIVE_LOADER",
                           str(native), "TPU.PACKED_DIR", "",
                           "TRAIN.NUM_GROUPS", "2", "TPU.LOADER_THREADS",
                           "3"] + sets)
        out.append(fac.Loaders(mod.cfg, seed=seed))
    if native:
        from dasac_tpu.data import native as jnative

        assert jnative.available(), "dasac_tpu would decode with PIL"
    return out


def _batches(loader):
    return [tuple(np.array(a) for a in b) for b in loader]


def _compare(ours, ref, resized, what):
    assert len(ours) == len(ref) > 0, what
    shares = []
    for (ti, tm), (ji, jm) in zip(ours, ref):
        assert ti.dtype == np.uint8 and ti.shape == ji.shape, what
        np.testing.assert_array_equal(tm, jm, err_msg=what)
        if resized:
            d = np.abs(ti.astype(np.int16) - ji)
            assert d.max() <= 1, what
            shares.append(float((d > 0).mean()))
        else:
            np.testing.assert_array_equal(ti, ji, err_msg=what)
    if resized:
        share = float(np.mean(shares))
        print("%s: %.4f of the image values differ by 1 level" % (what,
                                                                   share))
        assert share < MAX_RESIZE_SHARE, what


# "-native": TPU.NATIVE_LOADER True on both sides, batches byte-equal
@pytest.mark.parametrize("mode,native", [
    pytest.param("sac", False, id="sac"), pytest.param("abn", False, id="abn"),
    pytest.param("sac", True, id="sac-native"),
    pytest.param("abn", True, id="abn-native")])
def test_train_batches_equal_jax(jax_root, tmp_path, mode, native):
    sets = (["DATASET.SAMPLE_WEIGHTS",
             _is_weights(jax_root, str(tmp_path / "w.pkl"))]
            if mode == "sac" else ["MODEL.BASELINE", "True"])
    ref, ours = _loaders(jax_root, sets, native=native)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 3
    assert (ours.importance is None) == (ref.importance is None) == \
        (mode == "abn")
    for epoch in (0, 1):
        (ts, tt), (js, jt) = ours.train_loaders(epoch), ref.train_loaders(
            epoch)
        _compare(_batches(ts), _batches(js), False,
                 "%s source epoch %d" % (mode, epoch))
        _compare(_batches(tt), _batches(jt), mode == "sac" and not native,
                 "%s target epoch %d" % (mode, epoch))


@pytest.mark.parametrize("val_crop,native", [
    pytest.param("True", False, id="True"),
    pytest.param("False", False, id="False"),
    pytest.param("True", True, id="True-native"),
    pytest.param("False", True, id="False-native")])
def test_val_batches_equal_jax(jax_root, val_crop, native):
    from dasac_tpu_torch.data import native as tnative

    before = dict(tnative.PATH_DECODES)
    ref, ours = _loaders(jax_root, ["DATASET.VAL_CROP", val_crop],
                         native=native)
    assert list(ours.val) == list(ref.val) and ours.testset == ref.testset
    for split in ours.val:
        for bs in (2, 4):
            _compare(_batches(ours.val_loader(split, batch_size=bs)),
                     _batches(ref.val_loader(split, batch_size=bs)),
                     val_crop == "False" and split != "train_cityscapes"
                     and not native,
                     "%s val_crop %s bs %d" % (split, val_crop, bs))
    # every frame took the route the flag chose
    routes = {k: tnative.PATH_DECODES[k] - before[k] for k in before}
    assert routes["native" if native else "python"] > 0, routes
    assert routes["python" if native else "native"] == 0, routes


def test_packs_read_and_write_like_jax(jax_root, tmp_path):
    from dasac_tpu.data import lists as jlists

    jdir, tdir = str(tmp_path / "jpack"), str(tmp_path / "tpack")
    for split, hw, mode in (("train_game_9K", (52, 70), "resize"),
                            ("val_cityscapes", CROP, "center_crop")):
        imgs, msks = jlists.read_split(jax_root, split)
        jhdr = jpacked.write_pack(jhost.SegDataset(imgs, msks, hw, mode),
                                  split, jdir, verbose=False)
        ours = tpacked.PackedDataset(jhdr)
        ref = jpacked.PackedDataset(jhdr)
        for i in range(-1, len(imgs)):
            for a, b in zip(ours.load(i), ref.load(i)):
                np.testing.assert_array_equal(a, b)
        assert ours.mask_basenames() == ref.mask_basenames()
        thdr = tpacked.write_pack(thost.SegDataset(imgs, msks, hw, mode),
                                  split, tdir, verbose=False)
        for a, b in zip(jpacked.pack_paths(jdir, split, hw),
                        tpacked.pack_paths(tdir, split, hw)):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                if a.endswith(".json"):
                    assert json.load(fa) == json.load(fb)
                else:
                    assert fa.read() == fb.read(), b
        assert tpacked.find_pack(tdir, split, hw, mode) == thdr
    # the factory serves the source split from the pack dasac_tpu wrote
    _, ours = _loaders(jax_root, ["TPU.PACKED_DIR", jdir])
    assert isinstance(ours.source, tpacked.PackedDataset)
    assert not isinstance(ours.target, tpacked.PackedDataset)


@pytest.mark.parametrize("n,reps,bs,drop", [(10, 1, 3, True), (10, 2, 2,
                                                                  False),
                                             (7, 3, None, False),
                                             (7, 2, None, True)])
def test_samplers_equal_jax(n, reps, bs, drop):
    for rank in range(reps):
        for epoch in (0, 5):
            a = tsampler.EpochSampler(n, reps, rank, seed=11, drop_last=drop)
            b = jsampler.EpochSampler(n, reps, rank, seed=11, drop_last=drop)
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            np.testing.assert_array_equal(a.indices(bs), b.indices(bs))
    names = ["m%d.png" % i for i in range(n)]
    weights = {nm: {c: (i * 7 + c) % 5 / 10.0 for c in range(3)}
               for i, nm in enumerate(names)}
    a = tsampler.ImportanceSampler(n, 5, names, weights, 0.25, (1,))
    b = jsampler.ImportanceSampler(n, 5, names, weights, 0.25, (1,))
    for idx in range(20):
        assert a.sample(idx, np.random.RandomState(idx)) == b.sample(
            idx, np.random.RandomState(idx))


def test_synthetic_root_equals_jax(tmp_path):
    kw = dict(n_train_src=2, n_train_tgt=3, n_val=2, hw=(20, 30),
              src_hw=(24, 33))
    jroot = jsynth.make_synthetic_root(str(tmp_path / "j"), **kw)
    troot = tsynth.make_synthetic_root(str(tmp_path / "t"), **kw)
    iroot = tsynth.make_synthetic_root(str(tmp_path / "i"), ignore_frac=0.1,
                                       **kw)
    lists = sorted(f for f in os.listdir(jroot) if f.endswith(".txt"))
    assert lists == sorted(f for f in os.listdir(troot)
                           if f.endswith(".txt"))
    for name in lists:
        with open(os.path.join(jroot, name)) as a, \
                open(os.path.join(troot, name)) as b:
            assert a.read() == b.read()
    for sub in ("images", "labels"):
        for f in sorted(os.listdir(os.path.join(jroot, sub))):
            ref = np.asarray(Image.open(os.path.join(jroot, sub, f)))
            np.testing.assert_array_equal(
                np.asarray(Image.open(os.path.join(troot, sub, f))), ref)
            ign = np.asarray(Image.open(os.path.join(iroot, sub, f)))
            if sub == "images":
                np.testing.assert_array_equal(ign, ref)
            else:
                assert 0.03 < (ign == 255).mean() < 0.2
                np.testing.assert_array_equal(ign[ign != 255],
                                              ref[ign != 255])
