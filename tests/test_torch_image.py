"""``mx.image``, the vision transforms and the vision datasets of the
PyTorch port against the JAX package on the CPU.

Each augmenter, detection augmenter and transform runs on the same image
(made from a seed with numpy) in both packages, with Python's ``random``
and numpy's global generator reseeded before each package's call (the
packages share them in one process, and the port draws in the
reference's order).  Outputs are host integer or f32 elementwise
arithmetic on both sides and are compared bit for bit, dtypes included.
JPEG and PNG paths use the decoder the host has (cv2, else PIL), the same
in both packages; the port's arrays are host NDArrays whatever the
current context.
"""
import gzip
import os
import pickle
import random
import struct

import numpy as onp
import pytest

import mxnet_tpu as rmx
import mxnet_tpu_torch as pmx
from mxnet_tpu import recordio as rrio
from mxnet_tpu.gluon.data import vision as rvision
from mxnet_tpu_torch import recordio as prio
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data import vision as pvision
from mxnet_tpu_torch.image import image as pimage

pytest.importorskip("PIL")


def _seed(s=0):
    random.seed(s)
    onp.random.seed(s)


def _img(seed=0, shape=(20, 24, 3), dtype=onp.uint8):
    rs = onp.random.RandomState(seed)
    if dtype == onp.uint8:
        return rs.randint(0, 256, shape, dtype=onp.uint8)
    return (rs.rand(*shape) * 255).astype(dtype)


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _equal(a, b):
    if isinstance(a, list):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _equal(u, v)
        return
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    onp.testing.assert_array_equal(a, b)


def _both(fn_ref, fn_port, seed=3):
    """Run both with the generators reseeded; the port's output must be
    a host array."""
    _seed(seed)
    a = fn_ref()
    _seed(seed)
    b = fn_port()
    for leaf in (b if isinstance(b, (list, tuple)) else [b]):
        if hasattr(leaf, "context"):
            assert leaf.context == pmx.cpu()
    return _np(a), _np(b)


# --------------------------------------------------------------------- #
# decode, encode, resize, crops
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", [".png", ".jpg"])
@pytest.mark.parametrize("iscolor", [1, 0])
def test_imencode_imdecode(fmt, iscolor):
    img = _img()
    enc = pmx.image.imencode(img, quality=85, img_fmt=fmt)
    assert enc == rmx.image.imencode(img, quality=85, img_fmt=fmt)
    a, b = _both(lambda: rmx.image.imdecode(enc, iscolor=iscolor),
                 lambda: pmx.image.imdecode(enc, iscolor=iscolor))
    _equal(a, b)
    if fmt == ".png" and iscolor:
        _equal(b, img)


def test_imread_and_backends(tmp_path, monkeypatch):
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(pmx.image.imencode(_img(), img_fmt=".png"))
    _equal(*_both(lambda: rmx.image.imread(path),
                  lambda: pmx.image.imread(path)))
    assert "PIL" in pmx.image.backends()
    # no decoder at all: the reference's error, no fallback
    monkeypatch.setattr(pimage, "_cv2", None)
    monkeypatch.setattr(pimage, "_PILImage", None)
    assert pmx.image.backends() == []
    with pytest.raises(MXNetError, match="imdecode needs cv2 or PIL"):
        pmx.image.imdecode(open(path, "rb").read())
    with pytest.raises(MXNetError, match="imencode needs cv2 or PIL"):
        pmx.image.imencode(_img())
    with pytest.raises(MXNetError, match="needs cv2 or PIL"):
        pmx.image.imresize(_img(), 4, 4)


@pytest.mark.parametrize("call", [
    ("imresize", (8, 10), {}), ("imresize", (8, 10), {"interp": 0}),
    ("resize_short", (10,), {}), ("resize_short", (9,), {"interp": 0}),
    ("fixed_crop", (2, 3, 10, 8), {}),
    ("fixed_crop", (2, 3, 10, 8), {"size": (6, 5)}),
    ("center_crop", ((12, 12),), {}), ("center_crop", ((30, 8),), {}),
    ("random_crop", ((8, 8),), {}),
    ("random_size_crop", ((8, 8), (0.3, 1.0), (0.75, 1.33)), {}),
    ("random_size_crop", ((8, 8), 0.5, (0.75, 1.33)), {}),
    ("color_normalize", ([120.0, 110.0, 100.0], [50.0, 60.0, 70.0]), {}),
    ("color_normalize", ([120.0, 110.0, 100.0],), {}),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_image_functions(call):
    name, args, kw = call
    img = _img(1)
    a, b = _both(
        lambda: getattr(rmx.image, name)(rmx.nd.array(img, dtype="uint8"),
                                         *args, **kw),
        lambda: getattr(pmx.image, name)(pmx.nd.array(img, dtype="uint8",
                                                      ctx=pmx.cpu()),
                                         *args, **kw))
    _equal(a, b)
    # numpy sources too, whatever the current context
    _seed(3)
    c = getattr(pmx.image, name)(img, *args, **kw)
    _equal(_np(c), b)


# --------------------------------------------------------------------- #
# augmenters
# --------------------------------------------------------------------- #
EIGVAL = [55.46, 4.794, 1.148]
EIGVEC = [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
          [-0.5836, -0.6948, 0.4203]]
AUGS = [
    ("ResizeAug", (10,)), ("ForceResizeAug", ((9, 7),)),
    ("RandomCropAug", ((8, 8),)), ("CenterCropAug", ((8, 6),)),
    ("RandomSizedCropAug", ((8, 8), (0.08, 1.0), (0.75, 1.33))),
    ("HorizontalFlipAug", (0.5,)), ("HorizontalFlipAug", (1.0,)),
    ("CastAug", ()), ("CastAug", ("float16",)),
    ("ColorNormalizeAug", ([123.68, 116.28, 103.53],
                           [58.395, 57.12, 57.375])),
    ("BrightnessJitterAug", (0.3,)), ("ContrastJitterAug", (0.3,)),
    ("SaturationJitterAug", (0.3,)), ("HSVJitterAug", (0.3, 0.3, 0.3)),
    ("ColorJitterAug", (0.2, 0.0, 0.4)),
    ("LightingAug", (0.1, EIGVAL, EIGVEC)),
]


# the resize backends take uint8 images: those augmenters run on uint8 only
AUG_CASES = [(n, a, dt) for n, a in AUGS for dt in ("uint8", "float32")
             if dt == "uint8" or n not in ("ResizeAug", "ForceResizeAug",
                                           "RandomSizedCropAug")]


@pytest.mark.parametrize("name,args,dtype", AUG_CASES,
                         ids=[f"{n}{i}-{dt}" for i, (n, _, dt) in
                              enumerate(AUG_CASES)])
def test_augmenter(name, args, dtype):
    img = _img(2).astype(dtype)
    ra, pa = getattr(rmx.image, name)(*args), getattr(pmx.image, name)(*args)
    assert ra.dumps()[0] == pa.dumps()[0]
    for seed in range(3):
        _equal(*_both(lambda: ra(rmx.nd.array(img, dtype=dtype)),
                      lambda: pa(pmx.nd.array(img, dtype=dtype,
                                              ctx=pmx.cpu())), seed))


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=24, rand_crop=True, rand_mirror=True),
    dict(rand_resize=True, mean=True, std=True),
    dict(rand_crop=True, brightness=0.2, contrast=0.2, saturation=0.2,
         pca_noise=0.1, mean=True, std=True),
    dict(mean=onp.array([1.0, 2.0, 3.0]), std=None, inter_method=1),
], ids=["plain", "crop_mirror", "rand_resize", "jitter", "mean_only"])
def test_create_augmenter(kw):
    ra = rmx.image.CreateAugmenter((3, 16, 16), **kw)
    pa = pmx.image.CreateAugmenter((3, 16, 16), **kw)
    assert [a.dumps()[0] for a in ra] == [a.dumps()[0] for a in pa]
    img = _img(3, (22, 26, 3))

    def run(mx, augs, **ctx):
        x = mx.nd.array(img, dtype="uint8", **ctx)
        for a in augs:
            x = a(x)
        return x

    for seed in range(2):
        _equal(*_both(lambda: run(rmx, ra),
                      lambda: run(pmx, pa, ctx=pmx.cpu()), seed))


# --------------------------------------------------------------------- #
# detection augmenters
# --------------------------------------------------------------------- #
def _det_label():
    return onp.array([[1, 0.1, 0.1, 0.6, 0.7, 0.5],
                      [2, 0.3, 0.2, 0.9, 0.8, 0.1],
                      [-1, 0, 0, 0, 0, 0]], dtype=onp.float32)


DET = [
    ("DetBorrowAug", lambda m: (m.image.CastAug(),)),
    ("DetBorrowAug", lambda m: (m.image.BrightnessJitterAug(0.3),)),
    ("DetHorizontalFlipAug", lambda m: (0.5,)),
    ("DetRandomCropAug", lambda m: (0.3,)),
    ("DetRandomCropAug", lambda m: (0.95, (0.5, 2.0), (0.5, 1.0), 5)),
    ("DetRandomPadAug", lambda m: ()),
    ("DetRandomPadAug", lambda m: ((0.75, 1.33), (1.0, 1.0))),
    ("DetRandomSelectAug", lambda m: (
        [m.image.DetHorizontalFlipAug(1.0), m.image.DetRandomPadAug()],
        0.3)),
    ("DetRandomSelectAug", lambda m: ([], 0.0)),
]


@pytest.mark.parametrize("name,make", DET,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(DET)])
def test_det_augmenter(name, make):
    img = _img(4)
    ra = getattr(rmx.image, name)(*make(rmx))
    pa = getattr(pmx.image, name)(*make(pmx))
    assert ra.dumps()[0] == pa.dumps()[0]
    for seed in range(4):
        _equal(*_both(
            lambda: list(ra(rmx.nd.array(img, dtype="uint8"), _det_label())),
            lambda: list(pa(pmx.nd.array(img, dtype="uint8", ctx=pmx.cpu()),
                            _det_label())), seed))


@pytest.mark.parametrize("kw", [
    dict(), dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True),
    dict(rand_crop=1, mean=True, std=True, brightness=0.1),
], ids=["plain", "crop_pad_mirror", "normalize"])
def test_create_det_augmenter(kw):
    ra = rmx.image.CreateDetAugmenter((3, 16, 16), **kw)
    pa = pmx.image.CreateDetAugmenter((3, 16, 16), **kw)
    assert [a.dumps()[0] for a in ra] == [a.dumps()[0] for a in pa]
    img = _img(5, (24, 20, 3))

    def run(mx, augs, **ctx):
        x, label = mx.nd.array(img, dtype="uint8", **ctx), _det_label()
        for a in augs:
            x, label = a(x, label)
        return [x, label]

    for seed in range(3):
        _equal(*_both(lambda: run(rmx, ra),
                      lambda: run(pmx, pa, ctx=pmx.cpu()), seed))


# --------------------------------------------------------------------- #
# ImageIter and ImageDetIter
# --------------------------------------------------------------------- #
def _jpeg_records(tmp_path, det=False, n=6, indexed=True):
    rec = str(tmp_path / ("det.rec" if det else "img.rec"))
    rng = onp.random.RandomState(6)
    w = prio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "w") if indexed \
        else prio.MXRecordIO(rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, (20 + i, 24, 3), dtype=onp.uint8)
        label = [2, 5, i % 3, 0.1, 0.1, 0.6, 0.7] if det else float(i % 4)
        s = prio.pack_img(prio.IRHeader(0, label, i, 0), img, quality=90)
        if indexed:
            w.write_idx(i, s)
        else:
            w.write(s)
    w.close()
    return rec


def _iter_batches(it):
    out = []
    while True:
        try:
            b = it.next()
        except StopIteration:
            return out
        out.append([_np(b.data), _np(b.label), onp.asarray(b.pad)])


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True),
    dict(last_batch_handle="discard", resize=18, mean=True, std=True),
    dict(indexed=False), dict(label_width=1, num_parts=2, part_index=1),
], ids=["shuffle_aug", "discard_normalize", "sequential", "parts"])
def test_image_iter(tmp_path, kw):
    kw = dict(kw)
    rec = _jpeg_records(tmp_path, indexed=kw.pop("indexed", True))

    def run(mx, **ctx):
        it = mx.image.ImageIter(batch_size=4, data_shape=(3, 16, 16),
                                path_imgrec=rec, **kw)
        first = _iter_batches(it)
        it.reset()
        return first + _iter_batches(it)

    a = (_seed(7), run(rmx))[1]
    _seed(7)
    with pmx.cpu():
        b = run(pmx)
    _equal(a, b)


def test_image_iter_from_list(tmp_path):
    root = tmp_path / "imgs"
    root.mkdir()
    rng = onp.random.RandomState(8)
    lines, imglist = [], []
    for i in range(5):
        name = f"{i}.png"
        with open(root / name, "wb") as f:
            f.write(pmx.image.imencode(rng.randint(
                0, 256, (18, 18, 3), dtype=onp.uint8), img_fmt=".png"))
        lines.append(f"{i}\t{i % 2}\t{name}")
        imglist.append(([float(i % 2)], name))
    lst = tmp_path / "a.lst"
    lst.write_text("\n".join(lines) + "\n")
    for kw in (dict(path_imglst=str(lst)), dict(imglist=imglist)):
        def run(mx):
            return _iter_batches(mx.image.ImageIter(
                batch_size=2, data_shape=(3, 12, 12), path_root=str(root),
                **kw))
        a = (_seed(1), run(rmx))[1]
        _seed(1)
        with pmx.cpu():
            _equal(a, run(pmx))
    with pmx.cpu(), pytest.raises(MXNetError, match="needs path_imgrec"):
        pmx.image.ImageIter(batch_size=2, data_shape=(3, 4, 4))


def test_image_det_iter(tmp_path):
    rec = _jpeg_records(tmp_path, det=True)

    def run(mx):
        it = mx.image.ImageDetIter(batch_size=4, data_shape=(3, 16, 16),
                                   path_imgrec=rec, rand_mirror=True,
                                   rand_crop=0.5, shuffle=True)
        return _iter_batches(it)

    a = (_seed(2), run(rmx))[1]
    _seed(2)
    with pmx.cpu():
        b = run(pmx)
    _equal(a, b)
    assert b[0][1][0].shape[0] == 4 and b[0][1][0].shape[2] == 5
    with pytest.raises(MXNetError, match="invalid detection label"):
        pmx.image.ImageDetIter._parse_label([1.0])


def test_image_iter_needs_a_context(tmp_path, monkeypatch):
    import torch

    rec = _jpeg_records(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        pmx.image.ImageIter(batch_size=2, data_shape=(3, 8, 8),
                            path_imgrec=rec)


# --------------------------------------------------------------------- #
# vision transforms
# --------------------------------------------------------------------- #
TRANSFORMS = [
    ("Cast", ()), ("Cast", ("float16",)), ("ToTensor", ()),
    ("Normalize", ((0.5, 0.4, 0.3), (0.2, 0.25, 0.3))),
    ("Resize", (10,)), ("Resize", (10, True)), ("Resize", ((9, 7),)),
    ("CenterCrop", (8,)), ("CenterCrop", ((10, 6),)),
    ("RandomResizedCrop", (8,)), ("CropResize", (2, 3, 10, 8)),
    ("CropResize", (2, 3, 10, 8, (6, 5))),
    ("RandomFlipLeftRight", ()), ("RandomFlipTopBottom", (0.7,)),
    ("RandomBrightness", (0.3,)), ("RandomContrast", (0.3,)),
    ("RandomSaturation", (0.3,)), ("RandomHue", (0.2,)),
    ("RandomColorJitter", (0.2, 0.2, 0.2, 0.1)),
    ("RandomLighting", (0.1,)), ("RandomGray", (0.5,)),
]


@pytest.mark.parametrize("name,args", TRANSFORMS,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(TRANSFORMS)])
def test_transform(name, args):
    img = _img(9)
    x = img.astype(onp.float32) / 255 if name == "Normalize" else img
    if name == "Normalize":
        x = x.transpose(2, 0, 1)
    ra = getattr(rvision.transforms, name)(*args)
    pa = getattr(pvision.transforms, name)(*args)
    dt = str(x.dtype)
    for seed in range(3):
        _equal(*_both(lambda: ra(rmx.nd.array(x, dtype=dt)),
                      lambda: pa(pmx.nd.array(x, dtype=dt, ctx=pmx.cpu())),
                      seed))
    # a label rides along untouched
    out, label = pa(pmx.nd.array(x, dtype=dt, ctx=pmx.cpu()), 5)
    assert label == 5


def test_compose_and_transform_first():
    T_r, T_p = rvision.transforms, pvision.transforms
    ra = T_r.Compose([T_r.RandomResizedCrop(12), T_r.RandomFlipLeftRight(),
                      T_r.ToTensor(), T_r.Normalize(0.13, 0.31)])
    pa = T_p.Compose([T_p.RandomResizedCrop(12), T_p.RandomFlipLeftRight(),
                      T_p.ToTensor(), T_p.Normalize(0.13, 0.31)])
    rd = rvision.MNIST(synthetic=16).transform_first(ra)
    pd = pvision.MNIST(synthetic=16).transform_first(pa)
    _seed(4)
    a = [(_np(rd[i][0]), rd[i][1]) for i in range(6)]
    _seed(4)
    b = [(_np(pd[i][0]), pd[i][1]) for i in range(6)]
    for (xa, ya), (xb, yb) in zip(a, b):
        _equal(xa, xb)
        assert ya == yb


# --------------------------------------------------------------------- #
# vision datasets
# --------------------------------------------------------------------- #
def _idx_file(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    data = head + arr.astype(onp.uint8).tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
@pytest.mark.parametrize("gz", [True, False])
def test_mnist_from_files(tmp_path, cls, gz):
    rng = onp.random.RandomState(10)
    for prefix, n in (("train", 7), ("t10k", 3)):
        ext = ".gz" if gz else ""
        _idx_file(str(tmp_path / f"{prefix}-images-idx3-ubyte{ext}"),
                  rng.randint(0, 256, (n, 28, 28)), gz)
        _idx_file(str(tmp_path / f"{prefix}-labels-idx1-ubyte{ext}"),
                  rng.randint(0, 10, (n,)), gz)
    for train in (True, False):
        ra = getattr(rvision, cls)(root=str(tmp_path), train=train)
        pa = getattr(pvision, cls)(root=str(tmp_path), train=train)
        assert len(ra) == len(pa) == (7 if train else 3)
        for i in range(len(pa)):
            (xa, ya), (xb, yb) = ra[i], pa[i]
            assert xb.context == pmx.cpu() and ya == yb
            _equal(_np(xa), _np(xb))


def test_cifar_from_files(tmp_path):
    rng = onp.random.RandomState(11)
    py = tmp_path / "c10" / "cifar-10-batches-py"
    py.mkdir(parents=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        with open(py / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (2, 3072)).astype(
                onp.uint8), "labels": rng.randint(0, 10, 2).tolist()}, f)
    binroot = tmp_path / "c10bin"
    binroot.mkdir()
    for name in names:
        recs = rng.randint(0, 256, (3, 3073)).astype(onp.uint8)
        recs[:, 0] %= 10
        (binroot / f"{name}.bin").write_bytes(recs.tobytes())
    c100 = tmp_path / "c100" / "cifar-100-python"
    c100.mkdir(parents=True)
    for name in ("train", "test"):
        with open(c100 / name, "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (3, 3072)).astype(
                onp.uint8), "fine_labels": rng.randint(0, 100, 3).tolist(),
                "coarse_labels": rng.randint(0, 20, 3).tolist()}, f)
    cases = [("CIFAR10", dict(root=str(tmp_path / "c10"))),
             ("CIFAR10", dict(root=str(binroot))),
             ("CIFAR100", dict(root=str(tmp_path / "c100"))),
             ("CIFAR100", dict(root=str(tmp_path / "c100"),
                               fine_label=False))]
    for cls, kw in cases:
        for train in (True, False):
            ra = getattr(rvision, cls)(train=train, **kw)
            pa = getattr(pvision, cls)(train=train, **kw)
            assert len(ra) == len(pa)
            for i in range(len(pa)):
                (xa, ya), (xb, yb) = ra[i], pa[i]
                assert ya == yb
                _equal(_np(xa), _np(xb))


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST", "CIFAR10",
                                 "CIFAR100"])
def test_synthetic_and_refusal(tmp_path, cls):
    for train in (True, False):
        ra = getattr(rvision, cls)(train=train, synthetic=24)
        pa = getattr(pvision, cls)(train=train, synthetic=24)
        onp.testing.assert_array_equal(ra._data, pa._data)
        onp.testing.assert_array_equal(ra._label, pa._label)
        (xa, ya), (xb, yb) = ra[5], pa[5]
        _equal(_np(xa), _np(xb))
        assert ya == yb
    # no files, no download: the reference's refusal
    with pytest.raises(MXNetError, match="synthetic=N"):
        getattr(pvision, cls)(root=str(tmp_path / "none"))
    got = pvision.CIFAR10(train=False, synthetic=4,
                          transform=lambda x, y: (x.astype("float32"), y))
    assert got[0][0].dtype == onp.float32


def test_image_record_folder_and_list_datasets(tmp_path):
    rec = _jpeg_records(tmp_path)
    for flag in (1, 0):
        ra = rvision.ImageRecordDataset(rec, flag=flag)
        pa = pvision.ImageRecordDataset(rec, flag=flag)
        assert len(ra) == len(pa) == 6
        for i in range(6):
            (xa, ya), (xb, yb) = ra[i], pa[i]
            assert ya == yb and xb.context == pmx.cpu()
            _equal(_np(xa), _np(xb))
    tr = pvision.ImageRecordDataset(rec, transform=lambda x, y: (x, y + 1))
    assert tr[1][1] == 2.0
    root = tmp_path / "folder"
    rng = onp.random.RandomState(12)
    items = []
    for cat in ("cat", "dog"):
        (root / cat).mkdir(parents=True)
        for j in range(2):
            name = f"{j}.png"
            (root / cat / name).write_bytes(pmx.image.imencode(
                rng.randint(0, 256, (9, 8, 3), dtype=onp.uint8),
                img_fmt=".png"))
            items.append((os.path.join(cat, name), len(items) // 2))
    (root / "notes.txt").write_text("not a class")
    ra, pa = rvision.ImageFolderDataset(str(root)), \
        pvision.ImageFolderDataset(str(root))
    assert ra.synsets == pa.synsets == ["cat", "dog"]
    assert len(pa) == 4
    for ds_a, ds_b in ((ra, pa), (rvision.ImageListDataset(str(root), items),
                                  pvision.ImageListDataset(str(root),
                                                           items))):
        for i in range(len(ds_b)):
            (xa, ya), (xb, yb) = ds_a[i], ds_b[i]
            assert ya == yb
            _equal(_np(xa), _np(xb))
