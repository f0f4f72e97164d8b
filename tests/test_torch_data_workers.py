"""Port parity: the data side of the rest-of-training slice in
``mxnet_tpu_torch.gluon.data`` against the JAX package's, on the CPU.

* ``DataLoader`` with 2 spawned worker processes (the only test here that
  spawns: each worker is an interpreter start) and with the thread pool,
  against the JAX package's single-process batches of the same dataset and
  transforms: float32 batches bit for bit.  A consumer that breaks out
  early, and ``close``, leave no shared-memory segment behind in
  ``/dev/shm``; the workers see no CUDA device.  A dataset that cannot be
  pickled falls back to threads with a warning, as in the JAX package.
* MNIST, FashionMNIST, CIFAR10 and CIFAR100 from files the tests write
  (idx, plain and gzipped; CIFAR's python-pickle batches), train and test,
  with a transform: images and labels equal to the JAX package's; a
  missing file raises.  ``Dataset.filter``.
* Every transform that does not resize, under the same ``random`` and
  numpy seeds in both packages: outputs bit for bit; ``Resize``,
  ``RandomResizedCrop`` and ``CenterCrop``'s upscale raise, naming the
  queue item they wait for.
"""
import gzip
import os
import pickle
import random
import struct
import warnings

import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

RS = onp.random.RandomState(0)
IMAGES = RS.randint(0, 256, (14, 8, 6, 3)).astype("uint8")
LABELS = RS.randint(0, 10, 14).astype("float32")
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


def _pipeline(pkg):
    T = pkg.gluon.data.vision.transforms
    ds = pkg.gluon.data.ArrayDataset(pkg.nd.array(IMAGES, dtype="uint8"),
                                     LABELS)
    return ds.transform_first(T.Compose([T.ToTensor(),
                                         T.Normalize(MEAN, STD)]))


def _batches(loader, epochs=2):
    out = []
    for _ in range(epochs):
        out += [(d.asnumpy(), l.asnumpy()) for d, l in loader]
    return out


@pytest.fixture(scope="module")
def jax_batches():
    return _batches(mx.gluon.data.DataLoader(_pipeline(mx), batch_size=4,
                                             last_batch="keep"))


def _same(got, want):
    assert len(got) == len(want) == 8
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.dtype == wd.dtype and gd.shape == wd.shape
        onp.testing.assert_array_equal(gd, wd)
        onp.testing.assert_array_equal(gl, wl)


def _segments():
    if not os.path.isdir("/dev/shm"):
        return set()
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def _cuda_seen(_):
    import torch
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count(),
            os.environ.get("MXNET_TPU_COORDINATOR_ADDRESS"))


def test_worker_processes_match_jax_and_leave_no_segment(jax_batches,
                                                         monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COORDINATOR_ADDRESS", "localhost:1")
    before = _segments()
    with mxt.cpu():
        loader = mxt.gluon.data.DataLoader(
            _pipeline(mxt), batch_size=4, num_workers=2, prefetch=3,
            pin_memory=True)
        monkeypatch.delenv("MXNET_TPU_COORDINATOR_ADDRESS")
        assert loader._pool is not None and loader._executor is None
        got = _batches(loader)
        assert all(b.context == mxt.cpu() for b in next(iter(loader)))
        # a consumer that breaks out after one batch: the batches made
        # for it and never taken are unlinked
        for k, _ in enumerate(loader):
            if k == 0:
                break
        seen = loader._pool.apply(_cuda_seen, (0,))
        assert loader._live_inflight == []
        it = iter(loader)
        next(it)                    # batches in flight at close
        loader.close()
        del it
    _same(got, jax_batches)
    assert seen == ("", 0, None)
    assert _segments() - before == set()


def test_thread_pool_matches_jax(jax_batches):
    with mxt.cpu():
        loader = mxt.gluon.data.DataLoader(
            _pipeline(mxt), batch_size=4, num_workers=2, thread_pool=True)
        assert loader._executor is not None and loader._pool is None
        got = _batches(loader)
        assert all(b.context == mxt.cpu() for b in next(iter(loader)))
        loader.close()
    _same(got, jax_batches)


def test_unpicklable_dataset_falls_back_to_threads(jax_batches):
    with mxt.cpu():
        ds = _pipeline(mxt).transform(lambda d, l: (d, l))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loader = mxt.gluon.data.DataLoader(ds, batch_size=4,
                                               num_workers=2)
        assert any("picklable" in str(w.message) for w in caught)
        assert loader._executor is not None
        got = _batches(loader)
        loader.close()
    _same(got, jax_batches)


def test_dataloader_refuses_conflicting_samplers():
    with mxt.cpu():
        ds = mxt.gluon.data.ArrayDataset(IMAGES, LABELS)
        sampler = mxt.gluon.data.SequentialSampler(len(ds))
        with pytest.raises(ValueError, match="shuffle"):
            mxt.gluon.data.DataLoader(ds, batch_size=2, sampler=sampler,
                                      shuffle=True)
        with pytest.raises(ValueError, match="batch_size"):
            mxt.gluon.data.DataLoader(ds)


def test_filter_matches_jax():
    def run(pkg):
        ds = pkg.gluon.data.SimpleDataset(list(range(10)))
        kept = ds.filter(lambda x: x % 3 == 0)
        return [kept[i] for i in range(len(kept))]
    assert run(mxt) == run(mx) == [0, 3, 6, 9]


# -- datasets ----------------------------------------------------------------

def _write_mnist(root, prefix, n, zipped, seed):
    rs = onp.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 28, 28)).astype("uint8")
    labels = rs.randint(0, 10, n).astype("uint8")
    op, suffix = (gzip.open, ".gz") if zipped else (open, "")
    os.makedirs(root, exist_ok=True)
    with op(os.path.join(root, prefix + "-images-idx3-ubyte" + suffix),
            "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with op(os.path.join(root, prefix + "-labels-idx1-ubyte" + suffix),
            "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, files, n, label_keys, seed):
    rs = onp.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    for name in files:
        d = {b"data": rs.randint(0, 256, (n, 3 * 32 * 32)).astype("uint8")}
        for key, classes in label_keys:
            d[key] = rs.randint(0, classes, n).tolist()
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(d, f)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("vision")
    mnist, fashion = str(base / "mnist"), str(base / "fashion")
    _write_mnist(mnist, "train", 9, False, 1)
    _write_mnist(mnist, "t10k", 5, True, 2)
    _write_mnist(fashion, "train", 7, True, 3)
    _write_mnist(fashion, "t10k", 4, False, 4)
    c10 = str(base / "c10" / "cifar-10-batches-py")
    _write_cifar(c10, ["data_batch_%d" % i for i in range(1, 6)], 3,
                 [(b"labels", 10)], 5)
    _write_cifar(c10, ["test_batch"], 4, [(b"labels", 10)], 6)
    c100 = str(base / "c100")
    _write_cifar(c100, ["train", "test"], 5,
                 [(b"fine_labels", 100), (b"coarse_labels", 20)], 7)
    return {"mnist": mnist, "fashion": fashion,
            "c10": str(base / "c10"), "c100": c100}


CASES = [("MNIST", "mnist", {}), ("FashionMNIST", "fashion", {}),
         ("CIFAR10", "c10", {}), ("CIFAR100", "c100", {}),
         ("CIFAR100", "c100", {"fine_label": True})]


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("name,root,kw", CASES,
                         ids=["mnist", "fashion", "cifar10", "cifar100",
                              "cifar100_fine"])
def test_vision_dataset_matches_jax(name, root, kw, train, roots):
    def samples(pkg, transform=None):
        cls = getattr(pkg.gluon.data.vision, name)
        ds = cls(root=roots[root], train=train, transform=transform, **kw)
        return [(ds[i][0].asnumpy(), int(ds[i][1])) for i in range(len(ds))]
    want = samples(mx)
    with mxt.cpu():
        got = samples(mxt)
        scaled = samples(mxt, lambda d, l: (d.astype("float32") / 2, l + 1))
    assert len(got) == len(want) > 0
    for (gd, gl), (wd, wl), (sd, sl) in zip(got, want, scaled):
        assert gd.dtype == wd.dtype == onp.uint8
        onp.testing.assert_array_equal(gd, wd)
        assert gl == wl and sl == wl + 1
        onp.testing.assert_array_equal(sd, wd.astype("float32") / 2)


def test_vision_dataset_refuses_a_missing_file(tmp_path):
    with pytest.raises(IOError, match="not found"):
        mxt.gluon.data.vision.MNIST(root=str(tmp_path / "none"))
    with pytest.raises(IOError, match="not found"):
        mxt.gluon.data.vision.CIFAR10(root=str(tmp_path / "none"))
    for cls, args in (("ImageRecordDataset", ("x.rec",)),
                      ("ImageFolderDataset", (str(tmp_path),))):
        with pytest.raises(mxt.MXNetError, match="queue 1, item 7"):
            getattr(mxt.gluon.data.vision, cls)(*args)


# -- transforms --------------------------------------------------------------

IMG = onp.random.RandomState(3).randint(0, 256, (10, 12, 3)).astype("uint8")


def _transform_cases(T):
    return {
        "to_tensor": T.ToTensor(),
        "to_tensor_batch": T.ToTensor(),
        "normalize": T.Compose([T.ToTensor(), T.Normalize(MEAN, STD)]),
        "normalize_scalar": T.Compose([T.Cast("float32"),
                                       T.Normalize(100.0, 50.0)]),
        "cast": T.Cast("float16"),
        "center_crop": T.CenterCrop((8, 6)),
        "flip_lr": T.RandomFlipLeftRight(),
        "flip_tb": T.RandomFlipTopBottom(),
        "brightness": T.RandomBrightness(0.4),
        "contrast": T.RandomContrast(0.4),
        "saturation": T.RandomSaturation(0.4),
        "lighting": T.RandomLighting(0.3),
        "jitter": T.RandomColorJitter(0.3, 0.3, 0.3),
    }


@pytest.mark.parametrize("case", sorted(_transform_cases(
    mxt.gluon.data.vision.transforms)))
def test_transform_matches_jax_under_the_same_seeds(case):
    def run(pkg):
        t = _transform_cases(pkg.gluon.data.vision.transforms)[case]
        kw = {"ctx": mxt.cpu()} if pkg is mxt else {}
        img = IMG[None].repeat(2, 0) if case == "to_tensor_batch" else IMG
        x = pkg.nd.array(img, dtype="uint8", **kw)
        random.seed(7)
        onp.random.seed(7)
        outs = []
        for _ in range(6):
            out = t(x)
            outs.append(out.asnumpy() if hasattr(out, "asnumpy")
                        else onp.asarray(out))
        return outs
    want = run(mx)
    with mxt.cpu():
        got = run(mxt)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        onp.testing.assert_array_equal(a, b)
    if case.startswith("flip"):
        assert any(not onp.array_equal(a, IMG) for a in got)
        assert any(onp.array_equal(a, IMG) for a in got)


def test_resizing_transforms_wait():
    T = mxt.gluon.data.vision.transforms
    for make in (lambda: T.Resize(4), lambda: T.RandomResizedCrop(4)):
        with pytest.raises(mxt.MXNetError, match="queue 1, item 7"):
            make()
    with mxt.cpu():
        with pytest.raises(mxt.MXNetError, match="queue 1, item 7"):
            T.CenterCrop(16)(mxt.nd.array(IMG, dtype="uint8"))
