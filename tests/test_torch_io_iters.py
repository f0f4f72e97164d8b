"""Port parity: the iterators of ``mxnet_tpu_torch.io`` that the
rest-of-training slice added (ResizeIter, PrefetchingIter, CSVIter,
LibSVMIter, MNISTIter) and ``DataDesc``'s helpers, against the JAX
package's, on the CPU, over
arrays and over files each test writes itself (CSV, libsvm, MNIST's idx
format plain and gzipped).

Batches are compared over two epochs, with their padding: float32 values
bit for bit (both packages parse and scale in numpy).  PrefetchingIter is
also reset in the middle of an epoch, and the epoch after it must be a
whole one, in order.
"""
import gzip
import struct

import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mxt

X = onp.arange(10 * 3, dtype="float32").reshape(10, 3)
Y = onp.arange(10, dtype="float32")


def _epochs(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert len(gd) == len(wd) and len(gl) == len(wl)
        for a, b in zip(gd + gl, wd + wl):
            onp.testing.assert_array_equal(a, b)


def _both(make):
    want = _epochs(make(mx))
    with mxt.cpu():
        got = _epochs(make(mxt))
    _same(got, want)
    return got


@pytest.mark.parametrize("size", [2, 5])
def test_resize_iter_matches_jax(size):
    got = _both(lambda pkg: pkg.io.ResizeIter(
        pkg.io.NDArrayIter(X, Y, batch_size=4), size))
    assert len(got) == 2 * size


def test_prefetching_iter_of_two_children_matches_jax():
    def make(pkg):
        a = pkg.io.NDArrayIter(X, Y, batch_size=4, data_name="a",
                               label_name="la")
        b = pkg.io.NDArrayIter(X * 2, Y * 2, batch_size=4, data_name="b",
                               label_name="lb")
        return pkg.io.PrefetchingIter(
            [a, b], rename_data=[{"a": "x0"}, {"b": "x1"}],
            rename_label=[{"la": "y0"}, {"lb": "y1"}])
    got = _both(make)
    assert len(got) == 6 and len(got[0][0]) == 2
    with mxt.cpu():
        it = make(mxt)
        assert [d.name for d in it.provide_data] == ["x0", "x1"]
        assert [d.name for d in it.provide_label] == ["y0", "y1"]
        assert it.provide_data[0].shape == (4, 3)


def test_prefetching_iter_reset_mid_epoch_gives_a_whole_epoch():
    want = _epochs(mx.io.PrefetchingIter(
        mx.io.NDArrayIter(X, Y, batch_size=3)), epochs=1)
    with mxt.cpu():
        it = mxt.io.PrefetchingIter(mxt.io.NDArrayIter(X, Y, batch_size=3))
        first = next(it)
        onp.testing.assert_array_equal(first.data[0].asnumpy(), X[:3])
        it.reset()
        got = _epochs(it, epochs=1)
        again = _epochs(it, epochs=1)
    _same(got, want)
    _same(again, want)


def test_csv_iter_matches_jax(tmp_path):
    data = str(tmp_path / "d.csv")
    label = str(tmp_path / "l.csv")
    onp.savetxt(data, X.reshape(10, 3), delimiter=",")
    onp.savetxt(label, Y, delimiter=",")
    got = _both(lambda pkg: pkg.io.CSVIter(
        data, (3,), label_csv=label, label_shape=(1,), batch_size=4,
        last_batch_handle="roll_over"))
    assert got[0][0][0].shape == (4, 3) and got[0][1][0].shape == (4, 1)


def _write_libsvm(path, rows):
    with open(path, "w") as f:
        f.write("# a comment line\n")
        for r in rows:
            f.write(r + "\n")


@pytest.mark.parametrize("case", ["inline", "multi_label", "label_file",
                                  "discard"])
def test_libsvm_iter_matches_jax(case, tmp_path):
    data = str(tmp_path / "d.libsvm")
    rows = ["1 0:1.5 3:2.0", "0 1:-1.0", "1 2:0.25 4:4.0", "0",
            "1 0:3.0 1:3.0 2:3.0"]
    if case == "multi_label":
        rows = ["1,0 0:1.5 3:2.0", "0,1 1:-1.0", "1 2:0.25 4:4.0", "0,0",
                "1,1 0:3.0"]
    _write_libsvm(data, rows)
    kw = dict(batch_size=2, round_batch=case != "discard")
    if case == "label_file":
        labels = str(tmp_path / "l.libsvm")
        _write_libsvm(labels, ["0:1 1:2", "1:1", "0:5", "0:0", "1:7"])
        kw.update(label_libsvm=labels, label_shape=(2,))
    got = _both(lambda pkg: pkg.io.LibSVMIter(data, (5,), **kw))
    assert got[0][0][0].shape == (2, 5)
    assert len(got) == (4 if case == "discard" else 6)


def test_libsvm_iter_refuses_an_index_out_of_range(tmp_path):
    data = str(tmp_path / "bad.libsvm")
    _write_libsvm(data, ["1 5:1.0"])
    with pytest.raises(ValueError, match="zero-based"):
        with mxt.cpu():
            mxt.io.LibSVMIter(data, (5,))


def _write_idx(tmp_path, n, zipped):
    rs = onp.random.RandomState(4)
    images = rs.randint(0, 256, (n, 4, 5)).astype("uint8")
    labels = rs.randint(0, 10, n).astype("uint8")
    op = gzip.open if zipped else open
    suffix = ".gz" if zipped else ""
    img = str(tmp_path / "img-idx3-ubyte")
    lab = str(tmp_path / "lab-idx1-ubyte")
    with op(img + suffix, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 4, 5) + images.tobytes())
    with op(lab + suffix, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return img, lab


@pytest.mark.parametrize("flat,zipped", [(False, False), (True, True)])
def test_mnist_iter_matches_jax(flat, zipped, tmp_path):
    img, lab = _write_idx(tmp_path, 11, zipped)
    got = _both(lambda pkg: pkg.io.MNISTIter(image=img, label=lab,
                                             batch_size=4, shuffle=False,
                                             flat=flat))
    assert len(got) == 4                 # the last partial batch dropped
    assert got[0][0][0].shape == ((4, 20) if flat else (4, 1, 4, 5))
    assert got[0][0][0].max() <= 1.0


def test_mnist_iter_shuffles_a_seeded_permutation(tmp_path):
    img, lab = _write_idx(tmp_path, 12, False)

    def labels(seed):
        mxt.random.seed(seed)
        with mxt.cpu():
            it = mxt.io.MNISTIter(image=img, label=lab, batch_size=4)
            return onp.concatenate([b.label[0].asnumpy() for b in it])
    plain = onp.concatenate([b.label[0].asnumpy() for b in mx.io.MNISTIter(
        image=img, label=lab, batch_size=4, shuffle=False)])
    first = labels(5)
    assert sorted(first.tolist()) == sorted(plain.tolist())
    onp.testing.assert_array_equal(labels(5), first)
    with pytest.raises(IOError, match="not found"):
        mxt.io.MNISTIter(image=str(tmp_path / "missing"), label=lab)


def test_data_desc_helpers_match_jax():
    for layout in ("NCHW", "TNC", None):
        assert mxt.io.DataDesc.get_batch_axis(layout) == \
            mx.io.DataDesc.get_batch_axis(layout)
    shapes = [("data", (4, 3)), ("label", (4,))]
    types = [("label", "int32")]
    got = mxt.io.DataDesc.get_list(shapes, types)
    want = mx.io.DataDesc.get_list(shapes, types)
    assert [(d.name, d.shape, d.dtype) for d in got] == \
        [(d.name, d.shape, d.dtype) for d in want]
