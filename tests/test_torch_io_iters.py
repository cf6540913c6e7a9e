"""The port's ``ResizeIter``, ``PrefetchingIter``, ``DevicePrefetchIter``,
``CSVIter`` and ``MNISTIter`` against the JAX package's, on the CPU.

Each iterator of both packages runs over the same seeded arrays (the CSV
and idx files are written here, from numpy) and must yield the same
batches: data, labels, pad, in order, across ``reset``. The card path of
``DevicePrefetchIter`` (pinned staging, the copy stream, the slot events)
runs in ``chip_smoke.py``'s ssd phase; here it places copies on the host.
"""
import gzip
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


def _arrays(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 4).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32))


def _batches(it, limit=100):
    out = []
    for _ in range(limit):
        try:
            b = it.next()
        except StopIteration:
            break
        out.append(([d.asnumpy() for d in b.data],
                    [x.asnumpy() for x in (b.label or [])], b.pad))
    return out


def _same(got, want):
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert len(gd) == len(wd) and len(gl) == len(wl)
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _both(make):
    return make(mt), make(mx)


@pytest.mark.parametrize("size,reset_internal", [(3, True), (7, False),
                                                 (4, False)])
def test_resize_iter_matches_jax(size, reset_internal):
    """``size`` batches an epoch, the inner iterator restarted when it
    runs out; two epochs, ``reset`` restarting the inner one only with
    ``reset_internal``."""
    x, y = _arrays()
    got, want = _both(lambda pkg: pkg.io.ResizeIter(
        pkg.io.NDArrayIter(x, y, batch_size=3), size,
        reset_internal=reset_internal))
    for _ in range(2):
        _same(_batches(got), _batches(want))
        got.reset()
        want.reset()
    assert got.provide_data == want.provide_data


def test_prefetching_iter_joins_renamed_iterators_as_jax():
    """Two iterators read ahead by their threads, joined into one batch
    and renamed; two epochs."""
    x, y = _arrays()
    x2, _ = _arrays(seed=1)

    def make(pkg):
        return pkg.io.PrefetchingIter(
            [pkg.io.NDArrayIter(x, y, batch_size=4),
             pkg.io.NDArrayIter(x2, y, batch_size=4, data_name="other",
                                label_name="other_label")],
            rename_data=[{"data": "a"}, {"other": "b"}])

    got, want = _both(make)
    assert [d.name for d in got.provide_data] == ["a", "b"]
    assert [tuple(d.shape) for d in got.provide_data] == \
        [tuple(d.shape) for d in want.provide_data]
    assert [d.name for d in got.provide_label] == \
        [d.name for d in want.provide_label]
    for _ in range(2):
        _same(_batches(got), _batches(want))
        got.reset()
        want.reset()


@pytest.mark.parametrize("depth,cast", [(1, None), (2, None), (3, "float16")])
def test_device_prefetch_iter_matches_jax_on_the_host(depth, cast):
    """The batches, in order, across two epochs, with ``cast_dtype``
    casting the data and not the labels; exhausted, it stays exhausted."""
    x, y = _arrays(11)
    got = mt.io.DevicePrefetchIter(mt.io.NDArrayIter(x, y, batch_size=4),
                                   ctx="cpu", depth=depth, cast_dtype=cast)
    want = mx.io.DevicePrefetchIter(mx.io.NDArrayIter(x, y, batch_size=4),
                                    ctx=mx.cpu(), depth=depth,
                                    cast_dtype=cast)
    try:
        for _ in range(2):
            g, w = _batches(got), _batches(want)
            _same(g, w)
            assert g[0][0][0].dtype == np.dtype(cast or "float32")
            assert g[0][1][0].dtype == np.float32
            with pytest.raises(StopIteration):
                got.next()
            got.reset()
            want.reset()
        assert got.provide_data == want.provide_data
    finally:
        got.close()
        want.close()
    with pytest.raises(RuntimeError, match="closed"):
        got.next()


def test_device_prefetch_iter_needs_a_card_by_default():
    x, y = _arrays()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.io.DevicePrefetchIter(mt.io.NDArrayIter(x, y, batch_size=2))


def test_device_prefetch_iter_surfaces_the_base_iterators_error():
    class Broken(mt.io.DataIter):
        batch_size = 1
        provide_data = provide_label = []

        def next(self):
            raise ValueError("bad record")

    it = mt.io.DevicePrefetchIter(Broken(), ctx="cpu")
    with pytest.raises(ValueError, match="bad record"):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()


def test_fit_through_device_prefetch_equals_ndarray_iter():
    """``Module.fit`` fed through ``DevicePrefetchIter`` lands on the same
    parameters, bit for bit, as fed by the ``NDArrayIter`` it wraps."""
    rng = np.random.RandomState(2)
    x = rng.randn(12, 6).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    params = []
    for prefetch in (False, True):
        data = mt.sym.Variable("data")
        net = mt.sym.FullyConnected(data, num_hidden=3, name="fc")
        net = mt.sym.SoftmaxOutput(net, name="softmax")
        it = mt.io.NDArrayIter(x, y, batch_size=4)
        if prefetch:
            it = mt.io.DevicePrefetchIter(it, ctx="cpu")
        mod = mt.mod.Module(net, context="cpu")
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1),
                                  ("momentum", 0.9)),
                initializer=mt.initializer.Xavier(
                    rng=np.random.RandomState(0)))
        params.append({k: v.asnumpy() for k, v in mod.get_params()[0]
                       .items()})
        if prefetch:
            it.close()
    for k in params[0]:
        np.testing.assert_array_equal(params[0][k], params[1][k])


def _write_csv(path, arr):
    np.savetxt(path, arr.reshape(len(arr), -1), delimiter=",", fmt="%.7g")
    return str(path)


@pytest.mark.parametrize("round_batch,with_label", [(True, True),
                                                    (False, True),
                                                    (True, False)])
def test_csv_iter_matches_jax(tmp_path, round_batch, with_label):
    rng = np.random.RandomState(3)
    data = _write_csv(tmp_path / "data.csv",
                      rng.randn(10, 2, 3).astype(np.float32))
    label = _write_csv(tmp_path / "label.csv",
                       rng.randint(0, 4, (10, 1)).astype(np.float32)) \
        if with_label else None
    got, want = _both(lambda pkg: pkg.io.CSVIter(
        data_csv=data, data_shape=(2, 3), batch_size=4, label_csv=label,
        round_batch=round_batch))
    assert got.provide_data == want.provide_data
    assert got.provide_label == want.provide_label
    for _ in range(2):
        g = _batches(got)
        _same(g, _batches(want))
        got.reset()
        want.reset()
    assert g[-1][2] == (2 if round_batch else 0)


def _write_idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())
    return str(path)


@pytest.mark.parametrize("kwargs", [
    {}, {"flat": True}, {"shuffle": True, "seed": 5},
    {"num_parts": 2, "part_index": 1, "gz": True}])
def test_mnist_iter_matches_jax(tmp_path, kwargs):
    """Images and labels from idx files (gzipped or not), scaled to
    [0, 1], shuffled from a seed, sharded, the last batch wrapped."""
    kwargs = dict(kwargs)
    gz = kwargs.pop("gz", False)
    rng = np.random.RandomState(4)
    ext = ".gz" if gz else ""
    images = _write_idx(tmp_path / ("images" + ext),
                        rng.randint(0, 256, (23, 28, 28)), gz)
    labels = _write_idx(tmp_path / ("labels" + ext),
                        rng.randint(0, 10, 23), gz)
    got, want = _both(lambda pkg: pkg.io.MNISTIter(
        image=images, label=labels, batch_size=5, **kwargs))
    assert got.provide_data == want.provide_data
    for _ in range(2):
        _same(_batches(got), _batches(want))
        got.reset()
        want.reset()


def test_only_the_ported_file_iterators_are_exported():
    for name in ("CSVIter", "MNISTIter", "ResizeIter", "PrefetchingIter",
                 "DevicePrefetchIter"):
        assert hasattr(mt.io, name)
    for name in ("ImageRecordIter", "ImageRecordUInt8Iter",
                 "ImageDetRecordIter"):
        assert hasattr(mx.io, name) and not hasattr(mt.io, name)
