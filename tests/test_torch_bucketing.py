"""The bucketed LSTM LM of mxnet_tpu_torch against the JAX package, on the
CPU: ``rnn.encode_sentences``, ``rnn.BucketSentenceIter`` and
``module.BucketingModule`` (with ``Module.bind(shared_module=...)`` and
``borrow_optimizer`` beneath it).

The iterators get the same sentences and the same seeds of Python's
``random`` and numpy's global state, and must give the same batches
exactly (they make the same shuffles in the same order). The module runs
the fused 2-layer LSTM LM (vocab 50, embed = hidden = 16, buckets [4, 8],
batch 4) without dropout for 6 batches of SGD with momentum from the same
numpy weights in both packages: every parameter within rtol 1e-5 / atol
1e-5 and the perplexity after each batch within 1e-6 relative (f32 both
sides, other summation orders: a few ulps a step, compounded over six
steps of a recurrent net).
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import lstm_bucketing as lb

TINY = dict(lb.BUCKETING, vocab=50, embed=16, hidden=16, buckets=(4, 8),
            batch=4, sentences=60)
KEYS = (4, 8, 8, 4, 8, 4)
PARAM_TOL = {"rtol": 1e-5, "atol": 1e-5}
PPL_RTOL = 1e-6
CTX = {mt: "cpu", mx: None}


def _words(n=40, seed=3):
    rng = np.random.RandomState(seed)
    words = ["w%d" % i for i in range(12)]
    return [[words[i] for i in rng.randint(0, 12, rng.randint(2, 9))]
            for _ in range(n)]


@pytest.mark.parametrize("invalid_label,start_label", [(-1, 0), (0, 0),
                                                       (1, 1)])
def test_encode_sentences_matches_jax(invalid_label, start_label):
    sents = _words()
    got, got_vocab = mt.rnn.encode_sentences(
        sents, invalid_label=invalid_label, start_label=start_label)
    want, want_vocab = mx.rnn.encode_sentences(
        sents, invalid_label=invalid_label, start_label=start_label)
    assert got == want and got_vocab == want_vocab
    again, _ = mt.rnn.encode_sentences(sents[:5], vocab=got_vocab)
    assert again == got[:5]
    with pytest.raises(MXNetError, match="Unknown token"):
        mt.rnn.encode_sentences([["unseen"]], vocab=got_vocab)


def _iter_batches(pkg, labels, epochs=2):
    sents = lb.synthetic_sentences(30, 50, 10, seed=4)
    seq_labels = (None if labels == "language model"
                  else list(np.arange(len(sents)) % 3))
    random.seed(7)
    np.random.seed(7)
    it = pkg.rnn.BucketSentenceIter(sents, 4, buckets=[5, 10],
                                    invalid_label=0,
                                    sequence_labels=seq_labels)
    out = []
    for _ in range(epochs):
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(),
                     b.bucket_key, b.provide_data[0].shape,
                     b.provide_label[0].shape) for b in it])
        it.reset()
    desc = [(d.name, tuple(d.shape)) for d in it.provide_data
            + it.provide_label]
    return out, desc, it.default_bucket_key


@pytest.mark.parametrize("labels", ["language model", "sequence labels"])
def test_bucket_sentence_iter_matches_jax(labels):
    got, got_desc, got_key = _iter_batches(mt, labels)
    want, want_desc, want_key = _iter_batches(mx, labels)
    assert got_desc == want_desc and got_key == want_key == 10
    assert [len(e) for e in got] == [len(e) for e in want]
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:]


def test_bucket_sentence_iter_holds_host_arrays():
    it = lb.bucket_iter(TINY, 4, 0)
    batch = next(iter(it))
    assert batch.data[0].context == torch.device("cpu")
    assert batch.bucket_key in TINY["buckets"]


def _sym_gen(pkg):
    def gen(seq_len):
        sym = pkg.models.get_symbol(
            "lstm-lm", num_classes=TINY["vocab"], seq_len=seq_len,
            num_embed=TINY["embed"], num_hidden=TINY["hidden"],
            num_layers=TINY["layers"], dropout=0.0, fused=True)
        return sym, ("data",), ("softmax_label",)

    return gen


def _weights():
    sym = lb.lm_symbol(TINY, 8, 0.0)
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    shapes = sym.infer_shape(data=(4, 8), softmax_label=(4, 8))[0]
    rng = np.random.RandomState(11)
    return {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes) if n in names}


def _fit(pkg, keys=KEYS):
    """Fit a BucketingModule of the tiny LM over the batches of ``keys``;
    (parameters, perplexity after each batch, module)."""
    random.seed(0)
    np.random.seed(0)
    it = pkg.rnn.BucketSentenceIter(
        lb.synthetic_sentences(TINY["vocab"], TINY["sentences"], 8, 0),
        TINY["batch"], buckets=list(TINY["buckets"]), invalid_label=0)
    batches = lb.pick_batches(it, keys)
    mod = pkg.mod.BucketingModule(_sym_gen(pkg), default_bucket_key=8,
                                  context=pkg.cpu())
    mod.bind(batches.provide_data, batches.provide_label)
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=CTX[pkg])
                                for n, v in _weights().items()},
                    aux_params={})
    ppl = []
    mod.fit(batches, num_epoch=1, optimizer="sgd",
            optimizer_params=lb.optimizer_params(TINY),
            eval_metric=pkg.metric.Perplexity(ignore_label=0),
            batch_end_callback=lambda p: ppl.append(
                p.eval_metric.get_name_value()[0][1]))
    args, _ = mod.get_params()
    return {n: a.asnumpy() for n, a in args.items()}, ppl, mod


def test_bucketing_module_matches_jax():
    got, got_ppl, mod = _fit(mt)
    want, want_ppl, _ = _fit(mx)
    assert sorted(mod._buckets) == [4, 8]
    assert len(got_ppl) == len(want_ppl) == len(KEYS)
    for g, w in zip(got_ppl, want_ppl):
        assert abs(g - w) <= PPL_RTOL * w, (got_ppl, want_ppl)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **PARAM_TOL)
    init = _weights()
    assert all(not np.array_equal(got[n], init[n]) for n in init)


def test_bucket_executors_share_parameter_storage():
    _, _, mod = _fit(mt, keys=(4, 8))
    execs = [m._exec_group._exec for m in mod._buckets.values()]
    a, b = execs
    for n in ("embed_weight", "lstm_parameters", "pred_weight", "pred_bias"):
        assert a.arg_dict[n]._data.data_ptr() == b.arg_dict[n]._data.data_ptr()
        assert a.grad_dict[n]._data.data_ptr() != \
            b.grad_dict[n]._data.data_ptr()
    assert a.arg_dict["data"].shape != b.arg_dict["data"].shape
    m4, m8 = mod._buckets[4], mod._buckets[8]
    assert m4._updater is m8._updater and m4._arg_params is m8._arg_params


def test_shared_module_must_list_the_same_parameters_in_order():
    x = mt.sym.Variable("data")
    one = mt.sym.FullyConnected(mt.sym.FullyConnected(x, num_hidden=3,
                                                      name="a"),
                                num_hidden=2, name="b")
    two = mt.sym.FullyConnected(mt.sym.FullyConnected(x, num_hidden=3,
                                                      name="b"),
                                num_hidden=2, name="a")
    master = mt.mod.Module(mt.sym.SoftmaxOutput(one, name="softmax"),
                           context="cpu")
    master.bind([("data", (2, 3))], [("softmax_label", (2,))])
    master.init_params()
    other = mt.mod.Module(mt.sym.SoftmaxOutput(two, name="softmax"),
                          context="cpu")
    with pytest.raises(MXNetError, match="index keys"):
        other.bind([("data", (2, 3))], [("softmax_label", (2,))],
                   shared_module=master)
    with pytest.raises(MXNetError, match="not supported"):
        mt.mod.BucketingModule(_sym_gen(mt), 8, context="cpu").bind(
            [("data", (4, 8))], shared_module=master)
