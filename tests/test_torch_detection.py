"""The port's detection and signal ops and ``ssd-vgg16`` against the JAX
package's, on the CPU.

- The nine ``contrib.py`` ops (``ctc_loss``, ``fft`` / ``ifft``,
  ``count_sketch``, ``MultiBoxPrior`` / ``Target`` / ``Detection``,
  ``Proposal``, ``Correlation``): each contrib case of
  ``mxnet_tpu_torch/tools/op_cases.py`` (the table ``chip_smoke.py``'s ssd
  phase runs at full shapes on the card) at its small shapes, one registry
  op of both packages on the same seeded numpy inputs, outputs and the
  vector-Jacobian product at rtol 1e-5 / atol 1e-6; class targets, masks
  and keep masks bit for bit. The reference's quirks the port copies are
  held explicitly: the padding rows' last-writer forced match, no negative
  mining, class-agnostic NMS, the first maximum among tied scores.
- Every op runs on ``meta`` tensors: none reads a value on the host, so a
  graph holding them can be captured.
- ``ssd-vgg16`` at 64 x 64 with 3 classes: the builder's arguments and
  shapes, one executor forward and backward of both packages in f64 on the
  same weights (the JAX package under ``jax.enable_x64``), and the
  detection symbol's output.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.tools.op_cases import CONTRIB_OPS, exact_output, \
    op_cases
from test_torch_ops import _jax_run, _torch_run

TOL = {"rtol": 1e-5, "atol": 1e-6}
EXACT = {"rtol": 0, "atol": 0}

CASES = {k: c for k, c in op_cases().items() if c.op in CONTRIB_OPS}


def _arrays(key):
    rng = np.random.RandomState(len(key))
    return [m(rng) for m in CASES[key].makers]


@pytest.mark.parametrize("key", sorted(CASES))
def test_contrib_op_matches_jax(key):
    op, _, attrs, diff, _, _ = CASES[key]
    arrays = _arrays(key)
    want_out, want_grad = _jax_run(op, arrays, attrs, diff, 7)
    got_out, got_grad = _torch_run(op, arrays, attrs, diff, 7)
    assert len(got_out) == len(want_out)
    for i, (g, w) in enumerate(zip(got_out, want_out)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape,
                                                           w.shape)
        tol = EXACT if exact_output(CASES[key], i) else TOL
        np.testing.assert_allclose(g, w, err_msg="output %d" % i, **tol)
    if op == "MultiBoxDetection":
        # the class column carries the keep mask: -1 where not kept
        np.testing.assert_array_equal(got_out[0][..., 0], want_out[0][..., 0])
    if op == "Proposal":
        np.testing.assert_array_equal(got_out[0][:, 0], 0)
    for i, g, w in zip(diff, got_grad, want_grad):
        np.testing.assert_allclose(g, w, err_msg="grad of input %d" % i,
                                   **TOL)
    assert {CASES[k].op for k in CASES} == set(CONTRIB_OPS)


def _torch_op(op, arrays, attrs=None, device="cpu"):
    top = treg.get_op(op)
    outs, _ = top.impl(top.parse_attrs(dict(attrs or {})),
                       tuple(torch.tensor(a, device=device) for a in arrays),
                       (), treg.OpContext(False, torch.device(device)))
    return outs


def test_multibox_target_padding_rows_win_anchor_zero():
    """The reference quirk the port copies: box 0's best anchor is anchor
    0 (IoU 0.4, under the threshold), but the padding rows after it also
    claim anchor 0 (their IoU is -1 everywhere) and, as the last writers
    of XLA's duplicate scatter, win it: no anchor is positive for box 0.
    Boxes 1 and 2 tie at 0.5 on anchor 2, which the later row wins."""
    arrays = _arrays("multibox_target_padding_last_writer")
    loc_t, loc_m, cls_t = (o.numpy() for o in _torch_op("MultiBoxTarget",
                                                        arrays))
    np.testing.assert_array_equal(cls_t, [[0, 0, 2, 0, 0]])
    np.testing.assert_array_equal(loc_m.reshape(5, 4)[:, 0], [0, 0, 1, 0, 0])
    # without the padding rows box 0 keeps its forced match
    _, _, alone = _torch_op("MultiBoxTarget", [arrays[0], arrays[1][:, :3],
                                               arrays[2]])
    np.testing.assert_array_equal(alone.numpy(), [[3, 0, 2, 0, 0]])


def test_multibox_target_mines_no_negatives():
    """``negative_mining_ratio`` is ignored, as in the JAX package: every
    anchor that is not positive gets class 0, none the ignore label."""
    arrays = _arrays("multibox_target")
    for ratio in (-1.0, 3.0):
        _, mask, cls_t = _torch_op("MultiBoxTarget", arrays,
                                   {"negative_mining_ratio": ratio})
        cls_t = cls_t.numpy()
        assert (cls_t >= 0).all() and (cls_t > 0).any()
        np.testing.assert_array_equal(
            mask.numpy().reshape(cls_t.shape + (4,))[..., 0], cls_t > 0)


def test_nms_is_class_agnostic_and_takes_the_first_of_tied_scores():
    """Two boxes of different classes overlapping past the threshold: one
    is kept (NMS ignores the class, ``force_suppress`` or not); of two
    tied scores the lower anchor index is kept."""
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.1, 0.52, 0.5],
                         [0.6, 0.6, 0.9, 0.9]]], np.float32)
    loc = np.zeros((1, 12), np.float32)
    # classes 1 and 2 (after the background row), tied scores 0.5
    prob = np.array([[[0.5, 0.5, 0.6], [0.5, 0.0, 0.1], [0.0, 0.5, 0.3]]],
                    np.float32)
    for force in (False, True):
        out = _torch_op("MultiBoxDetection", [prob, loc, anchors],
                        {"force_suppress": force})[0].numpy()
        np.testing.assert_array_equal(out[0, :, 0], [0, -1, 1])
    (want,), _ = jreg.get_op("MultiBoxDetection").impl(
        jreg.get_op("MultiBoxDetection").parse_attrs({}),
        tuple(jnp.asarray(a) for a in (prob, loc, anchors)), (),
        jreg.OpContext(False, None))
    np.testing.assert_allclose(out, np.asarray(want), **TOL)


@pytest.mark.parametrize("key", sorted(CASES))
def test_contrib_op_runs_on_meta_tensors(key):
    """Shape inference runs each op on ``meta`` tensors, which hold no
    values: an op that read one on the host (``.item()``, ``nonzero``, a
    boolean mask, a Python branch on a tensor) would fail here."""
    case = CASES[key]
    arrays = _arrays(key)
    got = _torch_op(case.op, arrays, case.attrs, device="meta")
    want = _torch_op(case.op, arrays, case.attrs)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert [g.dtype for g in got] == [w.dtype for w in want]


@pytest.mark.parametrize("op", ["fft", "ifft"])
def test_fft_promotes_bfloat16_as_jax(op):
    """bf16 data: the transform in f32 (``torch.fft`` has no bf16), the
    output back in bf16, within one bf16 rounding of the JAX package's."""
    x = np.random.RandomState(3).randn(4, 16).astype(np.float32)
    jop = jreg.get_op(op)
    (want,), _ = jop.impl(jop.parse_attrs({}),
                          (jnp.asarray(x, jnp.bfloat16),), (),
                          jreg.OpContext(False, None))
    (got,) = _torch_op(op, [x.astype(np.float32)])
    top = treg.get_op(op)
    (got,), _ = top.impl(top.parse_attrs({}),
                         (torch.from_numpy(x).to(torch.bfloat16),), (),
                         treg.OpContext(False))
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), w, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(w).max())


def test_ifft_is_unnormalised_and_inverts_fft_times_d():
    x = np.random.RandomState(4).randn(3, 8).astype(np.float32)
    (f,) = _torch_op("fft", [x])
    (back,) = _torch_op("ifft", [f.numpy()])
    np.testing.assert_allclose(back.numpy(), 8 * x, rtol=1e-5, atol=1e-5)


def test_count_sketch_sums_repeated_buckets():
    data = np.arange(1, 7, dtype=np.float32).reshape(1, 6)
    h = np.array([[0, 2, 0, 1, 2, 0]], np.float32)
    s = np.array([[1, -1, 1, 1, 1, -1]], np.float32)
    (out,) = _torch_op("count_sketch", [data, h, s], {"out_dim": 3})
    np.testing.assert_array_equal(out.numpy(), [[1 + 3 - 6, 4, -2 + 5]])


def test_ctc_loss_of_an_empty_label_is_all_blanks():
    """An empty label (llen 0) costs -sum_t log p(blank); repeated symbols
    need a blank between them (no skip), so a label of T equal symbols
    cannot be emitted in T steps (the loss reaches the -1e9 floor)."""
    t, alpha = 5, 4
    data = np.random.RandomState(5).randn(t, 2, alpha).astype(np.float32)
    label = np.array([[0, 0, 0, 0, 0], [2, 2, 2, 2, 2]], np.float32)
    (loss,) = _torch_op("ctc_loss", [data, label])
    logp = torch.log_softmax(torch.from_numpy(data), -1).numpy()
    np.testing.assert_allclose(loss.numpy()[0], -logp[:, 0, 0].sum(),
                               rtol=1e-6)
    assert loss.numpy()[1] > 1e8
    want, _ = _jax_run("ctc_loss", [data, label], {}, [], 7)
    np.testing.assert_allclose(loss.numpy(), want[0], **TOL)


# --- ssd-vgg16 ---------------------------------------------------------------
SSD_SHAPE = (2, 3, 64, 64)
SSD_CLASSES = 3


def _ssd(pkg, mode="train"):
    with pkg.name.NameManager():
        return pkg.models.get_symbol("ssd-vgg16", num_classes=SSD_CLASSES,
                                     mode=mode)


def _ssd_inputs():
    """Seeded images, (B, 8, 5) labels padded with -1 (1-8 boxes an
    image, ``tools/ssd.py``'s maker) and Xavier-scaled weights."""
    from mxnet_tpu_torch.tools.ssd import ssd_labels

    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, SSD_SHAPE)
    y = ssd_labels(rng, SSD_SHAPE[0], 8, SSD_CLASSES)
    return x, y, rng


def test_ssd_builder_matches_jax():
    """The same arguments, outputs and inferred shapes at SSD300 width and
    at 64 x 64; 1,756 anchors at 300 x 300 (4 a position over 18^2, 9^2,
    5^2, 3^2) and 27 convolutions, 24 of them 3x3."""
    from mxnet_tpu_torch.tools.resnet import wgrad_convs

    for shape in ((1, 3, 300, 300), SSD_SHAPE):
        got, want = _ssd(mt), _ssd(mx)
        shapes = {"data": shape, "label": (shape[0], 8, 5)}
        assert got.list_arguments() == want.list_arguments()
        assert got.list_outputs() == want.list_outputs()
        g, w = got.infer_shape(**shapes), want.infer_shape(**shapes)
        for gs, ws in zip(g, w):
            assert [tuple(s) for s in gs] == [tuple(s) for s in ws]
    full = _ssd(mt).infer_shape(data=(1, 3, 300, 300), label=(1, 8, 5))[1]
    assert full[0] == (1, SSD_CLASSES + 1, 1756)
    sym = mt.models.get_symbol("ssd-vgg16")
    convs = [n for n in sym._nodes() if not n.is_var
             and n.op.name == "Convolution"]
    assert len(convs) == 27 and wgrad_convs(sym) == 24
    assert len(sym.list_arguments()) - 2 == 54


def _bind_f64(pkg, sym, shapes):
    f64 = {n: np.float64 for n in sym.list_arguments()}
    if pkg is mx:
        return sym.simple_bind(mx.cpu(), type_dict=f64, **shapes)
    return sym.simple_bind("cpu", type_dict=f64, **shapes)


def _ssd_run_f64(pkg, sym, shapes, values):
    exe = _bind_f64(pkg, sym, shapes)
    for n, v in values.items():
        exe.arg_dict[n][:] = v
    exe.forward(is_train=True)
    exe.backward()
    return [o.asnumpy() for o in exe.outputs], {
        n: g.asnumpy() for n, g in exe.grad_dict.items()
        if g is not None and n not in shapes}


def test_ssd_forward_backward_matches_jax_in_f64():
    """``ssd-vgg16`` train symbol, 64 x 64, 3 classes, batch 2: both
    packages in f64 on the same weights; the class probabilities, the
    location loss and every gradient within 1e-9 of its largest entry, the
    class targets equal."""
    x, y, rng = _ssd_inputs()
    tsym, jsym = _ssd(mt), _ssd(mx)
    shapes = {"data": SSD_SHAPE, "label": y.shape}
    arg_shapes, _, _ = tsym.infer_shape(**shapes)
    values = {"data": x, "label": y}
    for n, s in zip(tsym.list_arguments(), arg_shapes):
        if n not in values:
            values[n] = rng.randn(*s) / np.sqrt(
                int(np.prod(s[1:])) if len(s) > 1 else 1)
    with jax.enable_x64(True):
        want_out, want = _ssd_run_f64(mx, jsym, shapes, values)
    got_out, got = _ssd_run_f64(mt, tsym, shapes, values)
    assert [o.shape for o in got_out] == [o.shape for o in want_out]
    np.testing.assert_array_equal(got_out[2], want_out[2])
    assert (got_out[2] > 0).any()
    for g, w in zip(got_out[:2], want_out[:2]):
        assert g.dtype == np.float64
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max()
    assert set(got) == set(want) and len(got) == 54
    for n, w in want.items():
        err = float(np.abs(got[n] - w).max())
        assert err <= 1e-9 * float(np.abs(w).max()), (n, err)


def test_ssd_detect_symbol_matches_jax():
    """The detection symbol (softmax over the classes, then
    MultiBoxDetection, ``nms_topk`` 400) on the same f32 weights: every
    row within rtol 1e-5 / atol 1e-6, the class column (the keep mask)
    equal."""
    x, _, rng = _ssd_inputs()
    tsym, jsym = _ssd(mt, "detect"), _ssd(mx, "detect")
    assert tsym.list_arguments() == jsym.list_arguments()
    arg_shapes, _, _ = tsym.infer_shape(data=SSD_SHAPE)
    values = {"data": x.astype(np.float32)}
    for n, s in zip(tsym.list_arguments(), arg_shapes):
        if n != "data":
            values[n] = (rng.randn(*s) / np.sqrt(
                int(np.prod(s[1:])) if len(s) > 1 else 1)).astype(
                    np.float32)
    outs = []
    for pkg, sym, ctx in ((mx, jsym, mx.cpu()), (mt, tsym, "cpu")):
        exe = sym.simple_bind(ctx, grad_req="null", data=SSD_SHAPE)
        for n, v in values.items():
            exe.arg_dict[n][:] = v
        exe.forward(is_train=False)
        outs.append(exe.outputs[0].asnumpy())
    want, got = outs[0], outs[1]
    assert got.shape == want.shape == (2, 4 * (16 + 4 + 1 + 1), 6)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[..., 0] >= 0).any() and (got[..., 0] < 0).any()


def test_contrib_ops_have_the_reference_signatures():
    """Each of the nine ops: the JAX package's parameters and defaults,
    inputs, inputs without a gradient and number of outputs."""
    for name in CONTRIB_OPS:
        j, t = jreg.get_op(name), treg.get_op(name)
        assert t.param_spec == j.param_spec, name
        assert tuple(t.no_grad_inputs) == tuple(j.no_grad_inputs), name
        for attrs in ({}, {"output_score": True}):
            if name != "Proposal" and attrs:
                continue
            full = t.parse_attrs(attrs)
            assert t.get_arg_names(full) == j.get_arg_names(
                j.parse_attrs(attrs)), name
            assert t.get_num_outputs(full) == j.get_num_outputs(
                j.parse_attrs(attrs)), name
