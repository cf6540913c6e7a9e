"""The case table of the core and contrib ops (the unary families,
``Cast`` and ``add_n`` of ``elemwise``, the index reductions, ``pick`` and
the logical broadcasts of ``broadcast_reduce``, the shape, indexing and
ordering ops of ``matrix``, ``RMSNorm``, the layer heads, norms and
spatial ops of ``nn``, and the nine detection and signal ops of
``contrib``), one for both of its checks:

- ``tests/test_torch_ops_core.py`` runs each case at its small shapes
  (``op_cases()``) on the CPU against the JAX package's op;
- ``chip_smoke.py``'s image_zoo phase runs each at full shapes
  (``op_cases(big=True)``) on the card against the port's CPU path (the
  contrib cases in its ssd phase, :data:`CONTRIB_OPS`).

A case names one registry op, its inputs (makers: a
``numpy.random.RandomState`` -> an f32 array), its attributes, the inputs
whose vector-Jacobian product is compared, whether its outputs must agree
bit for bit (``exact``: the ops that only move, pick, order or round
values; a tuple names the outputs that must, such as MultiBoxTarget's
mask and class targets, the rest being close) and its aux states. Ties are integer-valued inputs; the edge cases
(out-of-range ids, ``adj`` at or past the stride, grid points on integers
and outside the image, empty ROI bins) are constants at both sizes where
their shape must stay small.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class OpCase(NamedTuple):
    op: str
    makers: list
    attrs: dict
    diff: list
    exact: object    # bool, or a tuple of the exact outputs' indices
    aux: tuple = ()


def exact_output(case, i):
    """Whether output ``i`` of ``case`` must agree bit for bit."""
    return case.exact is True or (isinstance(case.exact, tuple)
                                  and i in case.exact)


# the detection and signal ops of ``contrib.py`` (their cases run in the
# ssd phase on the card)
CONTRIB_OPS = ("Correlation", "MultiBoxDetection", "MultiBoxPrior",
               "MultiBoxTarget", "Proposal", "count_sketch", "ctc_loss",
               "fft", "ifft")


def normal(*shape) -> Callable:
    return lambda rng: rng.randn(*shape).astype(np.float32)


def uniform(lo, hi, *shape) -> Callable:
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def pos(*shape) -> Callable:
    return uniform(0.5, 1.5, *shape)


def ints(hi, *shape, lo=0) -> Callable:
    return lambda rng: rng.randint(lo, hi, shape).astype(np.float32)


def halves(*shape) -> Callable:
    """Multiples of 0.5, half of them at .5: round-half-to-even shows."""
    return lambda rng: (rng.randint(-16, 17, shape) / 2.0).astype(np.float32)


def const(values) -> Callable:
    return lambda rng: np.asarray(values, np.float32)


def with_nans(lo, hi, *shape) -> Callable:
    def make(rng):
        x = rng.uniform(lo, hi, shape).astype(np.float32)
        x[rng.rand(*shape) < 0.3] = np.nan
        return x
    return make


def grid_on_integers_and_outside(rng):
    """(1, 2, 2, 5) grid over a 5 x 5 image: x at exact pixels (-1, -0.5,
    0, 0.5, 1 map to 0..4) and outside it (1.5, -1.3), y off-pixel."""
    gx = np.array([[-1.0, -0.5, 0.0, 0.5, 1.0], [1.5, -1.3, 0.25, 0.0, 1.0]])
    gy = np.array([[0.1, -0.7, 1.0, -1.0, 0.33], [0.0, 0.5, 1.2, -1.5, 0.9]])
    return np.stack([gx, gy])[None].astype(np.float32)


def affine(n) -> Callable:
    return lambda rng: (np.tile([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]], (n, 1))
                        + 0.05 * rng.randn(n, 6)).astype(np.float32)


def saturating(*shape) -> Callable:
    """Floats far past every integer type's range, at its edges, NaN and
    the infinities, mixed with values in range."""
    edges = np.array([np.nan, np.inf, -np.inf, 2147483648.0, -2147483648.0,
                      2147483520.0, 255.9, 256.0, -0.9, -128.5, 127.99,
                      1e10, -3e9, 70000.0], np.float32)

    def make(rng):
        x = (rng.randn(*shape) * 10.0 ** rng.randint(0, 10, shape)).astype(
            np.float32)
        flat = x.reshape(-1)
        flat[:edges.size] = edges[:flat.size]
        return x
    return make


def ctc_labels(batch, length, alphabet) -> Callable:
    """(batch, length) CTC labels in 1..alphabet-1, 0-padded: the first row
    empty, the second a run of repeated symbols (no skip between equal
    neighbours), the rest random lengths."""
    def make(rng):
        lab = np.zeros((batch, length), np.float32)
        lab[1, :length] = np.repeat(rng.randint(1, alphabet, length // 2 + 1),
                                    2)[:length]
        for b in range(2, batch):
            n = rng.randint(1, length + 1)
            lab[b, :n] = rng.randint(1, alphabet, n)
        return lab
    return make


def random_boxes(rng, n, lo=0.0, hi=1.0, min_side=0.05, max_side=0.5):
    """(n, 4) corner boxes inside [lo, hi] with sides in [min_side,
    max_side) of the range."""
    span = hi - lo
    wh = rng.uniform(min_side, max_side, (n, 2)) * span
    x0 = lo + rng.uniform(0, 1, (n, 2)) * (span - wh)
    return np.concatenate([x0, x0 + wh], axis=1).astype(np.float32)


def anchors(n) -> Callable:
    return lambda rng: random_boxes(rng, n)[None]


def box_labels(batch, rows, classes) -> Callable:
    """(batch, rows, 5) ground truth [class, xmin, ymin, xmax, ymax], each
    image 1..rows boxes, the rest -1 rows (padding)."""
    def make(rng):
        lab = np.full((batch, rows, 5), -1.0, np.float32)
        for b in range(batch):
            n = rng.randint(1, rows + 1)
            lab[b, :n, 0] = rng.randint(0, classes, n)
            lab[b, :n, 1:] = random_boxes(rng, n, min_side=0.1)
        return lab
    return make


def padding_row_last_writer(rng):
    """Anchors on a 1/8 grid and ground truth whose forced matches collide
    on anchor 0: box 0's best anchor is anchor 0 at IoU 0.4 (under the
    threshold), and the padding rows after it (IoU -1 everywhere, so their
    argmax is anchor 0 too) win it as the last writers, so no anchor is
    positive for box 0; boxes 1 and 2 tie at IoU 0.5 on anchor 2 (the
    first maximum wins the best-ground-truth choice, the later row the
    forced one)."""
    return np.array([[[0.0, 0.0, 0.25, 0.25], [0.5, 0.5, 0.75, 0.75],
                      [0.25, 0.0, 0.5, 0.25], [0.0, 0.5, 0.375, 1.0],
                      [0.625, 0.0, 1.0, 0.375]]], np.float32)


def last_writer_labels(rng):
    return np.array([[[2, 0.0, 0.0, 0.25, 0.625],
                      [0, 0.25, 0.0, 0.5, 0.125],
                      [1, 0.25, 0.125, 0.5, 0.25],
                      [-1, -1, -1, -1, -1], [-1, -1, -1, -1, -1]]],
                    np.float32)


def class_probs(batch, classes, n, ties=False) -> Callable:
    """(batch, classes, n) per-anchor class probabilities (a softmax over
    the classes); with ``ties`` quantised to 1/16, so scores tie across
    anchors and classes."""
    def make(rng):
        z = rng.randn(batch, classes, n) * 2.0
        p = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        if ties:
            p = np.round(p * 16) / 16
        return p.astype(np.float32)
    return make


def signs(*shape) -> Callable:
    return lambda rng: rng.choice([-1.0, 1.0], shape).astype(np.float32)


ROUNDING = ("rint", "round", "ceil", "floor", "trunc", "fix")
CAST_TYPES = ("bfloat16", "float16", "int32", "uint8")


def op_cases(big=False):
    """{key: OpCase} at the small shapes or, with ``big``, the full ones."""
    def S(small, large):
        return large if big else small

    cases = {}

    def case(key, op, makers, attrs=None, diff=None, exact=False, aux=()):
        cases[key] = OpCase(op, makers, attrs or {},
                            list(range(len(makers))) if diff is None
                            else diff, exact, tuple(aux))

    rc = S((3, 4), (256, 1024))
    r, c = rc
    a = normal(*rc)

    # --- elemwise ------------------------------------------------------------
    for op in ROUNDING:
        case(op, op, [halves(*S((4, 5), rc))], exact=True)
    for op in ("cbrt", "rcbrt", "expm1", "arctan", "sinh", "cosh", "tanh",
               "arcsinh", "degrees", "radians", "sigmoid", "softsign", "erf",
               "make_loss"):
        case(op, op, [a])
    for op in ("rsqrt", "log10", "log2", "log1p", "gammaln", "reciprocal",
               "gamma"):
        case(op, op, [pos(*rc)])
    for op in ("sin", "cos", "tan"):
        case(op, op, [uniform(-1.2, 1.2, *rc)])
    for op in ("arcsin", "arccos", "arctanh", "erfinv"):
        case(op, op, [uniform(-0.9, 0.9, *rc)])
    case("arccosh", "arccosh", [uniform(1.1, 3.1, *rc)])
    # exp(lgamma(x)): the sign of Gamma at negative non-integers is dropped
    case("gamma_negative", "gamma", [const([[-0.5, -1.5, -2.5, 0.25]])])
    case("logical_not", "logical_not", [ints(3, *rc)], diff=[], exact=True)
    case("_hypot_scalar", "_hypot_scalar", [a], {"scalar": 0.7})
    case("smooth_l1", "smooth_l1", [a])
    case("smooth_l1_sigma2", "smooth_l1", [a], {"scalar": 2.0})
    for op in ("add_n", "ElementWiseSum", "_sum"):
        case(op, op, [a, normal(*rc), normal(*rc)], {"num_args": 3})
    for dtype in CAST_TYPES:
        case("Cast_" + dtype, "Cast", [uniform(0.0, 200.0, *rc)],
             {"dtype": dtype}, diff=[], exact=True)
    # out of every integer type's range, NaN and the infinities: saturate
    for dtype in ("uint8", "int8", "int32"):
        case("Cast_saturate_" + dtype, "Cast", [saturating(*rc)],
             {"dtype": dtype}, diff=[], exact=True)

    # --- broadcast_reduce ----------------------------------------------------
    ties = ints(3, *S((3, 4, 5), (64, 16, 32)))
    case("argmax_ties_all", "argmax", [ties], diff=[], exact=True)
    case("argmax_ties_axis", "argmax", [ties], {"axis": 1}, diff=[],
         exact=True)
    case("argmax_keepdims", "argmax", [ties],
         {"axis": -1, "keepdims": True}, diff=[], exact=True)
    case("argmin_ties_axis", "argmin", [ties], {"axis": 2}, diff=[],
         exact=True)
    case("argmin_all", "argmin", [a], diff=[], exact=True)
    case("argmax_channel", "argmax_channel", [ties], diff=[], exact=True)
    pr, pc = S((3, 5), (256, 1024))
    case("pick_squeezed", "pick", [normal(pr, pc), ints(pc, pr)], diff=[0],
         exact=True)
    case("pick_keepdims_index", "pick", [normal(pr, pc), ints(pc, pr, 1)],
         {"keepdims": True}, diff=[0], exact=True)
    case("pick_axis0", "pick", [normal(pc, pr), ints(pc, pr)],
         {"axis": 0}, diff=[0], exact=True)
    # clip clamps -3 to 0 (not Python's end-relative index) and 7 to the
    # last; wrap takes them modulo the axis
    far = S(const([-3, 7, 2]), ints(pc + 6, pr, lo=-6))
    case("pick_clip_out_of_range", "pick", [normal(pr, pc), far], diff=[0],
         exact=True)
    case("pick_wrap_out_of_range", "pick", [normal(pr, pc), far],
         {"mode": "wrap"}, diff=[0], exact=True)
    case("nansum", "nansum", [with_nans(0.5, 1.5, *S((3, 4, 5),
                                                     (64, 256, 32)))],
         {"axis": 1})
    case("nansum_all", "nansum", [with_nans(0.5, 1.5, *S((3, 4),
                                                         (64, 256)))])
    case("nanprod", "nanprod", [with_nans(0.9, 1.1, *S((3, 4, 5),
                                                       (16, 32, 16)))],
         {"axis": (0, 2)})
    case("broadcast_axis", "broadcast_axis", [normal(*S((3, 1, 4),
                                                        (64, 1, 1024)))],
         {"axis": 1, "size": S(5, 8)}, exact=True)
    case("broadcast_axes", "broadcast_axes", [normal(*S((1, 3, 1),
                                                        (1, 256, 1)))],
         {"axis": (0, 2), "size": S((2, 4), (8, 512))}, exact=True)
    case("broadcast_hypot", "broadcast_hypot", [a, normal(1, c)])
    for op in ("broadcast_logical_and", "broadcast_logical_or",
               "broadcast_logical_xor"):
        case(op, op, [ints(2, *rc), ints(2, 1, c)], diff=[], exact=True)

    # --- matrix --------------------------------------------------------------
    b, m, k, n = S((2, 3, 4, 5), (8, 64, 128, 32))
    case("batch_dot", "batch_dot", [normal(b, m, k), normal(b, k, n)])
    case("batch_dot_ta", "batch_dot", [normal(b, k, m), normal(b, k, n)],
         {"transpose_a": True})
    case("batch_dot_tb", "batch_dot", [normal(b, m, k), normal(b, n, k)],
         {"transpose_b": True})
    cube = normal(*S((2, 3, 4), (16, 32, 64)))
    case("transpose", "transpose", [cube], exact=True)
    case("transpose_axes", "transpose", [cube], {"axes": (1, 0, 2)},
         exact=True)
    case("slice", "slice", [normal(*S((4, 5, 6), (16, 32, 64)))],
         S({"begin": (1, None, -4), "end": (3, 4, None)},
           {"begin": (2, None, -40), "end": (9, 30, None)}), exact=True)
    case("crop", "crop", [normal(*S((4, 5), (64, 128)))],
         {"begin": (0, 1), "end": (2, -1)}, exact=True)
    flat = normal(*S((2, 3), (16, 64)))
    case("tile", "tile", [flat], {"reps": (2, 1)}, exact=True)
    case("tile_more_reps", "tile", [flat], {"reps": (2, 1, 3)}, exact=True)
    case("tile_fewer_reps", "tile", [normal(*S((2, 3, 2), (16, 64, 2)))],
         {"reps": (2,)}, exact=True)
    case("repeat_flat", "repeat", [flat], {"repeats": 2}, exact=True)
    case("repeat_axis", "repeat", [flat], {"repeats": 3, "axis": 1},
         exact=True)
    case("reverse", "reverse", [cube], {"axis": (0, 2)}, exact=True)
    case("flip", "flip", [cube], {"axis": 1}, exact=True)
    img = normal(*S((1, 2, 3, 4), (4, 8, 32, 32)))
    case("pad_constant", "Pad", [img],
         {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1), "constant_value": 1.5},
         exact=True)
    case("pad_edge", "Pad", [img],
         {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}, exact=True)
    case("pad_reflect", "Pad", [img],
         {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 2, 3, 1)},
         exact=True)
    case("pad_reflect_every_axis", "pad", [normal(*S((3, 4, 5),
                                                     (16, 32, 64)))],
         {"mode": "reflect", "pad_width": (1, 2, 2, 0, 4, 3)}, exact=True)
    rows, width = S((5, 3), (512, 64))
    table = normal(rows, width)
    case("take", "take", [table, ints(rows, *S((2, 4), (32, 64)))],
         diff=[0], exact=True)
    case("take_axis1", "take", [normal(*S((3, 5, 2), (16, 512, 8))),
                                ints(S(5, 512), S(4, 64))],
         {"axis": 1}, diff=[0], exact=True)
    # clip: -4 and -1 read row 0 (not Python's end-relative rows), 9 the
    # last row
    far = S(const([[-4, -1, 0], [4, 5, 9]]), ints(rows + 8, 32, 64, lo=-8))
    case("take_clip_out_of_range", "take", [table, far], diff=[0],
         exact=True)
    case("take_wrap_out_of_range", "take", [table, far], {"mode": "wrap"},
         diff=[0], exact=True)
    br, bc = S((4, 5), (256, 64))
    case("batch_take", "batch_take", [normal(br, bc), ints(bc, br)],
         diff=[0], exact=True)
    case("batch_take_out_of_range", "batch_take",
         [normal(br, bc), S(const([-1, -5, 5, 9]), ints(bc + 6, br,
                                                        lo=-bc - 6))],
         diff=[0], exact=True)
    case("sort_ties", "sort", [ties], diff=[0], exact=True)
    case("sort_descending", "sort", [ties], {"axis": 1, "is_ascend": False},
         diff=[0], exact=True)
    case("sort_flat", "sort", [a], {"axis": None, "is_ascend": False},
         diff=[0], exact=True)
    case("argsort_ties", "argsort", [ties], diff=[], exact=True)
    case("argsort_ties_descending", "argsort", [ties],
         {"axis": 0, "is_ascend": False}, diff=[], exact=True)
    case("argsort_flat_dtype_ignored", "argsort", [ties],
         {"axis": None, "dtype": "int32"}, diff=[], exact=True)
    case("topk_ties", "topk", [ties], {"k": 3}, diff=[], exact=True)
    case("topk_ascend_axis", "topk", [ties],
         {"k": 2, "axis": 1, "is_ascend": True}, diff=[], exact=True)
    case("topk_value", "topk", [ties], {"k": 2, "ret_typ": "value"},
         exact=True)
    case("topk_both", "topk", [ties], {"k": 2, "axis": 0,
                                        "ret_typ": "both"}, exact=True)
    case("topk_mask", "topk", [ties], {"k": 2, "axis": 1,
                                        "ret_typ": "mask"},
         diff=[], exact=True)

    # --- attention / nn ------------------------------------------------------
    d = S(8, 1024)
    case("rms_norm", "RMSNorm", [normal(*S((2, 3), (64, 16)), d), pos(d)])
    case("rms_norm_axis1", "RMSNorm", [normal(S(2, 16), d, S(3, 64)),
                                       pos(d)], {"axis": 1, "eps": 1e-5})
    act = normal(*S((2, 3, 4), (32, 64, 256)))
    case("leaky", "LeakyReLU", [act], {"slope": 0.1})
    case("elu", "LeakyReLU", [act], {"act_type": "elu", "slope": 0.5})
    case("prelu", "LeakyReLU", [normal(*S((2, 3, 4, 2), (32, 64, 16, 16))),
                                pos(S(3, 64))], {"act_type": "prelu"})
    case("rrelu_mean_slope", "LeakyReLU", [normal(*S((2, 3), rc))],
         {"act_type": "rrelu"})
    ch = S(3, 32)
    fmap = normal(*S((2, 3, 4, 5), (16, 32, 28, 28)))
    case("instance_norm", "InstanceNorm", [fmap, pos(ch), normal(ch)])
    for mode in ("instance", "channel", "spatial"):
        case("l2_normalization_" + mode, "L2Normalization",
             [normal(*S((2, 3, 4, 2), (16, 32, 28, 28)))], {"mode": mode})
    case("lrn", "LRN", [normal(*S((2, 7, 3, 3), (16, 96, 27, 27)))])
    case("lrn_nsize3", "LRN", [normal(*S((2, 4, 3, 3), (16, 64, 13, 13)))],
         {"nsize": 3, "alpha": 0.1, "beta": 0.5, "knorm": 1.0})
    case("softmax_activation", "SoftmaxActivation",
         [normal(*S((2, 3, 4), (64, 8, 1000)))])
    case("softmax_activation_channel", "SoftmaxActivation",
         [normal(*S((2, 3, 4), (16, 32, 784)))], {"mode": "channel"})
    head = S((4, 3), (256, 16))
    for op in ("LinearRegressionOutput", "MAERegressionOutput",
               "LogisticRegressionOutput"):
        case(op, op, [normal(*head), normal(*head)], {"grad_scale": 0.5},
             diff=[0])
    case("linear_regression_1d_label", "LinearRegressionOutput",
         [normal(head[0], 1), normal(head[0])], diff=[0])
    sr, sc = S((4, 5), (256, 1000))
    case("svm_l2", "SVMOutput", [normal(sr, sc), ints(sc, sr)],
         {"margin": 1.5}, diff=[0])
    case("svm_linear", "SVMOutput", [normal(sr, sc), ints(sc, sr)],
         {"use_linear": True, "regularization_coefficient": 0.5}, diff=[0])
    case("identity_attach_kl_sparse_reg", "IdentityAttachKLSparseReg",
         [uniform(0.05, 0.6, *S((4, 6), (256, 512)))],
         {"sparseness_target": 0.2, "penalty": 0.01, "momentum": 0.8},
         aux=[uniform(0.1, 0.3, S(6, 512))])
    dn, dc, ds = S((2, 4, 4), (8, 64, 14))
    case("deconv", "Deconvolution", [normal(dn, dc, ds, ds),
                                     normal(dc, S(2, 32), 3, 3)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": S(2, 32)})
    case("deconv_adj_at_stride", "Deconvolution",
         [normal(*S((1, 2, 3, 4), (8, 32, 14, 14))),
          normal(S(2, 32), S(3, 16), 3, 3)],
         {"kernel": (3, 3), "stride": (2, 2), "adj": (2, 3),
          "num_filter": S(3, 16)})
    case("deconv_adj_past_stride_groups", "Deconvolution",
         [normal(dn, dc, ds, ds), normal(dc, S(2, 16), 4, 4)],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (1, 1), "adj": (3, 2),
          "num_filter": S(4, 32), "num_group": 2})
    case("deconv_adj_stride1", "Deconvolution",
         [normal(*S((1, 2, 3, 3), (8, 32, 14, 14))),
          normal(S(2, 32), S(2, 32), 2, 2)],
         {"kernel": (2, 2), "adj": (1, 1), "num_filter": S(2, 32)})
    case("deconv_target_shape", "Deconvolution",
         [normal(*S((1, 2, 4, 4), (8, 32, 14, 14))),
          normal(S(2, 32), S(3, 16), 4, 4), normal(S(3, 16))],
         {"kernel": (4, 4), "stride": (2, 2), "pad": (9, 9),
          "target_shape": S((7, 8), (27, 30)), "num_filter": S(3, 16),
          "no_bias": False})
    case("deconv_groups_dilate", "Deconvolution",
         [normal(*S((2, 4, 3, 3), (8, 64, 14, 14))),
          normal(S(4, 64), S(3, 16), 3, 3)],
         {"kernel": (3, 3), "num_group": 2, "num_filter": S(6, 32),
          "dilate": (2, 1), "pad": (1, 0)})
    un, us = S((2, 2), (8, 14))
    case("upsampling_nearest", "UpSampling",
         [normal(un, S(3, 32), us, S(3, 14))], {"scale": 2}, exact=True)
    case("upsampling_nearest_concat", "UpSampling",
         [normal(S(1, 8), S(2, 16), us, us), normal(S(1, 8), S(3, 32), us,
                                                     us)],
         {"scale": 3, "num_args": 2}, exact=True)
    case("upsampling_nearest_sum", "UpSampling",
         [normal(S(1, 8), S(2, 16), us, us), normal(S(1, 8), S(2, 16), us,
                                                     us)],
         {"scale": 2, "num_args": 2, "multi_input_mode": "sum"}, exact=True)
    uc = S(3, 32)
    case("upsampling_bilinear", "UpSampling",
         [normal(un, uc, S(3, 14), S(4, 14)), normal(uc, 1, 4, 4)],
         {"scale": 2, "sample_type": "bilinear", "num_args": 2,
          "num_filter": uc})
    case("upsampling_bilinear_s3", "UpSampling",
         [normal(S(1, 8), S(2, 16), S(2, 14), S(3, 14)),
          normal(S(2, 16), 1, 5, 5)],
         {"scale": 3, "sample_type": "bilinear", "num_args": 2})
    gn = S(2, 8)
    case("grid_affine", "GridGenerator", [normal(gn, 6)],
         {"target_shape": S((3, 4), (20, 24))})
    case("grid_warp", "GridGenerator", [normal(gn, 2, *S((3, 4),
                                                          (16, 16)))],
         {"transform_type": "warp"})
    case("bilinear_sampler", "BilinearSampler",
         [normal(gn, *S((3, 4, 5), (32, 28, 28))),
          uniform(-1.2, 1.2, gn, 2, *S((3, 3), (20, 20)))])
    case("bilinear_sampler_integers_outside", "BilinearSampler",
         [normal(1, S(2, 64), 5, 5), grid_on_integers_and_outside])
    case("spatial_transformer", "SpatialTransformer",
         [normal(gn, *S((3, 5, 6), (32, 28, 28))), affine(gn)],
         {"target_shape": S((4, 3), (20, 24))})
    # rois: [batch, x1, y1, x2, y2]; the second reaches past the image
    # (bins outside it give 0), the third is one pixel; integer data ties
    rois = S(const([[0, 0, 0, 3, 2], [1, 2, 1, 12, 11], [1, 4, 3, 4, 3],
                    [0, 1.5, 0.5, 5.5, 4.5]]),
             const([[0, 0, 0, 15, 11], [1, 4, 2, 40, 30], [1, 3, 3, 3, 3],
                    [0, 1.5, 0.5, 20.5, 22.5]]))
    rshape = S((2, 2, 6, 7), (2, 16, 24, 24))
    case("roi_pooling_ties_and_empty_bins", "ROIPooling",
         [ints(3, *rshape), rois], {"pooled_size": (2, 3)}, diff=[0],
         exact=True)
    case("roi_pooling_scaled", "ROIPooling", [normal(*rshape), rois],
         {"pooled_size": (3, 2), "spatial_scale": 0.5}, diff=[0], exact=True)
    cshape = S((2, 3, 6, 7), (8, 32, 28, 28))
    case("crop_h_w", "Crop", [normal(*cshape)],
         {"h_w": S((3, 4), (20, 24)), "offset": (1, 2)}, exact=True)
    case("crop_center", "Crop", [normal(*cshape)],
         {"h_w": S((3, 4), (20, 24)), "center_crop": True}, exact=True)
    case("crop_like", "Crop", [normal(*cshape),
                               normal(cshape[0], 1, *S((4, 5), (20, 24)))],
         {"num_args": 2, "center_crop": True}, diff=[0], exact=True)

    # --- contrib: signal ops -------------------------------------------------
    t, cb, alpha, length = S((12, 4, 6, 4), (100, 32, 50, 20))
    case("ctc_loss", "ctc_loss", [normal(t, cb, alpha),
                                  ctc_labels(cb, length, alpha)], diff=[0])
    fr, fd = S((3, 8), (64, 1024))
    case("fft", "fft", [normal(fr, fd)], diff=[0])
    case("ifft", "ifft", [normal(fr, 2 * fd)], diff=[0])
    cn, cin, cout = S((4, 10, 6), (256, 4096, 1024))
    case("count_sketch", "count_sketch",
         [normal(cn, cin), ints(cout, 1, cin), signs(1, cin)],
         {"out_dim": cout}, diff=[0])
    # FlowNetC's correlation (kernel 1, displacement 20 in steps of 2, pad
    # 20) at its 1/8 scale, and a 3 x 3 window, both products and
    # absolute differences
    c1 = S((2, 3, 8, 9), (2, 256, 48, 64))
    c3 = S((2, 3, 7, 8), (2, 64, 48, 64))
    for mult in (True, False):
        tag = "" if mult else "_absdiff"
        case("correlation_k1" + tag, "Correlation", [normal(*c1), normal(*c1)],
             dict(S({"max_displacement": 2, "stride2": 1, "pad_size": 2},
                    {"max_displacement": 20, "stride2": 2, "pad_size": 20}),
                  is_multiply=mult), diff=[0, 1])
        case("correlation_k3" + tag, "Correlation", [normal(*c3), normal(*c3)],
             {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
              "pad_size": 1, "is_multiply": mult}, diff=[0, 1])

    # --- contrib: SSD and RCNN ops ---------------------------------------------
    # SSD300's anchors: 4 a position over 18^2, 9^2, 5^2, 3^2
    case("multibox_prior", "MultiBoxPrior", [normal(*S((1, 2, 5, 6),
                                                       (2, 8, 18, 18)))],
         {"sizes": (0.2, 0.272), "ratios": (1.0, 2.0, 0.5), "clip": True},
         diff=[])
    case("multibox_prior_steps", "MultiBoxPrior",
         [normal(*S((1, 2, 4, 3), (2, 8, 38, 38)))],
         {"sizes": (0.1, 0.141), "ratios": (1.0, 2.0, 0.5, 3.0),
          "steps": (0.125, 0.1), "offsets": (0.25, 0.75)}, diff=[])
    na, nb, ng, ncls = S((24, 2, 4, 3), (1756, 32, 8, 20))
    case("multibox_target", "MultiBoxTarget",
         [anchors(na), box_labels(nb, ng, ncls),
          normal(nb, ncls + 1, na)], diff=[], exact=(1, 2))
    case("multibox_target_padding_last_writer", "MultiBoxTarget",
         [padding_row_last_writer, last_writer_labels, normal(1, 4, 5)],
         diff=[], exact=(1, 2))
    nd_ = S(2, 8)
    case("multibox_detection", "MultiBoxDetection",
         [class_probs(nd_, ncls + 1, na), normal(nd_, na * 4), anchors(na)],
         {"nms_topk": S(10, 400)}, diff=[])
    case("multibox_detection_ties", "MultiBoxDetection",
         [class_probs(nd_, ncls + 1, na, ties=True),
          lambda rng: (0.3 * rng.randn(nd_, na * 4)).astype(np.float32),
          anchors(na)], {"nms_threshold": 0.45, "threshold": 0.05}, diff=[])
    # RPN: 9 anchors over a 38 x 50 map (a 600 x 800 image at stride 16)
    ph, pw, scales = S((4, 5, (2.0, 4.0)), (38, 50, (8.0, 16.0, 32.0)))
    pa = 3 * len(scales)
    post = S(12, 300)
    info = const([[ph * 16.0, pw * 16.0, 1.0]])
    for out_score in (False, True):
        case("proposal" + ("_scores" if out_score else ""), "Proposal",
             [uniform(0.0, 1.0, 1, 2 * pa, ph, pw),
              lambda rng, _s=(1, 4 * pa, ph, pw): (
                  0.2 * rng.randn(*_s)).astype(np.float32), info],
             {"scales": scales, "rpn_post_nms_top_n": post,
              "rpn_min_size": S(4, 16), "output_score": out_score},
             diff=[])
    return cases
