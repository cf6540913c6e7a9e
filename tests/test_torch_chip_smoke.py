"""chip_smoke.py's logic on the CPU at a tiny size.

The script itself needs a CUDA card; here its serve, train, resnet, lstm,
custom and bucketing phases run on the host (each wrapper takes its plain
version, counted in place of kernel launches) so a broken phase shows
before a card run, and its bound arithmetic is checked against closed
forms.
"""
import json
import re

import numpy as np
import pytest

import chip_smoke as cs
from mxnet_tpu_torch.ops.kernels import _launches
from mxnet_tpu_torch.ops.kernels import conv_wgrad as cw
from mxnet_tpu_torch.ops.kernels import flash_attention as fa
from mxnet_tpu_torch.ops.kernels import fused_update as fu
from mxnet_tpu_torch.ops.kernels import lstm as kl
from mxnet_tpu_torch.tools import rtc_softmax as rs

TINY = {"vocab": 97, "d_model": 32, "heads": 4, "kv_heads": 2, "ffn": 64,
        "layers": 2}
TINY_SERVE = {"slots": 2, "prefill_buckets": (8, 16), "max_context": 24,
              "max_new_tokens": 4, "prompt_lens": (3, 9, 14),
              "check_lens": (9, 14)}
# the paged traffic's shape, narrow: 8 slots over 22 blocks of 4, five
# prompts behind a 10-token system prompt (2 full blocks + 2), three
# unshared; the first six fit, the seventh waits for blocks
TINY_PAGED = {"slots": 8, "num_blocks": 22, "block_tokens": 4,
              "prefill_buckets": (8, 16, 24), "max_context": 24,
              "max_new_tokens": 4, "system_len": 10,
              "suffix_lens": (2, 3, 5, 7, 9), "other_lens": (3, 14, 18),
              "forced": (0, 1)}
# the speculative traffic: the paged traffic, 6 new tokens, k = 3
TINY_SPEC = dict(TINY_PAGED, max_new_tokens=6, spec_tokens=3,
                 temperature=0.8)
TINY_TRAIN = {"batch": 2, "seq": 16, "sgd_steps": 2, "adam_steps": 1,
              "lr": 0.05, "momentum": 0.9, "wd": 1e-4, "adam_lr": 1e-3,
              "dtype": "bfloat16", "timed_steps": 2,
              "check_batch": 1, "check_seq": 8, "check_steps": 2}
# plain version -> the launchers whose kernel launches it stands in for
PLAINS = {"flash_attention_plain": ("flash_attention",),
          "flash_attention_bwd_plain": ("flash_attention_bwd_dq",
                                        "flash_attention_bwd_dkv"),
          "sgd_mom_update_plain": ("sgd_mom_update",),
          "adam_update_plain": ("adam_update",),
          "conv_wgrad_plain": ("conv_wgrad_partial", "conv_wgrad_reduce"),
          "lstm_step_plain": ("lstm_step",)}
# ResNet-18 with the CIFAR stem at batch 2: every convolution but the 1x1
# shortcuts is 3x3 (17 per step)
TINY_RESNET = {"depth": 18, "classes": 10, "image": (3, 16, 16), "batch": 2,
               "batches": 2, "lr": 0.05, "momentum": 0.9, "wd": 1e-4,
               "dtype": "bfloat16", "check_batch": 2, "check_steps": 2}
# the fused LSTM LM, 2 layers, narrow
TINY_LSTM = {"vocab": 50, "embed": 16, "hidden": 16, "layers": 2, "seq": 5,
             "batch": 4, "batches": 2, "lr": 0.5, "check_batch": 2,
             "check_steps": 2}


# the bucketed LSTM LM, 2 layers, narrow, buckets 4 and 8
TINY_BUCKETING = dict(cs.BUCKETING, vocab=50, embed=16, hidden=16,
                      buckets=(4, 8), batch=4, sentences=200,
                      check_batch=2, check_keys=(4, 4, 8, 8),
                      resume_keys=(4, 8, 8, 4), capture_seq=5,
                      capture_batches=4, mask_elements=4096)


def _count_plain_calls(monkeypatch):
    """Count each plain call on the host as its kernels' launches, by the
    type of its first operand."""
    for plain_name, launcher_names in PLAINS.items():
        mod = next(m for m in (fa, fu, cw, kl) if hasattr(m, plain_name))
        plain = getattr(mod, plain_name)
        launchers = [getattr(mod, n) for n in launcher_names]

        def counted(*args, _plain=plain, _launchers=launchers, **kw):
            for launcher in _launchers:
                _launches.launched(launcher, args[0].dtype)
            return _plain(*args, **kw)

        monkeypatch.setattr(mod, plain_name, counted)


def test_serve_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    launches, tokens = cs.phase_serve(TINY, TINY_SERVE, device="cpu")
    assert launches == len(TINY_SERVE["prompt_lens"]) * TINY["layers"]
    assert [len(t) for t in tokens] == [TINY_SERVE["max_new_tokens"]] * 3
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "serve"' in line and '"flash_launches": 6' in line


def test_serve_phase_fails_when_the_kernel_is_not_reached(monkeypatch):
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="flash kernel ran 0 times"):
        cs.phase_serve(TINY, TINY_SERVE, device="cpu")


def _tiny_int8_tol():
    """1.5 x the tiny LM's f32-to-int8 distance, as chip_smoke.py's
    INT8_KV_TOL is of the full-width one."""
    from mxnet_tpu_torch.tools import kv_int8_spread

    res = kv_int8_spread.spread(TINY, TINY_PAGED, cs.SEED)
    assert res["unpaged"]["argmax_in_f32_top5"]
    assert res["paged"]["argmax_in_f32_top5"]
    assert 0 < res["spread"] < 0.5
    return 1.5 * res["spread"]


def test_serve_paged_phase_on_cpu(monkeypatch, capsys):
    """Every arm and gate of the phase on the host; the capture checks
    read the eager path, the only one the CPU has."""
    _count_plain_calls(monkeypatch)
    launches = cs.phase_serve_paged(TINY, TINY_SERVE, TINY_PAGED,
                                    device="cpu", int8_tol=_tiny_int8_tol())
    # the captured serve run, then the four unpaged arms of 8 prompts
    assert launches == (3 + 4 * 8) * TINY["layers"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_paged"
    assert (line["prefix_hits"], line["prefix_tokens_saved"],
            line["cow_forks"]) == (4, 40, 4)
    assert len(line["arms"]) == 8
    assert line["arms"]["paged_int8_captured"]["flash_launches"] == 0
    assert line["unpaged_capture"]["decode_path"] == "eager"
    assert line["direct_paged_capture"]["bit_for_bit"]


def test_serve_paged_phase_fails_when_a_prefix_count_is_off(monkeypatch):
    from mxnet_tpu_torch.serving.generate import paged as tpaged

    _count_plain_calls(monkeypatch)
    admit = tpaged.PagedKVCacheManager.try_admit

    def one_hit_too_many(self, *a, **kw):
        plan = admit(self, *a, **kw)
        if plan is not None and plan.ctx_len:
            self.prefix_hits += 1
        return plan

    monkeypatch.setattr(tpaged.PagedKVCacheManager, "try_admit",
                        one_hit_too_many)
    with pytest.raises(RuntimeError, match="prefix hits"):
        cs.phase_serve_paged(TINY, TINY_SERVE, TINY_PAGED, device="cpu",
                             int8_tol=1.0)


def test_serve_paged_phase_fails_on_a_flash_launch_in_the_paged_path(
        monkeypatch):
    from mxnet_tpu_torch.serving.generate import model as tmodel

    _count_plain_calls(monkeypatch)
    attend = tmodel.prefix_cached_attention

    def with_flash(q, *a, **kw):
        fa.flash_attention(q, q[:, :2], q[:, :2], causal=True)
        return attend(q, *a, **kw)

    monkeypatch.setattr(tmodel, "prefix_cached_attention", with_flash)
    with pytest.raises(RuntimeError, match="paged_f32_eager: flash kernel"):
        cs.phase_serve_paged(TINY, TINY_SERVE, TINY_PAGED, device="cpu",
                             int8_tol=1.0)


def _tiny_quant_tol():
    """1.5 x the tiny LM's f32-to-quantized-weights distances, as
    chip_smoke.py's QUANT_WEIGHTS_TOL is of the full-width one."""
    from mxnet_tpu_torch.tools import quant_weights_spread

    res = quant_weights_spread.spread(TINY, TINY_SPEC, cs.SEED,
                                      arms=("int8", "fp8"))
    assert all(r["argmax_in_f32_top5"] for r in res.values())
    return {arm: 1.5 * r["max_abs"] for arm, r in res.items()}


def test_serve_spec_phase_on_cpu(monkeypatch, capsys):
    """Every arm and gate of the phase on the host; the capture checks
    read the eager path, the only one the CPU has."""
    _count_plain_calls(monkeypatch)
    launches = cs.phase_serve_spec(TINY, TINY_SPEC, device="cpu",
                                   quant_tol=_tiny_quant_tol())
    # three unpaged arms of vanilla / quantized weights, three of spec
    assert launches == 6 * 8 * TINY["layers"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_spec" and len(line["arms"]) == 12
    arms = line["arms"]
    per_forward = 6 * TINY["layers"] + 1
    spec = arms["spec_int8_unpaged_f32_captured"]
    assert spec["int8_products"] == per_forward * 3 * spec["steps"] > 0
    assert arms["spec_self_unpaged_f32_captured"]["int8_products"] == 0
    assert arms["quant_fp8_unpaged_f32"]["int8_products"] == 0
    assert arms["spec_int8_paged_int8_captured"]["flash_launches"] == 0
    assert spec["tokens_per_seq_step"] > 1.0
    assert arms["vanilla_unpaged_f32"]["accept_rate"] == 0.0
    for name, row in arms.items():        # each against its own layout
        if name.startswith("vanilla"):
            assert row["tokens_per_s_vs_vanilla"] == 1.0
    assert sorted(line["quantized_matmul"]) == [
        "fp8_e4m3/bf16", "fp8_e4m3/float32", "int8/bf16", "int8/float32",
        "int8/int8"]
    assert line["quantized_matmul"]["int8/int8"]["max_abs_err"] == 0.0
    assert line["int8_accept_rate"]["predicted"] == \
        cs.SPEC_INT8_ACCEPT_PREDICTED
    tf = line["teacher_forced"]
    assert max(max(v) for e in tf["verify_vs_decode"].values()
               for v in e.values()) <= cs.SERVE_ATOL


def test_serve_spec_phase_fails_when_a_spec_stream_leaves_vanilla(
        monkeypatch):
    """A verify that favours another token where the margin is wide: the
    greedy gate must refuse."""
    from mxnet_tpu_torch.serving.generate import spec as tspec

    _count_plain_calls(monkeypatch)
    accept = tspec.accept_greedy

    def off_by_one(draft, vlogits, k_eff):
        acc, emitted = accept(draft, vlogits, k_eff)
        return acc, emitted[:-1] + [(emitted[-1] + 1) % TINY["vocab"]]

    monkeypatch.setattr(tspec, "accept_greedy", off_by_one)
    with pytest.raises(RuntimeError, match="leaves the vanilla one"):
        cs.phase_serve_spec(TINY, TINY_SPEC, device="cpu",
                            quant_tol={"int8": 1.0, "fp8": 1.0})


def test_serve_spec_phase_fails_without_the_int8_product(monkeypatch):
    """A draft whose products were widened to f32 counts no int8 product:
    the phase must refuse."""
    from mxnet_tpu_torch.ops import matrix

    _count_plain_calls(monkeypatch)
    monkeypatch.setattr(matrix, "int8_product",
                        lambda xq, w: xq.int() @ w.int().t())
    with pytest.raises(RuntimeError, match="int8 products"):
        cs.phase_serve_spec(TINY, TINY_SPEC, device="cpu",
                            quant_tol={"int8": 1.0, "fp8": 1.0})


def test_int8_product_bound_is_its_bytes_at_decode_shapes():
    # (8, 2048) x (2048, 8192): 16 KiB + 16 MiB in, 256 KiB out
    moved = 8 * 2048 + 2048 * 8192 + 4 * 8 * 8192
    assert cs.int8_product_bound(8, 2048, 8192) == pytest.approx(
        moved / 3.35e12 * 1e3)
    assert cs.qmm_shapes(cs.LM) == (
        (2048, 2048, 8), (2048, 512, 8), (2048, 8192, 4), (8192, 2048, 4),
        (2048, 10000, 1))


def test_serve_paged_traffic_at_full_width():
    """The full-width traffic's counts and block arithmetic: four joiners
    share the 1000-token system prompt (62 full blocks + 8 positions, so
    each forks), the first six prompts' reservations fit the 288 blocks,
    the seventh's does not."""
    paged = cs.SERVE_PAGED
    prompts = cs.paged_prompts(cs.LM, paged, cs.SEED)
    assert [len(p) for p in prompts] == [1024, 1100, 1300, 1500, 1900, 100,
                                         1500, 2000]
    assert cs.expected_prefix_counts(prompts, 16) == (4, 4000, 4)
    need = [-(-min(len(p) + 32, 2304) // 16) for p in prompts]
    shared = [0] + [1000 // 16] * 4 + [0] * 3
    first_wave = sum(n - s for n, s in zip(need[:6], shared[:6]))
    assert first_wave <= 288 < first_wave + need[6]
    assert need[6] + need[7] <= 288


@pytest.mark.parametrize("tq,tk", [(2048, 2048), (300, 1000), (7, 7)])
def test_attention_bound_counts_visible_pairs(tq, tk):
    b, h, hkv, d = 1, 16, 4, 128
    off = tk - tq
    pairs = sum(min(tk, i + off + 1) for i in range(tq))
    ms, by = cs.attention_bound(b, h, hkv, tq, tk, d, True, "bfloat16")
    t_ops = 4 * b * h * d * pairs / 989e12
    t_bytes = 2 * (2 * b * h * tq * d + 2 * b * hkv * tk * d) / 3.35e12
    assert np.isclose(ms, max(t_ops, t_bytes) * 1e3)
    assert by == ("operations" if t_ops >= t_bytes else "bytes")
    full_ms, _ = cs.attention_bound(b, h, hkv, tq, tk, d, False, "float32")
    assert full_ms >= ms


def test_train_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    launches = cs.phase_train(TINY, TINY_TRAIN, device="cpu")
    steps = TINY_TRAIN["sgd_steps"] + TINY_TRAIN["adam_steps"]
    n_params = len(cs.lm_param_shapes(TINY))
    assert launches == {
        "flash_attention_fwd": TINY["layers"] * steps,
        "flash_attention_bwd_dq": TINY["layers"] * steps,
        "flash_attention_bwd_dkv": TINY["layers"] * steps,
        "sgd_mom_update": n_params * TINY_TRAIN["sgd_steps"],
        "adam_update": n_params * TINY_TRAIN["adam_steps"]}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "train"' in line and '"losses"' in line


def test_train_phase_fails_when_the_kernels_are_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="train phase launched"):
        cs.phase_train(TINY, TINY_TRAIN, device="cpu")


@pytest.mark.parametrize("tq,tk,causal", [(2048, 2048, True),
                                          (300, 1000, True),
                                          (512, 512, False)])
def test_attention_bwd_bound_is_ten_d_flops_per_pair(tq, tk, causal):
    b, h, hkv, d = 4, 16, 4, 128
    pairs = (sum(min(tk, i + tk - tq + 1) for i in range(tq)) if causal
             else tq * tk)
    ms, by = cs.attention_bwd_bound(b, h, hkv, tq, tk, d, causal,
                                    "float32")
    assert by == "operations"
    assert np.isclose(ms, 10 * b * h * d * pairs / 67e12 * 1e3)


def test_update_bound_counts_each_buffer_once():
    n = sum(int(np.prod(s)) for s in cs.lm_param_shapes(cs.LM).values())
    assert 217.0e6 < n < 217.5e6
    ms, by = cs.update_bound("sgd_mom_update", n)
    assert by == "bytes" and np.isclose(ms, 20 * n / 3.35e12 * 1e3)
    assert np.isclose(cs.update_bound("adam_update", n)[0],
                      28 * n / 3.35e12 * 1e3)


def test_resnet_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    launches = cs.phase_resnet(TINY_RESNET, device="cpu")
    steps = TINY_RESNET["batches"]
    assert launches == {"conv_wgrad_partial": 17 * steps,
                        "conv_wgrad_reduce": 17 * steps,
                        "conv_wgrad_repack": 0,
                        "sgd_mom_update": 59 * steps}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "resnet"' in line and '"images_per_s"' in line


def test_resnet_phase_fails_when_conv_wgrad_is_not_reached(monkeypatch):
    """Only the update launches are counted here: the phase must refuse."""
    plain = fu.sgd_mom_update_plain

    def counted(*args, **kwargs):
        fu.sgd_mom_update.launches += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(fu, "sgd_mom_update_plain", counted)
    with pytest.raises(RuntimeError, match="resnet phase launched"):
        cs.phase_resnet(TINY_RESNET, device="cpu")


def test_resnet_wgrad_shapes_are_the_16_of_a_resnet50_step():
    from mxnet_tpu_torch.tools.resnet import RESNET, resnet_symbol, \
        wgrad_convs

    assert sum(cs.RESNET_WGRAD.values()) == 16
    assert wgrad_convs(resnet_symbol(RESNET)) == 16
    cases = cs.wgrad_cases()
    assert len(cases) == 2 * (7 + 5)
    assert {(h, c, s) for n, h, c, k, ksz, s, _ in cases if n == 32} \
        == set(cs.RESNET_WGRAD)


@pytest.mark.parametrize("h,c,s", sorted(cs.RESNET_WGRAD))
def test_wgrad_bound_is_7_4_gflop_per_resnet50_conv(h, c, s):
    ms, by = cs.wgrad_bound(32, h, c, c, 3, s, "float32")
    oh = h // s
    assert by == "operations"
    assert np.isclose(ms, 2 * 32 * oh * oh * c * c * 9 / 67e12 * 1e3)
    assert abs(2 * 32 * oh * oh * c * c * 9 - 7.399e9) < 1e6
    bf_ms, _ = cs.wgrad_bound(32, h, c, c, 3, s, "bfloat16")
    nbytes = 2 * (32 * h * h * c + 32 * oh * oh * c) + 4 * 9 * c * c
    assert np.isclose(bf_ms, max(7.399e9 / 989e12, nbytes / 3.35e12) * 1e3,
                      rtol=1e-3)


def test_resnet_spread_of_f32_against_f64_is_within_the_check():
    """tools/resnet_spread.py on a tiny ResNet: after one batch, f32
    rounding alone stays inside the resnet check's gates."""
    from mxnet_tpu_torch.tools.resnet_spread import spread

    (line,) = spread(dict(TINY_RESNET, check_steps=1))
    assert line["batch"] == 1
    assert line["update_err_worst"] <= cs.RESNET_UPDATE
    assert line["aux_err_worst"] <= cs.RESNET_AUX
    assert line["ce_rel_err"] <= cs.RESNET_CE[0]


def test_lstm_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    launches = cs.phase_lstm(TINY_LSTM, device="cpu")
    per = TINY_LSTM["layers"] * TINY_LSTM["seq"] * TINY_LSTM["batches"]
    assert launches == {"fit": per, "score": per}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "lstm"' in line and '"tokens_per_s"' in line


def test_lstm_phase_fails_when_lstm_step_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="lstm phase launched"):
        cs.phase_lstm(TINY_LSTM, device="cpu")


def test_lstm_phase_launch_arithmetic_is_560_per_pass():
    assert cs.lstm_steps(cs.LSTM_LM, cs.LSTM_LM["batches"]) == 560


@pytest.mark.parametrize("n,h,dtype,want,by", [
    (128, 512, "float32", 4.006e-3, "operations"),
    (128, 512, "bfloat16", 0.939e-3, "bytes"),
    (8, 512, "float32", 1.291e-3, "bytes")])
def test_lstm_step_bound(n, h, dtype, want, by):
    ms, got_by = cs.lstm_step_bound(n, h, dtype)
    assert got_by == by and abs(ms - want) < 1e-6
    flops = 2 * n * 4 * h * h
    item = 4 if dtype == "float32" else 2
    nbytes = item * (4 * n * h + 4 * h * h + 4 * n * h)
    peak = 67e12 if dtype == "float32" else 989e12
    assert np.isclose(ms, max(flops / peak, nbytes / 3.35e12) * 1e3)


def test_lstm_layer_bound_is_the_products_over_f32_peak():
    t, n, i, h = 35, 128, 512, 512
    ms, by = cs.lstm_layer_bound(t, n, i, h)
    assert by == "operations"
    assert np.isclose(ms, 2 * t * n * 4 * h * (i + h) / 67e12 * 1e3)


def test_lstm_spread_of_f32_against_f64_is_within_the_check():
    """tools/lstm_spread.py on the check's own configuration (the
    full-width LSTM LM at batch 8, 2 batches): f32 rounding alone stays
    inside the lstm check's gates after each batch."""
    from mxnet_tpu_torch.tools.lstm_spread import spread

    lines = list(spread(cs.LSTM_LM))
    assert [ln["batch"] for ln in lines] == [1, 2]
    for ln in lines:
        assert ln["update_err_worst"] <= cs.LSTM_UPDATE
        assert ln["perplexity_rel_err"] <= cs.LSTM_PPL


def test_bucketing_phase_on_cpu(monkeypatch, capsys):
    """The whole phase on the host: the check at p = 0, the epoch with its
    checkpoints, the launch arithmetic of the epoch's bucket sequence, the
    resume bit for bit, eval at p = 0.5 equal to p = 0, the mask checks,
    and the fused step with dropout against its eager twin."""
    _count_plain_calls(monkeypatch)
    got = cs.phase_bucketing(TINY_BUCKETING, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["phase"] == "bucketing" and rec["resume"]["bit_for_bit"]
    keys = rec["bucket_sequence"]
    assert got["lstm_step"] == 2 * sum(keys) + rec["launches"]["score"][
        "lstm_step"]
    assert got["sgd_mom_update"] == 4 * len(keys)
    assert got["capture_lstm_step"] == 2 * 5 * 4
    assert rec["dropout_checks"]["eval_equals_p0"]
    assert rec["capture"]["captured_vs_eager"]["bit_for_bit"]
    assert rec["capture"]["path"] == "eager"
    assert set(rec["step_ms_by_bucket"]) <= {"4", "8"}
    assert {"ck-0001.params", "ck-0001.states", "ck-symbol.json",
            "lm-0001.params", "lm-symbol.json"} <= set(
                rec["resume"]["files"])


def test_bucketing_phase_fails_when_lstm_step_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="bucketing phase: launched"):
        cs.phase_bucketing(TINY_BUCKETING, device="cpu")


def test_bucketing_launch_arithmetic_and_corpus():
    """Two lstm_step launches a time step of a bucket (2 layers), and the
    full-size corpus gives an epoch of >= 24 batches with every bucket
    twice or more."""
    from mxnet_tpu_torch.tools import lstm_bucketing as lb

    assert lb.lstm_steps(cs.BUCKETING, (10, 60, 30)) == 200
    it = lb.bucket_iter(cs.BUCKETING, cs.BUCKETING["batch"], cs.SEED + 1)
    keys = [lb.BUCKETING["buckets"][i] for i, _ in it.idx]
    assert len(keys) >= 24
    assert min(keys.count(k) for k in cs.BUCKETING["buckets"]) >= 2
    more = lb.pick_batches(lb.bucket_iter(cs.BUCKETING, 32, cs.SEED + 2),
                           cs.BUCKETING["resume_keys"])
    assert [b.bucket_key for b in more.batches] == [10, 60, 30, 60]


def _count_twin_pushes(monkeypatch):
    """Count each rtc_softmax twin push on the host as a launch of its
    CUDA kernel."""
    twins = rs.twins

    class Counted:
        def __init__(self, kind, twin):
            self.kind, self.twin = kind, twin

        def push(self, ins, outs):
            rs.kernels(ins[0].shape[1])[self.kind].launches += 1
            return self.twin.push(ins, outs)

    monkeypatch.setattr(rs, "twins", lambda: {k: Counted(k, v)
                                              for k, v in twins().items()})


def test_custom_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    _count_twin_pushes(monkeypatch)
    launches = cs.phase_custom(TINY_LSTM, device="cpu")
    b = TINY_LSTM["batches"]
    per = TINY_LSTM["layers"] * TINY_LSTM["seq"] * b
    assert launches == {"fit": {"fwd": b, "bwd": b, "lstm_step": per},
                        "score": {"fwd": b, "bwd": 0, "lstm_step": per}}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "custom"' in line and '"check_vs_softmax_output"' in line


def test_custom_phase_fails_when_the_rtc_kernels_are_not_reached(
        monkeypatch):
    """Only lstm_step is counted here: the phase must refuse."""
    _count_plain_calls(monkeypatch)
    with pytest.raises(RuntimeError, match="custom phase launched"):
        cs.phase_custom(TINY_LSTM, device="cpu")


def test_custom_phase_check_refuses_a_wrong_head(monkeypatch):
    """A head whose gradient is off (p - 0.9 onehot) fails check (b)
    against SoftmaxOutput."""
    _count_plain_calls(monkeypatch)
    _count_twin_pushes(monkeypatch)
    monkeypatch.setattr(rs, "BWD_TWIN", rs.BWD_TWIN.replace("1.0", "0.9"))
    with pytest.raises(RuntimeError, match="custom check"):
        cs.phase_custom(TINY_LSTM, device="cpu")


def test_rtc_softmax_bound_is_0_107_ms_at_the_lms_head():
    ms, by = cs.rtc_softmax_bound(128 * 35, 10000)
    assert by == "bytes" and abs(ms - 0.10699) < 1e-5
    assert np.isclose(ms, 358.4e6 / 3.35e12 * 1e3)
    assert cs.RTC_SOFTMAX_CASES[0] == (128 * 35, 10000)


@pytest.mark.parametrize("name", sorted(cs.RTC_ELEMENTWISE))
def test_rtc_test_kernels_wrap_their_bodies(name):
    ins, body, twin, dtype = cs.RTC_ELEMENTWISE[name]
    src = cs.rtc_elementwise_src(body, 128)
    assert "const int N = 128;" in src and body in src
    assert "def fn(" in twin and dtype in cs.RTC_TOL


# --- the flash forward's build and SASS report --------------------------------
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12rt20flash_fwd_f32_kernelILi128EEEvPKfS3_S3_PfS4_iiiilllllllllfi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_12rt20flash_fwd_f32_kernelILi128EEEvPKfS3_S3_PfS4_iiiilllllllllfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, used 1 barriers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_12wg22flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16Pfiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_12wg22flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16Pfiiiifi
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, 16 bytes smem, 400 bytes cmem[0]
"""
SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_12wg22flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16Pfiiiifi
        /*0100*/                   UTMALDG.4D [UR8], [UR4] ;
        /*0110*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0120*/                   HGMMA.64x64x16.F32.BF16 R88, R152, gdesc[UR8], R88 ;
\t\tFunction : _ZN12_GLOBAL__N_12rt20flash_fwd_f32_kernelILi64EEEvPKfS3_S3_PfS4_iiiilllllllllfi
        /*0100*/                   FFMA R1, R2, R3, R1 ;
\t\tFunction : _Z5otherv
        /*0100*/                   HGMMA.64x64x16.F32.BF16 R8, gdesc[UR4], RZ ;
"""


def test_ptxas_report_reads_each_instantiation():
    got = cs.ptxas_report(PTXAS_LOG, tuple(cs.FA_KERNELS))
    assert got == {
        "flash_fwd_f32_kernel<128>": {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 200, "smem_static": 0},
        "flash_fwd_wgmma_kernel<64>": {
            "stack": 8, "spill_stores": 4, "spill_loads": 12,
            "registers": 168, "smem_static": 16}}


def test_sass_counts_wgmma_and_tma_loads_per_instantiation():
    got = cs.sass_opcode_counts(SASS, tuple(cs.FA_KERNELS),
                                cs.FA_BF16_OPCODES)
    assert got == {"flash_fwd_wgmma_kernel<64>": {"HGMMA": 2, "UTMALDG": 1},
                   "flash_fwd_f32_kernel<64>": {"HGMMA": 0, "UTMALDG": 0}}


def test_flash_cases_cover_the_forward_tile_edges():
    """Both types get lengths 1, 63, 65, 129 and 2047, a ragged causal
    tq < tk, D = 64 off a multiple of 128, B * H = 64 and a padded-row
    layout, beside every earlier case."""
    cases = cs.flash_cases()
    for dtype in ("float32", "bfloat16"):
        mine = [c for c in cases if c[7] == dtype]
        lengths = {c[3] for c in mine if c[3] == c[4]}
        assert {1, 63, 65, 129, 2047, 128, 512, 1000, 2048} <= lengths
        assert any(c[6] and c[3] < c[4] and c[3] % 128 and c[4] % 128
                   for c in mine)
        assert any(c[5] == 64 and c[3] % 128 for c in mine)
        assert any(c[0] * c[1] == 64 for c in mine)
        assert any(c[8] == "padded" for c in mine)
        assert (4, 16, 4, 2048, 2048, 128, True, dtype, False) in mine
    assert set(c[8] for c in cases) <= set(cs.LAYOUTS)


def test_generate_profile_attributes_both_forward_kernels():
    """The prefill profile counts each forward instantiation's device time
    as flash_attention_fwd (mangled names as the profiler shows them)."""
    from mxnet_tpu_torch.tools import profile_generate as pg

    names = re.findall(r"Compiling entry function '(\w+)'", PTXAS_LOG)
    assert len(names) == 2
    for name in names:
        assert pg._kind(name) == "flash_attention_fwd"
    assert pg._kind("void cutlass::Kernel2<cutlass_80_gemm>") == "matmul"


# --- the flash backward's build report and timing row -------------------------
BWD_MANGLED = {
    "flash_bwd_dq_wgmma_kernel": "_ZN12_GLOBAL__N_12wg25flash_bwd_dq_wgmma_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_P13__nv_bfloat16iiiifi",
    "flash_bwd_dkv_wgmma_kernel": "_ZN12_GLOBAL__N_12wg26flash_bwd_dkv_wgmma_kernelILi128EEEv14CUtensorMap_stS2_S2_S2_PKfS4_P13__nv_bfloat16S6_iiiifi",
    "flash_bwd_dq_f32_kernel": "_ZN12_GLOBAL__N_12rt23flash_bwd_dq_f32_kernelILi128EEEvPKfS3_S3_S3_S3_S3_Pfiiiillllllllllllfi",
    "flash_bwd_dkv_f32_kernel": "_ZN12_GLOBAL__N_12rt24flash_bwd_dkv_f32_kernelILi128EEEvPKfS3_S3_S3_S3_S3_PfS4_iiiillllllllllllfi",
}


def _bwd_log(spill_f32=0, serialized=False):
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, mangled in BWD_MANGLED.items():
        lines += [
            "ptxas info    : Compiling entry function '%s' for 'sm_90a'"
            % mangled,
            "ptxas info    : Function properties for %s" % mangled,
            "    0 bytes stack frame, %d bytes spill stores, %d bytes spill "
            "loads" % ((spill_f32,) * 2 if "f32" in name else (0, 0)),
            "ptxas info    : Used 200 registers, used 1 barriers"]
        if serialized and "wgmma" in name:
            lines.append(
                "ptxas info    : (C7515) Potential Performance Loss: "
                "wgmma.mma_async instructions are serialized due to the "
                "presence of Extern calls in the function '%s'" % mangled)
    return "\n".join(lines)


def _bwd_sass(wgmma=True):
    out = {}
    for name, dtype in cs.FA_BWD_KERNELS.items():
        for d in (64, 128):
            ops = {"HGMMA": 4 if wgmma and dtype == "bfloat16" else 0,
                   "UTMALDG": 2 if dtype == "bfloat16" else 0}
            out["%s<%d>" % (name, d)] = ops
    return out


def _bwd_report(log, sass):
    return cs.instantiation_report(log, sass, cs.FA_BWD_KERNELS, (128,),
                                   lambda name, dtype, d: 1000)


def test_bwd_report_reads_every_instantiation_and_serialization_notes():
    report = _bwd_report(_bwd_log(serialized=True), _bwd_sass())
    assert set(report) == {"%s<128>" % n for n in cs.FA_BWD_KERNELS}
    for label, row in report.items():
        assert row["registers"] == 200 and row["smem_dynamic"] == 1000
        assert row["wgmma_serialized"] == (1 if "wgmma" in label else 0)
    clean = _bwd_report(_bwd_log(), _bwd_sass())
    assert all(r["wgmma_serialized"] == 0 for r in clean.values())


@pytest.mark.parametrize("fault,match", [("no_wgmma", "lacks"),
                                         ("f32_spill", "spills"),
                                         ("missing", "no ptxas report")])
def test_bwd_report_fails_without_wgmma_with_f32_spills_or_a_missing_kernel(
        fault, match):
    log, sass = _bwd_log(), _bwd_sass()
    if fault == "no_wgmma":
        sass = _bwd_sass(wgmma=False)
    elif fault == "f32_spill":
        log = _bwd_log(spill_f32=8)
    else:
        log = "\n".join(ln for ln in log.splitlines()
                        if "dkv_f32" not in ln)
    with pytest.raises(RuntimeError, match=match):
        _bwd_report(log, sass)


def test_generate_profile_attributes_the_backward_kernels():
    """profile_train's breakdown counts each backward instantiation's device
    time as flash_attention_bwd, not as other."""
    from mxnet_tpu_torch.tools import profile_generate as pg

    assert set(cs.FA_BWD_KERNELS) <= set(pg.KERNELS)
    for mangled in BWD_MANGLED.values():
        assert pg._kind(mangled) == "flash_attention_bwd"


@pytest.mark.parametrize("dtype,factor", [("float32", 1.4),
                                          ("bfloat16", 2.0)])
def test_attention_bwd_work_is_14_or_20_d_per_pair(dtype, factor):
    args = (4, 16, 4, 2048, 2048, 128, True, dtype)
    bound, by = cs.attention_bwd_bound(*args)
    work, _ = cs.attention_bwd_bound(*args, cs.FA_BWD_WORK[dtype])
    assert by == "operations" and np.isclose(work, factor * bound)


def test_bwd_timing_row_has_device_times_beside_the_bound(monkeypatch):
    """The backward phase's timing row on the host: fake timers stand in
    for the card's clocks; every field chip_smoke.py's kernels line reads
    is there, the kernel pair's device time split by kernel."""
    import torch

    def single(torch_, fn, reps=30, warmup=3):
        fn()
        return 2.0

    def device(torch_, fn, reps=20, warmup=3):
        fn()
        return 1.0

    def device_by(torch_, fn, by, reps=20, warmup=3):
        fn()
        return 1.5, {k: 0.75 for k in by}

    q, k, v = (torch.randn(1, 2, 8, 64) for _ in range(3))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    row = cs.bwd_timing(
        torch, (1, 2, 2, 8, 64, True), "float32",
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, o, True),
        lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, o, True),
        lambda: None, timers=(single, device, device_by))
    assert row["device_ms"] == 1.5 and row["library_device_ms"] == 1.0
    assert row["device_ms_by_kernel"] == {"dq": 0.75, "dkv": 0.75}
    assert row["ms"] == row["plain_ms"] == row["library_ms"] == 2.0
    assert row["work"]["flops_per_pair"] == {"bound": 640, "kernels": 896}
    assert np.isclose(row["work"]["ms"], 1.4 * row["bound_ms"]) or \
        row["bound_by"] == "bytes"


def test_bwd_spread_tool_follows_chip_smoke_gate_and_shapes():
    from mxnet_tpu_torch.tools import flash_bwd_spread as fbs

    assert fbs.GATE == {k: tuple(v) for k, v in
                        cs.BWD_TOL["bfloat16"].items()}
    want = {c[:7] for c in cs.flash_cases() if c[7] == "bfloat16"}
    assert set(fbs.SHAPES) == want


# conv_wgrad's templated partial kernels as ptxas and cuobjdump name them
WGRAD_MANGLED = {
    "conv_wgrad_wgmma_kernel": "_ZN46_GLOBAL__N__9293b8d0_13_conv_wgrad_cu_a131c0472wg23conv_wgrad_wgmma_kernelILi%dEEEvNS0_4MapsEPfNS0_4GeomE",
    "conv_wgrad_f32_kernel": "_ZN46_GLOBAL__N__9293b8d0_13_conv_wgrad_cu_a131c0472rt21conv_wgrad_f32_kernelILi%dEEEvPKfS3_PfNS0_4GeomE",
    "conv_wgrad_f32tap_kernel": "_ZN46_GLOBAL__N__9293b8d0_13_conv_wgrad_cu_a131c0472rt24conv_wgrad_f32tap_kernelILi%dEEEvPKfS3_PfNS0_4GeomE",
}


def _wgrad_log(spill_f32=0):
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, mangled in WGRAD_MANGLED.items():
        for bn in cw.BLOCK_COLS:
            m = mangled % bn
            lines += [
                "ptxas info    : Compiling entry function '%s' for 'sm_90a'"
                % m, "ptxas info    : Function properties for %s" % m,
                "    0 bytes stack frame, %d bytes spill stores, %d bytes "
                "spill loads" % ((spill_f32,) * 2 if "f32" in name
                                 else (0, 0)),
                "ptxas info    : Used %d registers, used 1 barriers"
                % (bn + 26)]
    return "\n".join(lines)


def _wgrad_sass(text=None, wgmma=True):
    """cuobjdump's text of the partial kernels: HGMMA and UTMALDG in the
    wgmma kernel's instantiations (HGMMA left out when not ``wgmma``)."""
    lines = []
    for name, mangled in WGRAD_MANGLED.items():
        for bn in cw.BLOCK_COLS:
            lines.append("\t\tFunction : %s" % (mangled % bn))
            lines.append("        /*0010*/  LDGSTS [R1], [R2.64] ;")
            if "wgmma" in name:
                lines.append("        /*0020*/  UTMALDG.4D [UR8], [UR4] ;")
                if wgmma:
                    lines.append("        /*0030*/  HGMMA.64x128x16.F32.BF16 "
                                 "R24, gdesc[UR8], R24 ;")
    sass = "\n".join(lines)
    return cs.sass_opcode_counts(sass, tuple(cs.WGRAD_KERNELS),
                                 cs.FA_BF16_OPCODES)


def _wgrad_report(log, sass):
    return cs.instantiation_report(log, sass, cs.WGRAD_KERNELS,
                                   cw.BLOCK_COLS,
                                   lambda name, dtype, bn: 100 * bn)


def _resnet_plans():
    return [(case, cw.plan(n, h, h, c, k, ksz, s, 1, dtype))
            for case in cs.wgrad_cases()
            for n, h, c, k, ksz, s, dtype in [case] if n == 32]


def test_wgrad_report_reads_every_instantiation():
    report = _wgrad_report(_wgrad_log(), _wgrad_sass())
    assert set(report) == {"%s<%d>" % (n, bn) for n in cs.WGRAD_KERNELS
                           for bn in cw.BLOCK_COLS}
    for label, row in report.items():
        bn = int(label.split("<")[1][:-1])
        assert row["registers"] == bn + 26 and row["smem_dynamic"] == 100 * bn
        assert row["sass"]["HGMMA"] == (1 if "wgmma" in label else 0)
        assert row["sass"]["UTMALDG"] == (1 if "wgmma" in label else 0)


@pytest.mark.parametrize("fault,match", [("no_wgmma", "lacks"),
                                         ("f32_spill", "spills")])
def test_wgrad_report_fails_without_hgmma_or_with_f32_spills(fault, match):
    log, sass = _wgrad_log(), _wgrad_sass()
    if fault == "no_wgmma":
        sass = _wgrad_sass(wgmma=False)
    else:
        log = _wgrad_log(spill_f32=4)
    with pytest.raises(RuntimeError, match=match):
        _wgrad_report(log, sass)


def test_wgrad_routes_of_the_resnet_shapes():
    """Each ResNet-50 shape runs the wgmma kernel (bf16) or an f32 kernel,
    into an instantiation the report holds; the check fails when the bf16
    instantiation a shape launches lacks HGMMA, or a bf16 shape would take
    the simt body."""
    report = _wgrad_report(_wgrad_log(), _wgrad_sass())
    plans = _resnet_plans()
    routes = cs.wgrad_route_check(plans, report)
    assert len(routes) == 14
    for (case, p), label in zip(plans, routes.values()):
        n, h, c, k, ksz, s, dtype = case
        if dtype == "bfloat16":
            assert label == "conv_wgrad_wgmma_kernel<%d>" % p.bn
        else:
            assert label == "conv_wgrad_%s_kernel<%d>" % (
                "f32tap" if c % cw.TILE_M == 0 else "f32", p.bn)
    bare = dict(report)
    for bn in cw.BLOCK_COLS:
        label = "conv_wgrad_wgmma_kernel<%d>" % bn
        bare[label] = dict(report[label], sass={"HGMMA": 0, "UTMALDG": 1})
    with pytest.raises(RuntimeError, match="lacks"):
        cs.wgrad_route_check(plans, bare)
    case, p = next((c, p) for c, p in plans if c[-1] == "bfloat16")
    with pytest.raises(RuntimeError, match="simt route"):
        cs.wgrad_route_check([(case, p._replace(route="simt"))], report)


def test_resnet_phase_launch_arithmetic():
    """One partial and one reduce launch for each 3x3 convolution of a
    step, whatever the route, and in bf16 on the card two repacks (x and
    dy): ResNet-50's 16 over the phase's 8 batches, the tiny ResNet-18's 17
    over 2 on the CPU (no repack)."""
    assert cs.resnet_wgrad_launches(16, cs.RESNET["batches"], True) == {
        "conv_wgrad_partial": 128, "conv_wgrad_reduce": 128,
        "conv_wgrad_repack": 256}
    assert cs.resnet_wgrad_launches(17, TINY_RESNET["batches"]) == {
        "conv_wgrad_partial": 34, "conv_wgrad_reduce": 34,
        "conv_wgrad_repack": 0}
    assert all(p.route == "f32" for c, p in _resnet_plans()
               if c[-1] == "float32")


def test_wgrad_timing_row_and_step_sums():
    """The wgrad phase's timing row on the host with fake timers: the
    device time split into the partial kernel, the reduce, the two
    repacks and the rest, and a step's sums weight each shape by its
    count."""
    import torch

    def single(torch_, fn, reps=30, warmup=3):
        return 2.0

    def device(torch_, fn, reps=20, warmup=3):
        return 1.0

    seen = []

    def device_by(torch_, fn, by, reps=20, warmup=3, calls=None):
        seen.append(dict(by))
        assert calls == {by["partial"]: 1, "conv_wgrad_reduce": 1,
                         "conv_wgrad_repack": 2}
        return 1.5, {"partial": 1.0, "reduce": 0.25, "repack": 0.125}

    rows = []
    for case, p in _resnet_plans():
        if case[-1] != "bfloat16":
            continue
        rows.append(cs.wgrad_timing(torch, case, p, None, None, None,
                                    timers=(single, device, device_by)))
    assert all(b == {"partial": "conv_wgrad_wgmma_kernel",
                     "reduce": "conv_wgrad_reduce",
                     "repack": "conv_wgrad_repack"} for b in seen)
    row = rows[0]
    assert row["device_ms_by_kernel"] == {"partial": 1.0, "reduce": 0.25,
                                          "repack": 0.125, "other": 0.125}
    assert row["route"] == "wgmma" and row["kernel"] == cw.WGMMA
    assert row["ms"] == row["plain_ms"] == row["library_ms"] == 2.0
    step = cs.wgrad_step(rows)
    assert step["device_ms"] == 1.5 * 16 and step["ms"] == 2.0 * 16
    assert step["device_ms_by_kernel"]["repack"] == 0.125 * 16
    assert np.isclose(step["bound_ms"],
                      sum(r["bound_ms"] * r["per_step"] for r in rows))


# --- lstm_step: instantiation report, routes, timing rows ----------------------
LSTM_MANGLED = {
    "lstm_f32_kernel": "_ZN46_GLOBAL__N__1c2d3e4f_12_lstm_step_cu_0a1b2c3d2rt"
                       "15lstm_f32_kernelILi%sEEEvNS_4ArgsE",
    "lstm_wgmma_kernel": "_ZN46_GLOBAL__N__1c2d3e4f_12_lstm_step_cu_0a1b2c3d2"
                         "wg17lstm_wgmma_kernelILi%sEEEvNS0_4MapsENS_4ArgsE",
    "lstm_simt_kernel": "_ZN46_GLOBAL__N__1c2d3e4f_12_lstm_step_cu_0a1b2c3d4"
                        "simt16lstm_simt_kernelILi%sELi%sEEEvNS_4ArgsE"}


def _lstm_instantiations():
    """(name, template arguments) of every lstm_step kernel the source
    builds."""
    out = [(name, (t,)) for name, (_, tiles) in cs.LSTM_KERNELS.items()
           for t in tiles]
    return out + [(cs.LSTM_SIMT, tile) for tile in kl.TILES]


def _lstm_log(spill_f32=0, serialized=False):
    lines = ["ptxas info    : 0 bytes gmem"]
    for name, args in _lstm_instantiations():
        m = LSTM_MANGLED[name] % args
        lines += [
            "ptxas info    : Compiling entry function '%s' for 'sm_90a'" % m,
            "ptxas info    : Function properties for %s" % m,
            "    0 bytes stack frame, %d bytes spill stores, %d bytes spill "
            "loads" % ((spill_f32,) * 2 if "f32" in name else (0, 0)),
            "ptxas info    : Used %d registers, 41472 bytes smem"
            % (60 + args[0])]
        if serialized and "wgmma" in name:
            lines.append("ptxas info    : (C7515) Potential Performance Loss:"
                         " wgmma.mma_async instructions are serialized due "
                         "to ... in the function '%s'" % m)
    return "\n".join(lines)


def _lstm_sass(wgmma=True, tma=True):
    lines = []
    for name, args in _lstm_instantiations():
        lines.append("\t\tFunction : %s" % (LSTM_MANGLED[name] % args))
        lines.append("        /*0010*/  LDGSTS.E.BYPASS.128 [R1], [R2.64] ;")
        if "wgmma" in name:
            if tma:
                lines.append("        /*0020*/  UTMALDG.4D [UR8], [UR4] ;")
            if wgmma:
                lines.append("        /*0030*/  HGMMA.64x32x16.F32.BF16 R24,"
                             " gdesc[UR8], R24 ;")
    return cs.sass_opcode_counts(
        "\n".join(lines), tuple(cs.LSTM_KERNELS) + (cs.LSTM_SIMT,),
        cs.FA_BF16_OPCODES)


def _lstm_report(log=None, sass=None):
    return cs.lstm_instantiations(
        _lstm_log() if log is None else log,
        _lstm_sass() if sass is None else sass,
        lambda name, dtype, tile: 0 if dtype == "float32" else 50240)


def test_kernel_label_reads_every_int_template_argument():
    names = (cs.LSTM_SIMT, "lstm_f32_kernel")
    assert cs.kernel_label(LSTM_MANGLED[cs.LSTM_SIMT] % (2, 4), names) == \
        "lstm_simt_kernel<2,4>"
    assert cs.kernel_label(LSTM_MANGLED["lstm_f32_kernel"] % 64, names) == \
        "lstm_f32_kernel<64>"
    assert cs.kernel_label("_Z5otherv", names) is None


def test_lstm_report_reads_every_instantiation():
    report = _lstm_report()
    assert set(report) == {
        "lstm_f32_kernel<64>", "lstm_f32_kernel<16>", "lstm_wgmma_kernel<8>",
        "lstm_simt_kernel<4,4>", "lstm_simt_kernel<2,4>",
        "lstm_simt_kernel<1,4>", "lstm_simt_kernel<1,2>",
        "lstm_simt_kernel<1,1>"}
    assert report["lstm_wgmma_kernel<8>"]["sass"] == {"HGMMA": 1,
                                                      "UTMALDG": 1}
    assert report["lstm_wgmma_kernel<8>"]["smem_dynamic"] == 50240
    assert report["lstm_f32_kernel<64>"]["registers"] == 124
    assert report["lstm_simt_kernel<2,4>"]["dtype"] == "bfloat16"


@pytest.mark.parametrize("fault,match", [("no_wgmma", "lacks"),
                                         ("no_tma", "lacks"),
                                         ("f32_spill", "spills")])
def test_lstm_report_fails_without_hgmma_or_tma_or_with_f32_spills(fault,
                                                                   match):
    log, sass = None, None
    if fault == "f32_spill":
        log = _lstm_log(spill_f32=8)
    else:
        sass = _lstm_sass(wgmma=fault != "no_wgmma", tma=fault != "no_tma")
    with pytest.raises(RuntimeError, match=match):
        _lstm_report(log, sass)


def _lstm_plans():
    """Plans of every lstm kernel-phase case as chip_smoke lays it out:
    the odd blob offset (3 elements) with broadcast or contiguous state,
    and the scan's layout (rows of the output, Wh at 4H*H)."""
    plans = []
    for dtype in ("float32", "bfloat16"):
        item = 4 if dtype == "float32" else 2
        for n, h in cs.LSTM_CASES:
            for layout in cs.LSTM_LAYOUTS:
                h_stride = {"views": (1, 0)}.get(layout, (h, 1))
                wh_ptr = 0 if layout == "scan" else (3 * item) % 16
                plans.append(((n, h), dtype, layout, kl.plan(
                    n, h, dtype, h_stride, (h, 1), 0, wh_ptr)))
    return plans


def test_lstm_routes_of_the_main_path():
    """The scan's (128, 512) and (8, 512) take the f32 tile body with
    16-byte copies and, in bf16, the wgmma body with HGMMA; every f32 case
    takes the f32 body; the check fails on a wrong route, 4-byte copies,
    a missing HGMMA or a serialized wgmma."""
    report = _lstm_report()
    plans = _lstm_plans()
    routes = cs.lstm_route_check(plans, report)
    assert len(routes) == 2 * len(cs.LSTM_CASES) * len(cs.LSTM_LAYOUTS)
    for n, h in cs.LSTM_MAIN:
        assert routes["float32/%s/scan" % [n, h]] == "lstm_f32_kernel<%d>" \
            % (64 if n > 32 else 16)
        assert routes["bfloat16/%s/scan" % [n, h]] == "lstm_wgmma_kernel<8>"
    assert all(label.startswith("lstm_f32_kernel")
               for key, label in routes.items() if key.startswith("float32"))
    assert routes["bfloat16/[128, 512]/views"] == "lstm_simt_kernel<2,4>"
    main = [c for c in plans if c[0] == (128, 512) and c[2] == "scan"]
    f32, bf16 = sorted(main, key=lambda c: c[1] != "float32")
    with pytest.raises(RuntimeError, match="4 bytes"):
        cs.lstm_route_check([f32[:3] + (f32[3]._replace(vec_w=False),)],
                            report)
    with pytest.raises(RuntimeError, match="simt route"):
        cs.lstm_route_check([bf16[:3] + (bf16[3]._replace(
            route="simt"),)], report)
    bare = dict(report)
    bare["lstm_wgmma_kernel<8>"] = dict(report["lstm_wgmma_kernel<8>"],
                                        sass={"HGMMA": 0, "UTMALDG": 1})
    with pytest.raises(RuntimeError, match="lacks"):
        cs.lstm_route_check([bf16], bare)
    serial = _lstm_report(log=_lstm_log(serialized=True))
    assert serial["lstm_wgmma_kernel<8>"]["wgmma_serialized"] == 1
    with pytest.raises(RuntimeError, match="serializes"):
        cs.lstm_route_check([bf16], serial)


def test_lstm_timing_row_has_replay_device_and_event_times():
    import torch

    seen = []

    def replay(torch_, fn, calls=35, reps=20):
        seen.append(fn)
        return 0.01

    def device(torch_, fn, reps=20, warmup=3):
        return 0.008

    def single(torch_, fn, reps=30, warmup=3):
        return 0.05

    p = kl.plan(128, 512, "float32", (512, 1), (512, 1))
    fns = (("ms", "k"), ("plain_ms", "p"), ("library_ms", "l"))
    row = cs.lstm_timing(torch, 128, 512, "float32", p, fns,
                         timers=(replay, device, single))
    assert seen == ["k", "p", "l"]
    assert row["ms"] == row["plain_ms"] == row["library_ms"] == 0.01
    assert row["device_ms"] == {"ms": 0.008, "plain_ms": 0.008,
                                "library_ms": 0.008}
    assert row["event_ms"]["ms"] == 0.05
    assert (row["route"], row["kernel"]) == ("f32", "lstm_f32_kernel<64>")
    assert (row["bound_ms"], row["bound_by"]) == cs.lstm_step_bound(
        128, 512, "float32")


def test_rtc_bwd_routes_and_timing_row():
    import torch

    vec = rs.bwd_plan(10000, 0, 0)
    assert cs.rtc_bwd_route_check(4480, 10000, vec) is vec
    with pytest.raises(RuntimeError, match="scalar route, want vector"):
        cs.rtc_bwd_route_check(4480, 10000, rs.bwd_plan(10000, 4, 0))
    with pytest.raises(RuntimeError, match="vector route, want scalar"):
        cs.rtc_bwd_route_check(3, 7, vec)
    assert cs.rtc_bwd_route_check(128, 1000, vec) is vec  # no route named

    def loop(torch_, fn, calls=20, reps=10, warmup=2):
        return {"k": 0.12, "s": 0.16}[fn]

    def device(torch_, fn, reps=20, warmup=3):
        return {"k": 0.115, "s": 0.155}[fn]

    row = cs.rtc_timing(torch, 4480, 10000, (("ms", "k"), ("scalar_ms", "s")),
                        timers=(loop, device))
    assert (row["ms"], row["scalar_ms"]) == (0.12, 0.16)
    assert row["device_ms"] == {"ms": 0.115, "scalar_ms": 0.155}
    assert row["bound_by"] == "bytes" and abs(row["bound_ms"] - 0.10699) \
        < 1e-5


def test_memory_holders_names_the_largest_blocks_and_tensors():
    """memory_holders on the host with a stand-in for torch.cuda: the
    active blocks largest first, and a tensor that claims to lie on the
    card grouped by shape and type with the object holding it."""
    import types

    import torch

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    class Holder:
        pass

    holder = Holder()
    holder.weight = torch.Tensor._make_subclass(OnCard, torch.zeros(1000))
    fake = types.SimpleNamespace(Tensor=torch.Tensor, cuda=types.SimpleNamespace(
        memory_snapshot=lambda: [{"blocks": [
            {"size": 4096, "state": "active_allocated"},
            {"size": 8192, "state": "inactive"},
            {"size": 512, "state": "active_allocated"}]}],
        memory_allocated=lambda: 4608))
    got = cs.memory_holders(fake)
    assert got["allocated"] == 4608 and got["largest_blocks"] == [4096, 512]
    (row,) = [t for t in got["largest_tensors"]
              if t["tensor"] == "(1000,) float32"]
    assert row["bytes"] == 4000 and row["count"] == 1
    assert any("Holder" in r for r in row["referrers"])
    assert got["untracked_bytes"] == 4608 - got["live_cuda_tensor_bytes"]
    # read-only: a second call sees the same card
    assert cs.memory_holders(fake)["allocated"] == 4608


def test_lstm_variants_edit_the_current_source(monkeypatch):
    """tools/lstm_variants.py: every variant's edits still find their text
    exactly once in the kernel source, each edited variant differs from
    it, and its shapes and tolerances are chip_smoke.py's."""
    import os

    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.tools import lstm_variants as lv

    with open(os.path.join(_build.CSRC, "lstm_step.cu")) as f:
        source = f.read()
    for name, edits in {**lv.VARIANTS, **lv.ABLATIONS}.items():
        assert (lv.variant_source(name) == source) == (not edits), name
    assert not set(lv.VARIANTS) & set(lv.ABLATIONS)
    # one definition of the main-path shapes and the gate, chip_smoke's too
    assert lv.STEP_SHAPES is cs.LSTM_MAIN and lv.STEP_TOL is cs.LSTM_TOL
    assert cs.LSTM_MAIN == ((128, 512), (8, 512))
    assert cs.LSTM_TOL == {"float32": (2e-5, 1e-5), "bfloat16": (1e-5, 1e-2)}
    log = ("ptxas info    : Function properties for _ZN45_GLOBAL__N__0_12_"
           "lstm_step_cu_c2rt15lstm_f32_kernelILi64EEEvNS_4ArgsE\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 114 registers, used 1 barriers\n")
    assert lv.ptxas_lines(log) == {"lstm_f32_kernel<64>": (
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads; "
        "Used 114 registers, used 1 barriers")}
    monkeypatch.setitem(lv.VARIANTS, "gone", [("no such text", "")])
    with pytest.raises(ValueError, match="occurs 0 times"):
        lv.variant_source("gone")


def test_lstm_variants_build_beside_the_headers(monkeypatch, tmp_path):
    """Each variant's directory holds its edited source and the csrc
    headers it includes (a compiler that does nothing stands in for
    nvcc)."""
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.tools import lstm_variants as lv

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc", lambda: "true")
    libs = lv.build(["this", "wgmma_ring8"])
    for name, (lib, ptxas) in libs.items():
        d = tmp_path / "variants" / "lstm_step" / name
        assert lib == str(d / "lstm_step.so") and ptxas == {}
        assert (d / "hopper.cuh").exists()
        assert (d / "lstm_step.cu").read_text() == lv.variant_source(name)


def test_variants_forget_drops_only_that_kernels_entries(monkeypatch):
    """tools/_variants.forget: the kernel's library and its C entries leave
    the wrappers' caches; another kernel's stay."""
    from mxnet_tpu_torch.ops.kernels import _build
    from mxnet_tpu_torch.tools import _variants

    monkeypatch.setattr(_build, "_libs", {"lstm_step": 1, "conv_wgrad": 2})
    monkeypatch.setattr(_build, "_fns", {"mxtt_lstm_step_f32": 1,
                                         "mxtt_lstm_step_bf16": 2,
                                         "mxtt_conv_wgrad_f32": 3})
    _variants.forget("lstm_step")
    assert _build._libs == {"conv_wgrad": 2}
    assert _build._fns == {"mxtt_conv_wgrad_f32": 3}


def test_train_phase_holds_bf16_and_the_eager_twin(monkeypatch, capsys):
    """The train phase's line on the host: the bf16 fused check (card and
    CPU both the host here: equal) and the eager twin of the run (equal
    bit for bit), with the step counts of both steps."""
    import json

    _count_plain_calls(monkeypatch)
    cs.phase_train(TINY, TINY_TRAIN, device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["dtype"] == "bfloat16"
    assert line["check_bf16"]["loss_abs_err"] == 0.0
    assert line["check_bf16"]["cpu_bf16_to_f32_param"] > 0.0
    # the f32 control lies the whole bf16-to-f32 distance away: it fails
    control = line["check_bf16"]["f32_control"]
    assert control["loss_x_spread"] == 1.0 and not control["passes"]
    steps = TINY_TRAIN["sgd_steps"] + TINY_TRAIN["adam_steps"]
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert line["launches_by_type"][k] == {
            "bfloat16": TINY["layers"] * steps}
    assert line["captured_vs_eager"]["bit_for_bit"]
    assert line["steps"]["sgd"]["eager_calls"] == TINY_TRAIN["sgd_steps"]
    assert line["steps"]["adam"]["eager_calls"] == (
        TINY_TRAIN["adam_steps"] + TINY_TRAIN["timed_steps"])


def test_require_types_refuses_another_type():
    """A main path that launched a kernel's f32 instantiation where the
    phase runs bf16 (a quiet upcast) fails; so does a launch no type
    counted."""
    names = ["flash_attention_fwd"]
    launches = {"flash_attention_fwd": 8}
    cs._require_types("train", {"flash_attention_fwd": {"bfloat16": 8}},
                      launches, "bfloat16", names)
    for types in ({"flash_attention_fwd": {"bfloat16": 4, "float32": 4}},
                  {"flash_attention_fwd": {"float32": 8}}, {}):
        with pytest.raises(RuntimeError, match="launched by type"):
            cs._require_types("train", types, launches, "bfloat16", names)
    cs._require_types("train", {}, {"flash_attention_fwd": 0}, "bfloat16",
                      names)


def test_bf16_check_fails_when_the_control_passes(monkeypatch):
    """If the card's f32 step also lay within the loss gate, the gate could
    not tell bf16 from f32: the check refuses. Here the "card" runs the
    control in bf16 too, so the control reads 0x."""
    real = cs.lm_train_executor

    def always_bf16(cfg, b, t, dev, dtype=None):
        return real(cfg, b, t, dev, "bfloat16")

    _count_plain_calls(monkeypatch)
    monkeypatch.setattr(cs, "lm_train_executor", always_bf16)
    with pytest.raises(RuntimeError, match="control passes the gate"):
        cs.phase_train(TINY, TINY_TRAIN, device="cpu")


def test_captured_path_is_required_on_the_card():
    eager = {"path": "eager", "warmup_calls": 0, "captures": 0,
             "replays": 0, "eager_calls": 8}
    cs._require_captured("resnet", [eager], on_card=False)
    with pytest.raises(RuntimeError, match="did not take the captured"):
        cs._require_captured("resnet", [eager], on_card=True)
    with pytest.raises(RuntimeError, match="did not take the captured"):
        cs._require_captured("resnet", [{"path": "unfused",
                                         "reason": "a kvstore"}], True)
    cs._require_captured("resnet", [dict(eager, path="captured",
                                         captures=1, replays=6)], True)


def test_eager_twin_refuses_other_parameters(monkeypatch):
    """The eager twin of a captured run must land on its parameters bit
    for bit: one last-bit change fails it."""
    from mxnet_tpu_torch.tools.lstm_lm import lstm_setup

    _count_plain_calls(monkeypatch)

    def setup():
        return lstm_setup(TINY_LSTM, 2, 2, "cpu")

    mod, it, init = setup()
    mod.fit(it, **cs.lstm_fit_args(TINY_LSTM, init))
    state = cs._host_state(mod)
    rec = cs._eager_twin(None, setup, lambda i: cs.lstm_fit_args(
        TINY_LSTM, i), False, state, "lstm")
    assert rec["path"] == "eager" and len(rec["step_ms"]) == 1
    name = sorted(state[0])[0]
    state[0][name] = np.nextafter(state[0][name], np.float32(np.inf))
    with pytest.raises(RuntimeError, match="captured steps land"):
        cs._eager_twin(None, setup, lambda i: cs.lstm_fit_args(
            TINY_LSTM, i), False, state, "lstm")


def test_steady_step_time_skips_the_warm_up_and_capture():
    ms = [500.0, 900.0, 10.0, 11.0, 12.0]
    assert cs._steady_ms(ms, on_card=True) == 11.0
    assert cs._steady_ms(ms, on_card=False) == 12.0


def test_train_bf16_spread_tool_on_the_tiny_lm():
    from mxnet_tpu_torch.tools.train_bf16_spread import spread

    lines = list(spread(TINY, TINY_TRAIN))
    assert [ln["step"] for ln in lines] == [1, 2]
    for ln in lines:
        assert 0.0 < ln["param_max_abs_diff"] < 0.1
        assert np.isfinite(ln["loss_bf16"]) and np.isfinite(ln["loss_f32"])


def test_profile_capture_needs_a_card(monkeypatch):
    import torch

    from mxnet_tpu_torch.tools import profile_capture

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_capture.main([]) == 2


def test_profile_generate_needs_a_card_and_names_its_arms(monkeypatch):
    import torch

    from mxnet_tpu_torch.tools import profile_generate as pg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pg.main([]) == 2
    assert pg.main(["paged_int8_captured"]) == 2
    assert len(pg.ARMS) == len(set(pg.ARMS)) == 12
    assert {a.split("_")[0] for a in pg.ARMS} == {"paged", "unpaged",
                                                   "quant", "spec"}


@pytest.mark.parametrize("arm", ["quant_int8_unpaged_f32_captured",
                                 "quant_fp8_unpaged_f32_captured",
                                 "spec_int8_unpaged_f32_captured",
                                 "spec_int8_paged_f32_captured"])
def test_profile_generate_arms_build_and_step_on_the_cpu(arm):
    """Each new arm at the tiny size: its step, prefill and (spec) verify
    run, the spec arms' step being the int8 draft's."""
    import types

    from mxnet_tpu_torch.ops.matrix import int8_product
    from mxnet_tpu_torch.serving import generate as gen
    from mxnet_tpu_torch.tools import lm
    from mxnet_tpu_torch.tools import profile_generate as pg

    tiny_lm = types.SimpleNamespace(
        LM=TINY, SERVE_PAGED=TINY_PAGED, SERVE_SPEC=TINY_SPEC, SEED=cs.SEED,
        paged_prompts=lm.paged_prompts)
    model = gen.DecodeModel.from_arg_params(
        cs.lm_arg_params(TINY, cs.SEED),
        gen.DecodeSpec(num_heads=TINY["heads"],
                       num_kv_heads=TINY["kv_heads"]), device="cpu")
    step, prefill, notes, verify = pg._arm(gen, tiny_lm, model, arm)
    before = int8_product.launches
    assert tuple(step().shape) == (TINY_PAGED["slots"], TINY["vocab"])
    int8_steps = arm.startswith(("spec", "quant_int8"))
    assert (int8_product.launches > before) == int8_steps
    assert tuple(prefill(8).shape) == (TINY["vocab"],)
    if arm.startswith("spec"):
        assert tuple(verify().shape) == (TINY_PAGED["slots"],
                                         TINY_SPEC["spec_tokens"] + 1,
                                         TINY["vocab"])
    else:
        assert verify is None


# the host's stand-in for the flash forward's CUDA events: its plain
# version inside a profiler region of this name (CPU activity)
CPU_FA_EVENT = ("user_annotation", "flash_fwd_plain")


def _annotate_plain_flash(monkeypatch):
    """Run the (counted) plain flash forward inside a record_function, so
    the profiler's CPU activity holds one event a launch, as the card's
    CUDA activity holds one kernel event a launch."""
    import torch

    plain = fa.flash_attention_plain

    def annotated(*args, **kw):
        with torch.profiler.record_function(CPU_FA_EVENT[1]):
            return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", annotated)


@pytest.fixture
def _flight_reset():
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import flight

    flight.reset()
    telemetry.disable_spans()
    telemetry.reset()
    yield
    flight.reset()
    telemetry.disable_spans()
    telemetry.reset()


def test_serve_trace_phase_on_cpu(monkeypatch, capsys, _flight_reset):
    """Every gate of the phase on the host (the device half is the CPU
    activity of the annotated plain flash forward), and the train and
    resnet runs under the profiler."""
    _count_plain_calls(monkeypatch)
    _annotate_plain_flash(monkeypatch)
    launches = cs.phase_serve_trace(TINY, TINY_SERVE, device="cpu",
                                    kernel_event=CPU_FA_EVENT,
                                    train=TINY_TRAIN, resnet=TINY_RESNET)
    n = len(TINY_SERVE["prompt_lens"])
    assert launches == 5 * n * TINY["layers"]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_trace" and line["tokens_equal"]
    steps = line["paths"]["profiled"]["steps"]
    assert line["spans"] == {"serving.queued": n, "serving.dispatch": n,
                             "decode.prefill": n, "decode.step": steps}
    assert line["flash_events"] == line["flash_launches"] == \
        n * TINY["layers"]
    assert line["gauges"]["decode_tokens_total"] == \
        n * TINY_SERVE["max_new_tokens"]
    assert line["gauges"]["decode_tokens_per_step"] == 1.0
    assert line["deadline"]["trigger"] == "deadline_miss"
    assert len(line["deadline"]["bundles"]) == 1
    assert set(line["profiled_runs"]) == {"train", "resnet"}
    assert set(line["profiled_runs"]["train"]) == set(cs.TRAIN_EVENTS)
    train = line["profiled_runs"]["train"]
    assert train["flash_attention_fwd"]["launches"] > 0


def test_serve_trace_phase_fails_without_the_device_events(
        monkeypatch, _flight_reset):
    """Launches counted with no event in the device half: gate 4 must
    refuse."""
    _count_plain_calls(monkeypatch)
    with pytest.raises(RuntimeError, match="the dump holds 0"):
        cs.phase_serve_trace(TINY, TINY_SERVE, device="cpu",
                             kernel_event=CPU_FA_EVENT, train=TINY_TRAIN,
                             resnet=TINY_RESNET)


def test_serve_trace_phase_refuses_a_span_inside_the_captured_step(
        monkeypatch, _flight_reset):
    """The control: ``decode.step`` recorded inside the captured callable
    instead of around its replay. A captured step runs that Python at its
    two warm-up calls and its capture only, which the host emulates here
    (the callable's body runs unspanned from the fourth call on), so the
    dump holds fewer step spans than steps and the phase must refuse."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving.generate import programs
    from mxnet_tpu_torch.serving.generate import scheduler

    _count_plain_calls(monkeypatch)
    _annotate_plain_flash(monkeypatch)
    real_span = telemetry.span

    class _NoStepSpan:
        """The scheduler's telemetry, without its own step span."""

        def __getattr__(self, name):
            return getattr(telemetry, name)

        @staticmethod
        def span(name, domain="app", **args):
            if name == "decode.step":
                return telemetry.tracer._NOOP
            return real_span(name, domain, **args)

    monkeypatch.setattr(scheduler, "_telemetry", _NoStepSpan())
    init = programs._DecodeStep.__init__

    def spanned_init(self, fn, device, capture, name="decode step"):
        calls = []

        def captured_body(*args):
            calls.append(1)
            if len(calls) > programs.CAPTURE_WARMUP + 1:
                return fn(*args)            # a replay runs no Python
            with real_span("decode.step", domain="serving"):
                return fn(*args)

        init(self, captured_body, device, capture, name)

    monkeypatch.setattr(programs._DecodeStep, "__init__", spanned_init)
    with pytest.raises(RuntimeError, match=r"'decode.step': 3"):
        cs.phase_serve_trace(TINY, TINY_SERVE, device="cpu",
                             kernel_event=CPU_FA_EVENT, train=TINY_TRAIN,
                             resnet=TINY_RESNET)


def test_parse_exposition_reads_samples_and_refuses_other_text():
    text = ("# HELP kv_bytes bytes\n# TYPE kv_bytes gauge\nkv_bytes 4096\n"
            "# HELP h h\n# TYPE h histogram\n"
            'h_bucket{le="1"} 2 # {trace_id="ab"} 0.5 1700000000.25\n'
            'h_bucket{le="+Inf"} 3\nh_sum 4.5\nh_count 3\n')
    assert cs.parse_exposition(text) == {
        "kv_bytes": 4096.0, 'h_bucket{le="1"}': 2.0,
        'h_bucket{le="+Inf"}': 3.0, "h_sum": 4.5, "h_count": 3.0}
    for bad in ("kv_bytes four\n", "untyped 1\n",
                '# TYPE x gauge\nx{le=1} 2\n'):
        with pytest.raises(RuntimeError):
            cs.parse_exposition(bad)


# the fixed-shape serving run, narrow: the LM Predictor at (1, 8), (4, 8),
# (1, 16); ResNet-18 with the CIFAR stem behind a server of buckets up to
# 8, two replicas, 24 requests from 4 clients, a burst of 16
TINY_FIXED = {"lm_shapes": ((1, 8), (4, 8), (1, 16)), "buckets": (1, 2, 4, 8),
              "max_delay_ms": 5.0, "replicas": 2, "clients": 4,
              "requests": 24, "rows": (1, 4), "timeout_ms": 10000.0,
              "burst": 16, "burst_timeout_ms": 1.0, "cpu_checks": 2,
              "decode_example_len": 8}
TINY_SERVE_RESNET = {"depth": 18, "classes": 10, "image": (3, 16, 16)}


def _tiny_fixed_tols():
    """1.5 x the tiny ResNet's f32-to-f64 and int8-to-f32 distances over
    the tiny traffic, as chip_smoke.py's RESNET_PREDICT_TOL and
    RESNET_INT8_TOL are of the full-width ones."""
    from mxnet_tpu_torch.tools.resnet_predict_spread import spread

    res = spread(TINY_SERVE_RESNET, TINY_FIXED, cs.SEED)
    assert res["requests"] == TINY_FIXED["requests"]
    assert 0 < res["f32_vs_f64"] < 1e-5 and 0 < res["int8_vs_f32"] < 1e-2
    return 1.5 * res["f32_vs_f64"], 1.5 * res["int8_vs_f32"]


def test_serve_fixed_phase_on_cpu(monkeypatch, capsys):
    """Every part and gate of the phase on the host, where the Predictors
    and the decode step run eagerly."""
    _count_plain_calls(monkeypatch)
    predict_tol, int8_tol = _tiny_fixed_tols()
    launches, timings = cs.phase_serve_fixed(
        TINY, TINY_SERVE, TINY_FIXED, TINY_SERVE_RESNET, device="cpu",
        predict_tol=predict_tol, int8_tol=int8_tol)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_fixed" and timings == {}
    lm = line["lm_predictor"]
    # 3 shapes, each a captured-or-eager forward and an eager twin's, 2
    # layers; then the CPU reference's forward (its plain calls count here)
    assert lm["flash_launches"] == 2 * 6 and lm["binds"] == 6
    assert lm["weights_shared"] and lm["captured_vs_eager"]["bit_for_bit"]
    gen = line["generate"]
    assert gen["flash_launches"] == 3 * TINY["layers"]
    assert "batch-major" in gen["refused_predict"]
    assert len(gen["replica_paths"]) == 2
    arms = line["resnet"]["arms"]
    assert set(arms) == {"rr", "least_loaded", "int8"}
    assert all(arms[a]["mean_batch_occupancy"] > 1 for a in arms)
    assert arms["rr"]["binds"] <= 8
    assert arms["rr"]["concurrent_binds"]["forwards_during_binds"] >= 1
    assert arms["least_loaded"]["burst"]["codes"]["deadline_exceeded"] >= 1
    assert launches == lm["flash_launches"] + TINY["layers"] \
        + gen["fixed_path_flash_launches"] + gen["flash_launches"] \
        + TINY["layers"]


def test_serve_fixed_phase_fails_when_the_flash_kernel_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="launched the flash kernel 0"):
        cs.phase_serve_fixed(TINY, TINY_SERVE, TINY_FIXED,
                             TINY_SERVE_RESNET, device="cpu",
                             serve_tokens=[[0]] * 3)


def test_serve_fixed_phase_fails_when_a_result_leaves_the_tolerance(
        monkeypatch):
    """A server whose outputs move by 1e-3 after the forward: the phase
    refuses at the first arm's per-request check."""
    from mxnet_tpu_torch.serving import server

    _count_plain_calls(monkeypatch)
    real = server._host
    monkeypatch.setattr(server, "_host", lambda o: real(o) + 1e-3)
    with pytest.raises(RuntimeError, match="from its forward alone"):
        cs.phase_serve_fixed(TINY, TINY_SERVE, TINY_FIXED,
                             TINY_SERVE_RESNET, device="cpu",
                             serve_tokens=[[0]] * 3,
                             predict_tol=1e-4, int8_tol=1e-2)


def test_serve_fixed_tolerances_follow_the_spread_tool():
    assert cs.RESNET_PREDICT_TOL == 1.5 * cs.RESNET_PREDICT_SPREAD
    assert cs.RESNET_INT8_TOL == 1.5 * cs.RESNET_INT8_SPREAD
    from mxnet_tpu_torch.tools.serve_fixed import request_sizes

    sizes = request_sizes(cs.SERVE_FIXED)
    assert len(sizes) == 96 and set(sizes) == {1, 2, 3, 4}


# the front door's run, narrow: the tiny ResNet's ladder, 16 requests from
# 4 clients; the admission arm's one bucket of 8 (4 parked stay below it);
# a client that leaves a 16-token stream after 2 tokens
TINY_HTTP = dict(cs.SERVE_HTTP, buckets=(1, 2, 4, 8), clients=4,
                 requests=16, timeout_ms=20000.0,
                 admission=dict(cs.SERVE_HTTP["admission"], buckets=(8,)),
                 decode_example_len=8, disconnect_after=2,
                 disconnect_tokens=16)


def test_serve_http_phase_on_cpu(monkeypatch, capsys):
    """Every part and gate of the phase on the host: predict over HTTP
    and in-process, admission, generate over SSE with a client that
    leaves, the traced request and the SIGTERM drain."""
    _count_plain_calls(monkeypatch)
    predict_tol, _ = _tiny_fixed_tols()
    launches = cs.phase_serve_http(TINY, TINY_SERVE, TINY_HTTP,
                                   TINY_SERVE_RESNET, device="cpu",
                                   predict_tol=predict_tol)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "serve_http"
    pred = line["predict"]
    assert pred["readyz_before_warm"] == {"status": "warming"}
    assert pred["requests"] == 16 and pred["json_vs_b64"]["bit_for_bit"]
    adm = line["admission"]
    assert (adm["shed"]["status"], adm["overloaded"]["status"]) == (429, 503)
    assert adm["shed"]["retry_after_s"] >= 1
    gen = line["generate"]
    n = len(TINY_SERVE["prompt_lens"])
    # on the host the fixed path's bind runs no forward: a flash call a
    # layer for each prompt admitted, 3 SSE + 1 left + 1 stream-false + 1
    # traced + 3 in-process + 2 drained
    assert launches == gen["flash_launches"] == TINY["layers"] * (
        n + 3 + n + TINY_HTTP["drain_streams"])
    assert gen["disconnect"]["finish_reason"] == "cancelled"
    assert gen["disconnect"]["server_tokens"] < 16
    assert len(gen["replica_paths"]) == 2
    assert gen["drain"]["new_post"] in (503, "refused")


def test_serve_http_phase_fails_when_the_flash_kernel_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="flash launches"):
        cs.phase_serve_http(TINY, TINY_SERVE, TINY_HTTP, TINY_SERVE_RESNET,
                            device="cpu", serve_tokens=[[0]] * 3,
                            predict_tol=1e-3)


# the sequence classifier, narrow
TINY_SEQ = dict(cs.SEQ, vocab=50, embed=16, hidden=16, seq=5, batch=4,
                batches=4, check_batch=2, random_elements=1 << 14)


def test_seq_phase_on_cpu(monkeypatch, capsys):
    """The whole phase on the host: the check, the scheduled run (eager
    here) with its lr read from the step's buffer, the eager twin, the
    deterministic ops against themselves and the sampling ops."""
    _count_plain_calls(monkeypatch)
    launches = cs.phase_seq(TINY_SEQ, device="cpu")
    assert launches == 2 * 5 * 4
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "seq" and line["path"] == "eager"
    assert line["lr"] == [float(np.float32(x))
                          for x in (0.1, 0.1, 0.05, 0.05)]
    assert set(line["random"]) == {r[0] for r in cs.RANDOM_OPS}
    assert "SequenceReverse" in line["deterministic_bit_for_bit"]


def test_seq_phase_fails_when_lstm_step_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="launched lstm_step 0 times"):
        cs.phase_seq(TINY_SEQ, device="cpu")


def test_seq_phase_launch_arithmetic_is_560_and_the_schedule_halves():
    assert cs.lstm_steps(cs.SEQ, cs.SEQ["batches"]) == 560
    assert cs.lr_sequence(cs.SEQ, 8) == [0.1, 0.1, 0.05, 0.05, 0.025,
                                         0.025, 0.0125, 0.0125]


# the zoo phase's LM, narrow
TINY_ZOO = dict(cs.ZOO, vocab=50, embed=16, hidden=16, seq=5, batch=4,
                batches=4, check_batch=2)


def _count_lr_plain_calls(monkeypatch):
    """Also count the device-lr entry's plain calls as its launches (its
    plain version calls sgd_mom_update_plain, which _count_plain_calls
    counts under the scalar entry: that count is taken back)."""
    plain = fu.sgd_mom_update_lr_plain

    def counted(*args, **kw):
        _launches.launched(fu.sgd_mom_update_lr, args[0].dtype)
        out = plain(*args, **kw)
        fu.sgd_mom_update.launches -= 1
        return out

    monkeypatch.setattr(fu, "sgd_mom_update_lr_plain", counted)


def test_zoo_phase_on_cpu(monkeypatch, capsys):
    """The whole phase on the host: every optimizer's check, the runs
    (the pure-rule ones fused, eager here, against their eager twins; the
    others through the Updater), the SequentialModule and
    PythonLossModule chains, Monitor, FeedForward and the small parts."""
    _count_plain_calls(monkeypatch)
    _count_lr_plain_calls(monkeypatch)
    launches = cs.phase_zoo(TINY_ZOO, device="cpu")
    per_fit = 2 * 5 * 4
    # (2) 6 fused runs, their eager twins and 4 Updater runs; (3) the
    # chain and the Module at the check's 2 batches, the chain's run, the
    # loss chain on both devices; (4) the monitored fit (4 batches + 2
    # monitored evaluations) on both; (5) FeedForward's fit, predict and
    # score on both, and the predict after load. Here the CPU's runs
    # count too
    per_batch = 2 * 5
    assert launches["lstm_step"] == (16 * per_fit + 3 * per_fit
                                     + 2 * 6 * per_batch
                                     + (2 * 6 + 2) * per_batch)
    # 4 parameters a step: ccSGD's run and twin and the fused Module of
    # (3) and FeedForward's fits (the lr entry); the chains and the
    # monitored fits, through the Updater (the scalar entry)
    assert launches["sgd_mom_update_lr"] == 4 * (2 * 4 + 2 + 2 * 2)
    assert launches["sgd_mom_update"] == 4 * (2 + 4 + 2 * 2 + 2 * 4)
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    rec = lines[-1]
    assert rec["phase"] == "zoo"
    assert sorted(rec["checks"]) == sorted(r for r, _, _ in cs.zoo.OPTIMIZERS)
    assert [x["optimizer"] for x in lines if x["phase"] == "zoo_step"] == \
        list(cs.zoo.CAPTURED + cs.zoo.UPDATER)
    for run in cs.zoo.CAPTURED:
        assert rec["runs"][run]["path"] == "eager"
        assert rec["runs"][run]["captured_vs_eager"]["bit_for_bit"]
    for run in cs.zoo.UPDATER:
        assert rec["runs"][run]["steps"]["reason"].endswith(
            "has no pure rule")
    assert rec["monitor"]["monitored_batches"] == [0, 2]
    assert rec["monitor"]["steps"]["reason"] == "monitor install"
    assert rec["feedforward"]["save_load_predict_bit_for_bit"]
    assert rec["checks"]["sgld"]["definition"]["elements"] == 50 * 16


def test_zoo_phase_fails_when_a_captured_optimizer_takes_the_updater(
        monkeypatch):
    """NAG without its pure rule goes down the Updater path: refused."""
    import mxnet_tpu_torch as mt

    _count_plain_calls(monkeypatch)
    _count_lr_plain_calls(monkeypatch)
    monkeypatch.setattr(mt.optimizer.NAG, "pure_rule", lambda self: None)
    with pytest.raises(RuntimeError, match="nag has a pure rule but took "
                                           "the Updater path"):
        cs.phase_zoo(TINY_ZOO, device="cpu")


def test_zoo_phase_fails_when_lstm_step_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="zoo phase: nag launched"):
        cs.phase_zoo(TINY_ZOO, device="cpu")


def test_zoo_phase_fails_when_the_monitor_reports_an_inactive_batch(
        monkeypatch):
    """A Monitor that stays active reports on every batch: refused."""
    import mxnet_tpu_torch as mt

    _count_plain_calls(monkeypatch)
    _count_lr_plain_calls(monkeypatch)
    tic = mt.monitor.Monitor.tic

    def always(self):
        tic(self)
        self.activated = True

    monkeypatch.setattr(mt.monitor.Monitor, "tic", always)
    with pytest.raises(RuntimeError, match=r"batch 1 \(inactive\) reported"):
        cs.phase_zoo(TINY_ZOO, device="cpu")


def test_zoo_phase_launch_arithmetic():
    """560 lstm_step launches a fit of 8 batches; ccSGD's lr entry 4
    parameters x 8 batches; the monitored fit 4 + 2 batches' forwards."""
    assert cs.lstm_steps(cs.ZOO, cs.ZOO["batches"]) == 560
    from mxnet_tpu_torch.tools.lstm_lm import lstm_symbol

    assert len(lstm_symbol(cs.ZOO).list_arguments()) - 2 == 4
    assert cs.lstm_steps(cs.ZOO, 4 + 2) == 420


# the image_zoo phase, narrow: Inception-BN at 32 x 32 (10 classes, batch
# 2, 2 batches) for the run, VGG-16 (its stem is a 3x3 on 3 channels: the
# simt body) at 32 x 32 for the check, the conv_wgrad table at batch 1;
# the check's gates loose (the CPU against itself)
TINY_IMAGE_ZOO = dict(cs.IMAGE_ZOO, main=dict(cs.IMAGE_ZOO["main"],
                                              classes=10, image=(3, 32, 32),
                                              batch=2, batches=2),
                      check={"vgg16": 32}, classes=10, wgrad_batch=1)
TINY_IMAGE_ZOO_SPREAD = {n: {"update": 0.0, "aux": 0.0, "ce": (0.0, 0.0)}
                   for n in TINY_IMAGE_ZOO["check"]}


def test_image_zoo_phase_on_cpu(monkeypatch, capsys):
    """The phase on the host: every op case, the conv_wgrad table (both
    bf16 routes reached), the run's exact launches (31 a step) and the
    check with its conv_wgrad launches."""
    _count_plain_calls(monkeypatch)
    out = cs.phase_image_zoo(TINY_IMAGE_ZOO, device="cpu", spread=TINY_IMAGE_ZOO_SPREAD)
    assert out["main"] == {"conv_wgrad_partial": 62,
                           "conv_wgrad_reduce": 62,
                           "conv_wgrad_repack": 0,
                           "sgd_mom_update": 278 * 2}
    # VGG-16's 13 routed 3x3 convolutions, 2 batches
    assert out["check"] == {"conv_wgrad_partial": 26,
                            "conv_wgrad_reduce": 26}
    assert {r["route"] for r in out["wgrad"]} == {"wgmma", "simt", "f32"}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "image_zoo" and line["path"] == "eager"
    assert set(line["checks"]) == {"vgg16"}
    assert set(line["ops"]) == {k for k, c in cs.op_cases(big=True).items()
                                if c.op not in cs.CONTRIB_OPS}
    assert set(line["seconds"]) == {"ops", "conv_wgrad", "main", "check",
                                    "phase"}


def _main_run_only(monkeypatch):
    """The phase without its op and conv_wgrad tables (tested above)."""
    monkeypatch.setattr(cs, "_zoo_ops_check", lambda *a: {})
    monkeypatch.setattr(cs, "_zoo_wgrad", lambda *a: ([], {}))


def test_image_zoo_phase_fails_when_conv_wgrad_is_not_reached(monkeypatch):
    """Nothing counts a launch on the host: the run's gate refuses."""
    _main_run_only(monkeypatch)
    with pytest.raises(RuntimeError, match="image_zoo phase launched"):
        cs.phase_image_zoo(TINY_IMAGE_ZOO, device="cpu", spread=TINY_IMAGE_ZOO_SPREAD)


def test_image_zoo_phase_fails_when_the_run_is_eager_on_the_card(
        monkeypatch):
    """The card's run must take the captured path: the host's eager run,
    judged as the card's, fails."""
    _count_plain_calls(monkeypatch)
    _main_run_only(monkeypatch)
    real = cs._require_captured
    monkeypatch.setattr(cs, "_require_captured",
                        lambda phase, stats, on_card: real(phase, stats,
                                                           True))
    with pytest.raises(RuntimeError, match="image_zoo phase did not take "
                                           "the captured path"):
        cs.phase_image_zoo(TINY_IMAGE_ZOO, device="cpu", spread=TINY_IMAGE_ZOO_SPREAD)


def test_image_zoo_check_fails_past_its_gate(monkeypatch):
    """A check whose card run differs from the reference by more than its
    gate fails: here the reference's learning rate differs."""
    _count_plain_calls(monkeypatch)
    real = cs.fit_args
    calls = []

    def fit_args(cfg, init):
        calls.append(1)
        kw = real(cfg, init)
        if len(calls) % 2 == 0:  # every reference run
            kw["optimizer_params"] = (("learning_rate", 0.01),) + \
                kw["optimizer_params"][1:]
        return kw

    cfg = dict(TINY_IMAGE_ZOO, check={"vgg16": 32})
    monkeypatch.setattr(cs, "fit_args", fit_args)
    _main_run_only(monkeypatch)
    monkeypatch.setattr(cs, "_captured_fit",
                        lambda *a: ({}, {"conv_wgrad_partial": 0}))
    tol = {"vgg16": {"update": 1e-3, "aux": 1e-3, "ce": (1.0, 1.0)}}
    with pytest.raises(RuntimeError, match="image_zoo check of vgg16: "
                                           "batch-1 update"):
        cs.phase_image_zoo(cfg, device="cpu", spread=tol)


def test_image_zoo_launch_arithmetic():
    """Inception-BN: 31 routed 3x3 convolutions a step, every one on the
    wgmma route in bf16 (two repacks a call): 248 + 248 + 496 over 8
    batches; ResNeXt-50's grouped 3x3 none; the seven models' table holds
    stems that take the simt body."""
    from mxnet_tpu_torch.tools.image_zoo import zoo_symbol

    main = cs.IMAGE_ZOO["main"]
    sym = zoo_symbol(main["model"], main["classes"])
    assert cs.wgrad_convs(sym) == 31
    assert cs.resnet_wgrad_launches(31, main["batches"], True) == {
        "conv_wgrad_partial": 248, "conv_wgrad_reduce": 248,
        "conv_wgrad_repack": 496}
    shapes = cs.wgrad_shapes(sym, main["image"], main["batch"])
    assert sum(shapes.values()) == 31
    assert all(cw.plan(*s[:5], 3, s[5], s[6], "bfloat16").route == "wgmma"
               for s in shapes)
    assert cs.wgrad_convs(zoo_symbol("resnext-50", 1000)) == 0
    table = cs.zoo_wgrad_shapes(cs.IMAGE_ZOO)
    assert sum(m.get("inception-bn", 0) for m in table.values()) == 31
    assert not any("resnext-50" in m for m in table.values())
    simt = [s for s in table if cw.plan(*s[:5], 3, s[5], s[6],
                                        "bfloat16").route == "simt"]
    assert (32, 299, 299, 3, 32, 2, 0) in simt and \
        (32, 224, 224, 3, 64, 1, 1) in simt


def test_image_zoo_gates_rest_on_the_cpu_spread_and_the_witness():
    """1.5 x the CPU's own f32-vs-f64 distance, widened by the witness
    ratio where it exceeds 1 (never narrowed); nothing of the card's run
    enters a gate."""
    cpu = {"m": {"update": 0.02, "aux": 3e-5, "ce": (1e-7, 2e-3)}}
    assert cs.zoo_tol("m", cpu, {"m": 0.5}) == {
        "update": pytest.approx(0.03), "aux": pytest.approx(4.5e-5),
        "ce": (cs.IMAGE_ZOO_CE_FLOOR, pytest.approx(3e-3))}
    assert cs.zoo_tol("m", cpu, {"m": 3.0}) == {
        "update": pytest.approx(0.09), "aux": pytest.approx(1.35e-4),
        "ce": (pytest.approx(4.5e-7), pytest.approx(9e-3))}
    for table in (cs.IMAGE_ZOO_SPREAD, cs.IMAGE_ZOO_WITNESS):
        assert set(table) == set(cs.IMAGE_ZOO["check"])
    assert not hasattr(cs, "IMAGE_ZOO_CARD_SPREAD")
    # alexnet's cross-entropy spread lies under the metric's resolution:
    # its gate is the floor
    assert cs.zoo_tol("alexnet")["ce"][0] == cs.IMAGE_ZOO_CE_FLOOR


def test_image_zoo_spread_and_witness_on_cpu():
    """tools/image_zoo_spread.py narrow: the spread's largest over seeds
    is each measure's largest line; the witness covers every convolution
    call (dW only where the port leaves it to autograd), and with the CPU
    on both sides its ratio is 1."""
    from mxnet_tpu_torch.tools import image_zoo_spread as zs

    cfg = dict(cs.IMAGE_ZOO, check={"vgg16": 32, "googlenet": 64},
               classes=10)
    lines = [l for seed in (cs.SEED, cs.SEED + 1)
             for l in zs.zoo_spread("vgg16", cfg, seed)]
    assert [(l["seed"], l["batch"]) for l in lines] == [
        (cs.SEED, 1), (cs.SEED, 2), (cs.SEED + 1, 1), (cs.SEED + 1, 2)]
    top = zs.max_over_seeds(lines)
    assert top["update"] == max(l["update_err_worst"] for l in lines
                                if l["batch"] == 1) > 0
    assert len(top["ce"]) == 2 and top["aux"] == 0.0
    w = zs.conv_witness("vgg16", cfg, device="cpu")
    assert w["convolutions"] == 13 and set(w["rms"]["cpu"]) == {"fwd",
                                                                "dgrad"}
    assert w["ratio"] == 1.0 and set(w["ratio_by_kind"]["card_native"]
                                         .values()) == {1.0}
    assert 0 < w["rms"]["cpu"]["fwd"] < 1e-5
    w = zs.conv_witness("googlenet", cfg, device="cpu")
    assert set(w["rms"]["card"]) == {"fwd", "dgrad", "wgrad"}


def test_wgrad_gate_grows_as_the_root_of_the_terms():
    assert cs.wgrad_rtol(32 * 7 * 7) == cs.WGRAD_RTOL
    assert cs.wgrad_rtol(32 * 56 * 56) == cs.WGRAD_RTOL
    assert cs.wgrad_rtol(4 * 32 * 56 * 56) == pytest.approx(
        2 * cs.WGRAD_RTOL)


def test_zoo_op_cases_cover_every_new_op():
    """The card's op check runs the CPU test's table at full shapes: the
    same cases, ops, differentiable inputs and kinds at both sizes; every
    new op has a case; the exact kinds are the ops that only move, pick,
    order or round."""
    from mxnet_tpu_torch.tools.op_cases import op_cases
    from test_torch_ops_core import CONTRIB, NEW_OPS

    big, small = op_cases(big=True), op_cases()
    assert [(k, c.op, c.diff, c.exact, len(c.makers), len(c.aux))
            for k, c in sorted(big.items())] == [
        (k, c.op, c.diff, c.exact, len(c.makers), len(c.aux))
        for k, c in sorted(small.items())]
    assert {c.op for c in big.values()} == set(NEW_OPS) | set(CONTRIB)
    exact = {c.op for c in big.values() if c.exact}
    assert {"take", "pick", "sort", "argsort", "topk", "round", "Cast",
            "broadcast_logical_xor", "Pad", "Crop", "slice", "tile",
            "repeat", "flip", "transpose", "ROIPooling"} <= exact


# the ssd phase, narrow: ssd-vgg16 at 64 x 64 with 3 classes, batch 2, 2
# batches, detection at batch 1 and 2 over 20 NMS rounds, the op cases at
# their small shapes; the check's gates the CPU against itself
TINY_SSD = dict(cs.SSD, classes=3, image=(3, 64, 64), batch=2, batches=2,
                detect_batches=(1, 2), nms_topk=20)
TINY_SSD_SPREAD = {"update": 0.0, "ce": (0.0, 0.0), "smooth_l1": (0.0, 0.0)}


def _ssd_phase():
    return cs.phase_ssd(TINY_SSD, device="cpu", spread=TINY_SSD_SPREAD,
                        witness=1.0)


def _small_op_cases(monkeypatch):
    """The op table at its small shapes in place of the full ones."""
    small = cs.op_cases
    monkeypatch.setattr(cs, "op_cases", lambda big=False: small(big=False))


def test_ssd_phase_on_cpu(monkeypatch, capsys):
    """The phase on the host: the nine ops' cases, the check (with its
    matching), the conv_wgrad table at ssd's shapes (both bf16 routes),
    the run's exact launches (24 conv_wgrad a step, 54 updates), its eager
    and DevicePrefetchIter twins bit for bit, the detection Predictors."""
    _count_plain_calls(monkeypatch)
    _small_op_cases(monkeypatch)
    out = _ssd_phase()
    assert out["main"] == {"conv_wgrad_partial": 48,
                           "conv_wgrad_reduce": 48,
                           "conv_wgrad_repack": 0,
                           "sgd_mom_update": 54 * 2}
    assert out["check"]["conv_wgrad_partial"] == 48
    assert {r["route"] for r in out["wgrad"]} == {"wgmma", "simt", "f32"}
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "ssd" and line["path"] == "eager"
    assert line["prefetch"]["bit_for_bit_with_ndarray_iter"]
    assert set(line["detect"]) == {"1", "2"}
    assert line["check"]["matching"]["differ"] == 0
    assert set(line["ops"]) == {k for k, c in cs.op_cases().items()
                                if c.op in cs.CONTRIB_OPS}
    assert set(line["seconds"]) == {"ops", "check", "conv_wgrad", "run",
                                    "detect", "phase"}


def test_ssd_phase_fails_when_conv_wgrad_is_not_reached(monkeypatch):
    """Nothing counts a launch on the host: the check's gate refuses."""
    monkeypatch.setattr(cs, "_zoo_ops_check", lambda *a, **k: {})
    with pytest.raises(RuntimeError, match="ssd check: conv_wgrad "
                                           "launched"):
        _ssd_phase()


def test_ssd_prefetch_twin_refuses_other_parameters(monkeypatch):
    """The DevicePrefetchIter run must land on the directly fed run's
    parameters: here the iterator hands out every batch twice."""
    from mxnet_tpu_torch import io

    real = io.DevicePrefetchIter.next
    seen = []

    def twice(self):
        if seen and len(seen) % 2:
            seen.append(1)
            return seen_batch[0]
        b = real(self)
        seen.append(1)
        seen_batch[:] = [b]
        return b

    seen_batch = []
    monkeypatch.setattr(io.DevicePrefetchIter, "next", twice)
    _count_plain_calls(monkeypatch)
    monkeypatch.setattr(cs, "_zoo_ops_check", lambda *a, **k: {})
    monkeypatch.setattr(cs, "_ssd_check", lambda *a, **k: {
        "matching": {"anchors": 0}, "conv_wgrad": {}})
    monkeypatch.setattr(cs, "_zoo_wgrad", lambda *a, **k: ([], {}))
    with pytest.raises(RuntimeError, match="fed through DevicePrefetchIter"):
        _ssd_phase()


def test_ssd_gates_and_launch_arithmetic():
    """ssd_tol: 1.5 x the CPU spread x the witness where it exceeds 1,
    floors on the metric's measures; SSD300's 24 routed 3x3 convolutions
    split 17 wgmma / 7 simt in bf16 (34 repacks a step), all f32 in f32;
    54 parameters."""
    tol = cs.ssd_tol({"update": 0.01, "ce": (1e-9, 2e-3),
                      "smooth_l1": (1e-7, 1e-3)}, 2.0)
    assert tol["update"] == pytest.approx(0.03)
    assert tol["ce"] == (cs.IMAGE_ZOO_CE_FLOOR, pytest.approx(6e-3))
    assert tol["smooth_l1"] == (pytest.approx(3e-7), pytest.approx(3e-3))
    assert cs.ssd_tol({"update": 0.01, "ce": (0.0, 0.0),
                       "smooth_l1": (0.0, 0.0)}, 0.5)["update"] == \
        pytest.approx(0.015)
    sym = cs.ssd_symbol(cs.SSD)
    assert cs.wgrad_convs(sym) == 24
    assert cs.wgrad_routes(sym, cs.SSD["image"], 32, "bfloat16") == {
        "wgmma": 17, "simt": 7}
    assert cs.wgrad_routes(sym, cs.SSD["image"], 32, "float32") == {
        "f32": 24}
    assert len(sym.list_arguments()) - 2 == 54


def test_nms_and_matching_excusals():
    """A keep-mask difference is explained only after a near tie of
    scores or an IoU at the threshold among the boxes scored at least as
    high as the first difference; matching excuses an IoU at 0.5 and two
    tied ground truths, nothing else."""
    from mxnet_tpu_torch.tools.ssd import matching_excused, nms_explained

    boxes = np.array([[0, 0, 0.5, 0.5], [0.6, 0.6, 1, 1],
                      [0, 0, 0.5, 0.4]], np.float64)
    scores = np.array([0.9, 0.8, 0.3])
    valid = np.ones(3, bool)
    a = np.array([True, True, False])
    b = np.array([True, False, True])
    assert not nms_explained(boxes, scores, valid, a, b, 0.5)[0]
    tied = np.array([0.9, 0.8 + 1e-7, 0.8])
    assert nms_explained(boxes, tied, valid, a, b, 0.5)[0]
    assert nms_explained(boxes, scores, valid, a, a, 0.5) == (True, 0, None)
    # box 2's IoU with box 0 is 0.8: at threshold 0.8 the choice is open
    assert nms_explained(boxes, scores, valid, np.array([True, True, True]),
                         a, 0.8)[0]
    anchors = np.array([[0, 0, 0.5, 0.5], [0.5, 0.5, 1, 1],
                        [0, 0, 0.5, 0.25]])
    labels = np.array([[[0, 0, 0, 0.5, 0.25], [1, 0.5, 0.5, 1, 1],
                        [-1, -1, -1, -1, -1]]], np.float32)
    got = matching_excused(anchors, labels, 0.5)
    # anchor 0's best IoU is 0.5 exactly; anchor 2 is box 0 exactly
    np.testing.assert_array_equal(got, [[True, False, False]])


# the data-parallel LSTM LM, 2 layers, narrow: 2 ranks of 4 rows
TINY_DIST = dict(cs.DIST_LSTM, vocab=50, embed=16, hidden=16, seq=5,
                 batch=8, batches=3)


def test_kvstore_and_dist_phases_on_cpu(monkeypatch, capsys):
    """Both communication phases on the host: two contexts through the
    "device" and "local" kvstores against one context (launches, counters,
    spans, contexts equal), then dist_sync over one gloo rank (bit for bit
    the reference), two gloo ranks and a parameter server with two
    workers (child processes counting their plain calls), and the closed
    forms."""
    _count_plain_calls(monkeypatch)
    kv = cs.phase_kvstore(TINY_DIST, device="cpu")
    n, nb = kv["n_params"], TINY_DIST["batches"]
    per = TINY_DIST["layers"] * TINY_DIST["seq"] * nb
    assert n == 4
    assert kv["launches"] == {"lstm_step": 2 * 2 * per,
                              "sgd_mom_update": 2 * n * nb,
                              "sgd_mom_update_lr": 0}
    launched = cs.phase_dist(TINY_DIST, device="cpu", kv=kv, timeout_s=90)
    # world 1 and the collective ranks update on the workers, the server's
    # workers do not
    assert launched == {"lstm_step": 5 * per, "sgd_mom_update": 3 * n * nb,
                        "sgd_mom_update_lr": 0}
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    kvl = next(x for x in lines if x.get("phase") == "kvstore")
    dl = next(x for x in lines if x.get("phase") == "dist")
    assert set(kvl["two_contexts"]) == {"device", "local"}
    assert dl["world1"]["bit_for_bit"] and dl["world1"]["backend"] == "gloo"
    assert dl["collective"]["ranks_equal_bit_for_bit"]
    assert dl["parameter_server"]["store"] == "PSKVStore"
    assert dl["closed_forms"]["collective"]["allgather"] == [1.0, 2.0]


def test_kvstore_phase_fails_when_lstm_step_is_not_reached():
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match=r"kvstore phase \(device\): "
                                           "launched"):
        cs.phase_kvstore(TINY_DIST, device="cpu")


def test_kv_launch_arithmetic_at_full_width():
    """2 x 70 lstm_step a batch over two contexts, one scalar
    sgd_mom_update a parameter a batch, no device-lr launch."""
    assert cs.kv_launches(cs.DIST_LSTM, 2, 8, 4) == {
        "lstm_step": 1120, "sgd_mom_update": 32, "sgd_mom_update_lr": 0}


# --- the engine phase ------------------------------------------------------
# ResNet-18 (CIFAR stem) in f32 for 5 batches: 3 warm-up steps, then 2
# replays or fused runs; the LM server at T = 8, the decode at 6 new tokens,
# the warm restart at T = 8
TINY_ENGINE_RESNET = dict(TINY_RESNET, dtype="float32", batches=5)
TINY_ENGINE = dict(cs.ENGINE, serve_seq=8, decode_new_tokens=6,
                   restart_seq=8)


def test_engine_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    launches = cs.phase_engine(TINY, TINY_ENGINE_RESNET, TINY_ENGINE,
                               TINY_SERVE, device="cpu")
    steps = TINY_ENGINE_RESNET["batches"]
    assert launches["conv_wgrad_partial"] == 3 * 17 * steps
    assert launches["sgd_mom_update"] == 3 * 59 * steps
    assert launches["flash_attention_fwd"] > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "engine" and line["sanitizer_reports"] == 0
    fuse = line["resnet"]["modes"]["fuse"]
    assert fuse["engine"]["fused_runs"] == steps - 3
    assert fuse["fused"]["captures"] == 0   # eager on the CPU
    assert line["decode"]["decode_step_r0"]["replays"] > 0
    restart = line["restart"]
    assert restart["second"]["disk_loads"] == len(restart["ladder"]) == 3
    assert restart["second"]["truncated"]["fallbacks"] == 1


def test_engine_phase_fails_without_the_native_engine(monkeypatch):
    from mxnet_tpu_torch import engine

    monkeypatch.setattr(engine, "_engine", engine.PythonEngine(
        0, "ThreadedEngine"))
    with pytest.raises(RuntimeError, match="not the native ThreadedEngine"):
        cs.phase_engine(TINY, TINY_ENGINE_RESNET, TINY_ENGINE, TINY_SERVE,
                        device="cpu")


def test_engine_phase_fails_when_a_fused_step_differs(monkeypatch):
    """A fused step that moves a parameter the eager step does not must
    fail the bit-for-bit gate."""
    from mxnet_tpu_torch import executor

    _count_plain_calls(monkeypatch)
    body = executor._TrainStep.fused_body

    def skewed(self, extra):
        outs = body(self, extra)
        next(iter(self._params.values())).add_(1e-3)
        return outs

    monkeypatch.setattr(executor._TrainStep, "fused_body", skewed)
    with pytest.raises(RuntimeError, match=r"resnet fit \(fuse\)"):
        cs._engine_fits(__import__("torch"),
                        dict(TINY_ENGINE_RESNET, batches=4), "cpu", cs.SEED,
                        False)


def test_phase_host_prints_the_jpeg_facts(capsys):
    cs.phase_host()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "host"
    assert set(line) == {"phase", "jpeglib_h", "libjpeg", "libnvjpeg"}
