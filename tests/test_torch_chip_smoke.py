"""chip_smoke.py's logic on the CPU at a tiny size.

The script itself needs a CUDA card; here its serve, train, resnet, lstm
and custom phases run on the host (each wrapper takes its plain version,
counted in place of kernel launches) so a broken phase shows before a card
run, and its bound arithmetic is checked against closed forms.
"""
import numpy as np
import pytest

import chip_smoke as cs
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
TINY_TRAIN = {"batch": 2, "seq": 16, "sgd_steps": 2, "adam_steps": 1,
              "lr": 0.05, "momentum": 0.9, "wd": 1e-4, "adam_lr": 1e-3,
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
               "check_batch": 2, "check_steps": 2}
# the fused LSTM LM, 2 layers, narrow
TINY_LSTM = {"vocab": 50, "embed": 16, "hidden": 16, "layers": 2, "seq": 5,
             "batch": 4, "batches": 2, "lr": 0.5, "check_batch": 2,
             "check_steps": 2}


def _count_plain_calls(monkeypatch):
    """Count each plain call on the host as its kernels' launches."""
    for plain_name, launcher_names in PLAINS.items():
        mod = next(m for m in (fa, fu, cw, kl) if hasattr(m, plain_name))
        plain = getattr(mod, plain_name)
        launchers = [getattr(mod, n) for n in launcher_names]

        def counted(*args, _plain=plain, _launchers=launchers, **kw):
            for launcher in _launchers:
                launcher.launches += 1
            return _plain(*args, **kw)

        monkeypatch.setattr(mod, plain_name, counted)


def test_serve_phase_on_cpu(monkeypatch, capsys):
    _count_plain_calls(monkeypatch)
    launches = cs.phase_serve(TINY, TINY_SERVE, device="cpu")
    assert launches == len(TINY_SERVE["prompt_lens"]) * TINY["layers"]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"phase": "serve"' in line and '"flash_launches": 6' in line


def test_serve_phase_fails_when_the_kernel_is_not_reached(monkeypatch):
    """On the host nothing counts a launch: the phase must refuse."""
    with pytest.raises(RuntimeError, match="flash kernel ran 0 times"):
        cs.phase_serve(TINY, TINY_SERVE, device="cpu")


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
