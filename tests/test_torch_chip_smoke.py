"""chip_smoke.py's logic on the CPU at a tiny size.

The script itself needs a CUDA card; here its serve, train, resnet, lstm
and custom phases run on the host (each wrapper takes its plain version,
counted in place of kernel launches) so a broken phase shows before a card
run, and its bound arithmetic is checked against closed forms.
"""
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
