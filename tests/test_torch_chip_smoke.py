"""chip_smoke.py's logic on the CPU at a tiny size.

The script itself needs a CUDA card; here its serve phase runs on the host
(the flash wrapper takes its plain version, counted in place of kernel
launches) so a broken phase shows before a card run, and its bound
arithmetic is checked against closed forms.
"""
import numpy as np
import pytest

import chip_smoke as cs
from mxnet_tpu_torch.ops.kernels import flash_attention as fa

TINY = {"vocab": 97, "d_model": 32, "heads": 4, "kv_heads": 2, "ffn": 64,
        "layers": 2}
TINY_SERVE = {"slots": 2, "prefill_buckets": (8, 16), "max_context": 24,
              "max_new_tokens": 4, "prompt_lens": (3, 9, 14),
              "check_lens": (9, 14)}


def test_serve_phase_on_cpu(monkeypatch, capsys):
    plain = fa.flash_attention_plain

    def counted(*args, **kw):
        fa.flash_attention.launches += 1
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
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
