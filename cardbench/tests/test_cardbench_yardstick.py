"""The benchmark's yardstick held to values worked out by hand."""
import json
import math
from pathlib import Path

import numpy as np
import pytest

from cardbench import families, yardstick

BENCH = Path(__file__).resolve().parents[1]


def config(name):
    return families.at_root(json.loads((BENCH / "configs" / f"{name}.json").read_text()),
                            BENCH.parent)


def test_internlm2_prefill_token():
    # per layer: wq and wo 2 x 2048 x 2048, wk and wv 2 x 2048 x 1024, the
    # SwiGLU 3 x 2048 x 8192 = 62.9M weights; x 24 layers x 2 = 3.02 GFLOP
    cfg = config("internlm2-1.8b")
    assert families.module(cfg).projection_params(cfg) == 62_914_560 * cfg["num_hidden_layers"]
    per_token = 2 * families.module(cfg).projection_params(cfg)
    assert per_token / 1e9 == pytest.approx(3.02, abs=0.005)


def test_causal_attention_layer_at_32k():
    # q.k and p.v over the causal half of 32,768^2 pairs, 16 heads of 128:
    # 4 x 128 x 32,768 x 32,769 / 2 x 16 = 4.40 TFLOP
    flops, nbytes = yardstick.k1_work(1, 16, 8, 32768, 32768, 128)
    assert flops / 1e12 == pytest.approx(4.40, abs=0.005)
    assert nbytes == 2 * (2 * 16 * 32768 * 128 + 2 * 8 * 32768 * 128)


def test_k2_bytes_at_32k():
    # x in and y out (bf16) 2 x 268.4 MB, dt 8.4 MB, B and C 16.8 MB, the
    # fp32 state 2.1 MB, A 256 B: 564 MB
    _, nbytes = yardstick.k2_work(1, 64, 32768, 64, 1, 128)
    assert nbytes / 1e6 == pytest.approx(564.2, abs=0.1)


def test_mamba2_token():
    # per layer: in_proj 2048 x (2 x 4096 + 2 x 128 + 64), out_proj 4096 x
    # 2048 = 25.8M weights; x 48 layers x 2 = 2.48 GFLOP
    cfg = config("mamba2-1.3b")
    assert families.module(cfg).projection_params(cfg) == 25_821_184 * cfg["num_hidden_layers"]
    per_token = 2 * families.module(cfg).projection_params(cfg)
    assert per_token / 1e9 == pytest.approx(2.48, abs=0.005)


def test_prefill_flops_counts_attention_and_head():
    cfg = config("internlm2-1.8b")
    S = 32768
    want = (3.02e9 * S + 24 * 4.40e12 + 2 * 2048 * 92544)
    assert yardstick.prefill_flops(cfg, 1, S) == pytest.approx(want, rel=2e-3)
    assert yardstick.prefill_flops(cfg, 4, S) == 4 * yardstick.prefill_flops(cfg, 1, S)


def test_bound_is_the_larger_term():
    card = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert yardstick.bound_s(989e12, 0, card) == pytest.approx(1.0)
    assert yardstick.bound_s(1.0, 3.35e12, card) == pytest.approx(1.0)


def test_unknown_card_has_no_peaks():
    with pytest.raises(ValueError, match="no peaks"):
        yardstick.peaks("NVIDIA A100-SXM4-80GB")


@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_is_numpys(q):
    xs = np.random.default_rng(0).exponential(size=101).tolist()
    assert yardstick.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
    assert math.isclose(yardstick.percentile([3.0], q), 3.0)
