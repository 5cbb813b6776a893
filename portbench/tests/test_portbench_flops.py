"""The frozen formulas equal the program's ``repro_torch.launch.flops`` at
the cell's shapes today, and the model's FLOPs a step (``mfu_pct``'s count)
equal 6 N T plus the SSD's work worked out by hand."""
import pytest

from portbench.bench import flops as FL
from portbench.bench import layout


@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_formulas_equal_the_programs(chunk):
    from repro_torch.launch import flops as P

    args = (4, 2048, 80, 64, 128, chunk, 1)
    assert FL.ssd_product_flops(*args) == P.ssd_product_flops(*args)
    assert FL.ssd_flops(*args) == P.ssd_flops(*args)
    assert FL.ssd_bwd_product_flops(*args) == P.ssd_bwd_product_flops(*args)
    assert FL.ssd_bwd_flops(*args) == P.ssd_bwd_flops(*args)
    assert FL.PEAK_FLOPS == P.PEAK_FLOPS and FL.HBM_BYTES_PER_S == P.HBM_BYTES_PER_S


def _model(config, traffic):
    c = layout.load_json("configs", config)
    t = layout.load_json("traffic", traffic)
    return layout.load_module("families", c["family"]), c["model"], t["batch"], t["seq"]


def test_mamba2_model_flops_by_hand():
    fam, m, B, S = _model("mamba2-2.7b", "train.b4.s2048")
    assert (B, S) == (4, 2048)
    d, di, H, P, N, V, L = 2560, 5120, 80, 64, 128, 50288, 64
    Nmat = L * (d * (2 * di + 2 * N + H) + di * d) + d * V
    # SSD forward at chunk 128: per chunk of q = 128, C.B^T q(q+1) N, W x q(q+1) P a head,
    # C h and the state update 2 q N P a head each
    q, chunks = 128, B * S // 128
    fwd = chunks * (q * (q + 1) * N + H * q * (q + 1) * P + 2 * H * 2 * q * N * P)
    # backward at chunk 64: C.B^T, G, W dy, dB and dC on the causal half, and four state
    # terms 2 N P a token and head (the fifth, the recomputed forward state, is not counted)
    q, chunks = 64, B * S // 64
    tri = chunks * q * (q + 1)
    bwd = tri * N + 2 * H * tri * P + 2 * H * tri * N + 4 * H * B * S * 2 * N * P
    assert fam.model_flops(m, B, S) == pytest.approx(6 * Nmat * B * S + L * (fwd + bwd),
                                                     rel=1e-12)
