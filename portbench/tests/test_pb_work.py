"""The yardstick's counts against values worked by hand at small
shapes."""

import pytest

from portbench.work import counts, model
from portbench.work.peaks import (
    PEAK_BYTES,
    PEAK_F32_EXACT_TC,
    PEAK_F32_FLOPS,
)

SMALL = dict(n=2, h=1, m=2, b=1, a_batch=1, stream_bytes=4)


def test_cell_flops_by_hand():
    # diffusions 2*(m-1)*n^2*(2h+d) = 2*2*4*3; products 2*n*(md+mh)*3h
    assert counts.cell_fwd_flops(n=2, h=1, d=1, m=3) == 48 + 72


def test_proj_by_hand():
    # rows = t*b*n = 2; diffusion 2*(m-1)*n^2*d*t*b = 8; product
    # 2*rows*m*d*3h = 24; bytes: x 8, Wx 24, operators 32, projection 24
    assert counts.proj_work(t=1, d=1, **SMALL) == (0.0, 88.0, 32.0,
                                                   PEAK_F32_EXACT_TC)


def test_loop_by_hand():
    # per step 2*(2*(m-1)*n^2*h) + 2*n*m*h*3h = 16 + 24; bytes: weights
    # and biases (6 + 3)*4, projection 2*3*4, operators 32, h0 8, h_seq 8
    assert counts.loop_work(t=1, **SMALL) == (0.0, 36.0 + 24 + 32 + 8 + 8,
                                              40.0, PEAK_F32_EXACT_TC)


def test_dw_and_dx_by_hand():
    # dW: rows 2; diffusion 2*1*4*(1+2)=24; products 2*2*(6+4+2)=48; db
    # sums rows*3h = 6; bytes: features 2*3*4, dpre 2*3*4, operators 32,
    # dW (2+2)*3+3 = 15 floats
    assert counts.dw_size(2, 1, 1) == 15
    assert counts.dw_work(t=1, d=1, **SMALL) == (6.0, 24 + 24 + 32 + 60,
                                                 72.0, PEAK_F32_EXACT_TC)
    # dx: diffusion 2*1*4*3 = 24; product 2*2*3*2 = 24; bytes dpre 24,
    # Wx 24, operators 32, dx 8
    assert counts.dx_work(t=1, d=1, **SMALL) == (0.0, 88.0, 48.0,
                                                 PEAK_F32_EXACT_TC)


def test_bound_takes_the_larger_of_operations_and_bytes():
    ms, by = counts.bound_ms([(PEAK_F32_FLOPS * 1e-3, PEAK_BYTES * 2e-3)])
    assert by == "bytes" and ms == pytest.approx(2.0)
    ms, by = counts.bound_ms([(0.0, 0.0, PEAK_F32_EXACT_TC * 3e-3,
                               PEAK_F32_EXACT_TC), (PEAK_F32_FLOPS * 1e-3,
                                                    0.0)])
    assert by == "operations" and ms == pytest.approx(4.0)


def test_reduce_by_hand():
    assert counts.reduce_work(3, 5) == (15.0, 80.0)


DETECT = {"task": "detection", "graph_type": "combined", "num_nodes": 19,
          "rnn_units": 64, "max_diffusion_step": 2, "max_seq_len": 60,
          "output_seq_len": 12, "dtype": "float32", "input_dim": 100,
          "output_dim": 100, "num_rnn_layers": 2, "num_classes": 1}


def test_detector_flops_by_hand():
    # a clip-step: layer 0 2*2*361*228 + 2*19*492*192 = 3,918,864; layer 1
    # 2*2*361*192 + 2*19*384*192 = 3,078,912; 60 steps; head 2*19*64
    want = (3_918_864 + 3_078_912) * 60 + 2 * 19 * 64
    assert model.fwd_flops_per_clip(DETECT) == want
    assert model.train_flops_per_clip(DETECT) == 3 * want


def test_ssl_flops_by_hand():
    cfg = dict(DETECT, task="SS pre-training", num_rnn_layers=3)
    enc = (3_918_864 + 2 * 3_078_912) * 60
    dec = (3_918_864 + 2 * 3_078_912 + 2 * 19 * 64 * 100) * 12
    assert model.fwd_flops_per_clip(cfg) == enc + dec


def test_work_items_per_step():
    assert len(model.dcgru_work(DETECT, 128, train=False)) == 4
    # per layer: projection, loop, backward loop, dW; dx for layer 1
    assert len(model.dcgru_work(DETECT, 128, train=True)) == 9
    ssl = dict(DETECT, task="SS pre-training", num_rnn_layers=3)
    # encoder 3*4 + 2 dx; decoder forward, loop, 2 dW, dWp
    assert len(model.dcgru_work(ssl, 128, train=True)) == 19
    shared = model.dcgru_work(DETECT, 4, train=False)[0][1]
    per_clip = model.dcgru_work(dict(DETECT, graph_type="individual"), 4,
                                train=False)[0][1]
    assert per_clip > shared  # one operator stack a clip
