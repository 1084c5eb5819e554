"""FLOP and byte counts against small shapes worked by hand."""
from __future__ import annotations

import pytest

from hemtbench.counts import causal_pairs, dense, roofline_s, ssm

DENSE = {"num_hidden_layers": 1, "hidden_size": 4, "intermediate_size": 8,
         "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2, "vocab_size": 10}
SSM = {"n_layer": 1, "d_model": 4, "vocab_size": 10,
       "ssm_cfg": {"expand": 2, "headdim": 4, "d_state": 3, "ngroups": 1, "d_conv": 2}}


def test_causal_pairs():
    assert [causal_pairs(s) for s in (1, 2, 3, 4)] == [1, 3, 6, 10]


def test_dense_prefill_flops():
    # per token 2 (q 4x4 + k, v 2 x 4x2 + o 4x4 + mlp 3 x 4x8) = 288; attention
    # 4 x 2 heads x 2 dims x 6 pairs = 96; head 2 x 4 x 10 = 80; two rows
    assert dense.prefill_flops(DENSE, 2, 3) == 2 * (3 * 288 + 96 + 80)


def test_flash_cost():
    # 4 x b 2 x hq 2 x d 2 x 6 pairs; q and o (2 heads) and k, v (1 head)
    # of 2 x 3 x 2 bf16 each
    assert dense.flash_cost(DENSE, 2, 3) == (192.0, 2.0 * 2 * 3 * 2 * (2 * 2 + 2 * 1))


def test_ssm_prefill_flops():
    # d_in 8, 2 heads of 4, state 3: in_dim 2 x 8 + 2 x 3 + 2 = 24; per token
    # 2 (4 x 24 + 8 x 4) + 2 x 2 x (8 + 6) = 312; the core 2 heads x 5 x 3 x 4
    assert ssm.ssd_flops(SSM, 1, 5) == 5 * 120
    assert ssm.prefill_flops(SSM, 1, 5) == 5 * 312 + 5 * 120 + 2 * 4 * 10


def test_ssd_cost():
    # per token: x in and y out (bf16, 8 wide), B and C (bf16, 3), dt (fp32, 2
    # heads); A (2 x fp32) once; the final state 2 x 4 x 3 fp32
    assert ssm.ssd_cost(SSM, 1, 5) == (600.0, 5 * (32 + 12 + 8) + 8 + 96.0)


def test_roofline_takes_the_larger_bound():
    assert roofline_s((2e12, 1e9), 1e12, 1e9) == pytest.approx(2.0)
    assert roofline_s((1e12, 3e9), 1e12, 1e9) == pytest.approx(3.0)


def test_each_family_names_its_kernels():
    assert set(dense.kernels(DENSE)) == {"flash_attention"}
    assert dense.kernels(DENSE)["flash_attention"][0] == 1
    assert set(ssm.kernels(SSM)) == {"ssd_scan"}
