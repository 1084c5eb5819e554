"""Cells of the benchmark cut to CPU size for the tests: the same files,
with every width and length made tiny, and limits of their own.

The limits are set as a cell's are, from readings at this size on the
CPU over ten seeds (2**31 + 9, 5, 77, 2**33 + 1, 12-17): the bf16 port's
largest (lower) and the fp8-e4m3 control's smallest (upper). Dense:
``logit_err`` 0.0050 and 0.0367; ``gap_max`` 0 and 0 (the folded logits
are small at this width, and both sides pick the reference's best), so
the control fails by ``logit_err`` alone. SSM: ``gap_max`` 0.031 and 0.225,
``logit_err`` 0.014 and 0.125."""
from __future__ import annotations

import copy

from hemtbench import bench

DENSE = {"num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "vocab_size": 256, "max_position_embeddings": 128, "attention_multiplier": 0.25}
DENSE_PORT = {"n_layers": 2, "d_model": 64, "d_ff": 128, "vocab_size": 256, "max_seq_len": 128,
              "attention": {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
                            "rope_theta": 10000.0, "scale": 0.25}}
SSM = {"n_layer": 2, "d_model": 64, "vocab_size": 256}
SSM_CFG = {"d_state": 16, "headdim": 16, "chunk_size": 16}
SSM_PORT = {"n_layers": 2, "d_model": 64, "vocab_size": 256, "max_seq_len": 128,
            "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2, "conv_width": 4,
                    "chunk": 16, "n_groups": 1}}
LIMITS = {"dense": {"gap_max": 0.02, "logit_err": 0.015},
          "ssm": {"gap_max": 0.09, "logit_err": 0.04}}
TRAFFIC = {"requests_per_round": 6, "prompt_lengths": [8, 16, 24, 40], "output_len": 4,
           "check_requests": 24}


def spec(family: str, dtype: str = "bfloat16") -> dict:
    name = {"dense": "granite-3-8b.long-prompt", "ssm": "mamba2-2.7b.long-prompt"}[family]
    return cell(name, dtype=dtype).spec


def cell(name: str, trace: bool = False, dtype: str = "bfloat16") -> bench.Cell:
    c = bench.cell(bench.load_benchmark(), name, trace)
    s = copy.deepcopy(c.spec)
    if s["family"] == "dense":
        s.update(DENSE)
        s["port"].update(copy.deepcopy(DENSE_PORT))
    else:
        s.update(SSM)
        s["ssm_cfg"].update(SSM_CFG)
        s["port"].update(copy.deepcopy(SSM_PORT))
    s["dtype"] = s["port"]["dtype"] = dtype
    c.spec = s
    c.traffic = {**c.traffic, **TRAFFIC}
    c.limits = dict(LIMITS[s["family"]])
    return c
