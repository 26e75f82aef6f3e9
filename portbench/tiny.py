"""Tiny widths of the configurations, for the CPU tests: the same networks
and paths at a size a test run holds (the program runs its plain versions
in f32 there)."""

from __future__ import annotations

import copy

import torch

from portbench import harness

DOWN = ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"]


def config(prediction_type: str = "epsilon", act: str = "quick_gelu") -> dict:
    return {"unet": {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64, 64],
                     "attention_head_dim": [2, 4, 4, 4], "cross_attention_dim": 24,
                     "down_block_types": DOWN, "layers_per_block": 2, "norm_num_groups": 32,
                     "norm_eps": 1e-5, "t_embed_dim": 16},
            "text": {"vocab_size": 49408, "hidden_size": 24, "intermediate_size": 48,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "max_position_embeddings": 77, "hidden_act": act, "layer_norm_eps": 1e-5},
            "vae": {"in_channels": 3, "out_channels": 3, "latent_channels": 4,
                    "base_channels": 32, "ch_mult": [1, 1, 1, 1], "norm_eps": 1e-6},
            "prediction_type": prediction_type, "resolution": 64, "dtype": "float32"}


def spec(cell: str, **config_kw):
    """``cell``'s spec from ``BENCHMARK.json`` at tiny widths and short traffic."""
    s = harness.cell_spec(cell)
    s.config = config(**config_kw)
    tr = copy.deepcopy(s.traffic)
    if tr["driver"] == "serve":
        tr.update(steps=2, check_requests=2, trace_requests=2, warmup_requests=1)
        if tr.get("rate"):
            tr["rate"] = 20.0
    else:
        tr.update(batch=12, rank=4, alpha=4, trace_steps=2)  # halves of 6: row blocks of 4 and 2
    s.traffic = tr
    return s


def run(s, *, seed: int = 2 ** 33 + 7, seconds: float = 0.5) -> dict:
    """One run of ``s`` on the CPU, the harness's look for a chip skipped."""
    import time

    return harness.run_cell(s, seed=seed, seconds=seconds, trace=False,
                            device=torch.device("cpu"), impl="torch", dtype=torch.float32,
                            t0=time.perf_counter())
