"""The frozen counts against hand counts at the two cells' shapes."""

import pytest

from portbench import counts, harness
from portbench.reference import family


def _cell(name):
    return harness.load_cell(name)


def test_params_per_agent_match_the_port():
    """One agent's parameters from each reference layout, against the
    published-width counts and the port's own parameter tree for the
    configuration as it is run."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_flatten_with_path

    want = {"mamba2-2.7b.train.k4-q09": 1_415_669_760,
            "mistral-7b.train.text4k": 2_007_044_096}
    for name, n in want.items():
        config = _cell(name)["config"]
        layout = family(config["family"]).layout(config["model"])
        assert counts.param_count(layout) == n
        port = {"/".join(p): tuple(x.shape) for p, x in
                tree_flatten_with_path(tf.param_specs(
                    ModelConfig(**config["model"])))}
        assert port == {p: tuple(s) for p, s, _, _ in layout}


def test_block_flops_by_hand():
    m = _cell("mamba2-2.7b.train.k4-q09")
    # 32 layers x (2560 x 10576 + 5120 x 2560) + the tied head 50288 x 2560
    per_pos = 6 * (32 * (2560 * 10576 + 5120 * 2560) + 50288 * 2560) \
        + 6 * 32 * 2 * 2 * 2560 * (128 + 128) // 64
    assert counts.block_flops(m["config"]["model"], m["traffic"]) \
        == 4 * 2 * 1024 * per_pos
    s = _cell("mistral-7b.train.text4k")
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336
    per_seq = (6 * 8 * layer * 4096 + 6 * 4096 * 32000 * 4096
               + 6 * 8 * 32 * 128 * 4096 * 4096)
    assert counts.block_flops(s["config"]["model"], s["traffic"]) \
        == 2 * 2 * per_seq
    # about 8.5 GFLOP a position (mamba2) and 12.1 (mistral)
    assert 8.4e9 < per_pos < 8.6e9
    assert 12.0e9 < per_seq / 4096 < 12.1e9


def test_a_prefix_counts_through_the_decoder_but_not_in_the_head():
    s = _cell("mistral-7b.train.text4k")
    model, traffic = s["config"]["model"], s["traffic"]
    short = dict(traffic, seq=1024)
    prefixed = dict(short, image_positions=3072)
    head = 2 * 2 * 6 * 4096 * 32000 * 3072
    assert counts.block_flops(model, prefixed) \
        == counts.block_flops(model, traffic) - head


def test_kernel_bounds_by_hand():
    flops, nbytes, peak = counts.flash_attention(1, 4096, 32, 8, 128)
    assert flops == 4 * 32 * (4096 * 4097 // 2) * 128
    assert nbytes == 2 * (2 * 4096 * 32 * 128 + 2 * 4096 * 8 * 128)
    assert peak == "bfloat16"
    assert counts.bound_s(flops, nbytes, peak) == pytest.approx(1.390e-4,
                                                               rel=1e-3)
    flops, nbytes, peak = counts.ssd_intra_chunk(1, 1024, 80, 64, 128, 128)
    assert nbytes == 4 * (2 * 1024 * 80 * 64 + 2 * 1024 * 80
                          + 8 * 80 * 64 * 128) + 2 * 2 * 1024 * 128
    assert flops == 2 * 8 * 8256 * 128 + 2 * 80 * 8 * (8256 * 64
                                                       + 128 * 64 * 128)
    assert counts.bound_s(flops, nbytes, peak) == pytest.approx(1.91e-5,
                                                               rel=1e-2)
    M = 1_415_669_760
    flops, nbytes, peak = counts.diffusion_mix(4, M)
    assert nbytes == 4 * 2 * 4 * M + 4 * (16 + 4)
    assert flops == 2 * 16 * M
    assert counts.bound_s(flops, nbytes, peak) == nbytes / 3.35e12
    assert counts.bound_s(flops, nbytes, peak) == pytest.approx(1.352e-2,
                                                               rel=1e-3)
