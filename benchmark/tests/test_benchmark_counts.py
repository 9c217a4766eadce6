"""The frozen counts: they repeat exactly, and they match a hand count at
one small shape per kernel and per configuration; the kernel roofline
leaves out nothing the port launched."""
from __future__ import annotations

import types

import torch

from bench_helpers import ROOT
from benchmark.core import readers
from benchmark.core.spec import Spec, read_json
from benchmark.counts import peaks, schnet_force, work


def test_peaks_are_the_h100_data_sheets():
    assert peaks.BYTES_PER_S == 3.35e12
    assert peaks.F32_OPS_PER_S == 67e12


def test_segment_sum_hand_count():
    # 1000 x 4 float32 values into 10 rows: 4 (4000 + 40) + 4 1000 bytes, 4000 adds
    assert work.segment_sum_seconds(1000, 4, 10, 4) == max(20160 / 3.35e12, 4000 / 67e12)


def test_kernel_files_of_each_configuration():
    spec = Spec(ROOT)
    for entry in spec.data["configs"]:
        cfg = spec.config(entry["name"])
        assert cfg["kernels"], entry["name"]
        for name in cfg["kernels"]:
            k = spec.module("kernels", name)
            assert k.MODULE.startswith(readers.PORT_KERNELS + ".") and k.WRAPPER and k.KERNEL
    k = spec.module("kernels", "segment_sum")
    shapes = k.shapes(torch.zeros(1000, 4), torch.zeros(1000, dtype=torch.int32), 10)
    assert shapes == (1000, 4, 10, 4)
    assert k.least_seconds(shapes, {}) == work.segment_sum_seconds(1000, 4, 10, 4)


def _traced_obs(spec, uncovered):
    trace = types.SimpleNamespace(kernel_ns=lambda m: 10_000, kernel_count=lambda m: 1)
    return types.SimpleNamespace(
        mode="train", trace=trace, spec=spec, cfg={"kernels": ["segment_sum"]},
        extra={"kernel_launches": [("segment_sum", (1000, 4, 10, 4))],
               "uncovered_launches": uncovered})


def test_kernel_roofline_is_silent_where_a_launch_is_not_covered():
    spec = Spec(ROOT)
    got = readers.kernel_roofline(_traced_obs(spec, 0), "train")
    assert got == 100.0 * work.segment_sum_seconds(1000, 4, 10, 4) / 1e-5
    obs = _traced_obs(spec, 3)
    assert readers.kernel_roofline(obs, "train") is None
    assert "3 launches" in obs.extra["warnings"][0]


def test_schnet_forward_flops_hand_count():
    cfg = {"model": {"units": 2, "gauss_bins": 2, "embedding_output_dim": 2, "depth": 1,
                     "last_mlp": [2], "output_mlp": [1]}}
    counts = {"atoms": [2], "edges": 2, "graphs": 1}
    # embedding 20, distances 18, basis 16; the interaction: pre 16, filter_1
    # 36, filter_2 20, message and sum 8, post_1 36, post_2 and residual 24;
    # the last MLP 36, the sum over atoms 4, the output layer 5
    assert schnet_force.forward_flops(counts, cfg) == 239.0


def test_counts_repeat_exactly():
    cfg = read_json(ROOT / "benchmark" / "configs" / "schnet-force.json")
    counts = {"atoms": [21] * 32, "edges": 10080, "graphs": 32}
    assert schnet_force.forward_flops(counts, cfg) == schnet_force.forward_flops(dict(counts), cfg)
    assert work.segment_sum_seconds(10080, 128, 673, 4) == work.segment_sum_seconds(10080, 128, 673, 4)
