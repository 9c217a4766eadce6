"""Model FLOPs of one forward pass of the ``schnet-force`` configuration at
a batch's real sizes, whatever implements it: every matmul as ``2 m n k``,
an elementwise operation as 1, an ``exp``, ``log`` or ``sqrt`` as 1 (the
shifted softplus as 4), gathers and the embedding lookup as 0. Padding is
not counted."""
from __future__ import annotations

SSP = 4  # shifted softplus: exp, add, log, subtract


def forward_flops(counts: dict, cfg: dict) -> float:
    m = cfg["model"]
    n, e, g = sum(counts["atoms"]), counts["edges"], counts["graphs"]
    u, bins, emb = m["units"], m["gauss_bins"], m["embedding_output_dim"]
    flops = 2 * n * emb * u + n * u                      # embed_to_units
    flops += e * 9                                       # r_i - r_j, |.|^2, sqrt
    flops += e * bins * 4                                # (d - c)^2 gamma, exp
    for _ in range(m["depth"]):
        flops += 2 * n * u * u                           # pre (no bias)
        flops += 2 * e * bins * u + e * u + e * u * SSP  # filter_1, bias, ssp
        flops += 2 * e * u * u + e * u                   # filter_2, bias
        flops += 2 * e * u                               # x_j * filter, the sum
        flops += 2 * n * u * u + n * u * (1 + SSP)       # post_1
        flops += 2 * n * u * u + n * u + n * u           # post_2, residual
    fan = u
    for w in m["last_mlp"]:
        flops += 2 * n * fan * w + n * w * (1 + SSP)
        fan = w
    flops += n * fan                                     # the sum over atoms
    for k, w in enumerate(m["output_mlp"]):
        flops += 2 * g * fan * w + g * w * (1 + (SSP if k < len(m["output_mlp"]) - 1 else 0))
        fan = w
    return float(flops)
