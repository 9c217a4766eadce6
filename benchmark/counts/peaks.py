"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit): a frozen copy of ``chip_smoke.py``'s."""

BYTES_PER_S = 3.35e12          # HBM3
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
