"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit), the card the port is measured on. The
bench's roofline stats and ``chip_smoke.py``'s kernel bounds read them
from here."""

# HBM bytes per second.
HBM_BYTES_PER_S = 3.35e12
# float32 operations per second outside the tensor cores (an FMA counts as
# two operations).
FP32_OPS_PER_S = 67e12
