"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit; the power limit of the card a run used is
printed beside its numbers)."""

HBM_BYTES_PER_S = 3.35e12
# float32 operations per second outside the tensor cores; an FMA counts two.
FP32_OPS_PER_S = 67e12
# float32 instructions issued per second (132 SMs x 128 lanes x 1.98 GHz):
# an FMA, a min, a compare or a select is one instruction.
FP32_ISSUE_PER_S = FP32_OPS_PER_S / 2
