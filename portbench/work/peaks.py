"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A share of a peak is stated against these,
with the card's power limit printed beside it."""

PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BF16_TC = 989e12      # bf16 tensor cores
PEAK_TF32_TC = 495e12      # TF32 tensor cores
# float32-exact products on tensor cores: 3xTF32, three TF32 products each
PEAK_F32_EXACT_TC = PEAK_TF32_TC / 3
PEAK_BYTES = 3.35e12       # HBM3
