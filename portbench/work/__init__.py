"""The yardstick's counts of work and the card's peaks.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense): 989 TFLOP/s bfloat16, 67 TFLOP/s float32 outside the tensor cores,
HBM at 3.35 TB/s; exponentials at the special-function units' 16 a clock
per SM (CUDA C++ Programming Guide, compute capability 9.0) x 132 SMs x
1.98 GHz. The same figures as `chip_smoke.py`'s bounds.
"""

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
FMA_PER_S = FP32_FLOP_PER_S / 2
HBM_BYTES_PER_S = 3.35e12
EXP_PER_S = 16 * 132 * 1.98e9
