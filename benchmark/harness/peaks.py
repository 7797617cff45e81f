"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit): float32 and float64 outside the tensor cores, float64 on
the tensor cores, and HBM3's bytes a second. A cosine on the special-function
units issues at 16 a clock an SM against 128 float32 lanes, so one counts as
8 float32 operations."""

F32_FLOPS = 67e12
F64_FLOPS = 34e12
F64_TC_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
COS_FLOPS = 8
