"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates): the roofline's denominators."""
F32_FLOPS = 67e12          # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12        # HBM3, bytes/s
