"""Device milliseconds a step in kernels that are neither cuBLAS /
cuDNN nor the port's hand-written kernels: PyTorch's elementwise,
reduction, layout and cast kernels (jitter and normalisation, autocast
casts, BatchNorm and activations outside cuDNN, their backward, the
optimizer's multi-tensor updates)."""

HAND = (r"stem_kernel|(?<![a-z0-9_])bottleneck_kernel|bridge_kernel|"
        r"dark_decode_kernel|int8_bottleneck_kernel|int8_deconv_kernel|"
        r"warp_kernel|flash_attention_kernel|flash_attention_dq_kernel|"
        r"flash_attention_dkv_kernel")
LIBRARY = (r"gemm|gemv|xmma|cutlass|nvjet|cudnn|cublas|implicit_convolve|"
           r"convolve|dgrad|wgrad|fprop|splitk|winograd|sm90_|sm80_|"
           r"conv2d|convolution")


def read(s):
    t = s.device_s_excluding(HAND, LIBRARY)
    return 1e3 * t / s.iters if t > 0 else None
