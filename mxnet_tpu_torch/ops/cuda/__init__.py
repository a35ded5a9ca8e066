"""Hand-written CUDA kernels for Hopper, each beside its plain version:
flash attention (``attention``) and the prologue-fused 1x1 convolution
(``conv_fused``)."""
