"""Hand-written CUDA kernels for Hopper, each beside its plain version:
flash attention (``attention``), the prologue-fused 1x1 convolution
(``conv_fused``) and BatchNorm's training forward and backward
(``batch_norm``)."""
