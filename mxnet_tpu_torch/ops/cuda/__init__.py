"""Hand-written CUDA kernels for Hopper, each beside its plain version:
flash attention (``attention``), the prologue-fused 1x1 convolution
(``conv_fused``), BatchNorm's training forward and backward
(``batch_norm``), the trainer's multi-tensor optimizer update
(``multi_tensor``), the generation engine's one-token decode attention
(``decode_attention``), the int8 tensor-core convolution and product of
the quantized operators (``int8_conv``) and non-maximum suppression's
keep mask (``box_nms``)."""
