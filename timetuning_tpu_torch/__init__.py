"""timetuning_tpu_torch — the PyTorch/CUDA port of timetuning_tpu.

A second package beside the JAX one, with the same layout and names
(``ops/ models/ data/ eval/ cli/``); the JAX package is the reference it is
held against. It imports torch and never jax. Every Pallas kernel of the
paths ported so far has a hand-written CUDA kernel for Hopper (``sm_90a``)
under ``csrc/``, built at first use (ops/kernel_lib) and launched only for
CUDA tensors; CPU tensors take each kernel's plain PyTorch version.

Ported so far: the training driver (``cli/train``), the clustering eval
(``cli/evaluate``), the DAVIS mask-propagation eval (``cli/propagate``), the
Pascal VOC linear probe (``cli/linear_probe``), and the ViT forward, the
TimeT train step, the augmentation and the loaders under them.
"""
