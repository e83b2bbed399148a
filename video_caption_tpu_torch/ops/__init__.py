"""Device ops of the port: the hand-written CUDA kernels of the caption path
(each beside its plain PyTorch version) and the prefix norm."""
