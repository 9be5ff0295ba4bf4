"""Device compute: the packed pool layout, bitwise folds, and the CUDA
count kernels with their plain PyTorch versions."""
