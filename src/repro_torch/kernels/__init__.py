# Hand-written CUDA kernels (csrc/) behind device-dispatching entry points
# (ops.py), with their plain PyTorch versions in ref.py.
