"""``ray_tpu_torch.ops`` — the port's kernels and their plain versions.

Each kernel module exposes a wrapper that launches a hand-written CUDA
kernel on CUDA tensors and runs its plain PyTorch version on CPU
tensors, plus the kernel object whose ``launches`` counts launches.
"""
