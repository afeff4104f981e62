"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It imports torch and numpy, never jax and nothing of paddle_tpu.
"""
