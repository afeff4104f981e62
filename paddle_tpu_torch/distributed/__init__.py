"""The port's training step (counterpart of paddle_tpu.distributed; one
device only so far)."""
