"""``python -m paddle_tpu_torch.distributed.launch`` (counterpart of
``python -m paddle_tpu.distributed.launch``; reference: python -m
paddle.distributed.launch) — alias of launch_mod."""
from .launch_mod import launch_collective, main  # noqa: F401

if __name__ == "__main__":
    main()
