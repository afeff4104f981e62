"""``python -m paddle_tpu_torch.distributed.fleet.launch`` (counterpart of
``python -m paddle_tpu.distributed.fleet.launch``; reference:
fleet/launch.py:215 launch_collective) — alias of the shared launcher."""
from ..launch_mod import launch_collective, main  # noqa: F401

if __name__ == "__main__":
    main()
