"""fluid.io (counterpart of paddle_tpu/fluid/io.py; reference:
python/paddle/fluid/io.py)."""
from ..io.dataloader import DataLoader  # noqa: F401
from ..static import load_inference_model, save_inference_model  # noqa: F401
from ..static.compat import load, load_program_state, save, set_program_state  # noqa: F401
