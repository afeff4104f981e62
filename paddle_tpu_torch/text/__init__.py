"""Text models and generation (counterpart of paddle_tpu.text): BERT, GPT,
Llama and generation, greedy or sampled."""
from . import generation, models  # noqa: F401
from .generation import generate, llama_generate  # noqa: F401
from .models import BertForPretraining, BertModel, GPTModel, LlamaModel  # noqa: F401
