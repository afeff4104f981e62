"""Text models, generation and datasets (counterpart of paddle_tpu.text):
BERT, GPT, Llama, generation greedy or sampled, and the text datasets.
``ragged`` holds the sequence ops of ``static.nn``."""
from . import datasets, generation, models, ragged  # noqa: F401
from .datasets import (  # noqa: F401
    Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16,
)
from .generation import generate, llama_generate  # noqa: F401
from .models import BertForPretraining, BertModel, GPTModel, LlamaModel  # noqa: F401
