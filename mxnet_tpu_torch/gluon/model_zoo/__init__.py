"""Model zoo: BERT (``bert``), GPT (``gpt``, with ``generation``), the
encoder-decoder Transformer (``transformer``, with
``transformer_generation``) and the vision ResNets (``vision``)."""
from .bert import bert_base, bert_large, get_bert  # noqa: F401
from .gpt import GPTBlock, GPTModel, get_gpt, gpt2_124m  # noqa: F401
from . import transformer  # noqa: F401
from .transformer import TransformerModel, get_transformer  # noqa: F401
from . import vision  # noqa: F401
