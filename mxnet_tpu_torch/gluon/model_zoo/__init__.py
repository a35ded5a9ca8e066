"""Model zoo: BERT (``bert``) and the vision ResNets (``vision``)."""
from .bert import bert_base, bert_large, get_bert  # noqa: F401
from . import vision  # noqa: F401
