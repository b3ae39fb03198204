"""Model zoo of the PyTorch port, on its Gluon blocks: the vision zoo
(``vision``, with ``get_model``), BERT and the Llama family."""

from . import vision
from . import bert
from . import llama
from .vision import get_model
from .bert import BERTModel, bert_12_768_12, bert_24_1024_16, get_bert_model

__all__ = ['vision', 'bert', 'llama', 'get_model', 'BERTModel',
           'bert_12_768_12', 'bert_24_1024_16', 'get_bert_model']
