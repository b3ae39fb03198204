"""Model zoo of the PyTorch port: BERT on the port's Gluon blocks, and the
Llama family as ``torch.nn.Module``s."""

from . import bert
from . import llama
from .bert import BERTModel, bert_12_768_12, bert_24_1024_16, get_bert_model

__all__ = ['bert', 'llama', 'BERTModel', 'bert_12_768_12', 'bert_24_1024_16',
           'get_bert_model']
