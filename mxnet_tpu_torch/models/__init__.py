"""Models of the port: GPT (with its KV-cache decoding) and BERT."""
from .bert import BERTConfig, BERTModel, bert_base, bert_large
from .convert import arrays_from_port, bert_from_mxnet_tpu, gpt_from_mxnet_tpu
from .decoding import kv_generate
from .gpt import GPT, GPTConfig, gpt2_large, gpt2_medium, gpt2_small

__all__ = ["GPT", "GPTConfig", "gpt2_small", "gpt2_medium", "gpt2_large",
           "BERTConfig", "BERTModel", "bert_base", "bert_large",
           "gpt_from_mxnet_tpu", "bert_from_mxnet_tpu", "arrays_from_port",
           "kv_generate"]
