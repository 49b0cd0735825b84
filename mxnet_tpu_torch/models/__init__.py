"""Models of the port: GPT and Llama (with their KV-cache decoding) and
BERT; the vision nets live in ``gluon.model_zoo``."""
from .bert import BERTConfig, BERTModel, bert_base, bert_large
from .convert import (arrays_from_port, bert_from_mxnet_tpu,
                      gpt_from_mxnet_tpu, llama_from_mxnet_tpu,
                      load_mxnet_tpu_arrays, resnet_from_mxnet_tpu)
from .decoding import decode_mode, decode_step_program, kv_generate
from .gpt import GPT, GPTConfig, gpt2_large, gpt2_medium, gpt2_small
from .llama import Llama, LlamaConfig, llama_7b, llama_tiny

__all__ = ["GPT", "GPTConfig", "gpt2_small", "gpt2_medium", "gpt2_large",
           "BERTConfig", "BERTModel", "bert_base", "bert_large",
           "Llama", "LlamaConfig", "llama_tiny", "llama_7b",
           "gpt_from_mxnet_tpu", "bert_from_mxnet_tpu",
           "llama_from_mxnet_tpu", "resnet_from_mxnet_tpu",
           "load_mxnet_tpu_arrays", "arrays_from_port", "kv_generate",
           "decode_mode", "decode_step_program"]
