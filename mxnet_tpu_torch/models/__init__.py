"""Models of the port: GPT and its KV-cache decoding."""
from .convert import gpt_from_mxnet_tpu
from .decoding import kv_generate
from .gpt import GPT, GPTConfig, gpt2_large, gpt2_medium, gpt2_small

__all__ = ["GPT", "GPTConfig", "gpt2_small", "gpt2_medium", "gpt2_large",
           "gpt_from_mxnet_tpu", "kv_generate"]
