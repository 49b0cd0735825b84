"""Models of the port: GPT and Llama (with their KV-cache decoding),
BERT and the Transformer seq2seq; the vision nets live in
``gluon.model_zoo``."""
from .bert import BERTConfig, BERTModel, bert_base, bert_large
from .convert import (arrays_from_port, bert_from_mxnet_tpu,
                      gpt_from_mxnet_tpu, llama_from_mxnet_tpu,
                      load_mxnet_tpu_arrays, resnet_from_mxnet_tpu,
                      seq2seq_from_mxnet_tpu)
from .decoding import decode_mode, decode_step_program, kv_generate
from .gpt import GPT, GPTConfig, gpt2_774m, gpt2_large, gpt2_medium, \
    gpt2_small
from .llama import Llama, LlamaConfig, llama_7b, llama_tiny
from .seq2seq import (CrossAttention, Seq2SeqConfig, Seq2SeqDecoder,
                      Seq2SeqDecoderCell, Seq2SeqEncoder, TransformerSeq2Seq,
                      transformer_big)
from .transformer import (MultiHeadAttention, PositionwiseFFN,
                          TransformerDecoderCell, TransformerEncoderCell)

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "TransformerDecoderCell",
           "GPT", "GPTConfig", "gpt2_small", "gpt2_medium", "gpt2_large",
           "gpt2_774m",
           "BERTConfig", "BERTModel", "bert_base", "bert_large",
           "Llama", "LlamaConfig", "llama_tiny", "llama_7b",
           "gpt_from_mxnet_tpu", "bert_from_mxnet_tpu",
           "llama_from_mxnet_tpu", "resnet_from_mxnet_tpu",
           "load_mxnet_tpu_arrays", "arrays_from_port", "kv_generate",
           "decode_mode", "decode_step_program", "TransformerSeq2Seq",
           "Seq2SeqConfig", "Seq2SeqEncoder", "Seq2SeqDecoder",
           "Seq2SeqDecoderCell", "CrossAttention", "transformer_big",
           "seq2seq_from_mxnet_tpu"]
