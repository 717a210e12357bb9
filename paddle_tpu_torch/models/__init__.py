"""Models of the port: Llama's serving path, GPT's training path, BERT's
pretraining (a Paddle ``Layer`` model), and weight conversion from the
JAX package."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_tiny)
from .convert import load_reference_state_dict
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt3_1_3b, gpt_tiny
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_tiny

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt3_1_3b",
           "BertConfig", "BertEmbeddings", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_tiny", "bert_base",
           "load_reference_state_dict"]
