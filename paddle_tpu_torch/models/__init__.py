"""Models of the port: Llama's and GPT's training, serving and
``generate()`` paths, BERT's pretraining (a Paddle ``Layer`` model),
weight conversion from the JAX package and from HF checkpoints."""
from .bert import (BertConfig, BertEmbeddings, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_tiny)
from .convert import load_reference_state_dict, reference_state_dict
from .convert_hf import load_hf_bert, load_hf_gpt2, load_hf_llama
from .generation import GenerationMixin
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt3_1_3b, gpt_tiny
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_tiny

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt3_1_3b",
           "BertConfig", "BertEmbeddings", "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "bert_tiny", "bert_base",
           "load_reference_state_dict", "reference_state_dict",
           "load_hf_llama", "load_hf_gpt2", "load_hf_bert",
           "GenerationMixin"]
