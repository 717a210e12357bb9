"""Models of the port: Llama's serving path, GPT's training path, and
weight conversion from the JAX package."""
from .convert import load_reference_state_dict
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt3_1_3b, gpt_tiny
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_tiny

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny", "gpt3_1_3b",
           "load_reference_state_dict"]
