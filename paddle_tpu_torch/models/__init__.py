"""Models of the port: Llama's serving path, and weight conversion from
the JAX package."""
from .convert import load_reference_state_dict
from .llama import LlamaConfig, LlamaForCausalLM, LlamaModel, llama_tiny

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "load_reference_state_dict"]
