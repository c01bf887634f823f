"""Serving surfaces of the port."""
from repro_torch.serving.generative_retrieval import GenerativeRetriever

__all__ = ["GenerativeRetriever"]
