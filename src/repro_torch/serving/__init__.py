"""Serving surfaces of the port: the retriever and the batch engine."""
from repro_torch.serving.engine import Request, RequestQueue, ServingEngine
from repro_torch.serving.generative_retrieval import GenerativeRetriever

__all__ = ["GenerativeRetriever", "ServingEngine", "RequestQueue", "Request"]
