from .api import build_embeddings, find_similar, load_inference_model
from .service import RetrievalService, ranked_query

__all__ = ["RetrievalService", "build_embeddings", "find_similar",
           "load_inference_model", "ranked_query"]
