from .api import load_inference_model
from .service import RetrievalService, ranked_query

__all__ = ["RetrievalService", "load_inference_model", "ranked_query"]
