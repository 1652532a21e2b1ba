from .api import build_embeddings, find_similar, load_inference_model
from .export import (
    export_embedder,
    export_from_config,
    export_retriever,
    export_retriever_from_config,
    load_embedder,
    load_retriever,
)
from .service import RetrievalService, ranked_query

__all__ = ["RetrievalService", "build_embeddings", "export_embedder",
           "export_from_config", "export_retriever",
           "export_retriever_from_config", "find_similar",
           "load_embedder", "load_inference_model", "load_retriever",
           "ranked_query"]
