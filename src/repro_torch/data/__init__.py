from repro_torch.data.vectors import make_clustered_corpus, VectorDataset
from repro_torch.data.pipeline import TokenPipeline, make_token_pipeline
from repro_torch.data.streams import make_query_stream

__all__ = ["make_clustered_corpus", "VectorDataset", "TokenPipeline",
           "make_token_pipeline", "make_query_stream"]
