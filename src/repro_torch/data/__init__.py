from repro_torch.data.vectors import make_clustered_corpus, VectorDataset
from repro_torch.data.streams import make_query_stream

__all__ = ["make_clustered_corpus", "VectorDataset", "make_query_stream"]
