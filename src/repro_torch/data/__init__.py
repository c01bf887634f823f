"""Synthetic corpora, the cold-start split, the sharded batcher and the GNN
fanout sampler: numpy copies of ``repro.data`` (their arrays equal the
reference's bit for bit under one seed)."""
from repro_torch.data.amazon import ColdStartData, make_cold_start_dataset
from repro_torch.data.graph_sampler import CSRGraph, fanout_sample, random_graph
from repro_torch.data.loader import ShardedBatcher
from repro_torch.data.synthetic import make_item_corpus, make_user_sequences

__all__ = ["ColdStartData", "make_cold_start_dataset", "ShardedBatcher",
           "make_item_corpus", "make_user_sequences", "CSRGraph",
           "fanout_sample", "random_graph"]
