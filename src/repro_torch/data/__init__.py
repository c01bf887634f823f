"""Synthetic corpora, the cold-start split and the sharded batcher: numpy
copies of ``repro.data`` (their arrays equal the reference's bit for bit
under one seed)."""
from repro_torch.data.amazon import ColdStartData, make_cold_start_dataset
from repro_torch.data.loader import ShardedBatcher
from repro_torch.data.synthetic import make_item_corpus, make_user_sequences

__all__ = ["ColdStartData", "make_cold_start_dataset", "ShardedBatcher",
           "make_item_corpus", "make_user_sequences"]
