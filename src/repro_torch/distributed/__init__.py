"""SPMD over a ``torch.distributed`` process mesh: sharding rules, the
row-sharded constraint step and the counted collectives (DESIGN.md §6)."""
