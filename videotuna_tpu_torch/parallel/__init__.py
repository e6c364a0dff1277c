"""Parallelism of the port over ``torch.distributed``: sequence (Ulysses,
ring), FSDP2 sharding and DTensor tensor parallelism on the mesh of
``core/mesh.py``."""
