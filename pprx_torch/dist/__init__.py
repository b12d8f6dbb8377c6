"""Row-sharded engines on ``torch.distributed`` (port of ``pprx.dist``).

One process per shard of a ``rows x srcs`` mesh (``mesh.make_row_mesh``),
each holding its own block of the state; ``init.init_distributed`` starts
the process group (NCCL for the card, gloo for the CPU).
"""
