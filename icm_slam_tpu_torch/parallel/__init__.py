"""Multi-rank execution of the port on ``torch.distributed``.

Port of ``icm_slam_tpu.parallel``: the process-group bring-up
(``distributed``), the fleet and time meshes with the rank-local blocks
the engines take (``mesh``), and the GPipe stage pipeline (``pipeline``).
Every rank runs the same program on its own block; the cross-rank pieces
are ``all_gather``s summed in rank order, so every rank holds the same
bits.
"""
