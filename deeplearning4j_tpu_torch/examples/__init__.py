"""Runnable examples (counterparts of the JAX package's ``examples/``
scripts, one module each, through the port's API).

    python -m deeplearning4j_tpu_torch.examples.<name> [--smoke] [--device cpu]

Each runs on the card unless ``--device cpu`` is given; ``--smoke``
shrinks it to a quick check. No example downloads anything: a dataset
fetcher that finds no local files uses its synthetic surrogate. The
distributed examples (``data_parallel_training``,
``parallel_transformer``, the second half of
``transformer_long_context``) read their world from the
``torch.distributed`` environment (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), one process per rank.
"""
