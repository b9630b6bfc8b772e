"""Data parallelism over a torch.distributed process group (counterpart
of rag_tpu.parallel): ``mesh`` describes the world, ``axis`` reduces
across it, ``multihost`` starts it and feeds it, ``sharded`` and
``scaling`` build and time its steps."""
