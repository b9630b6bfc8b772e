"""Data and spatial parallelism over a torch.distributed process group
(counterpart of rag_tpu.parallel): ``mesh`` describes the world,
``axis`` reduces across it, ``halo`` exchanges the model axis's slab
rows, ``multihost`` starts it and feeds it, ``sharded`` and ``scaling``
build and time its steps."""
