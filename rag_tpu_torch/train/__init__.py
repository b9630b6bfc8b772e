"""Port of rag_tpu.train (see the package docstring)."""
