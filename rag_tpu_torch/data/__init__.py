"""Port of rag_tpu.data (see the package docstring)."""
