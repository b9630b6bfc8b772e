"""Port of rag_tpu.search (see the package docstring)."""
