"""Port of rag_tpu.metrics (see the package docstring)."""
