"""Port of rag_tpu.continual (see the package docstring)."""
