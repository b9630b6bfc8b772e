"""Port of rag_tpu.models (see the package docstring)."""
