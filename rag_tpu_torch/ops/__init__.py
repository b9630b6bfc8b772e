"""Port of rag_tpu.ops (see the package docstring)."""
