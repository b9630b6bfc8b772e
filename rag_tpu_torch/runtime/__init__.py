"""The port's native data plane (see runtime.native)."""
