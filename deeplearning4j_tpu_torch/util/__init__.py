"""Host utilities: checkpoint serialization, metrics, tracing, fault
injection, flight recorder and resilience primitives."""
