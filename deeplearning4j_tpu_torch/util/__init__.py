"""Host utilities: checkpoint serialization, metrics, tracing, fault
injection, flight recorder, resilience primitives, and the training
substrate — ingest staging and the async fit loop (``ingest``), durable
snapshots and exact resume (``durable``), checkpoint recovery
(``recovery``) and step-function accounting (``xla``)."""
