"""Networks: the configuration DSL (``conf``), layers and the graph runtime."""
