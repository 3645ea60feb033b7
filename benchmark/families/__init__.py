"""Model families: one module each, named by a configuration's
``family``. A family gives the program's configuration (``port_conf``),
how each weight starts (``init``), the plain reference's loss and logits,
and ``REFERENCE_ROWS`` (rows the reference may take at a time, None for
the whole batch)."""
