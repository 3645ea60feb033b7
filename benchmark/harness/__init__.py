"""The benchmark harness of ``deeplearning4j_tpu_torch``: one run of one
cell of ``BENCHMARK.json`` (``benchmark/run.py``). Everything here is the
yardstick; the program under test is only imported, never changed."""
