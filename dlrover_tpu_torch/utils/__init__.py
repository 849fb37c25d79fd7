"""Profiling and meta-device utilities (port of ``dlrover_tpu/utils``:
``prof`` and ``meta_init``)."""
