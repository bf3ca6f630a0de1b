"""Frozen data generators, one module per generator name a configuration
file names (``"generator"``).  Each returns plain numpy tables
(:class:`treantbench.data.tables.Tables`) that both the program and the
reference are given."""
