"""The paper's Table 1 / Table 2 method grid on the port (``common``,
``table1``, ``table2``), run as ``python -m repro_torch.bench.table1``."""
