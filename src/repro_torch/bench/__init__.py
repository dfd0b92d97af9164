"""The paper's Table 1 / Table 2 method grid (``common``, ``table1``,
``table2``) and the wire-format ablation (``format_ablation``) on the port,
run as ``python -m repro_torch.bench.table1`` and so on."""
