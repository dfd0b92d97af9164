"""The paper's Table 1 / Table 2 method grid (``common``, ``table1``,
``table2``), the wire-format ablation (``format_ablation``) and federated LM
fine-tuning (``fed_lm``) on the port, run as ``python -m
repro_torch.bench.table1`` and so on."""
