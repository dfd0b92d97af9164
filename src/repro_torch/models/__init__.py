"""Models of the port: ``small`` (MLP, LeNet, KWT) and the dense LM
(``common``, ``attention``, ``transformer``, ``registry``)."""
