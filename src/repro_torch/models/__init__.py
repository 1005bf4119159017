"""The LM substrate's models: ``layers`` (norms, rotary variants, GQA
attention, MLPs), ``transformer`` (the dense decoder family) and
``registry`` (architecture id -> config and family functions)."""
