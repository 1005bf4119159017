"""The LM substrate's models: ``layers`` (norms, rotary variants, GQA
attention, MLPs, stacked layers), the families ``transformer`` (dense
decoders, and with ``moe`` mixtures of experts), ``ssm`` (Mamba2),
``hybrid`` (zamba2) and ``encdec`` (seamless-m4t), and ``registry``
(architecture id -> config and family functions)."""
