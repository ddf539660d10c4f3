"""User-facing scripts of the port: the demo (``python -m
realism_effects_tpu_torch.tools.demo``), the option sweep
(``tools.option_sweep``) and the live debug GUI (``tools.debug_gui``).
Each runs on ``cuda`` unless ``--device cpu`` is given."""
