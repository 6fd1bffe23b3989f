"""The repository's example entry points, ported to the card.

Port of ``examples/``: each module runs as
``PYTHONPATH=src python -m repro_torch.examples.<name>`` with the
reference script's flags, defaults (the reduced configs) and printed
lines, plus ``--device`` (``cuda`` by default, which raises without a
card; ``--device cpu`` runs it on the CPU):

  fact_verification      the paper's application: train a verifier, then
                         sweep the prompt templates through PCM
  opportunistic_serving  the paper's RQ3/RQ4 regimes, live (an elastic
                         pool under a capacity trace) or simulated
  quickstart             a tour of the client API on both backends
  train_smollm           training with checkpoint and restart

Each script's ``main`` is split into functions that take the config and
the device and return the counts ``main`` prints, so that tests and
``chip_smoke.py`` drive the same code at other sizes. The modules live in
the package so that a node process can import a context builder by its
module path (``repro_torch.examples.quickstart.load_model``).
"""
