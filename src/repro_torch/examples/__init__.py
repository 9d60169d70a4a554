"""The JAX package's examples on the port, one module each, run as
``python -m repro_torch.examples.<name> [--device cpu]``:

* ``quickstart`` — the paper's Fig. 1 pipeline (profile → policy → PRISM
  ViT), ``examples/quickstart.py``;
* ``serve_adaptive`` — the adaptive serving loop and generation,
  ``examples/serve_adaptive.py``;
* ``train_lm`` — a reduced llama trained with checkpoints,
  ``examples/train_lm.py``;
* ``finetune_prism`` — the paper's Table 3 mechanism (accuracy under
  segment means, recovered by fine-tuning through them),
  ``examples/finetune_prism.py`` with ``benchmarks/accuracy_prism.py``.

Each runs on the card unless ``--device cpu`` asks for the CPU, prints its
reference's lines and closing line, and has ``main(argv=None, *,
params=None)``: ``params`` (e.g. the JAX example's weights through
``repro_torch.models.bridge.params_from_numpy``) replaces the seeded draw.
"""
