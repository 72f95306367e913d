"""The reference's six examples on the port (counterpart of ``examples/``).

Each module keeps its reference's structure, constants, flags and printed
lines, does no work when imported, and runs as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

``--device`` defaults to CUDA and raises without a card; nothing falls
back to the CPU by itself.  Each also exposes the function the tests and
``chip_smoke.py`` call, whose arguments default to the reference's sizes:

* :mod:`.quickstart` — ``run()``: Algorithm 1 on the §VII regression
  against Theorem 5.
* :mod:`.federated_comparison` — ``run()``: the Section-IV variants as
  configurations of one engine, then MSD against bytes on the wire.
* :mod:`.custom_graph` — ``run()``: a third-party ``GraphProcess``
  registered with ``@GRAPHS.register("hub_rotate")``.
* :mod:`.train_lm` — ``main(argv)``: Algorithm 1 on a smoke language
  model, then a checkpoint.
* :mod:`.train_federated_text` — ``main(argv)``: the declarative spec
  path over a partitioned corpus.
* :mod:`.serve_lm` — ``serve(arch)``: prefill and greedy decode of three
  architecture families.
"""
