"""The zoo's inference scripts (counterparts of the JAX repo's
``inference/``), each ``python -m bsvd_tpu_torch.inference.<name>`` with
the JAX script's flags plus ``--device`` (the card unless ``cpu``)."""
