"""Training of the port: the trainer (``loop``), metrics and checkpoints.
``python -m or4d_tpu_torch.train`` is the command line (``__main__``)."""
