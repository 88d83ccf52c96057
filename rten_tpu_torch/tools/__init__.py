"""Tools of the port that are not part of serving: microbenchmarks run on
the card (``python3 -m rten_tpu_torch.tools.<name>``)."""
