"""Training (from ``repro.train``): the AdamW / Adafactor optimizers, the
microbatched train step over ``Model.loss``, the stateless synthetic data
stream, checkpoints that cross packages, and the elastic control plane."""
