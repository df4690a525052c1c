"""User programs on the port, one module per example of the JAX package's
``examples/``: each ``main(*, device=None, ...)`` runs on the card unless
given ``device="cpu"``, asserts its invariants and returns the quantities
the JAX script prints.  Run one as
``python -m mixed_radix_fast_fourier_transform_tpu_torch.examples.<name>``."""
