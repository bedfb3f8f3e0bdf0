"""PyTorch/CUDA port of the Sapphire tuner (the JAX package ``repro`` is
the reference).  Same subpackage layout; the Matérn-5/2 Gram kernel is
hand-written CUDA for Hopper (``kernels/gp_gram``)."""
