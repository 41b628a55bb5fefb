"""Replicated decode (the port's ``fira_tpu/parallel``): the slot-engine
fleet of :mod:`fira_tpu_torch.parallel.fleet`. The JAX package's training
mesh and ring attention are ROADMAP A.10."""
